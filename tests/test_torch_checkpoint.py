"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) on the CPU.

The cases of ``tests/integration/test_checkpoint.py`` on the port (round
trip, keep-N, a given step, async, missing), corruption (a corrupt or torn
step is quarantined and restore falls back to the newest valid one),
bfloat16 leaves, and checkpoints across the packages: a ``repro`` save
verifies and restores in the port, a port save verifies and restores in
``repro`` (JAX's leaf order on disk), and a port service restored from a
reference service's checkpoint (``interop.service_state_from_repro``)
snapshots what the reference's does.  Counts, integer sums and max/min
bit for bit; float sums within rtol = atol = 1e-6.
"""

import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
import repro.streaming as JS  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import plan_cache as pc  # noqa: E402
from repro_torch.streaming import sliding  # noqa: E402

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
B = 64


def tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(
            rng.integers(0, 9, 3).astype(np.int64))},
    }


def jtree(seed):
    """The reference's test tree, from the same seed as :func:`tree`."""
    rng = np.random.default_rng(seed)
    return {
        "a": jnp.asarray(rng.standard_normal((4, 4)), jnp.float32),
        "nested": {"b": jnp.asarray(rng.integers(0, 9, 3), jnp.int32)},
    }


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits(want, got):
    w, g = host(want), host(got)
    assert w.shape == g.shape
    if w.dtype.kind == "f":
        np.testing.assert_array_equal(w.view(f"u{w.itemsize}"),
                                      g.view(f"u{g.itemsize}"))
    else:
        np.testing.assert_array_equal(w, g)


def assert_same_leaves(want, got):
    wl, gl = ckpt.flatten(want)[0], ckpt.flatten(got)[0]
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert_bits(w, g)


# ---------------------------------------------------------------------------
# The reference's cases
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    t = tree(0)
    ckpt.save(str(tmp_path), 10, t)
    assert ckpt.latest_step(str(tmp_path)) == 10
    got, step = ckpt.restore(str(tmp_path), t, device="cpu")
    assert step == 10
    assert_same_leaves(t, got)
    assert got["nested"]["b"].dtype == torch.int64


def test_keep_n_gc(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, tree(s), keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_restore_specific_step(tmp_path):
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), s, tree(s), keep=10)
    got, step = ckpt.restore(str(tmp_path), tree(0), step=2, device="cpu")
    assert step == 2
    assert_bits(tree(2)["a"], got["a"])


def test_async_checkpointer(tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    t = tree(2)
    want = {"a": t["a"].clone(), "nested": {"b": t["nested"]["b"].clone()}}
    for s in range(3):
        ac.submit(s, tree(s) if s < 2 else t)
    t["a"].add_(1.0)  # after submit: the queued copy is not affected
    ac.close()
    assert not ac._t.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 2
    got, _ = ckpt.restore(str(tmp_path), tree(0), device="cpu")
    assert_same_leaves(want, got)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), tree(0), device="cpu")


def test_restore_leaf_count_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, tree(1))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"a": 0}, device="cpu")


def test_restore_with_shardings_names_roadmap_items(tmp_path):
    """``restore(shardings=...)`` lays each leaf out on the shardings' mesh
    (a gloo group of one rank here, made and destroyed in the test): the
    leaves come back as DTensors with the stored bits."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.models.common import P

    ckpt.save(str(tmp_path), 1, tree(1))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        specs = {"a": P("data", "model"), "nested": {"b": P(None)}}
        got, step = ckpt.restore(str(tmp_path), tree(0),
                                 shardings=shd.shardings_of(specs, mesh))
        assert step == 1
        want = tree(1)
        for g, w in zip(ckpt.flatten(got)[0], ckpt.flatten(want)[0]):
            assert isinstance(g, DTensor) and g.dtype == w.dtype
            assert torch.equal(g.full_tensor(), w)
        assert [str(p) for p in got["a"].placements] == ["S(0)", "S(1)"]
    finally:
        dist.destroy_process_group()


def test_flatten_follows_jax_order():
    t = {"slots": [(torch.zeros(2), torch.ones(1)), torch.zeros(3)],
         "meta": None, "b": 1, "a": (2,)}
    leaves, treedef = ckpt.flatten(t)
    jleaves, jdef = jax.tree_util.tree_flatten(t)
    assert str(jdef) == treedef
    assert len(leaves) == len(jleaves)
    for x, y in zip(leaves, jleaves):
        assert x is y
    back = ckpt.unflatten(t, leaves)
    assert list(back) == list(t)
    assert back["slots"][0][1] is t["slots"][0][1]


# ---------------------------------------------------------------------------
# Corruption
# ---------------------------------------------------------------------------


def _flip_byte(path, offset=-10):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END)
        b = f.read(1)
        f.seek(offset, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("damage", ["payload", "torn", "manifest"])
def test_corrupt_newest_step_falls_back(tmp_path, damage):
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, tree(s), keep=10)
    step3 = os.path.join(d, "step_3")
    if damage == "payload":
        _flip_byte(os.path.join(step3, "arrays.npz"))
    elif damage == "torn":
        os.remove(os.path.join(step3, "arrays.npz"))
    else:
        _flip_byte(os.path.join(step3, "manifest.json"), -3)
    assert not ckpt.has_valid_step(d, 3)
    with pytest.raises(ckpt.CheckpointCorruptError) as err:
        ckpt.verify_step(d, 3)
    assert err.value.step == 3 and err.value.path == step3
    with pytest.warns(RuntimeWarning, match="skipping corrupt checkpoint"):
        got, step = ckpt.restore(d, tree(0), device="cpu")
    assert step == 2
    assert_bits(tree(2)["a"], got["a"])
    assert os.path.isdir(step3 + ".corrupt") and not os.path.exists(step3)


def test_corrupt_explicit_step_raises_and_quarantines(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 5, tree(5))
    _flip_byte(os.path.join(d, "step_5", "arrays.npz"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="step 5"):
        ckpt.restore(d, tree(0), step=5, device="cpu")
    assert os.path.isdir(os.path.join(d, "step_5.corrupt"))
    assert not ckpt.has_step(d, 5)


def test_service_restore_skips_corrupt_newest(tmp_path):
    spec = (pc.TensorSpec((), torch.int32), pc.TensorSpec((), torch.int32))
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 64, B).astype(np.int32),
                rng.integers(-9, 9, B).astype(np.int32)) for _ in range(8)]

    def build():
        return T.MapReduce(T.make_app(
            lambda item, emit: emit(item[0], item[1]),
            lambda k, v, c: v.sum(), key_space=64,
            value_spec=T.ValueSpec((), torch.int32), emit_capacity=1),
            streaming=True, device="cpu").serve(
            batch_capacity=B, ckpt_dir=str(tmp_path), ckpt_every=4,
            item_spec=spec)

    svc = build()
    for b in batches[:4]:
        svc.ingest(b)
    at4 = svc.snapshot()
    for b in batches[4:]:
        svc.ingest(b)
    _flip_byte(os.path.join(ckpt.service_state_dir(str(tmp_path)),
                            "step_8", "arrays.npz"))
    fresh = build()
    with pytest.warns(RuntimeWarning, match="skipping corrupt"):
        assert fresh.restore() == 4
    assert_bits(at4.values, fresh.snapshot().values)
    assert_bits(at4.counts, fresh.snapshot().counts)


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------


def test_bf16_leaf_round_trip(tmp_path):
    vals = torch.tensor([1.5, -0.0, float("inf"), 3.1415], dtype=torch.bfloat16)
    t = {"h": vals, "n": torch.arange(3)}
    ckpt.save(str(tmp_path), 1, t)
    with open(os.path.join(tmp_path, "step_1", "manifest.json")) as f:
        assert '"bfloat16"' in f.read()
    got, _ = ckpt.restore(str(tmp_path), t, device="cpu")
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"].view(torch.int16), vals.view(torch.int16))


def test_bf16_reference_save_restores_in_port(tmp_path):
    j = {"h": jnp.asarray([1.5, -2.25, 0.125], jnp.bfloat16)}
    jckpt.save(str(tmp_path), 3, j)
    got, step = ckpt.restore(str(tmp_path), j, device="cpu")
    assert step == 3 and got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["h"].view(torch.int16).numpy(),
        np.asarray(j["h"]).view(np.int16))


def test_bf16_max_holder_service_round_trip(tmp_path):
    """A max over bfloat16 values keeps a bfloat16 holder (C.27 widens
    only sums and products); its checkpoint restores bit for bit."""
    app = T.make_app(lambda item, emit: emit(item[0], item[1]),
                     lambda k, v, c: v.amax(0), key_space=64,
                     value_spec=T.ValueSpec((), torch.bfloat16),
                     emit_capacity=1)
    spec = (pc.TensorSpec((), torch.int32), pc.TensorSpec((), torch.bfloat16))

    def build():
        return T.MapReduce(app, streaming=True, device="cpu").serve(
            batch_capacity=B, window=sliding(4, 2), ckpt_dir=str(tmp_path),
            item_spec=spec)

    svc = build()
    rng = np.random.default_rng(4)
    for _ in range(3):
        svc.ingest((torch.from_numpy(rng.integers(0, 64, B).astype(np.int32)),
                    torch.from_numpy(rng.standard_normal(B).astype(
                        np.float32)).to(torch.bfloat16)))
    assert ckpt.flatten(svc._state.slots)[0][0].dtype == torch.bfloat16
    svc.checkpoint()
    fresh = build()
    assert fresh.restore() == 3
    want, got = svc.snapshot(), fresh.snapshot()
    assert got.values.dtype == torch.bfloat16
    assert torch.equal(got.values.view(torch.int16),
                       want.values.view(torch.int16))
    assert torch.equal(got.counts, want.counts)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def test_reference_checkpoint_restores_in_port(tmp_path):
    j = jtree(7)
    jckpt.save(str(tmp_path), 4, j)
    ckpt.verify_step(str(tmp_path), 4)
    got, step = ckpt.restore(str(tmp_path), j, device="cpu")
    assert step == 4
    assert_same_leaves(jax.tree.map(np.asarray, j), got)


def test_port_checkpoint_restores_in_reference(tmp_path):
    """Insertion order differs from sorted order: the leaves must land as
    JAX numbers them."""
    t = {"slots": [(tree(1)["a"], torch.arange(5, dtype=torch.int32))],
         "meta": np.asarray([3, 7], np.int64)}
    ckpt.save(str(tmp_path), 2, t)
    jckpt.verify_step(str(tmp_path), 2)
    example = jax.tree.map(np.asarray, {"slots": [(np.zeros((4, 4)),
                                                   np.zeros(5))],
                                        "meta": np.zeros(2)})
    got, step = jckpt.restore(str(tmp_path), example)
    assert step == 2
    assert_bits(t["slots"][0][0], got["slots"][0][0])
    np.testing.assert_array_equal(np.asarray(got["slots"][0][1]),
                                  np.arange(5))
    np.testing.assert_array_equal(np.asarray(got["meta"]), [3, 7])


def _kmeans_apps():
    tapp = T.make_app(lambda item, emit: emit(item[0], item[1]),
                      lambda k, v, c: v.sum(0) / c.clamp(min=1).to(
                          torch.float32), key_space=16,
                      value_spec=T.ValueSpec((3,), torch.float32),
                      emit_capacity=1)
    japp = J.make_app(map_fn=lambda item, emit: emit(item[0], item[1]),
                      reduce_fn=lambda k, v, c: jnp.sum(v, 0)
                      / jnp.maximum(c, 1),
                      key_space=16,
                      value_aval=jax.ShapeDtypeStruct((3,), jnp.float32),
                      emit_capacity=1)
    return tapp, japp, (pc.TensorSpec((), torch.int32),
                        pc.TensorSpec((3,), torch.float32)), \
        (jax.ShapeDtypeStruct((), jnp.int32),
         jax.ShapeDtypeStruct((3,), jnp.float32))


def _int_sum_apps():
    tapp = T.make_app(lambda item, emit: emit(item[0], item[1]),
                      lambda k, v, c: v.sum(), key_space=16,
                      value_spec=T.ValueSpec((), torch.int32),
                      emit_capacity=1)
    japp = J.make_app(map_fn=lambda item, emit: emit(item[0], item[1]),
                      reduce_fn=lambda k, v, c: jnp.sum(v), key_space=16,
                      value_aval=jax.ShapeDtypeStruct((), jnp.int32),
                      emit_capacity=1)
    return tapp, japp, (pc.TensorSpec((), torch.int32),
                        pc.TensorSpec((), torch.int32)), \
        (jax.ShapeDtypeStruct((), jnp.int32),
         jax.ShapeDtypeStruct((), jnp.int32))


@pytest.mark.parametrize("case,kernels", [("kmeans", True),
                                          ("kmeans", False),
                                          ("int_sum", False)])
def test_port_service_resumes_reference_checkpoint(case, kernels):
    """A reference service checkpoints at batch 8; its tree crosses into
    the port (fused or per-leaf layout, int32 -> int64 tables), a port
    service restores it and snapshots what the reference service does at
    batch 8, then both ingest on and agree again.  The port's own
    checkpoint of that state verifies and restores in the reference."""
    tapp, japp, tspec, jspec = (_kmeans_apps() if case == "kmeans"
                                else _int_sum_apps())
    rng = np.random.default_rng(21)
    width = (3,) if case == "kmeans" else ()
    batches = []
    for n in [B, 40, B, 0, B, 7, B, B, B, 13, B]:
        keys = rng.integers(0, 16, n).astype(np.int32)
        vals = (rng.standard_normal((n,) + width).astype(np.float32)
                if case == "kmeans"
                else rng.integers(-50, 50, n).astype(np.int32))
        batches.append((keys, vals))

    def compare(want, got):
        np.testing.assert_array_equal(host(got.counts),
                                      np.asarray(want.counts))
        if case == "kmeans":
            np.testing.assert_allclose(host(got.values),
                                       np.asarray(want.values), **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(host(got.values),
                                          np.asarray(want.values))

    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as td:
        ref = J.MapReduce(japp, streaming=True).serve(
            batch_capacity=B, window=JS.sliding(4, 2), ckpt_dir=jd,
            ckpt_every=4, item_spec=jspec)
        for b in batches[:8]:
            ref.ingest(tuple(jnp.asarray(x) for x in b))
        want8 = ref.snapshot()
        svc = T.MapReduce(tapp, streaming=True, device="cpu",
                          use_kernels=kernels).serve(
            batch_capacity=B, window=sliding(4, 2), ckpt_dir=td,
            item_spec=tspec)
        assert svc.collector.fused_acc == kernels
        example = jax.tree.map(np.asarray, ref._state_tree(ref._state))
        jtree_8, step = ckpt.restore(jckpt.service_state_dir(jd), example,
                                     step=8, device="cpu")
        assert step == 8
        ported = interop.service_state_from_repro(svc, jtree_8)
        ckpt.save(ckpt.service_state_dir(td), 8, ported)
        assert svc.restore() == 8 and svc.batch_id == 8
        compare(want8, svc.snapshot())

        jckpt.verify_step(ckpt.service_state_dir(td), 8)
        port_example = jax.tree.map(
            np.asarray, ckpt.unflatten(ported, [
                np.zeros(1)] * len(ckpt.flatten(ported)[0])))
        back, _ = jckpt.restore(ckpt.service_state_dir(td), port_example)
        np.testing.assert_array_equal(np.asarray(back["meta"]),
                                      [8, ref.n_items])

        for b in batches[8:]:
            ref.ingest(tuple(jnp.asarray(x) for x in b))
            svc.ingest(b)
            compare(ref.snapshot(), svc.snapshot())


def test_service_checkpoint_and_restore_go_through_retry_policy(tmp_path):
    """Any object with ``.call(fn, op=, on_event=)`` retries the service's
    checkpoint writes and restore reads; its events reach ``explain()``."""

    class OneRetry:
        def __init__(self):
            self.ops = []

        def call(self, fn, *, op, on_event):
            self.ops.append(op)
            try:
                raise OSError("transient store error")
            except OSError as e:
                on_event(f"retry {op}: {e}")
            return fn()

    policy = OneRetry()
    spec = (pc.TensorSpec((), torch.int32), pc.TensorSpec((), torch.int32))
    app = T.make_app(lambda item, emit: emit(item[0], item[1]),
                     lambda k, v, c: v.sum(), key_space=16,
                     value_spec=T.ValueSpec((), torch.int32),
                     emit_capacity=1)
    svc = T.MapReduce(app, streaming=True, device="cpu").serve(
        batch_capacity=8, ckpt_dir=str(tmp_path), ckpt_every=2,
        item_spec=spec, retry_policy=policy)
    for i in range(2):
        svc.ingest((np.full(8, i, np.int32), np.ones(8, np.int32)))
    assert svc.restore() == 2
    assert policy.ops == ["checkpoint batch 2",
                          f"service restore from "
                          f"{ckpt.service_state_dir(str(tmp_path))}"]
    assert "event: retry checkpoint batch 2" in svc.explain()
