"""The combine flow's kernels, through their plain PyTorch versions (CPU).

``repro_torch.kernels.ops.onehot_combine`` / ``combine_scatter`` on CPU
tensors take the plain version of each kernel; these tests hold it against
the Pallas kernels of ``repro`` (interpret mode) and against
``repro.kernels.ref``, at the shapes of the reference's own kernel tests.
Sums agree within rtol=atol=1e-5 (another summation order), bf16 inputs
included: both packages cast the same bf16 numbers to f32 before summing.
Max/min must agree bit for bit, NaN and signed zeros included.  The CUDA
kernels themselves are held against the same plain versions on the card
by ``chip_smoke.py``; a last test routes meta tensors through the wrappers
to show that a tensor off the CPU reaches the kernel binding only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import combine_scatter as tcs  # noqa: E402
from repro_torch.kernels import onehot_combine as toc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)

# (n, d, k): the reference's test_kernels.py shapes for onehot_combine
ONEHOT_SHAPES = [(16, 8, 5), (100, 16, 37), (1000, 64, 256), (17, 3, 8),
                 (513, 128, 1024)]
# ... and for combine_scatter, plus one key and a ragged wide case
SCATTER_SHAPES = [(50, 4, 11), (300, 16, 64), (64, 1, 3), (37, 9, 1),
                  (257, 130, 100)]


def _pairs(seed, n, d, k, *, specials=False, bad_keys=True):
    """Keys in [0, K] (K: the sentinel) and, with ``bad_keys``, keys past K
    and below 0, which the port drops and the reference never sees."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k + 1, size=n).astype(np.int32)
    if bad_keys:
        bad = rng.random(n) < 0.1
        keys[bad] = rng.choice(np.array([k + 1, k + 9, -1, -5], np.int32),
                               size=int(bad.sum()))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    if specials:
        flat = vals.reshape(-1)
        pick = rng.random(flat.size)
        flat[pick < 0.15] = 0.0
        flat[(pick >= 0.15) & (pick < 0.3)] = -0.0
        flat[(pick >= 0.3) & (pick < 0.33)] = np.nan
    return keys, vals


def _sentinel(keys, k):
    """The reference's input: every key outside [0, K) is the sentinel, as
    the emitters of both packages make it."""
    return np.where((keys < 0) | (keys > k), k, keys).astype(np.int32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", ONEHOT_SHAPES)
def test_onehot_combine_plain_matches_pallas_and_ref(n, d, k, dtype):
    keys, vals = _pairs(n + 7 * k, n, d, k)
    tvals = torch.from_numpy(vals).to(getattr(torch, dtype))
    got = ops.onehot_combine(torch.from_numpy(keys), tvals, k)
    assert got.dtype == torch.float32 and got.shape == (k, d)
    jvals = jnp.asarray(vals, getattr(jnp, dtype))
    jkeys = jnp.asarray(_sentinel(keys, k))
    pallas = np.asarray(jops.onehot_combine(jkeys, jvals, k, interpret=True))
    oracle = np.asarray(jref.onehot_combine(jkeys, jvals, k))
    np.testing.assert_allclose(got.numpy(), pallas, **SUM_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **SUM_TOL)


@pytest.mark.parametrize("block_k", [None, 1, 7, 32])
def test_onehot_combine_key_blocks_do_not_change_the_sums(block_k):
    keys, vals = _pairs(5, 400, 3, 50)
    t = torch.from_numpy
    whole = ops.onehot_combine(t(keys), t(vals), 50)
    got = ops.onehot_combine(t(keys), t(vals), 50, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **SUM_TOL)
    plain = toc.onehot_combine_plain(t(keys), t(vals), 50, block_k=block_k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(plain.numpy()))


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n,d,k", SCATTER_SHAPES)
def test_combine_scatter_plain_matches_pallas_and_ref(op, n, d, k):
    keys, vals = _pairs(3 * n + k, n, d, k, specials=op != "add")
    got = ops.combine_scatter(torch.from_numpy(keys), torch.from_numpy(vals),
                              k, op).numpy()
    jkeys = jnp.asarray(_sentinel(keys, k))
    pallas = np.asarray(jops.combine_scatter(jkeys, jnp.asarray(vals), k, op,
                                             interpret=True))
    oracle = np.asarray(jref.combine_scatter(jkeys, jnp.asarray(vals), k, op))
    if op == "add":
        np.testing.assert_allclose(got, pallas, **SUM_TOL)
        np.testing.assert_allclose(got, oracle, **SUM_TOL)
    else:  # JAX's rule: NaN propagates, +0 beats -0 for max, -0 for min
        np.testing.assert_array_equal(_bits(got), _bits(pallas))
        np.testing.assert_array_equal(_bits(got), _bits(oracle))


@pytest.mark.parametrize("op", ["max", "min"])
def test_combine_scatter_signed_zeros_in_either_order(op):
    """+0 and -0 on one key, in both orders: max gives +0, min gives -0."""
    keys = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32)
    vals = torch.tensor([[0.0], [-0.0], [-0.0], [0.0], [float("nan")]])
    got = ops.combine_scatter(keys, vals, 4, op).numpy()
    want = np.asarray(jref.combine_scatter(jnp.asarray(keys.numpy()),
                                           jnp.asarray(vals.numpy()), 4, op))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    zero = np.float32(0.0 if op == "max" else -0.0)
    assert _bits(got[:2, 0]).tolist() == [_bits(zero)] * 2
    assert np.isnan(got[2, 0])
    assert got[3, 0] == (-np.inf if op == "max" else np.inf)


@pytest.mark.parametrize("op,ident", [("add", 0.0), ("max", -np.inf),
                                      ("min", np.inf)])
def test_empty_buffers_give_the_identity_table(op, ident):
    keys = torch.zeros(0, dtype=torch.int32)
    vals = torch.zeros((0, 3))
    got = ops.combine_scatter(keys, vals, 6, op)
    assert got.shape == (6, 3) and bool((got == ident).all())
    if op == "add":
        assert bool((ops.onehot_combine(keys, vals, 6) == 0).all())


def test_wrappers_check_their_inputs():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="values must be"):
        ops.onehot_combine(keys, torch.zeros(4), 3)
    with pytest.raises(ValueError, match="keys"):
        ops.combine_scatter(keys[:3], torch.zeros((4, 2)), 3)
    with pytest.raises(ValueError, match="op must be"):
        ops.combine_scatter(keys, torch.zeros((4, 2)), 3, "mul")
    with pytest.raises(ValueError, match="key_space"):
        ops.onehot_combine(keys, torch.zeros((4, 2)), 0)


def test_wrappers_on_a_card_tensor_reach_the_kernels_only(monkeypatch):
    """On tensors that do not lie on the CPU, onehot_combine and
    combine_scatter call their kernel bindings and nothing else: no plain
    version, no fallback.  Meta tensors stand in for CUDA tensors and
    recorders for the bindings."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("a plain version ran on a card tensor")

    def onehot(keys, values, key_space, plan):
        calls.append(("onehot_combine", values.dtype, plan))
        return torch.empty((key_space, values.shape[1]), device="meta")

    def scatter(keys, values, key_space, op, plan):
        calls.append(("combine_scatter", op, plan))
        return torch.empty((key_space, values.shape[1]), device="meta")

    monkeypatch.setattr(toc, "onehot_combine_plain", plain)
    monkeypatch.setattr(tcs, "combine_scatter_plain", plain)
    monkeypatch.setattr(toc, "onehot_combine_cuda", onehot)
    monkeypatch.setattr(tcs, "combine_scatter_cuda", scatter)
    k = 1 << 16
    keys = torch.empty(10_000, dtype=torch.int32, device="meta")
    vals = torch.empty((10_000, 3), dtype=torch.bfloat16, device="meta")
    assert ops.onehot_combine(keys, vals, 100).shape == (100, 3)
    assert ops.combine_scatter(keys, vals, k, "max").shape == (k, 3)
    assert calls == [
        ("onehot_combine", torch.float32,
         ops.fold_plan(10_000, 100, 3, "add")),
        ("combine_scatter", "max", ops.fold_plan(10_000, k, 3, "max"))]
    # one table of all 100 x 3; at 2^16 keys the tile route would read the
    # pairs 2 key tiles x 3 column tiles times into segment partials, so
    # the partitioned route within them: 256 key tiles of 256 keys, whole
    # rows
    assert (calls[0][2].key_tiles, calls[0][2].col_tiles) == (1, 1)
    assert ops.tile_plan(10_000, k, 3, "max").scans == 6
    assert (calls[1][2].route, calls[1][2].key_tiles,
            calls[1][2].col_tiles) == ("partitioned", 256, 1)
    with pytest.raises(TypeError):  # the kernels take int32 keys only
        ops.onehot_combine(keys.to(torch.int64), vals, 100)


@pytest.mark.parametrize("n,k,d", [(1 << 24, 100, 3), (1 << 24, 100, 1),
                                   (5_001, 37, 9), (17, 1, 128)])
def test_card_sums_take_lane_tables_and_max_min_do_not(monkeypatch, n, k, d):
    """On a tensor off the CPU, onehot_combine and combine_scatter's add
    launch with the lane-table plan at a small key space (the KMeans
    combine's values and counts among them), combine_scatter's max and
    min with the index-order plan.  Meta tensors stand in for CUDA
    tensors and recorders for the bindings."""
    calls = []

    def onehot(keys, values, key_space, plan):
        calls.append(("onehot_combine", plan))
        return torch.empty((key_space, values.shape[1]), device="meta")

    def scatter(keys, values, key_space, op, plan):
        calls.append((op, plan))
        return torch.empty((key_space, values.shape[1]), device="meta")

    monkeypatch.setattr(toc, "onehot_combine_cuda", onehot)
    monkeypatch.setattr(tcs, "combine_scatter_cuda", scatter)
    keys = torch.empty(n, dtype=torch.int32, device="meta")
    vals = torch.empty((n, d), device="meta")
    ops.onehot_combine(keys, vals, k)
    for op in ("add", "max", "min"):
        ops.combine_scatter(keys, vals, k, op)
    lane = ops.lane_plan(n, k, d)
    assert lane.shape == "lane"
    table = ops.table_plan(n, k, d)
    assert calls == [("onehot_combine", lane), ("add", lane),
                     ("max", table), ("min", table)]
