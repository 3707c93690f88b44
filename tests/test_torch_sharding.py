"""The sharding rules, the dry-run's cells and the roofline arithmetic
(``repro_torch.distributed.sharding`` / ``act_sharding``,
``models.common``, ``configs``, ``roofline.analysis``) against the
reference's, with no device and no process group: the rules read only a
mesh's ``.shape``, so both packages run on the same shape-only meshes
(16 × 16, 2 × 16 × 16 and 2 × 2).

Leaf for leaf and bit for bit: ``param_pspecs`` (fsdp on and off) for all
ten architectures at full width (the port's trees from
``Model.abstract_params``, the reference's from its own), and
``batch_pspecs``, ``input_specs``, ``decode_state_pspecs``,
``tokens_pspec`` and ``state_specs`` for the 40 cells (int8 KV included);
``pick`` / ``dp_axes`` / ``param_spec``, ``all_cells`` /
``cell_supported`` / ``default_kv_dtype``, parameter and active counts,
``model_flops_estimate``, and ``act_sharding``'s choices against the specs
the reference pins (``jax.lax.with_sharding_constraint`` patched to record
them).  None of these takes the reference's dry-run or
mesh runs as its oracle (ROADMAP C.3).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import act_sharding as jacts  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.registry import active_param_count as jactive  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.registry import active_param_count  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402


class ShapeMesh:
    """A mesh the rules can read: only ``.shape``."""

    def __init__(self, **shape):
        self.shape = dict(shape)

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


MESHES = [ShapeMesh(data=16, model=16), ShapeMesh(pod=2, data=16, model=16),
          ShapeMesh(data=2, model=2)]
MESH_IDS = ["16x16", "2x16x16", "2x2"]
ALL_CELLS = [(a, s) for a, s, _, _ in configs.all_cells()]


def _jspecs(tree):
    """The reference's spec tree as tuples, in JAX's leaf order."""
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _tspecs(tree):
    return [tuple(s) for s in flatten(tree)[0]]


@pytest.fixture(scope="module")
def trees():
    """Each architecture's parameter tree at full width: the port's fake
    tensors and the reference's avals, built once."""
    return {a: (get_model(configs.get_config(a)).abstract_params(),
                jget_model(jconfigs.get_config(a)).abstract_params())
            for a in configs.ARCHS}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_pspecs_match_reference(trees, arch):
    tp, jp = trees[arch]
    tleaves, jleaves = flatten(tp)[0], jax.tree.leaves(jp)
    assert [tuple(x.shape) for x in tleaves] == [x.shape for x in jleaves]
    for mesh, fsdp in itertools.product(MESHES, (True, False)):
        want = _jspecs(jshd.param_pspecs(jp, mesh, fsdp=fsdp))
        got = _tspecs(shd.param_pspecs(tp, mesh, fsdp=fsdp))
        assert got == want, (arch, mesh, fsdp)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_counts_match_reference(trees, arch):
    tp, jp = trees[arch]
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    n = sum(x.numel() for x in flatten(tp)[0])
    assert n == sum(x.size for x in jax.tree.leaves(jp))
    assert active_param_count(cfg, tp) == jactive(jcfg, jp)
    for name, shape in configs.SHAPES.items():
        for n_active in (n, active_param_count(cfg, tp)):
            assert analysis.model_flops_estimate(
                cfg, shape.kind, shape.seq_len, shape.global_batch, n,
                n_active) == janalysis.model_flops_estimate(
                jcfg, shape.kind, shape.seq_len, shape.global_batch, n,
                n_active)


def test_abstract_params_allocate_nothing():
    from torch._subclasses.fake_tensor import FakeTensor

    tp = get_model(configs.get_config("llama4-scout-17b-a16e")
                   ).abstract_params()
    leaves = flatten(tp)[0]
    assert all(isinstance(x, FakeTensor) for x in leaves)
    assert sum(x.numel() for x in leaves) == 101_730_063_360


def test_abstract_train_state_is_the_reference_tree(trees):
    from repro.training.train_step import abstract_train_state as jabs
    from repro_torch.training.train_step import abstract_train_state

    cfg = configs.get_config("qwen3-moe-30b-a3b")
    t = abstract_train_state(get_model(cfg))
    j = jabs(jget_model(jconfigs.get_config("qwen3-moe-30b-a3b")))
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for x in flatten(t)[0]]
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(j)]
    assert got == want
    for mesh in MESHES:
        assert _tspecs(shd.param_pspecs(t, mesh)) == _jspecs(
            jshd.param_pspecs(j, mesh))


def test_cells_match_reference():
    assert configs.all_cells() == jconfigs.all_cells()
    assert len(configs.all_cells()) == 40
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.FULL_ATTENTION_ARCHS == jconfigs.FULL_ATTENTION_ARCHS
    for name, s in configs.SHAPES.items():
        j = jconfigs.SHAPES[name]
        assert (s.name, s.kind, s.seq_len, s.global_batch) == (
            j.name, j.kind, j.seq_len, j.global_batch)
    for a, s in itertools.product(configs.ARCHS, configs.SHAPES):
        assert configs.cell_supported(a, s) == jconfigs.cell_supported(a, s)
        t, j = configs.default_kv_dtype(a, s), jconfigs.default_kv_dtype(a, s)
        assert (t is None) == (j is None)
        if t is not None:
            assert t == torch.int8 and j == jnp.int8


def _dt(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_and_batch_pspecs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        t = configs.input_specs(cfg, shape)
        j = jconfigs.input_specs(jcfg, jconfigs.SHAPES[name])
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == j[k].shape and _dt(t[k]) == str(
                j[k].dtype), (arch, name, k)
        for mesh in MESHES:
            assert _tspecs(shd.batch_pspecs(t, mesh)) == _jspecs(
                jshd.batch_pspecs(j, mesh))


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_state_specs_and_decode_pspecs_match_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    s, js = configs.SHAPES[shape], jconfigs.SHAPES[shape]
    kv, jkv = (configs.default_kv_dtype(arch, shape),
               jconfigs.default_kv_dtype(arch, shape))
    for tk, jk in ((kv, jkv), (torch.int8, jnp.int8)):
        t = configs.state_specs(cfg, s, kv_dtype=tk)
        j = jconfigs.state_specs(jcfg, js, kv_dtype=jk)
        tl, jl = flatten(t)[0], jax.tree.leaves(j)
        assert [(tuple(x.shape), _dt(x)) for x in tl] == [
            (x.shape, str(x.dtype)) for x in jl]
        assert all(x.device.type == "meta" for x in tl)
        for mesh in MESHES:
            assert _tspecs(shd.decode_state_pspecs(t, mesh, cfg)) == _jspecs(
                jshd.decode_state_pspecs(j, mesh, jcfg)), (mesh, tk)
    for mesh in MESHES:
        assert tuple(shd.tokens_pspec(s.global_batch, mesh)) == tuple(
            jshd.tokens_pspec(js.global_batch, mesh))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_pick_dp_axes_and_param_spec_match_reference(mesh):
    assert common.dp_axes(mesh) == jcommon.dp_axes(mesh)
    dims = (1, 2, 3, 8, 16, 40, 64, 96, 128, 256, 512, 4096, 151936)
    cands = [None, "data", "model", ("data",), ("data", "model"),
             common.dp_axes(mesh)]
    for d in dims:
        for c in itertools.permutations(cands, 2):
            assert common.pick(mesh, d, *c) == jcommon.pick(mesh, d, *c)
    kinds = ("model", "fsdp", "expert", None)
    for shape in itertools.product((16, 40, 128, 4096), repeat=3):
        for k in itertools.product(kinds, repeat=3):
            assert tuple(common.param_spec(mesh, shape, k)) == tuple(
                jcommon.param_spec(mesh, shape, k)), (shape, k)


def test_partition_spec_entries_as_jax_stores_them():
    from jax.sharding import PartitionSpec

    for entries in [((), None, ("a", "b"), ["c"]), (("data",),), ()]:
        assert tuple(common.P(*entries)) == tuple(PartitionSpec(*entries))
    assert common.P(("data",), None) == common.P("data", None)
    assert common.P(("pod", "data"), "model").axes() == ("pod", "data",
                                                          "model")


def _reference_choice(monkeypatch, fn, shape, *args):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    out = fn(jax.ShapeDtypeStruct(shape, jnp.float32), *args)
    assert out is not None
    return tuple(seen[0]) if seen else None


ACT_SHAPES = [(8, 16, 4096), (4, 40, 128), (16, 8, 4, 1024, 1024),
              (2, 8, 5, 32, 64), (256, 40, 1, 4096, 4096),
              (128, 8, 1, 1, 32768), (1, 6, 2, 16, 24), (3, 5, 7)]


@pytest.mark.parametrize("mesh", MESHES + [ShapeMesh(data=4)],
                         ids=MESH_IDS + ["4"])
def test_act_sharding_choices_match_reference(monkeypatch, mesh):
    try:
        jacts.set_mesh(mesh)
        acts.set_mesh(mesh)
        for shape in ACT_SHAPES:
            for tfn, jfn, args in ((acts.batch_major_spec, jacts.batch_major,
                                    ()),
                                   (acts.attn_weights_spec, jacts.attn_weights,
                                    ()),
                                   (acts.seq_major_spec, jacts.seq_major,
                                    (1,)),
                                   (acts.seq_major_spec, jacts.seq_major,
                                    (2,))):
                got = tfn(shape, *args)
                want = _reference_choice(monkeypatch, jfn, shape, *args)
                assert (tuple(got) if got is not None else None) == want, (
                    tfn.__name__, shape, args)
        for n in (1, 8, 16, 40, 32):
            assert acts.heads_even(n) == jacts.heads_even(n)
    finally:
        jacts.clear()
        acts.clear()


def test_act_sharding_hooks_are_identities_on_plain_tensors():
    x = torch.zeros(4, 2, 1, 8, 8)
    assert acts.attn_weights(x) is x and acts.batch_major(x) is x
    try:
        acts.set_mesh(MESHES[2])
        assert acts.attn_weights(x) is x and acts.seq_major(x, 3) is x
        assert acts.heads_even(4) and not acts.heads_even(3)
    finally:
        acts.clear()
    assert acts.heads_even(3)


def test_local_shape_divides_by_the_axes_of_each_dim():
    mesh = MESHES[1]
    spec = common.P(("pod", "data"), "model", None)
    assert shd.local_shape((512, 4096, 3), spec, mesh) == (16, 256, 3)
    assert shd.local_shape((8,), common.P(None), mesh) == (8,)


def test_best_grid_is_the_reference_rule():
    from repro.distributed.elastic import best_mesh as jbest_mesh
    from repro_torch.distributed.elastic import best_grid

    class Dev:  # the reference's Mesh holds any objects
        def __init__(self, i):
            self.id = i

    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 256, 512):
        devs = [Dev(i) for i in range(n)]
        for mp in (None, 1):
            want = jbest_mesh(devs, model_parallel=mp).shape
            assert best_grid(n, model_parallel=mp) == (want["data"],
                                                       want["model"])
    with pytest.raises(ValueError):
        best_grid(0)


def test_roofline_terms_on_data_sheet_rates():
    r = analysis.Roofline(arch="a", shape="s", mesh="pod", chips=4,
                          flops=989.4e12, bytes_accessed=2 * 3.35e12,
                          collective_bytes=450e9 / 2, collective_ops={},
                          model_flops=2 * 989.4e12, peak_memory_bytes=1.0)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.dominant == "memory" and r.step_s == pytest.approx(2.0)
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.mfu == pytest.approx(2 / (2 * 4))
    assert set(r.to_dict()) == set(janalysis.Roofline(
        arch="a", shape="s", mesh="pod", chips=4, flops=1.0,
        bytes_accessed=1.0, collective_bytes=1.0, collective_ops={},
        model_flops=1.0, peak_memory_bytes=1.0).to_dict())


def test_count_step_counts_matmul_flops_and_operand_bytes():
    """``analysis.analyze`` over a fake-traced step (``op_trace``): the
    matmul's 2·M·K·N FLOPs and the sum's |in|, each op's operands read
    and its output written once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.zeros(64, 32)
        b = torch.zeros(32, 16)
        r = analysis.analyze(lambda: (a @ b).sum(), arch="a", shape="s",
                             mesh_name="pod", chips=4, model_flops=1.0)
    assert r.flops == 2 * 64 * 32 * 16 + 64 * 16
    assert r.bytes_accessed == ((64 * 32 + 32 * 16 + 64 * 16) * 4
                                + (64 * 16 + 1) * 4)
    assert r.cost.op_counts == {"aten::mm": 1, "aten::sum": 1}
    assert r.collective_bytes == 0.0 and r.peak_memory_bytes > 0
    assert np.isfinite(r.flops)
