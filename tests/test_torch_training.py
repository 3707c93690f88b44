"""Training for the dense family (``repro_torch.training``) against the
reference's ``repro.training`` on the CPU.

The cases of ``tests/training/test_training.py`` on the port and against
the reference, with its tolerances: the three xent modes agree (1e-5);
the chunked loss's gradient with respect to ``hidden`` and ``unembed``,
with a softcap and a mask (rtol 1e-4, atol 1e-5), and its memory property
(no ``[B, S, V]`` tensor is saved for the backward); label masking; the
derived monoid; accumulation at M = 1, 2, 4 in both modes against the
reference's ``accumulate_gradients``; AdamW moves and clips; the cosine
schedule; int8 fake-quant.  Then ``make_train_step`` for three steps on
the four dense archs at ``reduced()`` from the reference's state
(``interop.train_state_from_repro``): per-step loss and ``grad_norm``
within rtol 1e-4 and the master parameters within atol 1e-5; gemma2 at
S = 64, so that its reduced 32-token window bites; int8 gradient
compression; and the reference's ``test_train_step_decreases_loss`` for
the dense archs.  The data pipeline's batches bit for bit.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.training import grad_accum as jaccum  # noqa: E402
from repro.training import losses as jlosses  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten, unflatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.training import grad_accum, losses, optim  # noqa: E402
from repro_torch.training import train_step  # noqa: E402

RNG = jax.random.PRNGKey(0)
DENSE = ("llama3-8b", "gemma2-27b", "qwen2.5-14b", "qwen1.5-32b")
XENT_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [x.detach().numpy() for x in flatten(tree)[0]]


def _xent_inputs(seed, B, S, E, V):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, E)).astype(np.float32),
            rng.standard_normal((V, E)).astype(np.float32),
            rng.integers(0, V, (B, S)).astype(np.int32))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_xent_modes_agree():
    h, w, lab = _xent_inputs(0, 2, 8, 16, 100)
    want = float(jlosses.xent_materialize(h, w, lab))
    got = {
        "materialize": losses.xent_materialize(_t(h), _t(w), _t(lab)),
        "chunked": losses.xent_chunked(_t(h), _t(w), _t(lab), chunk=32),
        "sharded": losses.xent_sharded(_t(h), _t(w), _t(lab)),
    }
    for mode, val in got.items():
        np.testing.assert_allclose(float(val), want, **XENT_TOL, err_msg=mode)
    np.testing.assert_allclose(
        float(got["chunked"]),
        float(jlosses.xent_chunked(h, w, lab, chunk=32)), **XENT_TOL)


@pytest.mark.parametrize("softcap", [None, 2.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [16, 50, 64])
def test_xent_chunked_grad_matches(softcap, masked, chunk):
    """d loss / d hidden and d loss / d unembed of the port's chunked loss
    against the reference's chunked loss and the port's materialized one
    (V = 50: chunk 16 leaves a short last chunk)."""
    h, w, lab = _xent_inputs(1, 2, 4, 8, 50)
    mask = (np.asarray([[1, 1, 0, 1], [0, 1, 1, 1]], np.float32) if masked
            else None)
    jmask = None if mask is None else jnp.asarray(mask)
    jg = jax.grad(lambda a, b: jlosses.xent_chunked(
        a, b, lab, mask=jmask, softcap=softcap, chunk=chunk),
        argnums=(0, 1))(h, w)
    tmask = None if mask is None else _t(mask)

    def port(fn, **kw):
        th = _t(h).requires_grad_(True)
        tw = _t(w).requires_grad_(True)
        loss = fn(th, tw, _t(lab), mask=tmask, softcap=softcap, **kw)
        return [g.numpy() for g in torch.autograd.grad(loss, (th, tw))]

    got = port(losses.xent_chunked, chunk=chunk)
    base = port(losses.xent_materialize)
    for name, a, b, c in zip(("hidden", "unembed"), got, jg, base):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a, c, **GRAD_TOL, err_msg=name)


def test_xent_chunked_saves_no_logits_for_backward():
    """The reference's ``jax.checkpoint`` property: nothing of the
    ``[B, S, V]`` logits (or of a chunk's) is kept for the backward."""
    B, S, E, V = 2, 8, 16, 96
    h, w, lab = _xent_inputs(2, B, S, E, V)
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = losses.xent_chunked(th, tw, _t(lab), chunk=32, softcap=5.0)
    assert saved, "the chunked loss saved nothing"
    assert all(not s or s[-1] not in (V, 32) for s in saved), saved
    assert max(int(np.prod(s)) for s in saved) == V * E
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        saved.clear()
        losses.xent_materialize(th, tw, _t(lab))
    assert (B, S, V) in saved  # the baseline keeps the logits
    loss.backward()
    assert th.grad is not None and tw.grad is not None


def test_label_masking():
    h, w, lab = _xent_inputs(2, 1, 6, 8, 20)
    mask = np.asarray([[1, 1, 0, 0, 1, 1]], np.float32)
    kept = [0, 1, 4, 5]
    want = float(jlosses.xent_materialize(h, w, lab, mask=mask))
    for fn in (losses.xent_materialize, losses.xent_chunked,
               losses.xent_sharded):
        a = float(fn(_t(h), _t(w), _t(lab), mask=_t(mask)))
        full = float(fn(_t(h[:, kept]), _t(w), _t(lab[:, kept])))
        np.testing.assert_allclose(a, full, rtol=1e-5)
        np.testing.assert_allclose(a, want, rtol=1e-5)


def test_lm_loss_masks_negative_labels_and_aligns_hidden():
    """``lm_loss``: labels < 0 drop out, labels clamp to 0 before the
    gather, and ``hidden[:, -labels.shape[1]:]`` when they differ in
    length; the port against the reference in every mode."""
    jcfg = jget_config("gemma2-27b").reduced()
    cfg = get_config("gemma2-27b").reduced()
    jm, tm = jget_model(jcfg), get_model(cfg)
    jp = jm.init_params(RNG)
    tp = interop.params_from_repro(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    for lab in (labels, labels[:, 4:]):
        jb = {"tokens": toks, "labels": lab}
        tb = {"tokens": _t(toks), "labels": _t(lab)}
        for mode in ("chunked", "materialize", "sharded"):
            jl, jaux = jlosses.lm_loss(jm, jp, jb, mode=mode, vocab_chunk=48)
            tl, taux = losses.lm_loss(tm, tp, tb, mode=mode, vocab_chunk=48)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                       err_msg=mode)
            assert set(taux) == set(jaux)


def test_sharding_arguments_name_their_roadmap_item():
    """The mesh arguments run now (tests/test_torch_fsdp.py); here what
    they check: ``logits_pspec`` names axes of the registered mesh, a
    sharded accumulation needs a mesh, a sharded step a DTensor state."""
    from repro_torch.distributed import act_sharding

    h, w, lab = _xent_inputs(0, 1, 2, 4, 8)
    with pytest.raises(ValueError, match="no mesh"):
        losses.xent_sharded(_t(h), _t(w), _t(lab), logits_pspec=("model",))

    class Mesh:
        shape = {"data": 2, "model": 2}

    try:
        act_sharding.set_mesh(Mesh())
        with pytest.raises(ValueError, match="lacks"):
            losses.xent_sharded(_t(h), _t(w), _t(lab),
                                logits_pspec=(("pod", "data"), None))
        got = losses.xent_sharded(_t(h), _t(w), _t(lab),
                                  logits_pspec=("data", None, "model"))
        assert float(got) == float(losses.xent_sharded(_t(h), _t(w),
                                                       _t(lab)))
    finally:
        act_sharding.clear()
    with pytest.raises(ValueError, match="needs a mesh"):
        grad_accum.accumulate_gradients(lambda p, b: None, {}, {},
                                        pspecs={})
    model = get_model(get_config("llama3-8b").reduced())
    step = train_step.make_train_step(model, train_step.TrainConfig(),
                                      param_pspecs={})
    with pytest.raises(TypeError, match="DTensors"):
        step(train_step.init_train_state(model,
                                         torch.Generator().manual_seed(0)),
             {})


# ---------------------------------------------------------------------------
# The derived combiner and accumulation
# ---------------------------------------------------------------------------


def test_grad_combiner_derivation_is_monoid():
    d = grad_accum.derive_grad_combiner()
    assert d.strategy == "monoid" and d.validated and d.combinable
    assert grad_accum.derive_grad_combiner() is d  # cached
    jd = jaccum.derive_grad_combiner()
    assert (d.strategy, d.validated) == (jd.strategy, jd.validated)


def test_derived_spec_applies_unchanged_to_a_gradient_leaf():
    """The spec derived at ``ValueSpec((4,), f32)`` folds and finalizes a
    ``[3, 5, 7]`` gradient: premap is the identity, combine adds, finalize
    divides by the count."""
    spec = grad_accum.derive_grad_combiner().spec
    rng = np.random.default_rng(4)
    gs = [torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))
          for _ in range(3)]
    h = torch.zeros((3, 5, 7))
    for k, g in enumerate(gs):
        mapped = spec.premap(g)
        assert torch.equal(mapped[0], g)
        h = spec.combine((h,), mapped, torch.tensor(k, dtype=torch.int32))[0]
    assert torch.equal(h, (gs[0] + gs[1]) + gs[2])
    out = spec.finalize(0, (h,), torch.tensor(3, dtype=torch.int32))
    assert out.shape == (3, 5, 7) and out.dtype == torch.float32
    assert torch.equal(out, h / 3.0)


@pytest.fixture(scope="module")
def llama_pair():
    jcfg = jget_config("llama3-8b").reduced()
    cfg = get_config("llama3-8b").reduced()
    jm, tm = jget_model(jcfg), get_model(cfg)
    jp = jm.init_params(RNG)
    tp = interop.params_from_repro(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg, jm, jp, tm, tp


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("mode", ["combiner", "materialize"])
def test_accumulation_against_reference(llama_pair, M, mode):
    cfg, jm, jp, tm, tp = llama_pair
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 8)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (4, 8)).astype(
        np.int32)}
    (jl, _), jg = jaccum.accumulate_gradients(
        lambda p, b: jlosses.lm_loss(jm, p, b, mode="materialize"), jp,
        batch, num_microbatches=M, mode=mode,
        spec=jaccum.derive_grad_combiner().spec)
    (tl, taux), tg = grad_accum.accumulate_gradients(
        lambda p, b: losses.lm_loss(tm, p, b, mode="materialize"), tp,
        {k: _t(v) for k, v in batch.items()}, num_microbatches=M, mode=mode)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(taux) == {"xent", "load_balance_loss"}
    jleaves, tleaves = _np_leaves(jg), _t_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    for p in flatten(tp)[0]:  # no .grad state is left behind
        assert p.grad is None and not p.requires_grad


def test_accumulation_flows_agree(llama_pair):
    """The reference test's own check, on the port: combiner ==
    materialize == the single-batch gradient."""
    cfg, _, _, tm, tp = llama_pair
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}

    def loss_fn(p, b):
        return losses.lm_loss(tm, p, b, mode="materialize")

    (l0, _), g0 = grad_accum.accumulate_gradients(loss_fn, tp, batch)
    (l1, _), g1 = grad_accum.accumulate_gradients(
        loss_fn, tp, batch, num_microbatches=4, mode="combiner")
    (l2, _), g2 = grad_accum.accumulate_gradients(
        loss_fn, tp, batch, num_microbatches=4, mode="materialize")
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(_t_leaves(g1), _t_leaves(g2)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(_t_leaves(g0), _t_leaves(g1)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_combiner_folds_in_microbatch_order(llama_pair, monkeypatch):
    """The holder adds microbatch k's gradient at fold k, through the
    derived spec's ``combine``, as the reference's scan does."""
    cfg, _, _, tm, tp = llama_pair
    seen = []
    spec = grad_accum.derive_grad_combiner().spec
    wrapped = dataclasses.replace(
        spec, combine=lambda h, m, n: (seen.append(int(n)),
                                       spec.combine(h, m, n))[1])
    batch = {k: torch.zeros((4, 8), dtype=torch.int32)
             for k in ("tokens", "labels")}
    grad_accum.accumulate_gradients(
        lambda p, b: losses.lm_loss(tm, p, b), tp, batch,
        num_microbatches=4, mode="combiner", spec=wrapped)
    n_leaves = len(flatten(tp)[0])
    assert seen == [k for k in range(4) for _ in range(n_leaves)]


# ---------------------------------------------------------------------------
# AdamW, the schedule, compression
# ---------------------------------------------------------------------------


def test_adamw_moves_params_and_clips():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = optim.init_opt_state(params)
    before = st["master"]["w"].clone()
    grads = {"w": torch.full((4, 4), 100.0)}  # should clip
    cfgd = optim.AdamWConfig(lr=1e-2, grad_clip=1.0)
    st2, stats = optim.adamw_update(cfgd, grads, st)
    assert float(stats["grad_norm"]) > 1.0
    assert not torch.allclose(st2["master"]["w"], before)
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32
    assert st2["step"].shape == ()

    jst = joptim.init_opt_state({"w": jnp.ones((4, 4), jnp.bfloat16)})
    jst2, jstats = joptim.adamw_update(
        cfgd, {"w": jnp.full((4, 4), 100.0, jnp.float32)}, jst)
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(st2["master"]["w"].numpy(),
                               np.asarray(jst2["master"]["w"]), atol=1e-6)


def test_adamw_updates_in_place_and_matches_reference_over_steps():
    """m, v and master are written in place (the state passed in is
    consumed), and three updates with clipping and a schedule track the
    reference's leaves; the leaves are visited in JAX's order."""
    rng = np.random.default_rng(7)
    shapes = {"b": (5,), "a": {"z": (3, 4), "y": (2,)}}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return rng.standard_normal(tree).astype(np.float32)

    p0 = draw(shapes)
    jst = joptim.init_opt_state(jax.tree.map(jnp.asarray, p0))
    st = optim.init_opt_state(optim.tree_map(_t, p0))
    cfgd = optim.AdamWConfig(lr=1e-2, grad_clip=0.5)
    for step in range(3):
        g = draw(shapes)
        ids = [id(x) for k in ("m", "master", "v")
               for x in flatten(st[k])[0]]
        lr_scale = optim.cosine_schedule(st["step"], warmup=1, total=10)
        st, stats = optim.adamw_update(cfgd, optim.tree_map(_t, g), st,
                                       lr_scale)
        assert [id(x) for k in ("m", "master", "v")
                for x in flatten(st[k])[0]] == ids
        jst, jstats = joptim.adamw_update(
            cfgd, jax.tree.map(jnp.asarray, g), jst,
            joptim.cosine_schedule(jnp.int32(step), warmup=1, total=10))
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        for name in ("master", "m", "v"):
            for a, b in zip(_t_leaves(st[name]), _np_leaves(jst[name])):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_global_norm_adds_in_jax_leaf_order():
    """Insertion order ``{"b", "a"}`` must not change the order of the
    adds: JAX flattens dicts by sorted key."""
    big, small = np.float32(1e8), np.float32(3.0)
    tree = {"b": torch.tensor([small]), "a": torch.tensor([big]),
            "c": torch.tensor([-big])}
    want = np.sqrt((np.float32(big * big) + np.float32(small * small))
                   + np.float32(big * big))
    assert float(optim.global_norm(tree)) == float(want)
    jtree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    assert float(optim.global_norm(tree)) == float(joptim.global_norm(jtree))


def test_model_params_are_fresh_tensors():
    st = optim.init_opt_state({"w": torch.ones(3)})
    for dtype in (torch.float32, torch.bfloat16):
        p = optim.model_params(st, dtype)
        assert p["w"].dtype == dtype
        assert p["w"].data_ptr() != st["master"]["w"].data_ptr()


def test_cosine_schedule():
    for step, kw in [(0, {}), (10, {}), (100, dict(min_frac=0.1)), (55, {}),
                     (3, {}), (1000, {})]:
        got = float(optim.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                          warmup=10, total=100, **kw))
        want = float(joptim.cosine_schedule(jnp.int32(step), warmup=10,
                                            total=100, **kw))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), step
    assert float(optim.cosine_schedule(torch.tensor(0), warmup=10,
                                       total=100)) == 0.0
    assert abs(float(optim.cosine_schedule(torch.tensor(10), warmup=10,
                                           total=100)) - 1.0) < 1e-6
    assert abs(float(optim.cosine_schedule(torch.tensor(100), warmup=10,
                                           total=100, min_frac=0.1))
               - 0.1) < 1e-6


def test_grad_compression_fake_quant_and_error_feedback():
    x = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32)
    g = {"w": _t(x)}
    got = compression.fake_quant_int8(g["w"])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcomp.fake_quant_int8(x)))
    err = np.abs(got.numpy() - x)
    assert err.max() <= np.abs(x).max() / 127 + 1e-6
    res = compression.ErrorFeedback.init(g)
    comp, res = compression.ErrorFeedback.apply(g, res)
    np.testing.assert_allclose((comp["w"] + res["w"]).numpy(), x, rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

#: (arch, seq, TrainConfig overrides): gemma2 at S = 64 so that its reduced
#: 32-token window bites
STEP_CASES = {
    "llama3-8b": ("llama3-8b", 16, {}),
    "llama3-8b-materialize": ("llama3-8b", 16, {"accum_mode": "materialize"}),
    "llama3-8b-int8": ("llama3-8b", 16, {"grad_compression": "int8"}),
    "gemma2-27b": ("gemma2-27b", 64, {}),
    "gemma2-27b-xent-materialize": ("gemma2-27b", 64,
                                    {"loss_mode": "materialize"}),
    "qwen2.5-14b": ("qwen2.5-14b", 16, {}),
    "qwen1.5-32b": ("qwen1.5-32b", 16, {}),
}
STEPS = 3


def _tc(over):
    return dict(num_microbatches=2, vocab_chunk=48, warmup_steps=1,
                total_steps=50, **over)


def _batches(cfg, seq):
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                             global_batch=4)
    return [pipeline.global_batch(dc, i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def reference_runs():
    """Each case's reference run, once: its initial state (numpy), and per
    step the loss, grad_norm and master leaves."""
    out = {}
    for name, (arch, seq, over) in STEP_CASES.items():
        cfg = jget_config(arch).reduced()
        model = jget_model(cfg)
        step = jax.jit(jtrain.make_train_step(
            model, jtrain.TrainConfig(**_tc(over))))
        state = jtrain.init_train_state(model, RNG)
        init = jax.tree.map(np.asarray, state)
        rows = []
        for b in _batches(cfg, seq):
            state, m = step(state, b)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         _np_leaves(state["master"]), int(state["step"])))
        out[name] = (init, rows)
    return out


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_against_reference(reference_runs, case):
    arch, seq, over = STEP_CASES[case]
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    init, rows = reference_runs[case]
    state = interop.train_state_from_repro(cfg, init, device="cpu")
    step = train_step.make_train_step(model, train_step.TrainConfig(
        **_tc(over)))
    for b, (jloss, jgn, jmaster, jstep) in zip(_batches(cfg, seq), rows):
        state, m = step(state, b)
        assert set(m) == {"loss", "xent", "load_balance_loss", "grad_norm",
                          "lr"}
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), jgn, rtol=1e-4)
        assert int(state["step"]) == jstep
        assert state["step"].dtype == torch.int32
        got = _t_leaves(state["master"])
        assert len(got) == len(jmaster)
        for a, w in zip(got, jmaster):
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_decreases_loss(arch):
    """The reference's ``tests/models/test_arch_smoke.py`` case for the
    dense archs, on the port."""
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    tc = train_step.TrainConfig(num_microbatches=2, vocab_chunk=64,
                                warmup_steps=1, total_steps=50)
    step = train_step.make_train_step(model, tc)
    state = train_step.init_train_state(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
             for k in ("tokens", "labels")}
    out = []
    for _ in range(4):
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    assert np.isfinite(out).all()
    assert out[-1] < out[0]


def test_a_train_step_leaves_no_tensor_in_a_reference_cycle():
    """With the garbage collector off, a step frees everything it made
    (gradients, holder, bf16 parameters): on the card a tensor kept by a
    reference cycle holds device memory until a collection runs.  The
    tree walkers (``ckpt.flatten`` / ``unflatten``) free their leaves."""
    t = torch.zeros(3)
    ref = weakref.ref(t)
    cfg = get_config("llama3-8b").reduced()
    model = get_model(cfg)
    tc = train_step.TrainConfig(num_microbatches=2, vocab_chunk=64,
                                warmup_steps=1, total_steps=50)
    batch = pipeline.global_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4), 0)
    gc.collect()
    gc.disable()
    try:
        leaves, _ = flatten({"a": t, "b": [None, (t,)]})
        unflatten({"a": 0, "b": [None, (0,)]}, leaves)
        del t, leaves
        assert ref() is None
        for mode in ("combiner", "materialize"):
            step = train_step.make_train_step(
                model, dataclasses.replace(tc, accum_mode=mode))
            state = train_step.init_train_state(
                model, torch.Generator().manual_seed(0))
            state, m = step(state, batch)  # warm: derivations, imports
            gc.collect()
            live = sum(issubclass(type(o), torch.Tensor)
                       for o in gc.get_objects())
            for _ in range(2):
                state, m = step(state, batch)
            now = sum(issubclass(type(o), torch.Tensor)
                       for o in gc.get_objects())
            assert now == live, (mode, live, now)
            del state, m
    finally:
        gc.enable()


def test_remat_gives_the_same_values_and_gradients():
    cfg = get_config("gemma2-27b").reduced()
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    outs = []
    for remat in (True, False):
        leaves, _ = flatten(params)
        fresh = [p.detach().requires_grad_(True) for p in leaves]
        h, _ = model.forward(unflatten(params, fresh), {"tokens": toks},
                             remat=remat)
        grads = torch.autograd.grad(h.square().mean(), fresh)
        outs.append((h.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Data pipeline and configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1)])
def test_data_pipeline_bit_for_bit(seed, step):
    dc = pipeline.DataConfig(seed=seed, vocab_size=1000, seq_len=33,
                             global_batch=8, zipf_a=1.3)
    jdc = jpipe.DataConfig(seed=seed, vocab_size=1000, seq_len=33,
                           global_batch=8, zipf_a=1.3)
    got, want = pipeline.global_batch(dc, step), jpipe.global_batch(jdc, step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    for host in range(4):
        hb, jhb = (pipeline.host_batch(dc, step, host, 4),
                   jpipe.host_batch(jdc, step, host, 4))
        for k in jhb:
            np.testing.assert_array_equal(hb[k], jhb[k])
    text = "The quick brown fox jumps over the lazy dog THE end"
    np.testing.assert_array_equal(pipeline.tokenize_words(text, 97),
                                  jpipe.tokenize_words(text, 97))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_are_the_reference(arch):
    j, t = jget_config(arch), get_config(arch)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
