"""The SSM family (``models/ssm.py``, ``models/mamba.py``) against the
reference on the CPU.

mamba2-2.7b at ``reduced()`` (2 layers, d_model 64, 8 heads of 16, state
16, chunk 8, f32), the reference's parameters carried across by
``interop.params_from_repro``, inputs drawn with numpy from a seed.
Tolerances as the dense family's: the SSD layer, hidden states and
gradients' inputs within rtol = atol = 1e-5 (another order of the same f32
operations: the inter-chunk combine runs in order where the reference's
``associative_scan`` runs a tree, ROADMAP C.64), gradients within rtol
1e-4, atol 1e-5, logits within 1e-4, greedy tokens equal, three train
steps within rtol 1e-4 (loss, grad_norm) and atol 1e-5 (master
parameters).  Prefill against stepwise decode within 2e-2, the reference's
own test's tolerance.  In bf16 the two packages round the same operations
in other places (XLA fuses elementwise chains in f32), so each is held
against the reference's f32 logits on the same weights: the port's error
within twice the reference's own (plus 2^-7), the two within 2^-4 of each
other (rms, relative).  ROADMAP C.63: at
the published chunk of 256 the reference's gradients are not finite, the
port's are.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serving import serve_step as jserve  # noqa: E402
from repro.training import losses as jlosses  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten, unflatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.registry import get_model, param_count  # noqa: E402
from repro_torch.serving import serve_step as tserve  # noqa: E402
from repro_torch.training import losses, train_step  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "mamba2-2.7b"
RNG = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
#: the forward at the published chunk (C.63): the within-chunk cumsum of
#: dt * A reaches ~218 there, where XLA's cumsum, which adds in another
#: order, is up to 3e-5 (two ulp) from torch's, and exp(cs_i - cs_j)
#: carries that as a relative error of the weights
CHUNK256_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16: each package's logits against the f32 reference's rounds its own
#: way (reduced width: 0.6-4.3 % rms); the port's error within twice the
#: reference's (plus 2^-7), the two packages within 2^-4 of each other
BF16_ERR_RATIO, BF16_ERR_FLOOR, BF16_RMS_TOL = 2.0, 2.0 ** -7, 2.0 ** -4


def _t(x):
    return torch.from_numpy(np.array(x))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs(**over):
    tover = {k: v for k, v in over.items() if k != "dtype"}
    return (jget_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**tover))


def _layer(jcfg, seed=0):
    """One SSM layer's parameters drawn by the reference, and the port's
    copy."""
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    return jp, pytree.tree_map(_t, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jp = jm.init_params(RNG)
    tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jm, jp, tm, tp


def _grads_close(got, want):
    """GRAD_TOL with atol taken relative to the leaf's largest gradient:
    sum(y^2) over a batch gives gradients of tens, where the f32 order of
    the sums moves an element near zero by more than 1e-5."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=GRAD_TOL["rtol"],
        atol=GRAD_TOL["atol"] * max(1.0, float(np.abs(want).max())))


def _rms_rel(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _tokens(cfg, seed, b=2, s=16):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------


def test_config_is_the_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    for prop in ("ssm_d_inner", "ssm_heads", "attention_free",
                 "sub_quadratic"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert (t.family, t.ssm_d_inner, t.ssm_heads, t.ssm_chunk) == (
        "ssm", 5120, 80, 256)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_parameters_are_the_reference_pytree(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg, tcfg = _cfgs(dtype=jdt)
    tcfg = dataclasses.replace(tcfg, dtype=tdt)
    jp = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                      jget_model(jcfg).abstract_params())
    tp = get_model(tcfg).init_params(torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree.flatten_with_path(jp)[0]}
    got = {jax.tree_util.keystr(p): (tuple(x.shape),
                                     str(x.dtype).replace("torch.", ""))
           for p, x in jax.tree.flatten_with_path(tp)[0]}
    assert got == want
    carried = interop.params_from_repro(tcfg, jp, device="cpu")
    assert param_count(carried) == sum(x.size for x in jax.tree.leaves(jp))
    with pytest.raises(ValueError, match="layers"):
        interop.params_from_repro(dataclasses.replace(tcfg, num_layers=3),
                                  jp, device="cpu")
    with pytest.raises(ValueError, match="'ffn' expected"):
        interop.params_from_repro(get_config("llama3-8b").reduced(), jp,
                                  device="cpu")


# ---------------------------------------------------------------------------
# The SSD layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,S", [(8, 16), (8, 12), (8, 7), (8, 3),
                                     (256, 2048), (256, 2049), (256, 1),
                                     (256, 4096), (6, 35)])
def test_chunk_len_is_the_reference_rule(chunk, S):
    assert tssm._chunk_len(chunk, S) == jssm._chunk_len(chunk, S)
    assert tssm._chunk_len(256, 2049) == 3  # the small chunks of C.65


@pytest.mark.parametrize("S", [16, 12, 5, 2, 1])
def test_ssm_forward_and_states(S):
    """The layer's output, the final SSM state and the conv state (the last
    W-1 raw rows, left-padded where S < W-1) as the reference's."""
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(jcfg)
    x = _x(S, 2, S, tcfg.d_model)
    jy, jst = jssm.ssm_forward(jcfg, jp, jnp.asarray(x), return_state=True)
    ty, tst = tssm.ssm_forward(tcfg, tp, _t(x), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("conv", "ssm"):
        assert tuple(tst[name].shape) == jst[name].shape
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   **TOL, err_msg=name)
    if S < tcfg.ssm_conv - 1:
        assert not tst["conv"][:, :tcfg.ssm_conv - 1 - S].any()
    np.testing.assert_allclose(tssm.ssm_train(tcfg, tp, _t(x)).numpy(),
                               np.asarray(jy), **TOL)


def test_ssm_decode_from_a_random_state():
    """Three chained decode steps from a random state: output and both
    states as the reference's; the state passed in is left unchanged."""
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(jcfg, 1)
    d_in, N = tcfg.ssm_d_inner, tcfg.ssm_state
    jst = {"conv": jnp.asarray(_x(2, 2, 3, d_in + 2 * N)),
           "ssm": jnp.asarray(_x(3, 2, tcfg.ssm_heads, N,
                                 tcfg.ssm_head_dim))}
    tst = {k: _t(v) for k, v in jst.items()}
    before = {k: v.clone() for k, v in tst.items()}
    for step in range(3):
        x = _x(10 + step, 2, 1, tcfg.d_model)
        jy, jst = jssm.ssm_decode(jcfg, jp, jnp.asarray(x), jst)
        ty, new = tssm.ssm_decode(tcfg, tp, _t(x), tst)
        if step == 0:
            for k in before:
                assert torch.equal(tst[k], before[k])
        tst = new
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       **TOL, err_msg=k)


def test_ssm_decode_into_writes_the_layer_state_in_place():
    jcfg, tcfg = _cfgs()
    _, tp = _layer(jcfg, 2)
    st = tssm.init_ssm_state(tcfg, 2, 3)
    st["ssm"].copy_(_t(_x(4, *st["ssm"].shape)))
    x = _t(_x(5, 2, 1, tcfg.d_model))
    want, new = tssm.ssm_decode(tcfg, tp, x, {"conv": st["conv"][1].clone(),
                                              "ssm": st["ssm"][1].clone()})
    got = tssm.ssm_decode_into(tcfg, tp, x, st["conv"][1], st["ssm"][1])
    assert torch.equal(got, want)
    assert torch.equal(st["ssm"][1], new["ssm"])
    assert torch.equal(st["conv"][1], new["conv"])


@pytest.mark.parametrize("S", [16, 24])
def test_ssm_gradients_against_jax_grad(S):
    """d(sum y^2) with respect to the input and every parameter, at the
    reduced chunk (where the reference's gradients are finite)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(jcfg, 3)
    x = _x(6, 2, S, tcfg.d_model)
    jgx, jgp = jax.grad(
        lambda x, p: jnp.sum(jssm.ssm_train(jcfg, p, x) ** 2),
        argnums=(0, 1))(jnp.asarray(x), jp)
    leaves, _ = flatten(tp)
    fresh = [t.clone().requires_grad_(True) for t in leaves]
    xt = _t(x).requires_grad_(True)
    y = tssm.ssm_train(tcfg, unflatten(tp, fresh), xt)
    grads = torch.autograd.grad((y ** 2).sum(), [xt] + fresh)
    for g, w in zip(grads, [jgx] + jax.tree.leaves(jgp)):
        _grads_close(g, w)


def test_c63_published_chunk_gradients_are_finite():
    """ROADMAP C.63: at ssm_chunk = 256, one sequence of 256 tokens, loss
    sum(y^2): the reference's forward is finite and its gradients of
    A_log, dt_bias and in_proj are not (exp of the unmasked exponent
    overflows before the mask); the port's forward equals the reference's
    within CHUNK256_TOL and every gradient is finite."""
    jcfg, tcfg = (jget_config(ARCH).reduced(ssm_chunk=256),
                  get_config(ARCH).reduced(ssm_chunk=256))
    jp, tp = _layer(jcfg, 0)
    x = _x(7, 1, 256, tcfg.d_model)
    jy = jssm.ssm_train(jcfg, jp, jnp.asarray(x))
    jg = jax.grad(lambda p: jnp.sum(jssm.ssm_train(jcfg, p, jnp.asarray(x))
                                    ** 2))(jp)
    assert np.isfinite(np.asarray(jy)).all()
    bad = sorted(k for k in ("A_log", "dt_bias", "in_proj")
                 if not np.isfinite(np.asarray(jg[k])).all())
    assert bad == ["A_log", "dt_bias", "in_proj"], bad

    leaves, _ = flatten(tp)
    fresh = [t.clone().requires_grad_(True) for t in leaves]
    y = tssm.ssm_train(tcfg, unflatten(tp, fresh), _t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **CHUNK256_TOL)
    grads = torch.autograd.grad((y ** 2).sum(), fresh)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_c63_masked_exponent_keeps_every_entry():
    """Masking the exponent before the exp gives the entries of the
    reference's form (exp, then mask) bit for bit on the same cumsum, where
    the exponents of the masked entries overflow."""
    cs = -torch.cumsum(torch.rand((1, 1, 256, 4),
                                  generator=torch.Generator().manual_seed(1))
                       * 2, dim=2)
    d = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    tri = torch.tril(torch.ones((256, 256), dtype=torch.bool))[
        None, None, :, :, None]
    assert not bool(torch.isfinite(torch.exp(d)).all())
    masked = torch.exp(torch.where(tri, d, -torch.inf))
    assert torch.equal(masked, torch.where(tri, torch.exp(d), 0.0))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_forward_and_logits(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, 0)
    jh, _ = jm.forward(jp, {"tokens": toks})
    th, taux = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tm.logits_of_hidden(tp, th).numpy(),
                               np.asarray(jm.logits_of_hidden(jp, jh)),
                               **LOGIT_TOL)
    assert taux == {"load_balance_loss": 0.0}
    assert tm.unembed_matrix(tp) is tp["embed"]["table"]  # tied


@pytest.mark.parametrize("S", [16, 13])
def test_prefill_and_decode_logits(pair, S):
    """Prefill (S = 13 takes 13 chunks of one token: no divisor of 13 up to
    the chunk but 1) and four decode steps: logits and every state entry
    as the reference's."""
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, 1, s=S)
    jst, tst = jm.init_decode_state(2, 32), tm.init_decode_state(
        2, 32, device="cpu")
    jl, jst = jm.prefill(jp, {"tokens": toks}, jst)
    tl, tst = tm.prefill(tp, {"tokens": _t(toks)}, tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tst["pos"] == int(jst["pos"]) == S
    step = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(4):
        jl, jst = step(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, _t(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tst["pos"] == S + 4
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tst["ssm"][name].numpy(),
                                   np.asarray(jst["ssm"][name]), **LOGIT_TOL)
    back = interop.decode_state_from_repro(jax.tree.map(np.asarray, jst),
                                           device="cpu")
    assert back["pos"] == S + 4 and back["ssm"]["ssm"].dtype == torch.float32


def test_generate_greedy_tokens_equal_the_reference(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, 2, b=3, s=10)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(toks), max_new=8))
    got = tserve.generate(tm, tp, _t(toks), max_new=8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S", [12, 16])
def test_prefill_matches_stepwise(S):
    """The reference's test_prefill_consistency on the port: chunked
    prefill against S single-token decode steps, and one step after each
    (softmax within 2e-2)."""
    _, tcfg = _cfgs()
    model = get_model(tcfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    prompt = _t(_tokens(tcfg, 3, s=S))
    lga, sta = model.prefill(params, {"tokens": prompt},
                             model.init_decode_state(2, 32, device="cpu"))
    tok = torch.argmax(lga, -1).to(torch.int32)
    lga2, _ = model.decode_step(params, sta, tok)
    stb = model.init_decode_state(2, 32, device="cpu")
    for t in range(S):
        lgb, stb = model.decode_step(params, stb, prompt[:, t])
    lgb2, _ = model.decode_step(params, stb, tok)
    for a, b in ((lga, lgb), (lga2, lgb2)):
        err = (torch.softmax(a, -1) - torch.softmax(b, -1)).abs().max()
        assert float(err) < 2e-2


def test_lm_loss(pair):
    jm, jp, tm, tp = pair
    b = jpipe.global_batch(jpipe.DataConfig(vocab_size=tm.cfg.vocab_size,
                                            seq_len=16, global_batch=2), 0)
    for mode in ("chunked", "materialize"):
        jl, _ = jlosses.lm_loss(jm, jp, b, mode=mode, vocab_chunk=48)
        tl, taux = losses.lm_loss(tm, tp, {k: _t(v) for k, v in b.items()},
                                  mode=mode, vocab_chunk=48)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=mode)


def test_train_steps_against_reference():
    """Three steps, M = 2, from the reference's state, against
    ``repro.training``; S = 16 (two chunks)."""
    jcfg, tcfg = _cfgs()
    jm, tm = jget_model(jcfg), get_model(tcfg)
    tc = dict(num_microbatches=2, vocab_chunk=48, warmup_steps=1,
              total_steps=50)
    jstep = jax.jit(jtrain.make_train_step(jm, jtrain.TrainConfig(**tc)))
    jstate = jtrain.init_train_state(jm, RNG)
    state = interop.train_state_from_repro(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    step = train_step.make_train_step(tm, train_step.TrainConfig(**tc))
    batch_fn = tlaunch.make_batch_fn(tcfg, pipeline.DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4))
    for i in range(3):
        b = batch_fn(i)
        jstate, jm_ = jstep(jstate, b)
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-4)
        for a, w in zip(flatten(state["master"])[0],
                        jax.tree.leaves(jstate["master"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)


def test_remat_gives_the_same_values_and_gradients(pair):
    _, _, tm, tp = pair
    toks = _t(_tokens(tm.cfg, 4))
    out = []
    for remat in (True, False):
        leaves, _ = flatten(tp)
        fresh = [t.clone().requires_grad_(True) for t in leaves]
        h, _ = tm.forward(unflatten(tp, fresh), {"tokens": toks},
                          remat=remat)
        out.append((h.detach(), torch.autograd.grad(h.pow(2).sum(), fresh)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_bf16_within_the_stated_tolerance():
    """bf16 parameters (the reference's, carried) and activations, the
    reference's greedy tokens fed to both: at prefill and four decode
    steps each package's logits against the reference's f32 logits on the
    same weights widened to f32; the port's error (rms relative) within
    BF16_ERR_RATIO times the reference's own plus BF16_ERR_FLOOR, and the
    two packages within BF16_RMS_TOL of each other."""
    jcfg, tcfg = _cfgs(dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jm32 = jget_model(dataclasses.replace(jcfg, dtype=jnp.float32))
    jp = jm.init_params(RNG)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = _tokens(tcfg, 5)
    jl, jst = jm.prefill(jp, {"tokens": toks}, jm.init_decode_state(2, 24))
    fl, fst = jm32.prefill(jp32, {"tokens": toks},
                           jm32.init_decode_state(2, 24))
    tl, tst = tm.prefill(tp, {"tokens": _t(toks)},
                         tm.init_decode_state(2, 24, device="cpu"))
    for _ in range(5):
        j, f, t = np.asarray(jl, np.float32), np.asarray(fl), tl.numpy()
        e_ref, e_port = _rms_rel(j, f), _rms_rel(t, f)
        assert e_port <= BF16_ERR_RATIO * e_ref + BF16_ERR_FLOOR, (e_port,
                                                                   e_ref)
        assert _rms_rel(t, j) <= BF16_RMS_TOL
        tok = j.argmax(-1).astype(np.int32)
        jl, jst = jm.decode_step(jp, jst, jnp.asarray(tok))
        fl, fst = jm32.decode_step(jp32, fst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, _t(tok))


def test_launchers_on_the_cpu(capsys):
    tserve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert ARCH in out and "tokens/s" in out
    got = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "3", "--batch", "4", "--seq", "16"])
    assert sorted(got) == [0, 1, 2] and np.isfinite(list(got.values())).all()
