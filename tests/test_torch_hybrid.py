"""The hybrid family (``models/hybrid.py``, zamba2) against the reference
on the CPU.

zamba2-1.2b at ``reduced()`` (2 layers in one group of 2, the shared
attention block once, f32) and at ``reduced(num_layers=5)`` (2 groups of
2 and a tail of 1 leftover layer), the reference's parameters carried
across by ``interop.params_from_repro``, inputs drawn with numpy from a
seed.  Tolerances as the dense family's: hidden states within rtol = atol
= 1e-5, logits and decode states within 1e-4, greedy tokens equal, three
train steps within rtol 1e-4 (loss, grad_norm) and atol 1e-5 (master
parameters); prefill against stepwise decode within 2e-2 (the reference's
own test).  The port's decode writes each call site's K/V first and
attends over ``pos + 1`` positions (ROADMAP C.66) where the reference
defers the write: the logits and the caches after each step agree, with
the shared attention on ``flash_decode``'s plain version
(``use_kernels=True``) and without it.  bf16 as in
``tests/test_torch_ssm.py``: the port's error against the reference's f32
logits within twice the reference's bf16 error (plus 2^-7).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
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
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models.registry import get_model, param_count  # noqa: E402
from repro_torch.serving import serve_step as tserve  # noqa: E402
from repro_torch.training import losses, train_step  # noqa: E402

ARCH = "zamba2-1.2b"
RNG = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16: each package's logits against the f32 reference's rounds its own
#: way (reduced width: 0.6-4.3 % rms); the port's error within twice the
#: reference's (plus 2^-7), the two packages within 2^-4 of each other
BF16_ERR_RATIO, BF16_ERR_FLOOR, BF16_RMS_TOL = 2.0, 2.0 ** -7, 2.0 ** -4
#: (label, reduced() overrides): one group and no tail; two groups and a
#: tail of one leftover layer
LAYOUTS = (("group", {}), ("tail", {"num_layers": 5}))


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**over):
    tover = {k: v for k, v in over.items() if k != "dtype"}
    return (jget_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**tover))


_PAIRS = {}


def _pair(label):
    """(reference model, its params, port model, its copy) for a layout."""
    if label not in _PAIRS:
        jcfg, tcfg = _cfgs(**dict(LAYOUTS)[label])
        jm, tm = jget_model(jcfg), get_model(tcfg)
        jp = jm.init_params(RNG)
        tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
        _PAIRS[label] = (jm, jp, tm, tp)
    return _PAIRS[label]


def _rms_rel(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _tokens(cfg, seed, b=2, s=16):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_is_the_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert hybrid._layout(t) == (6, 6, 2)
    assert hybrid._layout(t.reduced(num_layers=5)) == (2, 2, 1)


@pytest.mark.parametrize("label", [lb for lb, _ in LAYOUTS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_parameters_are_the_reference_pytree(label, dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg, tcfg = _cfgs(dtype=jdt, **dict(LAYOUTS)[label])
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
    assert ("tail" in tp) == (label == "tail")
    carried = interop.params_from_repro(tcfg, jp, device="cpu")
    assert param_count(carried) == sum(x.size for x in jax.tree.leaves(jp))
    other = dataclasses.replace(tcfg, num_layers=4 if label == "tail" else 3)
    with pytest.raises(ValueError):
        interop.params_from_repro(other, jp, device="cpu")


@pytest.mark.parametrize("label", [lb for lb, _ in LAYOUTS])
def test_forward_and_logits(label):
    jm, jp, tm, tp = _pair(label)
    toks = _tokens(tm.cfg, 0)
    jh, _ = jm.forward(jp, {"tokens": toks})
    th, taux = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tm.logits_of_hidden(tp, th).numpy(),
                               np.asarray(jm.logits_of_hidden(jp, jh)),
                               **LOGIT_TOL)
    assert taux == {"load_balance_loss": 0.0}


def _count_flash_decode(monkeypatch):
    from repro_torch.kernels import ops

    calls = []
    real = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("label", [lb for lb, _ in LAYOUTS])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_write_first_decode(label, use_kernels, monkeypatch):
    """Prefill, then five decode steps: logits, and every state entry
    (the call sites' caches, the grouped and tail SSM states) as the
    reference's deferred-write decode after each step.  Under
    ``use_kernels`` the shared attention takes ``flash_decode`` (its plain
    version on the CPU) once a call site a step."""
    jm, jp, tm, tp = _pair(label)
    groups = hybrid._layout(tm.cfg)[0]
    calls = _count_flash_decode(monkeypatch)
    toks = _tokens(tm.cfg, 1, s=12)
    jst, tst = jm.init_decode_state(2, 24), tm.init_decode_state(
        2, 24, device="cpu")
    assert sorted(tst) == sorted(jst)
    jl, jst = jm.prefill(jp, {"tokens": toks}, jst)
    tl, tst = tm.prefill(tp, {"tokens": _t(toks)}, tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    step = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(5):
        jl, jst = step(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, _t(tok), use_kernels=use_kernels)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for (path, j), t in zip(jax.tree.flatten_with_path(jst)[0],
                                flatten(tst)[0]):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       **LOGIT_TOL,
                                       err_msg=jax.tree_util.keystr(path))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tst["pos"] == 17
    assert len(calls) == (5 * groups if use_kernels else 0)


def test_generate_greedy_tokens_equal_the_reference():
    jm, jp, tm, tp = _pair("tail")
    toks = _tokens(tm.cfg, 2, b=3, s=10)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(toks), max_new=8))
    got = tserve.generate(tm, tp, _t(toks), max_new=8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("label", [lb for lb, _ in LAYOUTS])
def test_prefill_matches_stepwise(label):
    """The reference's test_prefill_consistency on the port (softmax of the
    last prompt position and of one more step within 2e-2)."""
    _, tcfg = _cfgs(**dict(LAYOUTS)[label])
    model = get_model(tcfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    S = 12
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


def test_lm_loss():
    jm, jp, tm, tp = _pair("tail")
    b = jpipe.global_batch(jpipe.DataConfig(vocab_size=tm.cfg.vocab_size,
                                            seq_len=16, global_batch=2), 0)
    for mode in ("chunked", "materialize"):
        jl, _ = jlosses.lm_loss(jm, jp, b, mode=mode, vocab_chunk=48)
        tl, _ = losses.lm_loss(tm, tp, {k: _t(v) for k, v in b.items()},
                               mode=mode, vocab_chunk=48)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=mode)


@pytest.mark.parametrize("label", [lb for lb, _ in LAYOUTS])
def test_train_steps_against_reference(label):
    """Three steps, M = 2, from the reference's state, against
    ``repro.training`` (the groups, the shared block and the tail)."""
    jcfg, tcfg = _cfgs(**dict(LAYOUTS)[label])
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


def test_remat_gives_the_same_values_and_gradients():
    _, _, tm, tp = _pair("tail")
    toks = _t(_tokens(tm.cfg, 4))
    out = []
    for remat in (True, False):
        leaves, _ = flatten(tp)
        fresh = [t.clone().requires_grad_(True) for t in leaves]
        h, _ = tm.forward(unflatten(tp, fresh), {"tokens": toks},
                          remat=remat)
        out.append((h.detach(), torch.autograd.grad(
            h.pow(2).sum(), fresh, allow_unused=True)))  # the head: unused
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_bf16_within_the_stated_tolerance():
    """bf16 parameters (the reference's, carried) and activations, the
    reference's greedy tokens fed to both: at prefill and four decode
    steps each package's logits against the reference's f32 logits on the
    same weights widened to f32; the port's error (rms relative) within
    BF16_ERR_RATIO times the reference's own plus BF16_ERR_FLOOR, and the
    two packages within BF16_RMS_TOL of each other."""
    jcfg, tcfg = _cfgs(dtype=jnp.bfloat16, num_layers=5)
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
        tl, tst = tm.decode_step(tp, tst, _t(tok), use_kernels=True)


def test_launchers_on_the_cpu(capsys):
    tserve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    out = capsys.readouterr().out
    assert ARCH in out and "tokens/s" in out
    got = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "3", "--batch", "4", "--seq", "16"])
    assert sorted(got) == [0, 1, 2] and np.isfinite(list(got.values())).all()
