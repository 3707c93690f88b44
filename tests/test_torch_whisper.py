"""The audio family (``models/whisper.py``) against the reference on the
CPU.

whisper-medium at ``reduced()`` (2 encoder and 2 decoder layers, d_model
64, 4 heads of 16, dec_len 16, f32), the reference's parameters carried
across by ``interop.params_from_repro``, frames and tokens drawn with
numpy from a seed.  Tolerances as the dense family's: the encoder output
and hidden states within rtol = atol = 1e-5, logits and decode states
within 1e-4, greedy tokens equal, three train steps within rtol 1e-4
(loss, grad_norm) and atol 1e-5 (master parameters); the launcher's
batches bit for bit.  The port's self-attention decode writes at
``pos_c = min(pos, dec_len - 1)`` first and attends over ``pos_c + 1``
positions where the reference defers the write (ROADMAP C.66): the logits
and caches agree after each step, past ``dec_len`` too, with the self- and
cross-attention on ``flash_decode``'s plain version (``use_kernels=True``)
and without it.  bf16 as in ``tests/test_torch_ssm.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
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
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402
from repro_torch.models.registry import get_model, param_count  # noqa: E402
from repro_torch.serving import serve_step as tserve  # noqa: E402
from repro_torch.training import losses, train_step  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "whisper-medium"
RNG = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16, as tests/test_torch_ssm.py states them
BF16_ERR_RATIO, BF16_ERR_FLOOR, BF16_RMS_TOL = 2.0, 2.0 ** -7, 2.0 ** -4
FRAMES = 12


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**over):
    tover = {k: v for k, v in over.items() if k != "dtype"}
    return (jget_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**tover))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jp = jm.init_params(RNG)
    tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jm, jp, tm, tp


def _rms_rel(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _inputs(cfg, seed, b=2, s=10, frames=FRAMES):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32))


def test_config_is_the_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert (t.family, t.enc_layers, t.dec_len, t.norm_eps) == (
        "audio", 24, 448, 1e-5)


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
    with pytest.raises(ValueError, match="decoder layers"):
        interop.params_from_repro(dataclasses.replace(tcfg, num_layers=3),
                                  jp, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        interop.params_from_repro(dataclasses.replace(tcfg, family="audio"),
                                  {"embed": jp["embed"]}, device="cpu")


@pytest.mark.parametrize("S,d", [(12, 64), (1500, 1024), (7, 6)])
def test_sinusoid(S, d):
    """Within atol 1e-4: the two packages' f32 ``10000 ** x`` differ in the
    last bit for 0.8 % of the exponents (one ulp at 10^4 is 1e-3), which
    moves an angle of 1500 rad by up to 1e-4."""
    np.testing.assert_allclose(twhisper._sinusoid(S, d).numpy(),
                               np.asarray(jwhisper._sinusoid(S, d)),
                               rtol=1e-5, atol=1e-4)


def test_encode(pair):
    jm, jp, tm, tp = pair
    _, frames = _inputs(tm.cfg, 0)
    want = jwhisper.encode(jm.cfg, jp, jnp.asarray(frames))
    got = twhisper.encode(tm.cfg, tp, _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_and_logits(pair):
    jm, jp, tm, tp = pair
    toks, frames = _inputs(tm.cfg, 1)
    jh, _ = jm.forward(jp, {"tokens": toks, "frames": frames})
    th, taux = tm.forward(tp, {"tokens": _t(toks), "frames": _t(frames)})
    assert th.shape == (2, 10, 64)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tm.logits_of_hidden(tp, th).numpy(),
                               np.asarray(jm.logits_of_hidden(jp, jh)),
                               **LOGIT_TOL)
    assert taux == {"load_balance_loss": 0.0}


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_attention_with_and_without_cross_kv(cross, use_kernels):
    """``attn_decode`` as whisper calls it (no rotary embedding): the
    self-attention with the write first, and the cross-attention over the
    encoder's K/V (every position valid), plain and on flash_decode's
    plain version, against the reference's."""
    jcfg, tcfg = _cfgs()
    p = jattn.init_attn(jax.random.PRNGKey(3), jcfg, cross=cross)
    tp = pytree.tree_map(_t, jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 9, tcfg.num_kv_heads,
                              tcfg.hd)).astype(np.float32)
    pos = 5
    cache = {"k": kv[0].copy(), "v": kv[1].copy()}
    if cross:
        jout, _ = jattn.attn_decode(
            jcfg, p, jnp.asarray(x), None, jnp.int32(pos), rope=False,
            cross_kv=(jnp.asarray(kv[0]), jnp.asarray(kv[1])))
        tout, _ = tattn.attn_decode(tcfg, tp, _t(x), None, pos, rope=False,
                                    cross_kv=(_t(kv[0]), _t(kv[1])),
                                    use_kernels=use_kernels)
    else:
        jout, _ = jattn.attn_decode(
            jcfg, p, jnp.asarray(x), {k: jnp.asarray(v)
                                      for k, v in cache.items()},
            jnp.int32(pos), rope=False, deferred_write=True)
        tout, _ = tattn.attn_decode(tcfg, tp, _t(x),
                                    {k: _t(v) for k, v in cache.items()},
                                    pos, rope=False, use_kernels=use_kernels)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def _count_flash_decode(monkeypatch):
    from repro_torch.kernels import ops

    calls = []
    real = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("steps", [4, 20])
@pytest.mark.parametrize("kv_heads", [2, 4])
def test_prefill_and_write_first_decode(use_kernels, steps, kv_heads,
                                        monkeypatch):
    """Prefill (encode, cross K/V, the BOS token), then decode steps:
    logits, the self cache and the cross K/V as the reference's after each
    step.  20 steps run past dec_len = 16, where ``pos_c`` clamps and both
    overwrite the last position.  Under ``use_kernels`` every layer's self-
    and cross-attention take ``flash_decode`` (its plain version on the
    CPU), the BOS step's in prefill too.  4 KV heads of 4 is the published
    model's G = 1 (the reduced config's 2 is G = 2)."""
    jcfg, tcfg = _cfgs(num_kv_heads=kv_heads)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jp = jm.init_params(RNG)
    tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    calls = _count_flash_decode(monkeypatch)
    toks, frames = _inputs(tm.cfg, 2, s=1)
    max_len = 1 + steps + 3
    jst, tst = jm.init_decode_state(2, max_len), tm.init_decode_state(
        2, max_len, device="cpu")
    assert sorted(tst) == sorted(jst)
    assert tst["cache"]["k"].shape == jst["cache"]["k"].shape
    jl, jst = jm.prefill(jp, {"tokens": toks, "frames": frames}, jst)
    tl, tst = tm.prefill(tp, {"tokens": _t(toks), "frames": _t(frames)},
                         tst, use_kernels=use_kernels)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tst["cross_k"].shape == jst["cross_k"].shape == (
        2, 2, FRAMES, kv_heads, 16)
    step = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(steps):
        jl, jst = step(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, _t(tok), use_kernels=use_kernels)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for (path, j), t in zip(jax.tree.flatten_with_path(jst)[0],
                                flatten(tst)[0]):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       **LOGIT_TOL,
                                       err_msg=jax.tree_util.keystr(path))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tst["pos"] == int(jst["pos"]) == steps + 1
    layers = tm.cfg.num_layers
    assert len(calls) == (2 * layers * (steps + 1) if use_kernels else 0)


def test_generate_with_frames_equals_the_reference(pair):
    """``generate(extra_batch={"frames": ...})``: greedy tokens equal the
    reference's; frames add no length to the decode state."""
    jm, jp, tm, tp = pair
    toks, frames = _inputs(tm.cfg, 3, b=3, s=4)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(toks), max_new=6,
                                      extra_batch={"frames": frames}))
    sizes = []
    real = tm.init_decode_state

    class Spy:
        def __getattr__(self, name):
            return getattr(tm, name)

        def init_decode_state(self, b, n, **kw):
            sizes.append(n)
            return real(b, n, **kw)

    got = tserve.generate(Spy(), tp, _t(toks), max_new=6,
                          extra_batch={"frames": _t(frames)})
    np.testing.assert_array_equal(got.numpy(), want)
    assert sizes == [4 + 6]


def test_lm_loss(pair):
    jm, jp, tm, tp = pair
    dc = jpipe.DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=20,
                          global_batch=2)
    b = jlaunch.make_batch_fn(jm.cfg, dc)(0)
    for mode in ("chunked", "materialize"):
        jl, _ = jlosses.lm_loss(jm, jp, b, mode=mode, vocab_chunk=48)
        tl, _ = losses.lm_loss(tm, tp, {k: _t(v) for k, v in b.items()},
                               mode=mode, vocab_chunk=48)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=mode)


@pytest.mark.parametrize("step", [0, 4])
@pytest.mark.parametrize("seq", [12, 20])
def test_make_batch_fn_is_the_reference(step, seq):
    """Frames from ``default_rng(step)``, tokens and labels cut to
    dec_len (16 at reduced size: seq 20 is cut, 12 is not)."""
    cfg = get_config(ARCH).reduced()
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                             global_batch=4)
    jdc = jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=4)
    got = tlaunch.make_batch_fn(cfg, dc)(step)
    want = jlaunch.make_batch_fn(jget_config(ARCH).reduced(), jdc)(step)
    assert set(got) == set(want) == {"frames", "tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["tokens"].shape == (4, min(seq, cfg.dec_len))
    assert got["frames"].shape == (4, seq, cfg.d_model)


def test_train_steps_against_reference():
    """Three steps on the launcher's audio batches, M = 2 (the frames split
    with the tokens), against ``repro.training``."""
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
        vocab_size=tcfg.vocab_size, seq_len=20, global_batch=4))
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
    toks, frames = _inputs(tm.cfg, 5)
    batch = {"tokens": _t(toks), "frames": _t(frames)}
    out = []
    for remat in (True, False):
        leaves, _ = flatten(tp)
        fresh = [t.clone().requires_grad_(True) for t in leaves]
        h, _ = tm.forward(unflatten(tp, fresh), batch, remat=remat)
        out.append((h.detach(), torch.autograd.grad(h.pow(2).sum(), fresh)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_bf16_within_the_stated_tolerance():
    """bf16 parameters (the reference's, carried), bf16 frames: prefill and
    four decode steps, each package's logits against the reference's f32
    logits on the same weights widened to f32; the port's error within
    BF16_ERR_RATIO times the reference's own plus BF16_ERR_FLOOR, the two
    within BF16_RMS_TOL of each other; attention on flash_decode's plain
    version."""
    jcfg, tcfg = _cfgs(dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jm32 = jget_model(dataclasses.replace(jcfg, dtype=jnp.float32))
    jp = jm.init_params(RNG)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks, frames = _inputs(tcfg, 6, s=1)
    batch = {"tokens": toks, "frames": frames}
    jl, jst = jm.prefill(jp, batch, jm.init_decode_state(2, 8))
    fl, fst = jm32.prefill(jp32, batch, jm32.init_decode_state(2, 8))
    tl, tst = tm.prefill(tp, {k: _t(v) for k, v in batch.items()},
                         tm.init_decode_state(2, 8, device="cpu"),
                         use_kernels=True)
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
                     "--batch", "2", "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert ARCH in out and "tokens/s" in out
    got = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "3", "--batch", "4", "--seq", "20"])
    assert sorted(got) == [0, 1, 2] and np.isfinite(list(got.values())).all()
