"""The VLM family (the transformer's ``patches`` branch) against the
reference on the CPU.

internvl2-26b at ``reduced()`` (2 layers, d_model 64, 4 patches, f32),
the reference's parameters carried across by
``interop.params_from_repro``, patches and prompts drawn with numpy from a
seed.  The patch embeddings (the stub frontend's output) go in front of
the embedded tokens in ``forward`` and ``prefill``; prefill's RoPE table
and cache write cover ``num_patches + S`` positions.  Tolerances as the
dense family's: hidden states within 1e-5, prefill and decode logits
within 1e-4, greedy tokens equal, the loss within rtol 1e-5, three train
steps within rtol 1e-4 (loss, grad_norm) and atol 1e-5 (master
parameters); the launcher's batches bit for bit.
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
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serving import serve_step as jserve  # noqa: E402
from repro.training import losses as jlosses  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving import serve_step as tserve  # noqa: E402
from repro_torch.training import losses, train_step  # noqa: E402

ARCH = "internvl2-26b"
RNG = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jp = jm.init_params(RNG)
    tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jm, jp, tm, tp


def _inputs(cfg, seed, b=2, s=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(
                np.float32))


def test_config_is_the_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert (t.family, t.num_patches, t.reduced().num_patches) == (
        "vlm", 256, 4)


def test_forward_with_patches(pair):
    jm, jp, tm, tp = pair
    toks, patches = _inputs(tm.cfg, 0)
    jh, jaux = jm.forward(jp, {"tokens": toks, "patches": patches})
    th, taux = tm.forward(tp, {"tokens": _t(toks), "patches": _t(patches)})
    assert th.shape == (2, 4 + 10, 64)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tm.logits_of_hidden(tp, th).numpy(),
                               np.asarray(jm.logits_of_hidden(jp, jh)),
                               **TOL)
    assert taux == {"load_balance_loss": 0.0}
    with pytest.raises(KeyError, match="patches"):
        tm.forward(tp, {"tokens": _t(toks)})


def test_prefill_and_decode_with_patches(pair):
    jm, jp, tm, tp = pair
    toks, patches = _inputs(tm.cfg, 1)
    jst, tst = jm.init_decode_state(2, 24), tm.init_decode_state(
        2, 24, device="cpu")
    jl, jst = jm.prefill(jp, {"tokens": toks, "patches": patches}, jst)
    tl, tst = tm.prefill(tp, {"tokens": _t(toks), "patches": _t(patches)},
                         tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tst["pos"] == int(jst["pos"]) == 14
    step = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(4):
        jl, jst = step(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, _t(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tst["pos"] == 18
    for name, j in jst["cache"].items():
        np.testing.assert_allclose(tst["cache"][name].numpy(), np.asarray(j),
                                   **LOGIT_TOL)


def test_generate_with_patches_equals_the_reference(pair):
    """``generate(extra_batch={"patches": ...})``: greedy tokens equal the
    reference's; the decode state holds S + max_new + num_patches."""
    jm, jp, tm, tp = pair
    toks, patches = _inputs(tm.cfg, 2, b=3, s=7)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(toks), max_new=6,
                                      extra_batch={"patches": patches}))
    sizes = []
    real = tm.init_decode_state

    class Spy:
        def __getattr__(self, name):
            return getattr(tm, name)

        def init_decode_state(self, b, n, **kw):
            sizes.append(n)
            return real(b, n, **kw)

    got = tserve.generate(Spy(), tp, _t(toks), max_new=6,
                          extra_batch={"patches": _t(patches)})
    np.testing.assert_array_equal(got.numpy(), want)
    assert sizes == [7 + 6 + tm.cfg.num_patches]


def test_lm_loss_with_patch_labels(pair):
    """-1 labels over the patches drop out; labels of the text alone align
    with the last hidden states; both as the reference."""
    jm, jp, tm, tp = pair
    toks, patches = _inputs(tm.cfg, 3)
    pn = tm.cfg.num_patches
    text = np.random.default_rng(4).integers(
        0, tm.cfg.vocab_size, (2, 10)).astype(np.int32)
    full = np.concatenate([np.full((2, pn), -1, np.int32), text], axis=1)
    for labels in (full, text):
        jb = {"tokens": toks, "patches": patches, "labels": labels}
        tb = {k: _t(v) for k, v in jb.items()}
        for mode in ("chunked", "materialize"):
            jl, _ = jlosses.lm_loss(jm, jp, jb, mode=mode, vocab_chunk=48)
            tl, taux = losses.lm_loss(tm, tp, tb, mode=mode, vocab_chunk=48)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                       err_msg=mode)
            assert float(taux["load_balance_loss"]) == 0.0
    a = losses.lm_loss(tm, tp, {"tokens": _t(toks), "patches": _t(patches),
                                "labels": _t(full)})[0]
    b = losses.lm_loss(tm, tp, {"tokens": _t(toks), "patches": _t(patches),
                                "labels": _t(text)})[0]
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 5])
def test_make_batch_fn_is_the_reference(step):
    cfg = get_config(ARCH).reduced()
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=12,
                             global_batch=4)
    jdc = jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=12,
                           global_batch=4)
    got = tlaunch.make_batch_fn(cfg, dc)(step)
    want = jlaunch.make_batch_fn(jget_config(ARCH).reduced(), jdc)(step)
    assert set(got) == set(want) == {"tokens", "patches", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["labels"].shape == (4, cfg.num_patches + 12)


def test_train_steps_against_reference():
    """Three steps on the launcher's vlm batches (patches, -1 labels over
    them), M = 2, against ``repro.training``."""
    jcfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm, tm = jget_model(jcfg), get_model(tcfg)
    tc = dict(num_microbatches=2, vocab_chunk=48, warmup_steps=1,
              total_steps=50)
    jstep = jax.jit(jtrain.make_train_step(jm, jtrain.TrainConfig(**tc)))
    jstate = jtrain.init_train_state(jm, RNG)
    state = interop.train_state_from_repro(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    step = train_step.make_train_step(tm, train_step.TrainConfig(**tc))
    batch_fn = tlaunch.make_batch_fn(tcfg, pipeline.DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=12, global_batch=4))
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


def test_launchers_on_the_cpu(capsys):
    tserve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "5", "--max-new", "3"])
    out = capsys.readouterr().out
    assert ARCH in out and "tokens/s" in out
    got = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "3", "--batch", "4", "--seq", "8"])
    assert sorted(got) == [0, 1, 2] and np.isfinite(list(got.values())).all()
