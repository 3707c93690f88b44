"""The serving path — prefill, decode_step and greedy generate — against
the reference (CPU).

llama3-8b reduced (2 layers, d_model 64, f32), with the reference's
parameters carried across by ``interop.params_from_repro``:

* f32: logits within rtol = atol = 1e-4 (the same f32 operations in
  another order, over two layers and a 128-way unembedding; measured
  about 2e-6), greedy tokens equal;
* bf16: logits within atol = 0.125, eight bf16 ulps at the logits'
  magnitude (|logit| < 4, ulp 2^-6).  The packages round to bf16 in other
  places, and under the kernels the decode attention keeps its weights and
  output in f32 where the reference rounds the weights to bf16 (ROADMAP
  C.22); measured about 0.05;
* an int8 cache: within 2e-2, since a K/V element whose f32 value differs
  in the last bit may quantize one step ``max|x| / 127`` apart.

The port's decode writes the token's K/V first (ROADMAP C.21); the
reference defers the write.  The states are compared after each step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serving import serve_step as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving import serve_step as tserve  # noqa: E402

TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=0, atol=0.125),
       "int8": dict(rtol=2e-2, atol=2e-2)}


def _models(dtype="f32", **over):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jcfg = jget_config("llama3-8b").reduced(dtype=jdt, **over)
    tcfg = get_config("llama3-8b").reduced(dtype=tdt, **over)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jm, jp, tm, tp


def _prompt(cfg_vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg_vocab, (b, s)).astype(
        np.int32)


CASES = [("f32", None, False), ("f32", None, True), ("bf16", None, True),
         ("bf16", None, False), ("f32", "int8", True)]


@pytest.mark.parametrize("dtype,kv,use_kernels", CASES)
def test_prefill_and_decode_logits(dtype, kv, use_kernels):
    jm, jp, tm, tp = _models(dtype)
    prompt = _prompt(tm.cfg.vocab_size)
    tol = TOL["int8" if kv else dtype]
    jst = jm.init_decode_state(2, 24, kv_dtype=jnp.int8 if kv else None)
    tst = tm.init_decode_state(2, 24, kv_dtype=torch.int8 if kv else None,
                               device="cpu")
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, jst)
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, tst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert tst["pos"] == int(jst["pos"]) == 12
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(5):
        jl, jst = jm.decode_step(jp, jst, jnp.asarray(tok))
        tl, tst = tm.decode_step(tp, tst, torch.from_numpy(tok),
                                 use_kernels=use_kernels)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tst["pos"] == int(jst["pos"]) == 17
    # the write-first cache equals the reference's deferred column writes
    for name, j in jst["cache"].items():
        j, t = np.asarray(j).astype(np.float32), tst["cache"][name].float()
        if name in ("k", "v") and kv:
            assert np.abs(t.numpy() - j).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy(), j, **tol)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_generate_greedy_tokens_equal_the_reference(kv):
    """f32: the same greedy tokens.  (In bf16 two logits a bf16 ulp apart
    may swap places, so bf16 is held to its logits' tolerance above.)"""
    jm, jp, tm, tp = _models()
    prompt = _prompt(tm.cfg.vocab_size, b=3, s=9, seed=1)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompt), max_new=8,
                                      sc=jserve.ServeConfig(kv_dtype=kv)))
    for use_kernels in (None, True, False):
        got = tserve.generate(tm, tp, torch.from_numpy(prompt), max_new=8,
                              sc=tserve.ServeConfig(kv_dtype=kv),
                              use_kernels=use_kernels)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_decode_from_a_reference_state():
    """A reference decode state carried across continues as the
    reference's next step."""
    jm, jp, tm, tp = _models()
    prompt = _prompt(tm.cfg.vocab_size, seed=2)
    jst = jm.init_decode_state(2, 20)
    _, jst = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, jst)
    tst = interop.decode_state_from_repro(jax.tree.map(np.asarray, jst),
                                          device="cpu")
    tok = np.array([3, 77], np.int32)
    jl, _ = jm.decode_step(jp, jst, jnp.asarray(tok))
    tl, _ = tm.decode_step(tp, tst, torch.from_numpy(tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["f32"])


def test_prefill_matches_stepwise():
    """The reference's test_prefill_consistency property for llama3-8b:
    prefill then one step equals token-by-token decode (softmax within
    2e-2, the reference's tolerance)."""
    _, _, tm, _ = _models()
    params = tm.init_params(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(_prompt(tm.cfg.vocab_size, s=12, seed=3))
    st = tm.init_decode_state(2, 32, device="cpu")
    lg_a, st = tm.prefill(params, {"tokens": prompt}, st)
    tok = torch.argmax(lg_a, -1).to(torch.int32)
    lg_a2, _ = tm.decode_step(params, st, tok)
    st_b = tm.init_decode_state(2, 32, device="cpu")
    for t in range(prompt.shape[1]):
        lg_b, st_b = tm.decode_step(params, st_b, prompt[:, t])
    lg_b2, _ = tm.decode_step(params, st_b, tok)
    err1 = (torch.softmax(lg_a, -1) - torch.softmax(lg_b, -1)).abs().max()
    err2 = (torch.softmax(lg_a2, -1) - torch.softmax(lg_b2, -1)).abs().max()
    assert float(err1) < 2e-2 and float(err2) < 2e-2


def test_temperature_sampling_uses_the_generator():
    _, _, tm, tp = _models()
    prompt = torch.from_numpy(_prompt(tm.cfg.vocab_size, seed=4))
    sc = tserve.ServeConfig(temperature=0.8)
    runs = [tserve.generate(tm, tp, prompt, max_new=6, sc=sc,
                            generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tm.cfg.vocab_size


def test_generate_stats():
    _, _, tm, tp = _models()
    prompt = torch.from_numpy(_prompt(tm.cfg.vocab_size, seed=6))
    stats = {}
    out = tserve.generate(tm, tp, prompt, max_new=5, stats=stats)
    assert out.shape == (2, 5)
    assert stats["prefill_ms"] > 0 and stats["decode_steps"] == 4
    assert len(stats["decode_step_ms"]) == 4
    assert 0 < sum(stats["decode_step_ms"]) <= stats["decode_ms"]


def test_serve_cli_on_the_cpu(capsys):
    tlaunch.main(["--reduced", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "5", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "prefill" in out and "tokens/s" in out and "seq1:" in out


def test_serve_cli_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--reduced"])
