"""The port's model layers and attention against the reference's (CPU).

The same numpy inputs and the same parameters (drawn by the reference,
carried across as numpy) go through ``repro.models`` and
``repro_torch.models``.  In f32 the two agree to rounding: rtol = atol =
1e-5 (another order of the same f32 operations).  Decode attention under
``use_kernels`` takes ``ops.flash_decode``'s plain version on the CPU.
With an int8 cache the two packages quantize K/V that differ in the last
f32 bit, and a rounding at .5 may then flip by one step of ``s =
max|x| / 127``, so outputs there agree within 2e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return pytree.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _cfgs(**over):
    """(reference, port) reduced llama3-8b configs with ``over``."""
    jcfg = jget_config("llama3-8b").reduced(**over)
    tover = {k: v for k, v in over.items() if k != "dtype"}
    return jcfg, get_config("llama3-8b").reduced(**tover)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Configs and the registry
# ---------------------------------------------------------------------------


def test_llama3_8b_config_is_the_published_one():
    j, t = jget_config("llama3-8b"), get_config("llama3-8b")
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads, t.hd,
            t.d_ff, t.vocab_size, t.rope_theta) == (
        32, 4096, 32, 8, 128, 14336, 128256, 5e5)
    for prop in ("hd", "q_dim", "kv_dim", "attention_free", "sub_quadratic",
                 "ssm_d_inner", "ssm_heads"):
        assert getattr(t, prop) == getattr(j, prop), prop
    jr, tr = j.reduced(), t.reduced()
    for f in dataclasses.fields(jr):
        if f.name != "dtype":
            assert getattr(tr, f.name) == getattr(jr, f.name), f.name
    assert tr.dtype == torch.float32


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_architecture_resolves_to_the_reference_config(arch):
    """All ten architectures, in the reference's order: the config field for
    field (dtype aside, bf16 in both) and a model of its family."""
    assert ARCHS == jconfigs.ARCHS
    j, t = jget_config(arch), get_config(arch)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    model = get_model(t)
    assert model.module.__name__.rsplit(".", 1)[1] == jget_model(
        j).module.__name__.rsplit(".", 1)[1]


def test_unknown_architecture_and_family_raise_key_error():
    with pytest.raises(KeyError, match="not an architecture"):
        get_config("gpt-2")
    with pytest.raises(KeyError, match="unknown family"):
        get_model(dataclasses.replace(get_config("llama3-8b"),
                                      family="diffusion"))


@pytest.mark.parametrize("over", [{}, {"qkv_bias": True, "num_layers": 3},
                                  {"tie_embeddings": True},
                                  {"post_norms": True}])
def test_parameters_are_the_reference_pytree(over):
    jcfg, tcfg = _cfgs(**over)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tp = get_model(tcfg).init_params(torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree.flatten_with_path(jp)[0]}
    got = {}

    def walk(prefix, node):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(f"{prefix}['{key}']", val)
            else:
                got[f"{prefix}['{key}']"] = (
                    tuple(val.shape), str(val.dtype).replace("torch.", ""))

    walk("", tp)
    assert got == want


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rmsnorm():
    x = _x(0, 3, 5, 64)
    scale = _x(1, 64) * 0.1
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope(theta):
    pos = np.array([0, 1, 7, 300, 2047], np.int32)
    jc, js = jlayers.rope_table(jnp.asarray(pos), 16, theta)
    tc, ts = tlayers.rope_table(torch.from_numpy(pos), 16, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=2e-5)
    x = _x(2, 2, 5, 4, 16)
    want = jlayers.apply_rope(jnp.asarray(x), jc, js)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.array(jc)), torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layernorm(eps):
    """The population variance (``jnp.var``), not torch's default unbiased
    one; a large mean, where the two variances' forms differ most."""
    x = _x(0, 3, 5, 64) * 3.0 + 20.0
    p = {"scale": _x(1, 64) + 1.0, "bias": _x(2, 64) * 0.1}
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), eps)
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    init = tlayers.init_layernorm(64)
    jinit = jlayers.init_layernorm(64)
    for k in jinit:
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_mlp(act):
    """``mlp`` (whisper's feed-forward, tanh GELU as ``jax.nn.gelu``) on
    the reference's parameters, with nonzero biases."""
    p = _np(jlayers.init_mlp(jax.random.PRNGKey(4), 32, 48, jnp.float32))
    p["b1"], p["b2"] = _x(5, 48), _x(6, 32)
    x = _x(7, 2, 7, 32)
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = tlayers.mlp(_t(p), torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tp = tlayers.init_mlp(torch.Generator().manual_seed(0), 32, 48,
                          torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("tie", [False, True])
def test_unembed(tie):
    pe = {"table": _x(8, 40, 32)}
    ph = {} if tie else {"w": _x(9, 40, 32)}
    x = _x(10, 2, 3, 32)
    want = jlayers.unembed(jax.tree.map(jnp.asarray, pe),
                           jax.tree.map(jnp.asarray, ph), jnp.asarray(x),
                           tie=tie)
    got = tlayers.unembed(_t(pe), _t(ph), torch.from_numpy(x), tie=tie)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_swiglu(act):
    p = _np(jlayers.init_swiglu(jax.random.PRNGKey(1), 32, 48, jnp.float32))
    x = _x(3, 2, 7, 32)
    want = jlayers.swiglu(p, jnp.asarray(x), act)
    got = tlayers.swiglu(_t(p), torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed():
    p = _np(jlayers.init_embed(jax.random.PRNGKey(2), 50, 16, jnp.float32))
    toks = np.array([[0, 49, 7], [3, 3, 1]], np.int32)
    got = tlayers.embed(_t(p), torch.from_numpy(toks))
    assert np.array_equal(got.numpy(), np.asarray(jlayers.embed(
        p, jnp.asarray(toks))))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

TRAIN_CASES = [
    ({}, {}),
    ({"qkv_bias": True}, {}),
    ({"attn_softcap": 30.0}, {}),
    ({}, {"window": 5}),
    ({}, {"window": 0}),  # 0 is global
    ({}, {"query_chunk": 4}),
    ({}, {"query_chunk": 4, "window": 3}),
    ({}, {"causal": False}),
    ({}, {"kv": True}),  # cross-attention
]


@pytest.mark.parametrize("over,kw", TRAIN_CASES)
def test_attn_train(over, kw):
    jcfg, tcfg = _cfgs(**over)
    p = _np(jattn.init_attn(jax.random.PRNGKey(3), jcfg))
    if "bq" in p:  # the reference draws zero biases: make them count
        for i, name in enumerate(("bq", "bk", "bv")):
            p[name] = _x(20 + i, *p[name].shape)
    x = _x(4, 2, 12, jcfg.d_model)
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("kv", False):
        src = _x(5, 2, 9, jcfg.d_model)
        jkw = {"kv_x": jnp.asarray(src)}
        tkw = {"kv_x": torch.from_numpy(src)}
    want = jattn.attn_train(jcfg, p, jnp.asarray(x), **jkw)
    got = tattn.attn_train(tcfg, _t(p), torch.from_numpy(x), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _caches(jcfg, tcfg, kv_dtype, pos, seed=6):
    """A reference cache filled below ``pos`` (through the reference's own
    writes, so int8 caches hold its quantization) and the port's copy."""
    B, S = 2, 16
    jc = jattn.init_kv_cache(jcfg, B, S, kv_dtype=kv_dtype, layers=1)
    jc = {k: v[0] for k, v in jc.items()}
    kk = _x(seed, B, pos, jcfg.num_kv_heads, jcfg.hd)
    vv = _x(seed + 1, B, pos, jcfg.num_kv_heads, jcfg.hd)
    for t in range(pos):
        jc = jattn.cache_update(jc, jnp.asarray(kk[:, t:t + 1]),
                                jnp.asarray(vv[:, t:t + 1]), t)
    jc = _np(jc)
    return jc, _t(jc)


DECODE_CASES = [
    ({}, {}, None),
    ({"qkv_bias": True}, {}, None),
    ({}, {"window": 4}, None),
    ({}, {"window": 0}, None),
    ({"attn_softcap": 20.0}, {}, None),
    ({}, {"deferred_write": True}, None),
    ({}, {"deferred_write": True, "window": 3}, None),
    ({}, {"cross": True}, None),
    ({}, {}, "int8"),
    ({}, {"deferred_write": True}, "int8"),
    ({}, {"rope": False}, None),
]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("over,kw,kv", DECODE_CASES)
def test_attn_decode(over, kw, kv, use_kernels):
    jcfg, tcfg = _cfgs(**over)
    p = _np(jattn.init_attn(jax.random.PRNGKey(7), jcfg))
    pos = 9
    jc, tc = _caches(jcfg, tcfg, jnp.int8 if kv else None, pos)
    x = _x(8, 2, 1, jcfg.d_model)
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("cross", False):
        ck, cv = _x(9, 2, 11, 2, 16), _x(10, 2, 11, 2, 16)
        jkw = {"cross_kv": (jnp.asarray(ck), jnp.asarray(cv))}
        tkw = {"cross_kv": (torch.from_numpy(ck), torch.from_numpy(cv))}
    jout, jnew = jattn.attn_decode(jcfg, p, jnp.asarray(x), jc,
                                   jnp.asarray(pos, jnp.int32), **jkw)
    tout, tnew = tattn.attn_decode(tcfg, _t(p), torch.from_numpy(x), tc, pos,
                                   use_kernels=use_kernels, **tkw)
    tol = INT8_TOL if kv else TOL
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **tol)
    for j, t in zip(jax.tree.leaves(jnew), jax.tree.leaves(tnew)):
        j = np.asarray(j)
        if j.dtype == np.int8:  # one quantization step apart at most
            assert np.abs(t.numpy().astype(int) - j).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy(), j, **tol)


def test_takes_flash_decode_only_where_it_computes_the_same_function(
        monkeypatch):
    from repro_torch.kernels import ops

    calls = []
    real = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    p = _t(_np(jattn.init_attn(jax.random.PRNGKey(7), jcfg)))
    x = torch.from_numpy(_x(8, 2, 1, tcfg.d_model))
    for cfg, kw, taken in (
            (tcfg, {}, True), (tcfg, {"window": 0}, True),
            (tcfg, {"window": 4}, False),
            (tcfg, {"deferred_write": True}, False),
            (dataclasses.replace(tcfg, attn_softcap=5.0), {}, False),
            (tcfg, {"cross_kv": (torch.zeros(2, 3, 2, 16),
                                 torch.zeros(2, 3, 2, 16))}, True),
            (tcfg, {"cross_kv": (torch.zeros(2, 3, 2, 16),
                                 torch.zeros(2, 3, 2, 16)), "window": 4},
             True),
            (dataclasses.replace(tcfg, attn_softcap=5.0),
             {"cross_kv": (torch.zeros(2, 3, 2, 16),
                           torch.zeros(2, 3, 2, 16))}, False)):
        calls.clear()
        cache = tattn.init_kv_cache(cfg, 2, 8, layers=1)
        cache = {k: v[0] for k, v in cache.items()}
        tattn.attn_decode(cfg, p, x, cache, 3, use_kernels=True, **kw)
        assert bool(calls) == taken, kw
        calls.clear()
        tattn.attn_decode(cfg, p, x, cache, 3, use_kernels=False, **kw)
        assert not calls


def test_write_first_decode_equals_deferred_write():
    """The port's decode writes the token's K/V first and attends over
    ``pos + 1`` positions; the reference defers the write: same output,
    same cache once the reference's column is written."""
    jcfg, tcfg = _cfgs()
    p = _np(jattn.init_attn(jax.random.PRNGKey(11), jcfg))
    pos = 6
    jc, tc = _caches(jcfg, tcfg, None, pos, seed=12)
    x = _x(13, 2, 1, jcfg.d_model)
    jout, (kn, vn) = jattn.attn_decode(jcfg, p, jnp.asarray(x), jc,
                                       jnp.asarray(pos, jnp.int32),
                                       deferred_write=True)
    jfull = jattn.stacked_cache_write(
        {k: v[None] for k, v in jc.items()}, kn[None], vn[None], pos)
    for use_kernels in (False, True):
        tcache = {k: v.clone() for k, v in tc.items()}
        tout, tnew = tattn.attn_decode(tcfg, _t(p), torch.from_numpy(x),
                                       tcache, pos, use_kernels=use_kernels)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tnew[name].numpy(),
                                       np.asarray(jfull[name][0]), **TOL)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_kv_cache_writes(kv):
    jcfg, tcfg = _cfgs()
    jdt, tdt = (jnp.int8, torch.int8) if kv else (None, None)
    jc = jattn.init_kv_cache(jcfg, 2, 8, kv_dtype=jdt)
    tc = tattn.init_kv_cache(tcfg, 2, 8, kv_dtype=tdt)
    assert {k: (v.shape, str(v.dtype)) for k, v in jc.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        for k, v in tc.items()}
    ks = _x(14, jcfg.num_layers, 2, 1, 2, 16)
    vs = _x(15, jcfg.num_layers, 2, 1, 2, 16)
    jc = jattn.stacked_cache_write(jc, jnp.asarray(ks), jnp.asarray(vs), 3)
    tattn.stacked_cache_write(tc, torch.from_numpy(ks), torch.from_numpy(vs),
                              3)
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    jk, jv = jattn.cache_kv({k: v[0] for k, v in jc.items()}, jnp.float32)
    tk, tv = tattn.cache_kv({k: v[0] for k, v in tc.items()}, torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_layer_windows():
    _, tcfg = _cfgs()
    jcfg = jget_config("llama3-8b")
    for over in ({}, {"sliding_window": 4},
                 {"sliding_window": 4, "local_global_alternate": True}):
        assert ttr._layer_windows(dataclasses.replace(tcfg, **over)) == \
            jtr._layer_windows(dataclasses.replace(jcfg, num_layers=2,
                                                   **over))


@pytest.mark.parametrize("over", [{}, {"sliding_window": 4,
                                       "local_global_alternate": True,
                                       "attn_softcap": 30.0,
                                       "logit_softcap": 20.0,
                                       "post_norms": True,
                                       "qkv_bias": True}])
def test_forward_and_logits(over):
    """The training forward (hidden states) and the unembedding."""
    jcfg, tcfg = _cfgs(**over)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(4))
    tp = interop.params_from_repro(tcfg, _np(jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 10)
                                             ).astype(np.int32)
    jh, _ = jtr.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, remat=False)
    th, aux = ttr.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert aux == {"load_balance_loss": 0.0}
    np.testing.assert_allclose(
        ttr.logits_of_hidden(tcfg, tp, th).numpy(),
        np.asarray(jtr.logits_of_hidden(jcfg, jp, jh)), **TOL)
