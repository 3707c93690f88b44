"""GQA attention: training (full-sequence) and decode (KV cache) paths.

Counterpart of ``repro/models/attention.py``, in its layouts: q, k and v
are ``[B, S, heads, hd]``, the cache ``[L, B, S, Kv, hd]`` (with int8
caches, per-position-head f32 scales ``[L, B, S, Kv, 1]``).  Options cover
QKV bias (qwen), attention softcaps and sliding windows (gemma2),
cross-attention (whisper's decoder) and int8 caches.  The reference's
``act_sharding`` hints are called where it calls them; they act on a
DTensor with a mesh registered and are identities otherwise (one ``None``
check each: the models compute on plain tensors, ROADMAP C.70).

Two differences on purpose:

* The cache is updated in place (:func:`cache_update`,
  :func:`stacked_cache_write`): the reference's functional
  ``dynamic_update_slice`` becomes a write into the given tensors.  A
  cache passed in is therefore changed.
* Under ``use_kernels``, :func:`attn_decode` sends the attention itself to
  the ``flash_decode`` kernel wherever the kernel computes the same
  function (:func:`takes_flash_decode`): self-attention with the new
  token's K/V already in the cache (no ``deferred_write``), no sliding
  window and no softcap, whose valid length is ``pos + 1``; and
  cross-attention (``cross_kv``, whisper's decoder) with no softcap, over
  all T encoder positions (valid length T for every row: the reference
  attends there with no mask and no window).  An int8 cache is
  dequantized first, as :func:`cache_kv` does.  The kernel keeps the
  softmax weights and its output in f32 where the reference rounds the
  weights to the model dtype before the value product (ROADMAP C.22); in
  f32 models the two agree to rounding.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import act_sharding as acts
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_rope, normal, rope_table

NEG_INF = -1e30


def init_attn(rng: torch.Generator, cfg: ModelConfig, *, cross: bool = False):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = d ** -0.5
    p = {
        "wq": normal(rng, (d, qd), s, cfg.dtype),
        "wk": normal(rng, (d, kvd), s, cfg.dtype),
        "wv": normal(rng, (d, kvd), s, cfg.dtype),
        "wo": normal(rng, (qd, d), qd ** -0.5, cfg.dtype),
    }
    if cfg.qkv_bias and not cross:
        dev = rng.device
        p["bq"] = torch.zeros((qd,), dtype=cfg.dtype, device=dev)
        p["bk"] = torch.zeros((kvd,), dtype=cfg.dtype, device=dev)
        p["bv"] = torch.zeros((kvd,), dtype=cfg.dtype, device=dev)
    return p


def _project_q(cfg, p, x):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(x.shape[:-1] + (cfg.num_heads, cfg.hd))


def _project_kv(cfg, p, x):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    shp = x.shape[:-1] + (cfg.num_kv_heads, cfg.hd)
    return k.reshape(shp), v.reshape(shp)


def _softcap(logits, cap):
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


def _gqa_logits(q, k):
    """q [B,S,H,D], k [B,T,Kv,D] -> [B,Kv,G,S,T] (native GQA 5D layout)."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, H // Kv, D)
    return torch.einsum("bskgd,btkd->bkgst", qg, k)


def _gqa_out(w, v):
    """w [B,Kv,G,S,T], v [B,T,Kv,D] -> [B,S,H,D]."""
    B, Kv, G, S, T = w.shape
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, Kv * G, v.shape[3])


#: sequences longer than this use query-chunked attention automatically
#: (the [B,H,S,S] logits tensor would not fit device memory at 32k+).
CHUNK_THRESHOLD = 8192
QUERY_CHUNK = 1024


def _window_mask(mask, i, j, window, T):
    """``mask & (j > i - w)`` with ``w = window`` (0 means global)."""
    if window is None:
        return mask
    w = window if window > 0 else T
    return mask & (j > i - w)


def _attend(cfg, q, k, v, *, causal, window, q_offset, kv_x_is_none, T):
    """Attention for a (possibly chunked) query block. q [B,Sq,H,D]."""
    Sq = q.shape[1]
    logits = _gqa_logits(q, k).to(torch.float32) * (cfg.hd ** -0.5)
    logits = acts.attn_weights(logits)  # pin batch/head/query sharding
    logits = _softcap(logits, cfg.attn_softcap)
    if causal and kv_x_is_none:
        i = q_offset + torch.arange(Sq, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        mask = _window_mask(j <= i, i, j, window, T)
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    w = acts.attn_weights(w)
    return acts.batch_major(_gqa_out(w, v))


def attn_train(
    cfg: ModelConfig,
    p,
    x,
    *,
    positions=None,
    causal: bool = True,
    window: int | None = None,
    rope: bool = True,
    kv_x=None,  # cross-attention source (whisper decoder)
    query_chunk: int | None = None,
):
    """Full-sequence attention. x [B,S,E] -> [B,S,E].

    Long sequences are processed in query chunks: each chunk folds the full
    KV via softmax, so the [S,S] logits matrix is never materialized.
    ``window`` 0 means global attention, as in the reference."""
    B, S, E = x.shape
    q = _project_q(cfg, p, x)
    src = x if kv_x is None else kv_x
    k, v = _project_kv(cfg, p, src)
    T = k.shape[1]

    if not acts.heads_even(cfg.num_kv_heads):
        # sequence parallelism: uneven head counts (40 over 16) cannot
        # carry the model axis, so the query sequence does
        q = acts.seq_major(q, axis=1)

    if rope and kv_x is None:
        pos = (positions if positions is not None
               else torch.arange(S, device=x.device))
        cos, sin = rope_table(pos, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if query_chunk is None and S > CHUNK_THRESHOLD:
        query_chunk = QUERY_CHUNK

    if query_chunk is None or S <= query_chunk:
        out = _attend(cfg, q, k, v, causal=causal, window=window,
                      q_offset=0, kv_x_is_none=kv_x is None, T=T)
    else:
        if S % query_chunk:
            raise ValueError(f"sequence {S} is no multiple of the query "
                             f"chunk {query_chunk}")
        out = torch.cat([
            _attend(cfg, q[:, off:off + query_chunk], k, v, causal=causal,
                    window=window, q_offset=off, kv_x_is_none=kv_x is None,
                    T=T)
            for off in range(0, S, query_chunk)], dim=1)

    return out.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# KV cache (model dtype, or int8 with per-position-head scales)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  kv_dtype=None, layers: int | None = None, device=None):
    """Stacked-layer cache: [L, B, S, Kv, D] (+ scales when int8)."""
    L = layers if layers is not None else cfg.num_layers
    kv_dtype = kv_dtype or cfg.dtype
    shape = (L, batch, max_len, cfg.num_kv_heads, cfg.hd)
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
    }
    if kv_dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                       device=device)
    return cache


def _quantize(x):
    s = torch.amax(torch.abs(x), dim=-1, keepdim=True).to(
        torch.float32) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127)
    return q.to(torch.int8), s


def _dequant(q, s, dtype):
    return (q.to(torch.float32) * s).to(dtype)


def _write(cache, new, pos, dim):
    """``cache[..., pos:pos + n, ...] = new`` along ``dim``, in place."""
    cache.narrow(dim, pos, new.shape[dim]).copy_(new)


def cache_update(layer_cache, k_new, v_new, pos: int):
    """Write one token's K/V at position ``pos`` into the layer cache, in
    place (quantized for an int8 cache). k_new [B,1,Kv,D].  Returns the
    layer cache."""
    if layer_cache["k"].dtype == torch.int8:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _write(layer_cache[name], new, pos, 1)
        return layer_cache
    _write(layer_cache["k"], k_new.to(layer_cache["k"].dtype), pos, 1)
    _write(layer_cache["v"], v_new.to(layer_cache["v"].dtype), pos, 1)
    return layer_cache


def cache_kv(layer_cache, dtype):
    if layer_cache["k"].dtype == torch.int8:
        return (_dequant(layer_cache["k"], layer_cache["k_scale"], dtype),
                _dequant(layer_cache["v"], layer_cache["v_scale"], dtype))
    return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)


def takes_flash_decode(cfg: ModelConfig, *, window, cross_kv,
                       deferred_write: bool) -> bool:
    """Whether the ``flash_decode`` kernel computes this decode step's
    attention: no softcap, and either cross-attention (every encoder
    position valid; the reference's cross branch takes no window and no
    deferred write) or self-attention with K/V in the cache, valid length
    ``pos + 1`` and no window (0 is global)."""
    if cfg.attn_softcap is not None:
        return False
    return cross_kv is not None or (not deferred_write and not window)


def attn_decode(
    cfg: ModelConfig,
    p,
    x,  # [B, 1, E] current token hidden
    layer_cache,
    pos: int,  # next position index
    *,
    window: int | None = None,
    rope: bool = True,
    cross_kv=None,  # (k, v) precomputed encoder cross KV
    deferred_write: bool = False,
    use_kernels: bool = False,
):
    """One decode step.

    deferred_write=False: write the token's K/V into the cache (in place),
    attend over positions ``<= pos``, return (out, cache).
    deferred_write=True: do NOT touch the cache; attend over the cache's
    first ``pos`` positions PLUS the current token's K/V, and return
    (out, (k_new, v_new)).  ``use_kernels`` sends the attention to the
    ``flash_decode`` kernel where it computes the same function
    (:func:`takes_flash_decode`)."""
    B = x.shape[0]
    q = _project_q(cfg, p, x)  # [B,1,H,D]
    kernel = use_kernels and takes_flash_decode(
        cfg, window=window, cross_kv=cross_kv, deferred_write=deferred_write)

    if cross_kv is None:
        k_new, v_new = _project_kv(cfg, p, x)
        if rope:
            cos, sin = rope_table(
                torch.tensor([pos], device=x.device), cfg.hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k_new = apply_rope(k_new, cos, sin)
        if not deferred_write:
            layer_cache = cache_update(layer_cache, k_new, v_new, pos)
        k, v = cache_kv(layer_cache, x.dtype)
        T = k.shape[1]
        if not kernel:  # the kernel masks by kv_len itself
            j = torch.arange(T, device=x.device)
            valid = j <= pos if not deferred_write else j < pos
            valid = _window_mask(valid, pos, j, window, T)
    else:
        k, v = cross_kv
        T = k.shape[1]
        valid = torch.ones((T,), dtype=torch.bool, device=x.device)

    if kernel:
        from repro_torch.kernels import ops

        kv_len = torch.full((B,), T if cross_kv is not None else pos + 1,
                            dtype=torch.int32, device=x.device)
        out = ops.flash_decode(q.reshape(B, cfg.num_heads, cfg.hd)
                               .contiguous(), k.contiguous(), v.contiguous(),
                               kv_len)
        out = out.to(x.dtype).reshape(B, 1, -1)
        return out @ p["wo"], layer_cache

    logits = _gqa_logits(q, k).to(torch.float32) * (cfg.hd ** -0.5)
    logits = acts.attn_weights(logits)
    logits = _softcap(logits, cfg.attn_softcap)
    logits = torch.where(valid[None, None, None, None, :], logits, NEG_INF)

    if cross_kv is None and deferred_write:
        # current token's logit against its own (in-register) K
        self_logit = _gqa_logits(q, k_new.to(x.dtype)).to(
            torch.float32) * (cfg.hd ** -0.5)
        self_logit = _softcap(self_logit, cfg.attn_softcap)
        logits = torch.cat([logits, self_logit], dim=-1)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        out = (_gqa_out(w[..., :T], v)
               + _gqa_out(w[..., T:], v_new.to(x.dtype)))
        out = out.reshape(B, 1, -1)
        return out @ p["wo"], (k_new, v_new)

    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = _gqa_out(w, v).reshape(B, 1, -1)
    return out @ p["wo"], layer_cache


def cache_fill(cache, i: int, k, v):
    """Write a prompt's K/V ([B, S, Kv, D]) at positions ``[0, S)`` of
    layer ``i`` of a stacked cache, in place (quantized for an int8
    cache), as prefill does."""
    S = k.shape[1]
    if cache["k"].dtype == torch.int8:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            cache[name][i, :, :S] = new
    else:
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)


def stacked_cache_write(cache, k_stack, v_stack, pos: int):
    """Write one token column for ALL layers, in place: k_stack
    [L,B,1,Kv,D].  Returns the cache."""
    if cache["k"].dtype == torch.int8:
        kq, ks = _quantize(k_stack)
        vq, vs = _quantize(v_stack)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _write(cache[name], new, pos, 2)
        return cache
    _write(cache["k"], k_stack.to(cache["k"].dtype), pos, 2)
    _write(cache["v"], v_stack.to(cache["v"].dtype), pos, 2)
    return cache
