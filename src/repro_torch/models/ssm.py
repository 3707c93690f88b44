"""Mamba2 / SSD (state-space duality) blocks: attention-free sequence mixing.

Counterpart of ``repro/models/ssm.py``.  The SSD algorithm is an instance
of the paper's combiner: the sequence is split into chunks, each chunk
computes a local summary state, and the inter-chunk recurrence

    state_c = decay_c * state_{c-1} + S_c

is an associative combine ((d1, s1) o (d2, s2) = (d1 d2, s2 + d2 s1)).
Single SSM group (n_groups = 1); d_inner = expand * E split into H heads
of P dims, state size N per head.  The dtypes are the reference's: the
projections and the prefill's causal conv in the model dtype, the decode's
conv and all SSD math in f32, ``y`` cast back to the model dtype before
the gate.

Two differences on purpose (ROADMAP C.63, C.64):

* The intra-chunk decay masks the exponent before the ``exp``:
  ``exp(where(i >= j, cs_i - cs_j, -inf))``.  The reference takes the
  ``exp`` of every (i, j) and masks after it; for j > i the exponent is
  minus a partial sum of ``dt * A``, which passes f32's range at the
  published chunk of 256, so its forward is finite but ``0 * inf`` puts
  NaN into the gradients of ``A_log``, ``dt_bias`` and ``in_proj``.  The
  forward here is the reference's entry for entry.
* The inter-chunk combine runs in order, one chunk after the other: the
  recurrence itself, O(nc) work, where the reference's
  ``associative_scan`` combines in a tree.  The two add the same terms in
  another order, so they agree to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import init_rmsnorm, normal, rmsnorm


def _dims(cfg: ModelConfig):
    return cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(rng: torch.Generator, cfg: ModelConfig):
    d_in, H, P, N = _dims(cfg)
    E = cfg.d_model
    conv_ch = d_in + 2 * N  # conv over (x, B, C)
    dev = rng.device
    proj_out = 2 * d_in + 2 * N + H  # z, x, B, C, dt
    return {
        "in_proj": normal(rng, (E, proj_out), E ** -0.5, cfg.dtype),
        "conv_w": normal(rng, (cfg.ssm_conv, conv_ch), cfg.ssm_conv ** -0.5,
                         cfg.dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=cfg.dtype, device=dev),
        # A = -exp(A_log) = -1
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(d_in, dev),
        "out_proj": normal(rng, (d_in, E), d_in ** -0.5, cfg.dtype),
    }


def _split_proj(cfg, proj):
    """(z, x, B, C, dt) of the input projection (``torch.split`` takes
    sizes where ``jnp.split`` takes indices)."""
    d_in, H, P, N = _dims(cfg)
    return torch.split(proj, [d_in, d_in, N, N, H], dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along seq, in xbc's dtype, taps in order.
    xbc [Bt, S, Ch]; w [W, Ch]."""
    W = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(W):  # W is small (4); unrolled taps
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _chunk_len(chunk: int, S: int) -> int:
    """The largest divisor of ``S`` not above ``chunk`` (the reference's
    rule: a prompt length with no divisor near the chunk gives tiny
    chunks, 2049 gives 3; ROADMAP C.65)."""
    q = min(chunk, S)
    while S % q:
        q -= 1
    return q


def _chunk_states(chunk_decay, S_chunk):
    """The inter-chunk combine, in chunk order: ``state_c = decay_c *
    state_{c-1} + S_c`` from zeros.  chunk_decay [b, c, h], S_chunk [b, c,
    h, n, p] -> (the exclusive states, entering each chunk, [b, c, h, n,
    p]; the last inclusive state [b, h, n, p])."""
    state = torch.zeros_like(S_chunk[:, 0])
    prev = []
    for c in range(S_chunk.shape[1]):
        prev.append(state)
        state = chunk_decay[:, c, :, None, None] * state + S_chunk[:, c]
    return torch.stack(prev, dim=1), state


def ssm_train(cfg: ModelConfig, p, x):
    """Chunked SSD forward. x [Bt, S, E] -> [Bt, S, E]."""
    y, _ = ssm_forward(cfg, p, x, return_state=False)
    return y


def ssm_forward(cfg: ModelConfig, p, x, *, return_state: bool = False):
    """Chunked SSD forward; with ``return_state`` also the decode-ready
    state ``{"conv": [Bt, W-1, Ch], "ssm": [Bt, H, N, P]}``: the last
    chunk's inclusive state and the last W-1 rows of the raw conv input
    (left-padded with zeros when S < W-1)."""
    d_in, H, P, N = _dims(cfg)
    Bt, S, E = x.shape
    Q = _chunk_len(cfg.ssm_chunk, S)
    nc = S // Q

    proj = x @ p["in_proj"]
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)
    xbc_raw = torch.cat([xc, Bm, Cm], dim=-1)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xc, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)

    f32 = torch.float32
    xh = xc.reshape(Bt, nc, Q, H, P).to(f32)
    Bm = Bm.reshape(Bt, nc, Q, N).to(f32)
    Cm = Cm.reshape(Bt, nc, Q, N).to(f32)
    # F.softplus is x past 20, jax.nn.softplus x + log1p(e^-x): within
    # 2e-9, below f32's rounding there (ROADMAP C.67)
    dt = F.softplus(dt.to(f32) + p["dt_bias"]).reshape(Bt, nc, Q, H)
    A = -torch.exp(p["A_log"])  # [H], negative

    dA = dt * A  # [b, c, q, h]
    cs = torch.cumsum(dA, dim=2)  # within-chunk cumulative decay

    # ---- intra-chunk (quadratic within Q), the exponent masked first ----
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    expo = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [b, c, i, j, h]
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], expo,
                                 -torch.inf))
    del expo
    scores = torch.einsum("bcin,bcjn->bcij", Cm, Bm)  # single group
    W = scores[..., None] * Lmat * dt[:, :, None, :, :]  # [b, c, i, j, h]
    del Lmat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xh)
    del W

    # ---- chunk summaries + the inter-chunk combine, in order ----
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # [b, c, q, h]
    S_chunk = torch.einsum("bcqn,bcqhp->bchnp", Bm,
                           (dt * decay_to_end)[..., None] * xh)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # [b, c, h]

    prev, state = _chunk_states(chunk_decay, S_chunk)

    y_inter = (torch.einsum("bcqn,bchnp->bcqhp", Cm, prev)
               * torch.exp(cs)[..., None])

    y = (y_intra + y_inter).reshape(Bt, S, H, P)
    y = y + p["D"][None, None, :, None] * xc.reshape(Bt, S, H, P).to(f32)
    y = y.reshape(Bt, S, d_in).to(x.dtype)

    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = y @ p["out_proj"]

    if not return_state:
        return out, None
    Wc = cfg.ssm_conv
    padded = F.pad(xbc_raw, (0, 0, max(Wc - 1 - S, 0), 0))
    conv_state = padded[:, padded.shape[1] - (Wc - 1):, :].to(cfg.dtype)
    return out, {"conv": conv_state, "ssm": state}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int, device=None):
    d_in, H, P, N = _dims(cfg)
    conv_ch = d_in + 2 * N
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=cfg.dtype, device=device),
        "ssm": torch.zeros((layers, batch, H, N, P), dtype=torch.float32,
                           device=device),
    }


def _decode_conv(window, w, b):
    """The causal conv at the newest position, in f32 (the reference's
    decode dtype): window [Bt, W, Ch] (oldest row first), w [W, Ch]."""
    f32 = torch.float32
    return F.silu(torch.einsum("bwc,wc->bc", window.to(f32), w.to(f32))
                  + b.to(f32))


def ssm_decode(cfg: ModelConfig, p, x, state):
    """One token. x [Bt, 1, E]; state {conv [Bt, W-1, Ch], ssm [Bt, H, N,
    P]} -> (out [Bt, 1, E], new state); the state given is not changed."""
    d_in, H, P, N = _dims(cfg)
    Bt = x.shape[0]
    f32 = torch.float32

    proj = (x @ p["in_proj"])[:, 0]
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)

    xbc_new = torch.cat([xc, Bm, Cm], dim=-1)  # [Bt, Ch]
    window = torch.cat([state["conv"], xbc_new[:, None]], dim=1)
    xbc = _decode_conv(window, p["conv_w"], p["conv_b"])
    new_conv = window[:, 1:]

    xc, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    xh = xc.reshape(Bt, H, P)
    # F.softplus against jax.nn.softplus: ROADMAP C.67, as in the prefill
    dt = F.softplus(dt.to(f32) + p["dt_bias"])  # [Bt, H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)  # [Bt, H]

    ssm = state["ssm"] * dA[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm, dt[..., None] * xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, ssm) + p["D"][None, :, None] * xh
    y = y.reshape(Bt, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssm": ssm}


def ssm_decode_into(cfg: ModelConfig, p, x, conv, ssm):
    """:func:`ssm_decode` with the layer's state tensors ``conv`` and
    ``ssm`` (views into a stacked decode state) updated in place; returns
    the block's output."""
    out, new = ssm_decode(cfg, p, x, {"conv": conv, "ssm": ssm})
    conv.copy_(new["conv"])
    ssm.copy_(new["ssm"])
    return out
