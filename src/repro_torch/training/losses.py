"""Losses: vocab-chunked cross-entropy through the logsumexp monoid.

Counterpart of ``repro/training/losses.py``.  For the big-vocab archs
(128k-256k), ``[B, S, V]`` f32 logits dominate training memory.
:func:`xent_chunked` streams vocab chunks through the ``(m, l)``
logsumexp monoid and picks the label logit on the fly, so the full logits
tensor never exists; :func:`xent_materialize` keeps the baseline
(reduce-flow) loss for comparison.

The reference keeps :func:`xent_chunked`'s memory property under
autodiff with ``jax.checkpoint`` on the chunk fold.  Here it is a
``torch.autograd.Function`` (ROADMAP C.54): the forward saves only
``hidden``, ``unembed``, the labels and the ``[B, S]`` logsumexp; the
backward recomputes each chunk's logits and writes ``softmax - onehot``
(through the softcap's derivative) into ``d_hidden`` and that chunk's
rows of ``d_unembed``.  The last chunk may be short where the reference
pads it with ``-inf`` logits; the value is the same.
"""

from __future__ import annotations

import torch


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def _masked_mean(nll, mask):
    if mask is None:
        mask = torch.ones_like(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def xent_materialize(hidden, unembed, labels, *, mask=None, softcap=None):
    """Baseline: full [B,S,V] logits then log_softmax."""
    logits = (hidden @ unembed.T).to(torch.float32)
    logits = _softcap(logits, softcap)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _masked_mean(nll, mask)


def _chunk_logits(hf, unembed, base, size, softcap):
    """f32 logits of vocab rows ``[base, base + size)``: ``[B, S, size]``."""
    wc = unembed[base:base + size].to(torch.float32)
    return _softcap(hf @ wc.T, softcap), wc


class _ChunkedXent(torch.autograd.Function):
    """Per-token ``logsumexp - label_logit`` over vocab chunks."""

    @staticmethod
    def forward(ctx, hidden, unembed, labels, softcap, chunk):
        B, S = labels.shape
        V = unembed.shape[0]
        hf = hidden.to(torch.float32)
        lab64 = labels.long()
        m = torch.full((B, S), -torch.inf, dtype=torch.float32,
                       device=hidden.device)
        l = torch.zeros((B, S), dtype=torch.float32, device=hidden.device)
        lab = torch.zeros((B, S), dtype=torch.float32, device=hidden.device)
        for base in range(0, V, chunk):
            size = min(chunk, V - base)
            logits, _ = _chunk_logits(hf, unembed, base, size, softcap)
            # (m, l) monoid update against the chunk
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            l = l * torch.exp(m - m_new) + torch.sum(
                torch.exp(logits - m_new[..., None]), dim=-1)
            m = m_new
            # label-logit extraction for labels inside this chunk
            in_chunk = (lab64 >= base) & (lab64 < base + size)
            off = torch.clamp(lab64 - base, 0, size - 1)
            here = torch.gather(logits, -1, off[..., None])[..., 0]
            lab = torch.where(in_chunk, here, lab)
            del logits
        lse = m + torch.log(l)
        ctx.save_for_backward(hidden, unembed, labels, lse)
        ctx.softcap, ctx.chunk = softcap, chunk
        return lse - lab

    @staticmethod
    def backward(ctx, g):
        hidden, unembed, labels, lse = ctx.saved_tensors
        softcap, chunk = ctx.softcap, ctx.chunk
        want_h, want_w = ctx.needs_input_grad[:2]
        V, E = unembed.shape
        hf = hidden.to(torch.float32)
        lab64 = labels.long()
        g = g.to(torch.float32)
        d_h = torch.zeros_like(hf) if want_h else None
        d_w = torch.empty_like(unembed) if want_w else None
        for base in range(0, V, chunk):
            size = min(chunk, V - base)
            logits, wc = _chunk_logits(hf, unembed, base, size, softcap)
            # d nll / d logits = softmax - onehot(label)
            dz = torch.exp(logits - lse[..., None])
            in_chunk = (lab64 >= base) & (lab64 < base + size)
            off = torch.clamp(lab64 - base, 0, size - 1)
            dz.scatter_add_(-1, off[..., None],
                            -in_chunk.to(torch.float32)[..., None])
            dz.mul_(g[..., None])
            if softcap:  # d(tanh(z / c) * c) / dz = 1 - tanh(z / c)^2
                t = logits.div_(softcap)
                dz.mul_(1.0 - t * t)
            del logits
            if want_h:
                d_h.add_(dz @ wc)
            if want_w:
                d_w[base:base + size] = (
                    dz.reshape(-1, size).T @ hf.reshape(-1, E)
                ).to(unembed.dtype)
            del dz, wc
        d_h = d_h.to(hidden.dtype) if want_h else None
        return d_h, d_w, None, None, None


def xent_chunked(hidden, unembed, labels, *, mask=None, softcap=None,
                 chunk: int = 8192):
    """Combine flow: stream vocab chunks through the logsumexp monoid.

    holder per token = (m, l, label_logit); the combine is associative, so
    this is a CombinerSpec fold over the vocab axis.  No ``[B, S, V]``
    tensor exists, in the forward or for the backward."""
    chunk = min(chunk, unembed.shape[0])
    nll = _ChunkedXent.apply(hidden, unembed, labels, softcap, chunk)
    return _masked_mean(nll, mask)


def _check_logits_pspec(spec) -> None:
    from repro_torch.distributed import act_sharding
    from repro_torch.models.common import P, mesh_shape

    mesh = act_sharding.current_mesh()
    if mesh is None:
        raise ValueError(f"logits_pspec {spec} names mesh axes, and no mesh "
                         f"is registered (distributed.act_sharding.set_mesh)")
    names = mesh_shape(mesh)
    missing = [a for a in P(*spec).axes() if a not in names]
    if missing:
        raise ValueError(f"logits_pspec {spec} names axes {missing} that the "
                         f"registered mesh {tuple(names)} lacks")


def xent_sharded(hidden, unembed, labels, *, mask=None, softcap=None,
                 logits_pspec=None):
    """Vocab-parallel xent: the stable-softmax statistics and the label
    logit are reductions over V (the logsumexp-monoid merge across vocab
    shards on a mesh); the label logit is a masked sum, no gather.
    ``logits_pspec`` is a layout hint, as in the reference: it must name
    only axes of the mesh registered with
    ``distributed.act_sharding.set_mesh``; the logits are computed on the
    tensors given (ROADMAP C.70)."""
    if logits_pspec is not None:
        _check_logits_pspec(logits_pspec)
    logits = hidden.to(torch.float32) @ unembed.to(torch.float32).T
    logits = _softcap(logits, softcap)
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    V = logits.shape[-1]
    onehot = (torch.arange(V, device=logits.device)[None, None, :]
              == labels[..., None])
    lab = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    return _masked_mean(lse - lab, mask)


def lm_loss(model, params, batch, *, mode: str = "chunked",
            moe_mode: str = "combiner", lb_coef: float = 0.01,
            vocab_chunk: int = 8192, logits_pspec=None):
    """Next-token LM loss for a registry model.

    batch needs "tokens" and "labels" (tensors); labels < 0 are masked."""
    hidden, aux = model.forward(params, batch, moe_mode=moe_mode)
    labels = batch["labels"]
    # align: predict labels[t] from hidden[t] (labels are pre-shifted by the
    # data pipeline); for vlm, hidden includes the patch prefix.
    if hidden.shape[1] != labels.shape[1]:
        hidden = hidden[:, -labels.shape[1]:]
    w = model.unembed_matrix(params)
    mask = (labels >= 0).to(torch.float32)
    labels_ = torch.clamp(labels, min=0)
    if mode == "sharded":
        loss = xent_sharded(hidden, w, labels_, mask=mask,
                            softcap=model.logit_softcap,
                            logits_pspec=logits_pspec)
    elif mode == "chunked":
        loss = xent_chunked(hidden, w, labels_, mask=mask,
                            softcap=model.logit_softcap, chunk=vocab_chunk)
    else:
        loss = xent_materialize(hidden, w, labels_, mask=mask,
                                softcap=model.logit_softcap)
    total = loss + lb_coef * aux.get("load_balance_loss", 0.0)
    return total, {"xent": loss, **aux}
