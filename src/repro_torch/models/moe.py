"""Mixture-of-Experts FFN with the paper's two execution flows.

Counterpart of ``repro/models/moe.py``.  Token→expert routing *is*
MapReduce: map emits (expert_id, token_hidden), the shuffle groups by
expert, the expert FFN is applied per group, and the combine-back is a
per-token weighted-sum reduction of the top-k expert outputs.

Two combine-back modes, mirroring ``core/collector.py``:

* ``materialize`` (reduce flow): the per-(token, k) expert outputs are
  written into an explicit ``[N·k, E]`` buffer by a permutation, then
  reduced over k with the gates.  O(N·k·E) intermediate.
* ``combiner`` (combine flow): ``gate · expert_out`` is summed straight
  into the ``[N, E]`` token holder.  No intermediate buffer.

Dispatch is sort-based with a static capacity (GShard-style drops on
overflow), as in the reference.  Where the port differs (ROADMAP C.58 to
C.61):

* the top k is a stable descending sort, so ties go to the lower expert
  id as ``jax.lax.top_k`` breaks them (C.58);
* every dispatch group (a batch row under ``per_row``, else the whole
  batch) is sorted by one stable ``torch.sort`` on the key
  ``row · X + expert`` (C.9, C.58);
* the combine-back sums each token's kept slots in ascending slot order,
  that is ascending expert id, starting from zeros: the order in which
  XLA's scatter-add applies the reference's updates on the CPU, with no
  float atomics (C.59).  The gathers whose autograd backward would
  accumulate over repeated indices are autograd Functions whose backward
  is the adjoint gather, so every gradient also sums in a fixed order
  (C.59);
* the rows' expert batches are folded into one ``[X, R·C, E]`` batch, one
  ``torch.bmm`` per weight, so each expert's weights are read once a
  layer and not once a row (C.60).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _ACT, normal


def init_moe(rng: torch.Generator, cfg: ModelConfig):
    """The router in f32 ``[E, X]``, the experts' SwiGLU weights in
    ``cfg.dtype``, drawn from ``rng`` on its device."""
    X, E, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    s_in, s_out = E ** -0.5, F ** -0.5
    return {
        "router": normal(rng, (E, X), s_in, torch.float32),
        "w_gate": normal(rng, (X, E, F), s_in, cfg.dtype),
        "w_up": normal(rng, (X, E, F), s_in, cfg.dtype),
        "w_down": normal(rng, (X, F, E), s_out, cfg.dtype),
    }


def _expert_ffn(p, x, act):
    """x [X, C, E] -> [X, C, E]; per-expert SwiGLU, one bmm per weight."""
    g = _ACT[act](torch.bmm(x, p["w_gate"]))
    u = torch.bmm(x, p["w_up"])
    return torch.bmm(g * u, p["w_down"])


# ---------------------------------------------------------------------------
# Fixed-order gathers and their adjoints
# ---------------------------------------------------------------------------


def _gather_rows(x, index, valid):
    """``x[index]`` where ``valid``, zero rows elsewhere (``index`` is in
    range everywhere)."""
    mask = valid.reshape(valid.shape + (1,) * (x.dim() - 1))
    return torch.where(mask, x[index], x.new_zeros(()))


class _Plan(NamedTuple):
    """A capacity dispatch of T = R·N tokens with K assignments each into
    X·R·C slots (slot ``x·R·C + r·C + rank``)."""

    src_tok: torch.Tensor  # [slots] the slot's token (0 where empty)
    src: torch.Tensor  # [slots] the slot's assignment (0 where empty)
    valid: torch.Tensor  # [slots] the slot holds an assignment
    slot_of: torch.Tensor  # [T·K] the assignment's slot (0 where dropped)
    kept: torch.Tensor  # [T·K] the assignment has a slot
    tok_slots: torch.Tensor  # [T, K] a token's slots ascending, -1 dropped


def _sum_slots(y, plan: _Plan):
    """out [T, E]: each token's kept slots of ``y`` [slots, E] summed from
    zeros in ascending slot order (ascending expert id)."""
    out = y.new_zeros((plan.tok_slots.shape[0],) + tuple(y.shape[1:]))
    for j in range(plan.tok_slots.shape[1]):
        s = plan.tok_slots[:, j]
        out = out + _gather_rows(y, s.clamp(min=0), s >= 0)
    return out


class _Dispatch(torch.autograd.Function):
    """expert_in [slots, E]: each slot's token row (zero where empty).
    Backward: each token's slot gradients summed as :func:`_sum_slots`."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _gather_rows(x, plan.src_tok, plan.valid)

    @staticmethod
    def backward(ctx, g):
        return _sum_slots(g, ctx.plan), None


class _Combine(torch.autograd.Function):
    """The combine flow's holder [T, E] (:func:`_sum_slots`).  Backward:
    each slot takes its token's gradient (:class:`_Dispatch`'s gather)."""

    @staticmethod
    def forward(ctx, y, plan):
        ctx.plan = plan
        return _sum_slots(y, plan)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        return _gather_rows(g, plan.src_tok, plan.valid), None


class _Move(torch.autograd.Function):
    """``y[i] = x[index[i]]`` where ``valid[i]``, else 0, for an index that
    is one to one between the kept rows of x and of y; the backward moves
    the gradient back through the inverse (``back``, ``back_valid``)."""

    @staticmethod
    def forward(ctx, x, index, valid, back, back_valid):
        ctx.back = (back, back_valid)
        return _gather_rows(x, index, valid)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, *ctx.back), None, None, None, None


def capacity(n_tokens: int, k: int, x: int, capacity_factor: float) -> int:
    """Slots an expert, as the reference computes it:
    ``ceil(N·K / X) · capacity_factor``, at least 1."""
    return int(max(1, -(-n_tokens * k // x) * capacity_factor))


def _dispatch_plan(idx, X: int, C: int) -> _Plan:
    """The capacity dispatch of ``idx`` [R, N, K] (expert ids): assignments
    sorted stably by ``row · X + expert``; an assignment's rank within its
    (row, expert) group decides whether it keeps a slot."""
    R, N, K = idx.shape
    A = R * N * K
    dev = idx.device
    rows = torch.arange(R, device=dev, dtype=torch.int64)
    key = (idx.reshape(R, N * K).to(torch.int64) + X * rows[:, None]
           ).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        sorted_key, torch.arange(R * X, device=dev, dtype=torch.int64))
    rank = torch.arange(A, device=dev) - starts[sorted_key]
    keep = rank < C
    n_slots = X * R * C
    slot = (sorted_key % X) * (R * C) + (sorted_key // X) * C + rank
    # slot -> assignment; the dropped write into one spare entry
    src = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=dev)
    src[torch.where(keep, slot, n_slots)] = order
    src = src[:n_slots]
    slot_of = torch.empty(A, dtype=torch.int64, device=dev)
    slot_of[order] = torch.where(keep, slot, -1)
    valid = src >= 0
    src = src.clamp(min=0)
    tok_slots, _ = torch.sort(slot_of.reshape(R * N, K), dim=-1)
    return _Plan(src_tok=src // K, src=src, valid=valid,
                 slot_of=slot_of.clamp(min=0), kept=slot_of >= 0,
                 tok_slots=tok_slots)


def _route(p, tokens, K: int):
    """tokens [..., E] -> (probs [..., X] f32, gates [..., K] f32, idx
    [..., K]): softmax over ``tokens.f32 @ router``, the top K by a stable
    descending sort (ties to the lower expert id), gates renormalized."""
    logits = tokens.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :K], order[..., :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _load_balance(probs, idx, X: int):
    """Per row (Switch):
    ``X · Σ_x mean(probs)_x · mean(any_k(idx == x))``."""
    me = probs.mean(-2)
    hit = (idx[..., None] == torch.arange(X, device=idx.device)).any(-2)
    ce = hit.to(torch.float32).mean(-2)
    return X * torch.sum(me * ce, dim=-1)


def _moe_rows(cfg: ModelConfig, p, x, *, mode: str, capacity_factor: float,
              act: str, with_aux: bool = True):
    """Dispatch + expert FFN + combine-back, each of the R rows of ``x``
    [R, N, E] a dispatch group of its own.  Returns (out [R·N, E], aux)
    with the load-balance loss the mean over rows."""
    if mode not in ("combiner", "materialize"):
        raise ValueError(mode)
    R, N, E = x.shape
    X, K = cfg.num_experts, cfg.num_experts_per_tok
    probs, gates, idx = _route(p, x, K)
    aux = ({"load_balance_loss": _load_balance(probs, idx, X).mean()}
           if with_aux else {})

    C = capacity(N, K, X, capacity_factor)
    plan = _dispatch_plan(idx, X, C)
    tokens = x.reshape(R * N, E)
    expert_in = _Dispatch.apply(tokens, plan).reshape(X, R * C, E)
    expert_out = _expert_ffn(p, expert_in, act).reshape(X * R * C, E)

    if mode == "combiner":
        # combine flow: weighted outputs summed into the token holder
        gate_of_src = _Move.apply(gates.reshape(-1), plan.src, plan.valid,
                                  plan.slot_of, plan.kept)
        out = _Combine.apply(
            expert_out * gate_of_src[:, None].to(expert_out.dtype), plan)
    else:
        # reduce flow: materialize [N·K, E] per-assignment outputs, reduce
        assign_out = _Move.apply(expert_out, plan.slot_of, plan.kept,
                                 plan.src, plan.valid)
        per_k = assign_out.reshape(R * N, K, E)  # the materialized buffer
        out = torch.sum(per_k * gates.reshape(R * N, K, 1).to(per_k.dtype),
                        dim=1)
    return out, aux


def moe_ffn(cfg: ModelConfig, p, x, *, mode: str = "combiner",
            capacity_factor: float = 1.25, act: str = "silu",
            per_row: bool = True):
    """x [B, S, E] -> (out [B, S, E], aux) where aux has the load-balancing
    loss.

    ``per_row=True`` (default) dispatches each batch row on its own, as the
    reference's ``vmap`` does (the distributed engine's map-side local
    combine applied to routing; the loss is the mean of the rows'); one
    stable sort orders every row.  ``per_row=False`` dispatches the whole
    batch at once, the reference's baseline."""
    B, S, E = x.shape
    rows = x if per_row and B > 1 else x.reshape(1, B * S, E)
    out, aux = _moe_rows(cfg, p, rows, mode=mode,
                         capacity_factor=capacity_factor, act=act)
    return out.reshape(B, S, E).to(x.dtype), aux


def _moe_tokens(cfg: ModelConfig, p, tokens, *, mode: str = "combiner",
                capacity_factor: float = 1.25, act: str = "silu"):
    """Dispatch + expert FFN + combine-back over a flat token block
    ``tokens`` [N, E]: (out [N, E], aux)."""
    return _moe_rows(cfg, p, tokens[None], mode=mode,
                     capacity_factor=capacity_factor, act=act)


def moe_ffn_decode(cfg: ModelConfig, p, x, *, act: str = "silu"):
    """Decode-time MoE for [B, 1, E]: the capacity dispatch of training per
    row (capacity factor 2.0, combiner mode), its load-balance loss not
    computed.  The rows share one expert batch, so every expert's weights
    are read once a step."""
    B, S, E = x.shape
    rows = x if B > 1 else x.reshape(1, B * S, E)
    out, _ = _moe_rows(cfg, p, rows, mode="combiner", capacity_factor=2.0,
                       act=act, with_aux=False)
    return out.reshape(B, S, E).to(x.dtype)
