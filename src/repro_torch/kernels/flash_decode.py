"""``flash_decode``: one-token GQA decode attention on the H100.

Counterpart of ``repro/kernels/flash_decode.py``: softmax attention of one
new token over a KV cache is a reduction that admits an associative
combiner over KV tiles, with holder ``(m, l, acc)`` (running max, rescaled
normalizer, rescaled value sum).  The kernel (``csrc/flash_decode.cu``)
splits S into chunks, one block per (chunk, KV head, batch row): each block
stages its chunk's K and V rows in shared memory with asynchronous copies
and folds them into the holder of the G query heads that share the KV
head; the last block of each (row, KV head) to finish, found with an
integer ticket, merges the chunks' holders in split order with the
combiner's own merge.  No float atomics, so two runs give the same bits.
:func:`split_plan` sizes the chunk from the blocks that fit on an SM.

Its bound is bytes: the K and V rows below each row's ``kv_len``.

:func:`flash_decode_plain` is the same function in plain PyTorch, unfused,
with the TPU kernel's masking (``NEG_INF = -1e30``, ``p = 0`` past
``kv_len``, ``acc / max(l, 1e-30)``), so ``kv_len = 0`` gives zeros as the
TPU kernel does (``repro.kernels.ref.flash_decode`` gives NaN there).  It
is used for CPU tensors and as the kernel's oracle.  Call both through
:func:`repro_torch.kernels.ops.flash_decode`.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

#: the TPU kernel's mask value (finite, so an all-masked tile stays finite)
NEG_INF = -1e30

#: limits of csrc/flash_decode.cu: the head dim, heads per KV head, and
#: (head, column) pairs per block
MAX_HEAD_DIM = 256
MAX_GROUP = 64
MAX_GROUP_ELEMS = 2048

#: the card the plan sizes for (H100 SXM): SMs, shared memory per SM and
#: per block, the runtime's reserve per block, resident blocks and threads
SMS = 132
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448 - 64  # dynamic: the rest for static shared memory
SMEM_RESERVE = 1024
MAX_BLOCKS_PER_SM = 32
MAX_THREADS_PER_SM = 2048

#: csrc/flash_decode.cu: threads per block, the pad after each staged row,
#: the most positions a block folds at once (a tile), and the heads of a
#: block (4 where G <= 4, else 8; more heads take more blocks)
THREADS = 256
ROW_PAD = 16
TILE = 64
STAGES = 2
#: registers a thread may take (csrc/flash_decode.cu kMaxRegs), and the most
#: splits of one (row, KV head): the last block to finish merges them all
MAX_REGS = 128
MAX_SPLITS = 64


def heads_per_block(G: int) -> int:
    return 4 if G <= 4 else 8


def smem_bytes(GB: int, D: int, itemsize: int, tile: int) -> int:
    """Shared memory of one block (csrc/flash_decode.cu ``layout``): the
    scaled q of its GB heads, one tile's logits, two tiles' maxima, then a
    ring of :data:`STAGES` tiles of K and V rows (or the p.V and l partial
    sums, the larger)."""
    row = D * itemsize + ROW_PAD
    groups = THREADS // (D * itemsize // 16)
    ring = max(STAGES * 2 * tile * row, groups * GB * D * 4)
    return -(-(GB * D * 4 + GB * tile * 4 + 5 * GB * 4) // 16) * 16 + ring


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """q [B, H, D], k and v [B, S, Hkv, D], kv_len [B] -> [B, H, D] f32:
    head ``h`` of row ``b`` attends KV head ``h // (H // Hkv)`` over the
    positions below ``kv_len[b]``, with scale ``D^-0.5``."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.to(torch.float32).reshape(B, Hkv, G, D) * (D ** -0.5)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32))
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_len.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return (acc / torch.clamp(l, min=1e-30)).reshape(B, H, D)


@functools.lru_cache(maxsize=256)
def split_plan(B: int, H: int, Hkv: int, S: int, D: int, itemsize: int,
               tile_s: int) -> tuple[int, int, int]:
    """(tile, positions per block, blocks along S).  The tile is the most
    positions, up to :data:`TILE`, whose ring of staged K/V tiles lets as
    many blocks share an SM as its registers and threads allow; S is split into as many
    chunks of whole tiles as fill the blocks that fit on the card at once
    (one wave), at most :data:`MAX_SPLITS`, each at most ``tile_s``
    positions (rounded up to a tile).  It depends on the shapes alone, never on
    ``kv_len``, so no value is read back."""
    G = H // Hkv
    gb = heads_per_block(G)

    fit = min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // THREADS,
              65536 // (MAX_REGS * THREADS))

    def per_sm(tile):
        smem = smem_bytes(gb, D, itemsize, tile)
        if smem > SMEM_PER_BLOCK:
            return 0
        return min(SMEM_PER_SM // (smem + SMEM_RESERVE), fit)

    tile = TILE
    while tile > 8 and per_sm(tile) < fit:
        tile //= 2
    if per_sm(tile) < 1:
        raise ValueError(f"flash_decode: no tile fits the shared memory of a "
                         f"block at D={D}")
    groups = B * Hkv * -(-G // gb)
    n_tiles = -(-S // tile)
    n_split = max(1, min(n_tiles, per_sm(tile) * SMS // groups, MAX_SPLITS))
    chunk = -(-n_tiles // n_split) * tile
    chunk = min(chunk, max(-(-tile_s // tile) * tile, tile))
    return tile, chunk, -(-S // chunk)


#: per (device, stream): the kernel's merge tickets, one int32 per (row, KV
#: head), zero between calls (the merging block resets its own)
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def merge_tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index if device.index is not None else 0, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, *, tile: int, chunk: int,
                      n_split: int) -> torch.Tensor:
    """Launch the kernel; the wrapper in ``ops`` has checked the inputs."""
    lib = _build.library("flash_decode")
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    # the chunks' holders: acc [B, H, n_split, D], then m and l [B, H, n_split]
    part = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                       device=dev)
    acc_ptr = part.data_ptr()
    m_ptr = acc_ptr + 4 * B * H * n_split * D
    l_ptr = m_ptr + 4 * B * H * n_split
    G = H // Hkv
    tickets = merge_tickets(dev, stream, B * Hkv * -(-G // heads_per_block(G)))
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), m_ptr, l_ptr, acc_ptr, tickets.data_ptr(), B, S, H,
        Hkv, D, tile, chunk, n_split, int(q.dtype == torch.bfloat16), stream)
    _build.check("flash_decode", lib, err)
    _build.count_launch("flash_decode", key=S)  # by KV positions
    return out


# ---------------------------------------------------------------------------
# Tracing under fake tensors (the dry-run)
# ---------------------------------------------------------------------------

_TRACED_OP = None


def traced_op():
    """The kernel as the dispatcher op ``repro_torch::flash_decode``, made
    on first use: its fake implementation gives the f32 ``[B, H, D]``
    output's shape, so that a step traced under ``FakeTensorMode`` counts
    one op with the kernel's inputs and output where a real step launches
    it.  On real tensors the op is ``ops.flash_decode``."""
    global _TRACED_OP
    if _TRACED_OP is None:

        @torch.library.custom_op("repro_torch::flash_decode",
                                 mutates_args=())
        def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: torch.Tensor) -> torch.Tensor:
            from repro_torch.kernels import ops

            return ops.flash_decode(q, k, v, kv_len)

        @_op.register_fake
        def _(q, k, v, kv_len):
            return q.new_empty(tuple(q.shape), dtype=torch.float32)

        _TRACED_OP = _op
    return _TRACED_OP


def traced_flops(q_shape, k_shape, v_shape, kv_len_shape, *,
                 out_shape=None, **_) -> int:
    """The kernel's FLOPs in a trace (``roofline.op_trace``): q·Kᵀ and p·V
    over all S positions, 4·B·H·S·D."""
    B, H, D = q_shape
    return 4 * B * H * k_shape[1] * D
