"""``flash_decode``: one-token GQA decode attention on the H100.

Counterpart of ``repro/kernels/flash_decode.py``: softmax attention of one
new token over a KV cache is a reduction that admits an associative
combiner over KV tiles, with holder ``(m, l, acc)`` (running max, rescaled
normalizer, rescaled value sum).  The kernel (``csrc/flash_decode.cu``)
folds the tiles of one S range per block into the holder of the G query
heads that share a KV head, and merges the ranges' holders in a second
pass, in a fixed order, with the combiner's own merge: no float atomics,
so two runs give the same bits.  Splitting S across blocks is what fills
the card: B·Hkv holders alone are 2 blocks at the bench shape and 32 at
llama3-8b's decode shape, for 132 SMs.

Its bound is bytes: the K and V rows below each row's ``kv_len``.

:func:`flash_decode_plain` is the same function in plain PyTorch, unfused,
with the TPU kernel's masking (``NEG_INF = -1e30``, ``p = 0`` past
``kv_len``, ``acc / max(l, 1e-30)``), so ``kv_len = 0`` gives zeros as the
TPU kernel does (``repro.kernels.ref.flash_decode`` gives NaN there).  It
is used for CPU tensors and as the kernel's oracle.  Call both through
:func:`repro_torch.kernels.ops.flash_decode`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the TPU kernel's mask value (finite, so an all-masked tile stays finite)
NEG_INF = -1e30

#: limits of csrc/flash_decode.cu: D per lane slots, heads per KV head, and
#: (head, column) accumulators per block
MAX_HEAD_DIM = 256
MAX_GROUP = 64
MAX_GROUP_ELEMS = 2048

#: blocks the kernel aims to launch (two per SM), and the fewest positions
#: a block folds (one tile of csrc/flash_decode.cu kTile)
TARGET_BLOCKS = 2 * 132
TILE = 64


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


def split_plan(B: int, Hkv: int, S: int, tile_s: int) -> tuple[int, int]:
    """(positions per block, blocks along S): enough blocks to fill the
    card, each a whole number of tiles and at most ``tile_s`` positions
    (rounded up to a tile).  It depends on the shapes alone, never on
    ``kv_len``, so no value is read back from the card."""
    n_split = max(1, -(-TARGET_BLOCKS // (B * Hkv)))
    n_split = min(n_split, -(-S // TILE))
    chunk = -(-S // n_split)
    chunk = min(chunk, max(tile_s, 1))
    chunk = -(-chunk // TILE) * TILE
    return chunk, -(-S // chunk)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor, *, chunk: int, n_split: int
                      ) -> torch.Tensor:
    """Launch the kernel; the wrapper in ``ops`` has checked the inputs."""
    lib = _build.library("flash_decode")
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    part_m = torch.empty((B, H, n_split), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_split, D), dtype=torch.float32,
                           device=dev)
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), B, S, H, Hkv, D, chunk, n_split,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("flash_decode", lib, err)
    _build.count_launch("flash_decode")
    return out
