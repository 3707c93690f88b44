"""``chunk_monoid_fold``: an unsorted chunk folded into the carried table.

Counterpart of ``repro/kernels/segment_reduce.py::chunk_monoid_fold``.  The
kernel (``csrc/chunk_monoid_fold.cu``) folds with add, max or min in two
deterministic passes; :func:`chunk_monoid_fold_plain` is the same function
in plain PyTorch, used for CPU tensors and as the kernel's oracle.  Max and
min follow JAX's rules for NaN and signed zero (``repro_torch.numerics``).
Call both through :func:`repro_torch.kernels.ops.chunk_monoid_fold`.
"""

from __future__ import annotations

import torch

from repro_torch import numerics
from repro_torch.kernels import _build
from repro_torch.kernels.onehot_combine import onehot_fold_plain

#: op codes of csrc/keyed_fold.cuh
OPS = {"add": 0, "max": 1, "min": 2}


def chunk_monoid_fold_plain(keys: torch.Tensor, values: torch.Tensor,
                            acc: torch.Tensor, op: str = "add",
                            block_k: int | None = None) -> torch.Tensor:
    """Unsorted [N] keys + [N, D] values folded into [K, D] acc (f32).

    Rows of keys absent from the chunk pass through; keys outside
    ``[0, K)`` are dropped.  ``add`` is the blocked one-hot contraction;
    ``max``/``min`` reduce each key's values exactly, in any order."""
    if op == "add":
        return onehot_fold_plain(keys, values, acc, block_k=block_k)
    return numerics.scatter_extremum(acc.to(torch.float32), keys,
                                     values.to(torch.float32), op)


def chunk_monoid_fold_cuda(keys: torch.Tensor, values: torch.Tensor,
                           acc: torch.Tensor, op: str, *, block_k: int,
                           tile_n: int, seg_len: int, n_seg: int
                           ) -> torch.Tensor:
    """Launch the kernel; the wrapper in ``ops`` has checked the inputs."""
    lib = _build.library("chunk_monoid_fold")
    n, d = values.shape
    k_space = acc.shape[0]
    out = torch.empty_like(acc)
    partial = torch.empty((n_seg, k_space, d), dtype=torch.float32,
                          device=acc.device)
    err = lib.chunk_monoid_fold_launch(
        keys.data_ptr(), values.data_ptr(), acc.data_ptr(), out.data_ptr(),
        partial.data_ptr(), n, d, k_space, OPS[op], block_k, tile_n, seg_len,
        n_seg, torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check("chunk_monoid_fold", lib, err)
    _build.count_launch("chunk_monoid_fold")
    return out
