"""``int_fold``: the exact integer keyed fold on the H100.

No counterpart in ``repro/kernels/``: the reference folds integer channels
with an exact integer one-hot contraction that XLA fuses
(``repro/core/collector.py::StreamCombiner._fold_additive``).  The kernel
(``csrc/int_fold.cu``) adds ``[n, D]`` int32 or int64 rows into a ``[K, D]``
int64 table by key, and the pairs of each key into ``[K]`` int32 counts, in
one pass with integer atomics (the same bits in any order).
:func:`int_fold_plain` is the same function in plain PyTorch, the exact
route the port took before the kernel (``index_add_`` in the table's dtype
and ``bincount``), used for CPU tensors and as the kernel's oracle.  Call
both through :func:`repro_torch.kernels.ops.int_fold`, which checks the
inputs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def int_fold_plain(keys: torch.Tensor, rows: torch.Tensor,
                   table: torch.Tensor, counts: torch.Tensor | None = None):
    """[N] keys, [N, D] integer rows, [K, D] table -> ``table`` plus each
    key's sum of rows in the table's dtype (and ``counts`` plus each key's
    pair count, int32, when given); keys outside ``[0, K)`` never land."""
    k = table.shape[0]
    _build.count_fold(keys.shape[0], keys.shape[0])
    valid = (keys >= 0) & (keys < k)
    out = table.index_add(0, torch.where(valid, keys, 0).to(torch.int64),
                          torch.where(valid[:, None], rows, 0).to(table.dtype))
    if counts is None:
        return out
    binned = torch.where(valid, keys, k).to(torch.int64)
    return out, counts + torch.bincount(binned, minlength=k + 1)[:k].to(
        torch.int32)


def int_fold_cuda(keys: torch.Tensor, rows: torch.Tensor,
                  table: torch.Tensor, counts: torch.Tensor | None = None):
    """Launch the kernel into fresh outputs; the wrapper in ``ops`` has
    checked the inputs."""
    lib = _build.library("int_fold")
    n, d = rows.shape
    out = torch.empty_like(table)
    out_counts = None if counts is None else torch.empty_like(counts)
    err = lib.int_fold_launch(
        keys.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.int64),
        table.data_ptr(), out.data_ptr(),
        None if counts is None else counts.data_ptr(),
        None if out_counts is None else out_counts.data_ptr(), n, d,
        table.shape[0], torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check("int_fold", lib, err)
    _build.count_launch("int_fold")
    _build.count_fold(n, n)
    return out if counts is None else (out, out_counts)
