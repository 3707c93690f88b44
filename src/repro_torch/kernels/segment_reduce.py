"""``chunk_monoid_fold`` and ``segment_reduce``: keyed folds into a table.

Counterpart of ``repro/kernels/segment_reduce.py``.

* ``chunk_monoid_fold`` folds an unsorted chunk into the carried table
  (``csrc/chunk_monoid_fold.cu``, two deterministic passes, O(N) work).
* ``segment_reduce`` reduces a stream grouped into aligned key blocks — the
  radix partition's layout, or a key-sorted stream — to a ``[K, D]`` table
  (``csrc/segment_reduce.cu``, no atomics), optionally folded onto a
  carried table in the same pass.

Each has a plain PyTorch version, used for CPU tensors and as the kernel's
oracle.  Max and min follow JAX's rules for NaN and signed zero
(``repro_torch.numerics``).  Call them through
:func:`repro_torch.kernels.ops.chunk_monoid_fold` and
:func:`repro_torch.kernels.ops.segment_reduce`.
"""

from __future__ import annotations

import torch

from repro_torch import numerics
from repro_torch.kernels import _build
from repro_torch.kernels.onehot_combine import (count_fold, fold_scratch,
                                                onehot_fold_plain)

#: op codes of csrc/fold_table.cuh
OPS = {"add": 0, "max": 1, "min": 2}


def chunk_monoid_fold_plain(keys: torch.Tensor, values: torch.Tensor,
                            acc: torch.Tensor, op: str = "add",
                            block_k: int | None = None,
                            inplace: bool = False) -> torch.Tensor:
    """Unsorted [N] keys + [N, D] values folded into [K, D] acc (f32).

    Rows of keys absent from the chunk pass through; keys outside
    ``[0, K)`` are dropped.  ``add`` is the blocked one-hot contraction;
    ``max``/``min`` reduce each key's values exactly, in any order.
    ``inplace``: the result is written into acc, which is returned."""
    if op == "add":
        return onehot_fold_plain(keys, values, acc, block_k=block_k,
                                 inplace=inplace)
    _build.count_fold(keys.shape[0], keys.shape[0])
    out = numerics.scatter_extremum(acc.to(torch.float32), keys,
                                    values.to(torch.float32), op)
    return acc.copy_(out) if inplace else out


def chunk_monoid_fold_cuda(keys: torch.Tensor, values: torch.Tensor,
                           acc: torch.Tensor, op: str, plan,
                           inplace: bool = False) -> torch.Tensor:
    """Launch the kernel with ``plan`` (an ``ops.FoldPlan``); the wrapper
    in ``ops`` has checked the inputs.  ``inplace`` writes the result into
    acc and returns it."""
    lib = _build.library("chunk_monoid_fold")
    n, d = values.shape
    k_space = acc.shape[0]
    out = acc if inplace else torch.empty_like(acc)
    scratch = fold_scratch(plan, k_space, d, acc.device)
    err = lib.chunk_monoid_fold_launch(
        keys.data_ptr(), values.data_ptr(), acc.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, d, k_space,
        OPS[op], *plan.launch_args(), *plan.route_args(),
        torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check("chunk_monoid_fold", lib, err)
    _build.count_launch("chunk_monoid_fold")
    count_fold(n, plan)
    return out


def segment_reduce_plain(keys: torch.Tensor, values: torch.Tensor,
                         key_space: int, op: str = "add") -> torch.Tensor:
    """[N] keys + [N, D] values -> [K, D] per-key fold (f32).

    Keys outside ``[0, K)`` are dropped and absent keys get the identity.
    ``add`` accumulates with ``index_put_`` (sorted, the same bits on every
    run); ``max``/``min`` are exact in any order."""
    vals = values.to(torch.float32)
    _build.count_fold(keys.shape[0], keys.shape[0])
    if op == "add":
        valid = (keys >= 0) & (keys < key_space)
        table = torch.zeros((key_space, vals.shape[1]), dtype=torch.float32,
                            device=vals.device)
        return table.index_put_((keys[valid].long(),), vals[valid],
                                accumulate=True)
    ident = float("-inf") if op == "max" else float("inf")
    table = torch.full((key_space, vals.shape[1]), ident,
                       dtype=torch.float32, device=vals.device)
    return numerics.scatter_extremum(table, keys, vals, op)


def segment_reduce_cuda(keys: torch.Tensor, values: torch.Tensor,
                        key_space: int, op: str, *, block_k: int, tile: int,
                        acc: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel; the wrapper in ``ops`` has checked the inputs.
    With ``acc`` the result is folded onto it (``op(acc, chunk)``)."""
    lib = _build.library("segment_reduce")
    n, d = values.shape
    nbytes = lib.segment_reduce_scratch_bytes(n, d, key_space, block_k, tile)
    if nbytes < 0:
        raise ValueError(f"segment_reduce: the kernel refuses n={n}, d={d}, "
                         f"key_space={key_space}, block_k={block_k}, "
                         f"tile={tile}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=keys.device)
    out = torch.empty((key_space, d), dtype=torch.float32, device=keys.device)
    err = lib.segment_reduce_launch(
        keys.data_ptr(), values.data_ptr(),
        None if acc is None else acc.data_ptr(), out.data_ptr(), n, d,
        key_space, OPS[op], block_k, tile, scratch.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check("segment_reduce", lib, err)
    _build.count_launch("segment_reduce")
    _build.count_fold(n, n)
    return out
