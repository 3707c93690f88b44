"""``combine_scatter``: the ``[K, D]`` add, max or min table of a pair
buffer on the H100.

Counterpart of ``repro/kernels/combine_scatter.py``.  The kernel
(``csrc/combine_scatter.cu``) builds the table from the op's identity in
two deterministic passes with no float atomics;
:func:`combine_scatter_plain` is the same function in plain PyTorch, used
for CPU tensors and as the kernel's oracle.  Max and min follow JAX's rules
for NaN and signed zero (``repro_torch.numerics``).  Call both through
:func:`repro_torch.kernels.ops.combine_scatter`, which checks shapes and
picks the tiling.  The combine flow's scatter lowering takes it for f32
add/max/min holder leaves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.onehot_combine import keyed_table_cuda
from repro_torch.kernels.segment_reduce import OPS, segment_reduce_plain


def combine_scatter_plain(keys: torch.Tensor, values: torch.Tensor,
                          key_space: int, op: str = "add") -> torch.Tensor:
    """[N] keys in any order, [N, D] values -> [K, D] ``op`` table (f32):
    ``identity.at[keys].<op>(values, mode="drop")``.  Absent keys keep the
    identity.  The plain segment reduce computes exactly this: it needs no
    sorted input."""
    return segment_reduce_plain(keys, values, key_space, op)


def combine_scatter_cuda(keys: torch.Tensor, values: torch.Tensor,
                         key_space: int, op: str, plan) -> torch.Tensor:
    """Launch the kernel with ``plan`` (an ``ops.FoldPlan``); the wrapper
    in ``ops`` has checked the inputs."""
    return keyed_table_cuda("combine_scatter", keys, values, key_space,
                            OPS[op], plan=plan)
