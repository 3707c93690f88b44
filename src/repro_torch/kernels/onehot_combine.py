"""``onehot_fold`` and ``onehot_combine``: per-key sums on the H100.

Counterpart of ``repro/kernels/onehot_combine.py``.

* ``onehot_fold`` — ``acc + one_hot(keys)ᵀ @ values``, the stream flow's
  additive chunk fold (``csrc/onehot_fold.cu``); with ``counts`` the
  per-key pair counts land in acc's last column;
* ``onehot_combine`` — ``one_hot(keys)ᵀ @ values`` of a whole pair buffer,
  the combine flow's additive fold (``csrc/onehot_combine.cu``).

Both kernels fold deterministically with no float atomics; the
``*_plain`` functions are the same functions in plain PyTorch, used for CPU
tensors and as the kernels' oracles.  Call them through
:func:`repro_torch.kernels.ops.onehot_fold` and
:func:`repro_torch.kernels.ops.onehot_combine`, which check shapes and pick
the tiling.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def onehot_fold_plain(keys: torch.Tensor, values: torch.Tensor,
                      acc: torch.Tensor, block_k: int | None = None,
                      counts: bool = False,
                      inplace: bool = False) -> torch.Tensor:
    """[N] keys, [N, D] values, [K, D] acc -> acc + per-key sums (f32).

    The one-hot contraction one key block at a time, so the live one-hot is
    ``[N, block_k]``; keys outside ``[0, K)`` match no row.  With
    ``counts`` acc is ``[K, D + 1]`` and its last column gains each key's
    pair count (the one-hot's column sums, exact below 2^24).
    ``inplace``: the sums are added into acc, which is returned."""
    k_space = acc.shape[0]
    block_k = k_space if block_k is None else block_k
    d = values.shape[1]
    vals = values.to(torch.float32)
    keys64 = keys.to(torch.int64)
    delta = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    _build.count_fold(keys.shape[0], keys.shape[0] * -(-k_space // block_k))
    for lo in range(0, k_space, block_k):
        hi = min(lo + block_k, k_space)
        iota = torch.arange(lo, hi, device=keys.device)
        onehot = (keys64[:, None] == iota[None, :]).to(torch.float32)
        delta[lo:hi, :d] = onehot.T @ vals
        if counts:
            delta[lo:hi, d] = onehot.sum(0)
    if inplace:
        return acc.add_(delta)
    return acc.to(torch.float32) + delta


def onehot_fold_cuda(keys: torch.Tensor, values: torch.Tensor,
                     acc: torch.Tensor, plan, counts: bool = False,
                     inplace: bool = False) -> torch.Tensor:
    """Launch the kernel with ``plan`` (an ``ops.FoldPlan``, of acc's
    width); the wrapper in ``ops`` has checked the inputs.  ``inplace``
    writes the result into acc and returns it."""
    lib = _build.library("onehot_fold")
    n = values.shape[0]
    k_space, d = acc.shape
    out = acc if inplace else torch.empty_like(acc)
    scratch = fold_scratch(plan, k_space, d, acc.device)
    err = lib.onehot_fold_launch(
        keys.data_ptr(), values.data_ptr(), acc.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, d, k_space,
        *plan.launch_args(), int(counts), *plan.route_args(),
        torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check("onehot_fold", lib, err)
    _build.count_launch("onehot_fold")
    count_fold(n, plan)
    return out


def fold_scratch(plan, key_space: int, d: int, device):
    """The scratch of a launch with ``plan``: the partitioned route's
    (``plan.scratch`` bytes), a ``[n_seg, K, D]`` f32 partials buffer for
    a tile plan of several segments, else None (one segment writes its
    table straight out)."""
    if plan.route == "partitioned":
        return torch.empty(plan.scratch, dtype=torch.uint8, device=device)
    if plan.n_seg == 1:
        return None
    return torch.empty((plan.n_seg, key_space, d), dtype=torch.float32,
                       device=device)


def count_fold(n: int, plan) -> None:
    """Count a keyed fold of ``n`` pairs launched with ``plan``: its
    reads of the pairs (``plan.scans`` each) and, on the partitioned
    route, one ``fold_partitioned``."""
    _build.count_fold(n, n * plan.scans,
                      partitioned=plan.route == "partitioned")


def onehot_combine_plain(keys: torch.Tensor, values: torch.Tensor,
                         key_space: int, block_k: int | None = None
                         ) -> torch.Tensor:
    """[N] keys, [N, D] values -> [K, D] per-key sums (f32); keys outside
    ``[0, K)`` (the sentinel ``K`` among them) are dropped."""
    zeros = torch.zeros((key_space, values.shape[1]), dtype=torch.float32,
                        device=values.device)
    return onehot_fold_plain(keys, values, zeros, block_k=block_k)


def keyed_table_cuda(name: str, keys: torch.Tensor, values: torch.Tensor,
                     key_space: int, *extra: int, plan) -> torch.Tensor:
    """Launch kernel ``name`` over the keyed fold that builds a fresh
    ``[K, D]`` f32 table (``onehot_combine``, ``combine_scatter``) with
    ``plan``; ``extra`` are the launch arguments between ``K`` and the
    plan's."""
    lib = _build.library(name)
    n, d = values.shape
    out = torch.empty((key_space, d), dtype=torch.float32,
                      device=values.device)
    scratch = fold_scratch(plan, key_space, d, values.device)
    err = getattr(lib, f"{name}_launch")(
        keys.data_ptr(), values.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, d, key_space,
        *extra, *plan.launch_args(), *plan.route_args(),
        torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(name, lib, err)
    _build.count_launch(name)
    count_fold(n, plan)
    return out


def onehot_combine_cuda(keys: torch.Tensor, values: torch.Tensor,
                        key_space: int, plan) -> torch.Tensor:
    """Launch the kernel with ``plan``; the wrapper in ``ops`` has checked
    the inputs."""
    return keyed_table_cuda("onehot_combine", keys, values, key_space,
                            plan=plan)
