"""Carry a stream or sort fold's state between ``repro`` and the port.

The collectors' carried state is the system's only long-lived data (what
weights are to a model).  ``repro`` keeps it as numpy-convertible arrays
in one of three layouts, and so do the port's
:class:`~repro_torch.core.collector.StreamCombiner` and
:class:`~repro_torch.core.collector.SortCombiner`:

* fused   — one f32 ``[K, ΣD + 1]`` accumulator, counts in the last column
            (additive float holders: the stream flow's ``onehot_fold``
            kernel, the sort flow's plain path);
* tables  — ``(holder tables, counts)``, the tables a pytree of
            ``[K, *leaf]`` arrays (the sort flow's kernel path too);
* size    — ``[K]`` int32 counts alone.

:func:`state_from_repro` turns a reference state (as numpy) into the
port's state for a given combiner, converting between the fused and the
per-leaf layouts when the two sides chose differently; a fold seeded with
it continues exactly as the reference's next fold would.
:func:`state_to_repro` goes back.  Holder dtypes follow the port's
combiner (torch sums integers into int64, the reference into int32).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.collector import CarriedTables


def _split_fused(comb: CarriedTables, acc: np.ndarray):
    """(tables leaves, counts) of a fused accumulator, per the port's
    holder leaves."""
    leaves, off = [], 0
    for leaf in comb._holder_leaves:
        size = leaf.numel()
        leaves.append(acc[:, off:off + size].reshape(
            (comb.key_space,) + tuple(leaf.shape)))
        off += size
    return leaves, acc[:, -1].astype(np.int32)


def state_from_repro(comb: CarriedTables, state):
    """The port's carried state for ``comb`` from a reference state given
    as numpy arrays (``np.asarray`` of each leaf of the reference's
    state)."""
    dev = comb.device
    if comb.mode == "size":
        return torch.tensor(np.asarray(state), dtype=torch.int32,
                            device=dev)
    if isinstance(state, np.ndarray) and state.ndim == 2:  # fused
        if comb.fused_acc:
            return torch.tensor(state, dtype=torch.float32, device=dev)
        leaves, counts = _split_fused(comb, state)
    else:
        tables, counts = state
        leaves = pytree.tree_leaves(tables)
    leaves = [torch.tensor(np.asarray(x)).to(device=dev, dtype=h.dtype)
              for x, h in zip(leaves, comb._holder_leaves)]
    counts = torch.tensor(np.asarray(counts), dtype=torch.int32, device=dev)
    if comb.fused_acc:
        cols = [x.reshape(comb.key_space, -1).to(torch.float32)
                for x in leaves]
        cols.append(counts.to(torch.float32)[:, None])
        return torch.cat(cols, dim=1)
    return (pytree.tree_unflatten(leaves, comb._holder_treedef), counts)


def state_to_repro(comb: CarriedTables, state, *, fused: bool):
    """The reference's carried state (numpy) from the port's; ``fused``
    picks the reference combiner's layout (its ``_fused_acc``)."""
    if comb.mode == "size":
        return state.cpu().numpy()
    tables, counts = comb.tables_counts(state)
    leaves = [x.cpu().numpy() for x in pytree.tree_leaves(tables)]
    counts = counts.cpu().numpy().astype(np.int32)
    if fused:
        cols = [x.reshape(comb.key_space, -1).astype(np.float32)
                for x in leaves]
        return np.concatenate(cols + [counts.astype(np.float32)[:, None]],
                              axis=1)
    return pytree.tree_unflatten(leaves, comb._holder_treedef), counts
