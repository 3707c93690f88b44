"""Plain reference of ``uservisits-node``: ``SELECT sourceIP,
SUM(adRevenue) FROM UserVisits GROUP BY sourceIP`` over the generated
columns, in float64, a block of records at a time.

``reference`` gives each group's float64 sum, the float64 sum of its
values' magnitudes (the scale an error is read against) and its exact
count; ``control`` is the same query in bfloat16, the precision below the
configuration's float32, put in the program's place; ``numbers`` compares
a result with the reference.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25


def _blocks(cols, query):
    keys = cols[query["group_by"]].reshape(-1)
    vals = cols[query["sum"]].reshape(-1)
    for lo in range(0, keys.numel(), BLOCK):
        yield keys[lo:lo + BLOCK].long(), vals[lo:lo + BLOCK]


def _counts(cols, query, groups: int) -> torch.Tensor:
    keys = cols[query["group_by"]]
    counts = torch.zeros(groups, dtype=torch.int64, device=keys.device)
    for k, _ in _blocks(cols, query):
        counts += torch.bincount(k, minlength=groups)
    return counts


def reference(cols, query, sizes) -> dict:
    groups = int(sizes[query["groups"]])
    dev = cols[query["group_by"]].device
    sums = torch.zeros(groups, dtype=torch.float64, device=dev)
    mags = torch.zeros(groups, dtype=torch.float64, device=dev)
    for k, v in _blocks(cols, query):
        v = v.double()
        sums.index_add_(0, k, v)
        mags.index_add_(0, k, v.abs())
    return {"values": sums, "magnitudes": mags,
            "counts": _counts(cols, query, groups)}


def control(cols, query, sizes) -> dict:
    groups = int(sizes[query["groups"]])
    dev = cols[query["group_by"]].device
    sums = torch.zeros(groups, dtype=torch.bfloat16, device=dev)
    for k, v in _blocks(cols, query):
        sums.index_add_(0, k, v.to(torch.bfloat16))
    return {"values": sums.float(), "counts": _counts(cols, query, groups)}


def numbers(values: torch.Tensor, counts: torch.Tensor, ref: dict) -> dict:
    """``count_mismatch``: groups whose count differs; ``sum_rel_err``: the
    largest gap of a group's sum from the float64 one, over the larger of
    that group's magnitude and the median group's."""
    mags = ref["magnitudes"]
    scale = torch.clamp(mags, min=float(mags.median()))
    err = (values.double() - ref["values"]).abs() / scale
    return {"count_mismatch": int((counts.long() != ref["counts"]).sum()),
            "sum_rel_err": float(err.max())}
