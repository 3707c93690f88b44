#!/usr/bin/env python3
"""The keyed fold's two routes against each other on one CUDA card: the
sweep behind ``ops.FOLD_PART_SCANS``.

    python3 tools/fold_route_sweep.py [--iters 10] [--pairs 4194304]

For each key space of :data:`KEYS` and each fused accumulator width of
:data:`WIDTHS` (the values and the counts column, ``onehot_fold(...,
counts=True)`` as the stream flow calls it), one chunk of ``--pairs``
pairs with uniform keys is folded onto a ``[K, D]`` table through B1's
binding with an explicit plan: the tile route's (``ops.tile_plan``) and
the partitioned route's (``ops.partitioned_plan`` within
``ops.route_budget``), each timed from a CUDA graph of ``--iters`` calls.
The two tables must agree (sums within 1e-5, counts exactly).  It prints
the card's name and power limit and one JSON line: each shape's times, the
tile plan's reads a pair, the route's sub-chunks, and the largest tile
read count at which the tile route was the faster (a choice of
``FOLD_PART_SCANS``).  Exits 1 where the tables disagree.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ab_radix_partition import card_line, graph_ms  # noqa: E402

#: key spaces of the sweep: one key tile up to the benchmark cell's 2.5M
KEYS = (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 20, 2_500_000)
#: widths of the fused accumulator: 1 and 3 value columns, then counts
WIDTHS = (2, 4)


def sweep(n: int, iters: int) -> dict:
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import onehot_combine as oc

    _build.build(("onehot_fold",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, bad = [], []
    for k in KEYS:
        keys = torch.randint(0, k, (n,), device=dev, generator=g,
                             dtype=torch.int32)
        for d in WIDTHS:
            vals = torch.rand((n, d - 1), device=dev, generator=g)
            acc = torch.rand((k, d), device=dev, generator=g)
            acc[:, -1] = 0
            tile = ops.tile_plan(n, k, d, "add")
            route = ops.partitioned_plan(n, k, d, counts=True,
                                         budget=ops.route_budget(tile, k, d,
                                                                True))
            row = {"K": k, "D": d, "tile_scans": tile.scans,
                   "tile_blocks": tile.n_seg * tile.key_tiles
                   * tile.col_tiles}
            outs = {}
            for name, plan in (("tile", tile), ("route", route)):
                if plan is None:
                    continue

                def fold(plan=plan):
                    return oc.onehot_fold_cuda(keys, vals, acc, plan,
                                               counts=True)

                outs[name] = fold()
                row[f"{name}_ms"] = round(graph_ms(fold, iters), 4)
            if route is not None:
                row.update(route_scans=route.scans, sub_chunks=route.n_seg,
                           sub_pairs=route.seg_len,
                           route_key_tiles=route.key_tiles,
                           scratch_mb=round(route.scratch / 2**20, 2))
                a, b = outs["tile"], outs["route"]
                ok = (torch.equal(a[:, -1], b[:, -1]) and torch.allclose(
                    a[:, :-1], b[:, :-1], rtol=1e-5, atol=1e-5))
                row["agree"] = ok
                if not ok:
                    bad.append((k, d))
            print(json.dumps(row), flush=True)
            rows.append(row)
    # the largest tile read count where the tile route won, past one tile
    won = [r["tile_scans"] for r in rows
           if "route_ms" in r and r["tile_ms"] <= r["route_ms"]]
    return {"card": card_line(), "pairs": n, "iters": iters, "rows": rows,
            "tile_wins_up_to_scans": max(won, default=0), "disagree": bad}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=1 << 22)
    args = ap.parse_args()
    out = sweep(args.pairs, args.iters)
    print(out["card"])
    print(json.dumps(out))
    return 1 if out["disagree"] else 0


if __name__ == "__main__":
    sys.exit(main())
