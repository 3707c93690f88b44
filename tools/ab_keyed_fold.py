#!/usr/bin/env python3
"""Same-call A/B of the keyed fold (B1, B2, B6, B7) between two checkouts
of the port on one CUDA card.

    git archive <commit> src | tar -x -C build/ab_parent
    python3 tools/ab_keyed_fold.py --parent build/ab_parent

Both sides are driven through their public entry points only
(``ops.onehot_fold``, ``chunk_monoid_fold``, ``onehot_combine``,
``combine_scatter``, ``sort_segment_fold`` and ``MapReduce.run``), each
from its own checkout (its kernels built into that checkout's
``build/``), so any commit of the port can be the parent.  The script runs
parent, tree, tree, parent, a process each.  Per process it records, for
each of :data:`SHAPES`, the call's time from a CUDA graph of ``--iters``
calls and a digest of its table (B1's counts rows: ``onehot_fold(...,
counts=True)`` on [n, D] values where the side has it, else the fold of
``[values, ones]`` made before the timed call, onto the same [K, D + 1]
acc); for each cell of the combine flow's
scatter-route sweep (:data:`ROUTE_KEYS` x D = 1, 3 x uniform keys and one
key holding half the pairs) the times of ``combine_scatter``'s and
``sort_segment_fold``'s add by CUDA events; and for each of the KMeans main
paths (:data:`PATHS`) the median and fastest wall time of a run and the
device time of one run (torch.profiler).  It prints the card's name and
power limit and one JSON line, and exits 1 if the two runs of a side
differ, or if the two sides differ where the pass did not change (max,
and B1's counts rows).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from ab_radix_partition import card_line, device_ms, graph_ms

TREE = Path(__file__).resolve().parents[1]

#: (label, entry point, pairs, D, key space, op, keys); "half" keys: key
#: K // 2 holds half the pairs
SHAPES = (
    ("B1 onehot_fold, KMeans stream", "onehot_fold", 1 << 22, 4, 100,
     "add", "uniform"),
    ("B1 onehot_fold, half-hot key", "onehot_fold", 1 << 22, 4, 100,
     "add", "half"),
    ("B1 onehot_fold counts, KMeans stream [K, 3+1]", "onehot_fold_counts",
     1 << 22, 3, 100, "add", "uniform"),
    ("B1 onehot_fold counts, half-hot key", "onehot_fold_counts", 1 << 22,
     3, 100, "add", "half"),
    ("B1 onehot_fold counts, KeyedSum K=2^16 (index order)",
     "onehot_fold_counts", 1 << 22, 1, 1 << 16, "add", "uniform"),
    ("B2 chunk_monoid_fold add", "chunk_monoid_fold", 1 << 22, 3, 100,
     "add", "uniform"),
    ("B2 chunk_monoid_fold max (index order)", "chunk_monoid_fold", 1 << 22,
     3, 100, "max", "uniform"),
    ("B6 onehot_combine, KMeans values", "onehot_combine", 1 << 24, 3, 100,
     "add", "uniform"),
    ("B6 onehot_combine, KMeans counts", "onehot_combine", 1 << 24, 1, 100,
     "add", "uniform"),
    ("B7 combine_scatter add, KMeans scatter", "combine_scatter", 1 << 24, 3,
     100, "add", "uniform"),
    ("B7 combine_scatter add, half-hot key", "combine_scatter", 1 << 24, 3,
     100, "add", "half"),
    ("B7 combine_scatter max (index order)", "combine_scatter", 1 << 24, 3,
     100, "max", "uniform"),
)
#: key spaces of the scatter-route sweep, 2^22 pairs each (chip_smoke.py's
#: ROUTE_SWEEP_KEYS)
ROUTE_KEYS = (1 << 6, 1 << 7, 1 << 8, 1 << 10, 1 << 11, 1 << 12, 1 << 13,
              1 << 14, 1 << 16)
#: the KMeans main paths on 2^24 points: (label, flow, combine_impl)
PATHS = (("KMeans stream", "auto", "auto"),
         ("KMeans combine", "combine", "auto"),
         ("KMeans scatter combine", "combine", "scatter"))


def pairs(seed: int, n: int, d: int, k: int, mix: str):
    """[n] int32 keys in [0, K) and [n, D] f32 values from a seeded
    generator on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda",
                         generator=gen)
    if mix == "half":
        hot = torch.rand((n,), device="cuda", generator=gen) < 0.5
        keys[hot] = k // 2
    vals = torch.randn((n, d), device="cuda", generator=gen)
    return keys, vals


def events_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds of ``fn()`` by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def worker(root: Path, iters: int) -> dict:
    """One checkout's numbers; ``root`` holds its ``src/``."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.data import datasets
    from repro_torch.kernels import ops

    import inspect
    has_counts = "counts" in inspect.signature(ops.onehot_fold).parameters
    rows = []
    for i, (label, entry, n, d, k, op, mix) in enumerate(SHAPES):
        keys, vals = pairs(200 + i, n, d, k, mix)
        width = d + (entry == "onehot_fold_counts")
        acc = torch.randn((k, width), device="cuda",
                          generator=torch.Generator(
                              device="cuda").manual_seed(300 + i))
        ones = (None if has_counts or width == d else
                torch.cat([vals, torch.ones_like(vals[:, :1])], 1))
        fn = {"onehot_fold": lambda: ops.onehot_fold(keys, vals, acc),
              "onehot_fold_counts": (
                  (lambda: ops.onehot_fold(keys, vals, acc, counts=True))
                  if has_counts else
                  (lambda: ops.onehot_fold(keys, ones, acc))),
              "chunk_monoid_fold": lambda: ops.chunk_monoid_fold(
                  keys, vals, acc, op),
              "onehot_combine": lambda: ops.onehot_combine(keys, vals, k),
              "combine_scatter": lambda: ops.combine_scatter(
                  keys, vals, k, op)}[entry]
        digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()
        rows.append({"shape": label, "digest": digest[:16],
                     "graph_ms": graph_ms(fn, iters)})
        del keys, vals, ones

    routes = []
    for d in (1, 3):
        for mix in ("uniform", "half"):
            for j, k in enumerate(ROUTE_KEYS):
                keys, vals = pairs(400 + j, 1 << 22, d, k, mix)
                zero = torch.zeros((k, d), device="cuda")
                routes.append({
                    "k": k, "d": d, "keys": mix,
                    "combine_scatter_ms": events_ms(
                        lambda: ops.combine_scatter(keys, vals, k, "add")),
                    "sort_segment_fold_ms": events_ms(
                        lambda: ops.sort_segment_fold(keys, vals, zero,
                                                      "add"))})

    pts, assign, _ = datasets.kmeans_data(np.random.default_rng(1),
                                          points=1 << 24)
    items = (torch.from_numpy(assign).cuda(), torch.from_numpy(pts).cuda())
    paths = {}
    for label, flow, impl in PATHS:
        mr = (MapReduce(apps.KMeans()) if flow == "auto" else
              MapReduce(apps.KMeans(), flow=flow, combine_impl=impl))
        for _ in range(3):
            mr.run(items)
        torch.cuda.synchronize()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            mr.run(items)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        paths[label] = {"wall_ms_median": statistics.median(walls),
                        "wall_ms_min": min(walls),
                        "device_ms": device_ms(lambda: mr.run(items))}
    return {"root": str(root), "rows": rows, "routes": routes,
            "paths": paths}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the parent checkout (holds src/)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.iters)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_keyed_fold: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    runs = {"parent": [], "tree": []}
    for which in ("parent", "tree", "tree", "parent"):
        root = args.parent.resolve() if which == "parent" else TREE
        out = subprocess.run(
            [sys.executable, __file__, "--parent", str(args.parent),
             "--iters", str(args.iters), "--worker", str(root)],
            capture_output=True, text=True, check=False)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return 1
        runs[which].append(json.loads(out.stdout.strip().splitlines()[-1]))
    rows, ok = [], True
    for i, (label, entry, n, d, k, op, mix) in enumerate(SHAPES):
        digests = {w: {r["rows"][i]["digest"] for r in runs[w]}
                   for w in runs}
        repeat = all(len(v) == 1 for v in digests.values())
        same = len(digests["parent"] | digests["tree"]) == 1
        ok &= repeat and (same or (op == "add"
                                   and entry != "onehot_fold_counts"))
        rows.append({"shape": label, "n": n, "d": d, "k": k, "op": op,
                     "keys": mix, "runs_repeat": repeat,
                     "same_as_parent": same,
                     **{f"{w}_graph_ms": [r["rows"][i]["graph_ms"]
                                          for r in runs[w]] for w in runs}})
    routes = []
    for i, cell in enumerate(runs["tree"][0]["routes"]):
        routes.append({"k": cell["k"], "d": cell["d"], "keys": cell["keys"],
                       **{f"{w}_{key}": [r["routes"][i][key]
                                         for r in runs[w]]
                          for w in runs for key in ("combine_scatter_ms",
                                                    "sort_segment_fold_ms")}})
    paths = {label: {w: [r["paths"][label] for r in runs[w]] for w in runs}
             for label, *_ in PATHS}
    print(json.dumps({"ab_keyed_fold": {
        "card": card, "iters": args.iters, "rows": rows, "routes": routes,
        "paths": paths}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
