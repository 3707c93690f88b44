#!/usr/bin/env python3
"""A stream job's chunk loop replayed from a CUDA graph against the eager
loop, in one process on one CUDA card.

    python3 tools/chunk_graph_ab.py [--cases uv,hg] [--sets 6] [--jobs 10]
                                    [--traffic same|turns] [--src DIR]

Two cases, each at its benchmark size: ``uv`` is the uv.sourceip cell's
job (``KeyedSum`` over 155,000,000 records into 2,500,000 groups, 37
chunks of 2^22 pairs), ``hg`` Phoenix 2's ``histogram`` on ``large.bmp``
(466,666,666 pixels of three uint8 channels held as int32, 334 chunks).
Each case compiles two runs: one held to the eager loop, one left to
itself, which captures its loop on its second call over the same items
and replays it after.  ``--traffic same`` gives every job the same items
(a column store queried again); ``--traffic turns`` gives each run the
items and a copy of them in turn, so no job repeats the items of the one
before and the loop is never captured (new items each query).  The two
runs must give the same bits.  Then ``--sets`` sets of ``--jobs`` jobs of
each run, in turns (eager, graph, graph, eager, ...), each job ended by a
synchronize; a set's job time is its median, and a side's spread the
distance between the quartiles of its sets' times over their median.
``--src`` imports ``repro_torch`` from ``DIR/src`` (another checkout, such
as the parent commit's, whose runs both take the path it has).  It prints
the card's name and power limit and one JSON line a case: the sides' set
times, spreads, the capture's seconds and pool, and for each side a job's
host syncs (with where they happened), counters, the memory it reserves
beyond an emptied cache and the most it allocates beyond what it finds.
Exits 1 where the bits differ.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

COUNTERS = ("runs", "chunks", "pairs", "fold_pairs", "fold_scans",
            "fold_partitioned", "launches.onehot_fold", "launches.int_fold",
            "loop_captures", "loop_replays", "loop_fallbacks")


def items_of(case: str, device):
    import torch

    from repro_torch import apps

    g = torch.Generator(device=device).manual_seed(1)
    if case == "uv":
        n, k = 155_000_000, 2_500_000
        keys = torch.randint(0, k, (n,), device=device, generator=g,
                             dtype=torch.int32).view(-1, 8)
        vals = torch.empty(n, device=device).uniform_(0, 1, generator=g)
        return apps.KeyedSum(k), (keys, vals.view(-1, 8))
    if case == "hg":
        px = torch.randint(0, 256, (466_666_666, 3), device=device,
                           generator=g, dtype=torch.int32)
        return apps.Histogram(), px
    raise ValueError(case)


def spread(xs: list[float]) -> float:
    q = statistics.quantiles(xs, n=4)
    return (q[2] - q[0]) / statistics.median(xs)


def in_turn(items, traffic: str):
    """The items of each job of one run: the same every time, or the
    items and a copy of them in turn."""
    if traffic == "same":
        return lambda: items
    copies = (items, tuple(t.clone() for t in items)
              if isinstance(items, tuple) else items.clone())
    turn = [0]

    def next_items():
        turn[0] ^= 1
        return copies[turn[0]]
    return next_items


def one_case(case: str, sets: int, jobs: int, traffic: str) -> dict:
    import torch

    from portbench import syncs
    from repro_torch import spans
    from repro_torch.core import ExecutionOptions, MapReduce

    dev = torch.device("cuda")
    app, items = items_of(case, dev)
    opts = ExecutionOptions(cache=False)
    # the copies first: a copy made after a compile could take the address
    # of its warm-up's zeros, freed by then, and so repeat its key
    feeds = {side: in_turn(items, traffic) for side in ("eager", "graph")}
    comps = {}
    for side in ("eager", "graph"):
        mr = MapReduce(app, device=dev, cache=False)
        comps[side] = mr.lower(items, options=opts).compile()
    comps["eager"]._entry.executable._no_capture = "held eager"
    graph_run = comps["graph"]._entry.executable

    def job(side):
        res = comps[side](feeds[side]())
        torch.cuda.synchronize()
        return res

    job("graph")  # a first call over the items: eager
    t0 = time.perf_counter()
    got = job("graph")  # the capture, where the items repeat
    capture_s = time.perf_counter() - t0
    want = job("eager")
    same = all(torch.equal(a, b) for a, b in zip(
        (got.keys, got.values, got.counts),
        (want.keys, want.values, want.counts)))
    del got, want
    held = getattr(graph_run, "captured", None)
    out = {"case": case, "traffic": traffic, "same_bits": same,
           "second_call_s": capture_s,
           "pool_bytes": getattr(held, "pool_bytes", None),
           "graph_path": getattr(graph_run, "loop_path", None),
           "explain_loop": [ln for ln in comps["graph"].explain().splitlines()
                            if ln.startswith(("loop:", "lowering:"))]}
    for side in ("eager", "graph"):
        # what a job reserves beyond the cache it finds emptied, and the
        # most it allocates beyond what it finds (the benchmark's
        # job_peak_gib); the graph's pool is held throughout
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = {n: spans.total(n) for n in COUNTERS}
        job(side)
        out[f"{side}_counters"] = {n: spans.total(n) - v
                                   for n, v in before.items()}
        out[f"{side}_job_reserved_bytes"] = (torch.cuda.memory_reserved()
                                             - reserved)
        out[f"{side}_job_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                         - base)
        out[f"{side}_syncs"] = syncs.host_syncs(lambda s=side: job(s))
    times = {"eager": [], "graph": []}
    for i in range(sets):
        for side in (("eager", "graph") if i % 2 == 0 else
                     ("graph", "eager")):
            lat = []
            for _ in range(jobs):
                t = time.perf_counter()
                job(side)
                lat.append((time.perf_counter() - t) * 1e3)
            times[side].append(statistics.median(lat))
    for side, xs in times.items():
        out[f"{side}_set_ms"] = xs
        out[f"{side}_median_ms"] = statistics.median(xs)
        out[f"{side}_spread"] = spread(xs) if len(xs) > 1 else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="uv,hg")
    ap.add_argument("--sets", type=int, default=6)
    ap.add_argument("--jobs", type=int, default=10)
    ap.add_argument("--traffic", choices=("same", "turns"), default="same")
    ap.add_argument("--src", type=Path, default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve() / "src"))
    import torch
    from ab_radix_partition import card_line

    if not torch.cuda.is_available():
        print("no CUDA card: this A/B runs only on one", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    ok = True
    for case in args.cases.split(","):
        row = one_case(case, args.sets, args.jobs, args.traffic)
        row["src"] = str(args.src)
        ok &= row["same_bits"]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
