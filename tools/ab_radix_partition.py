#!/usr/bin/env python3
"""Same-call A/B of the radix partition (B3, B4) between two checkouts of
the port on one CUDA card.

    git archive <commit> | tar -x -C build/ab_parent
    python3 tools/ab_radix_partition.py --parent build/ab_parent

Both sides are driven through their public entry points only
(``ops.radix_partition`` and ``MapReduce.run``), each from its own checkout
(its kernels built into that checkout's ``build/``), so any commit of the
port can be the parent.  The script runs parent, tree, tree, parent, a
process each (two libraries with the same kernel names in one process fail
to launch).  Per process it records, for each of :data:`SHAPES`, the
partition's time from a CUDA graph of ``--iters`` calls, a digest of its
layout (keys, starts, values at real slots) and the host time of one call
(the call alone, queued behind a sleeping kernel); and for each of the
main paths that run the partition (:data:`PATHS`) the median and fastest
wall time of a run and the device time of one run (torch.profiler).  It prints the card's name
and power limit and one JSON line, and exits 1 if the layouts differ.
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

TREE = Path(__file__).resolve().parents[1]

#: (label, pairs, D, key space, bucket_size, fan-outs); pad_align 256
SHAPES = (
    ("B3 KeyedSum K=2^18", 1 << 22, 2, 1 << 18, 8192, ()),
    ("B4 KeyedSum K=2^20 (8, 8)", 1 << 22, 2, 1 << 20, 16384, (8, 8)),
    ("B3 BoundingBox combine, D=1", 1 << 24, 1, 100, 100, ()),
    ("B3 BoundingBox combine, D=3", 1 << 24, 3, 100, 100, ()),
    ("B3 KeyedSum combine K=2^16", 1 << 22, 1, 1 << 16, 2048, ()),
    ("B4 K=2^25 (16, 16, 8)", 1 << 22, 2, 1 << 25, 16384, (16, 16, 8)),
)
PAD = 256
#: the KeyedSum main paths that run the partition, as chip_smoke.py runs
#: them: (label, key space, flow, items of 8 pairs, data seed)
PATHS = (
    ("KeyedSum K=2^16 combine", 1 << 16, "combine", 1 << 19, 4),
    ("KeyedSum K=2^18 sort", 1 << 18, "sort", 1 << 21, 3),
    ("KeyedSum K=2^20 sort", 1 << 20, "sort", 1 << 21, 3),
)


def graph_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` replayed from a CUDA graph."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_us(fn, reps: int = 50) -> float:
    """Median host microseconds of one call of ``fn``, each queued behind a
    sleeping kernel so that no call waits for the device."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn) -> float:
    """Device time of one call of ``fn`` (torch.profiler's kernels,
    copies and memsets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def worker(root: Path, iters: int) -> dict:
    """One checkout's numbers; ``root`` holds its ``src/``."""
    sys.path.insert(0, str(root / "src"))
    import warnings

    import numpy as np
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.data import datasets
    from repro_torch.kernels import ops

    rows = []
    for i, (label, n, d, k, bs, fan) in enumerate(SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda",
                             generator=gen)
        vals = torch.rand((n, d), device="cuda", generator=gen)

        def fn():
            return ops.radix_partition(keys, vals, k, bucket_size=bs,
                                       fanouts=fan, pad_align=PAD)
        pk, pv, st = fn()
        h = hashlib.sha256()
        for t in (pk, st, pv[pk < k]):
            h.update(t.contiguous().cpu().numpy().tobytes())
        rows.append({"shape": label, "digest": h.hexdigest()[:16],
                     "graph_ms": graph_ms(fn, iters),
                     "host_us": host_us(fn)})
        del pk, pv, st

    paths = {}
    for label, k, flow, n_items, seed in PATHS:
        mr = MapReduce(apps.KeyedSum(k), flow=flow)
        keys, weights = datasets.keyed_sum_data(
            np.random.default_rng(seed), items=n_items, key_space=k)
        items = (torch.from_numpy(keys).cuda(),
                 torch.from_numpy(weights).cuda())
        walls = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for _ in range(3):
                mr.run(items)
            torch.cuda.synchronize()
            for _ in range(20):
                t0 = time.perf_counter()
                mr.run(items)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            dev = device_ms(lambda: mr.run(items))
        paths[label] = {"wall_ms_median": statistics.median(walls),
                        "wall_ms_min": min(walls), "device_ms": dev}
    return {"root": str(root), "rows": rows, "paths": paths}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


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
        print("ab_radix_partition: no CUDA device", file=sys.stderr)
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
    rows, same = [], True
    for i, (label, n, d, k, bs, fan) in enumerate(SHAPES):
        digests = {r["rows"][i]["digest"] for v in runs.values() for r in v}
        same &= len(digests) == 1
        rows.append({"shape": label, "n": n, "d": d, "k": k,
                     "fanouts": list(fan), "same_layout": len(digests) == 1,
                     **{f"{w}_{key}": [r["rows"][i][key] for r in runs[w]]
                        for w in runs for key in ("graph_ms", "host_us")}})
    paths = {label: {w: [r["paths"][label] for r in runs[w]] for w in runs}
             for label, *_ in PATHS}
    print(json.dumps({"ab_radix_partition": {
        "card": card, "iters": args.iters, "rows": rows, "paths": paths}}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
