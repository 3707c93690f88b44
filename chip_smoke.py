#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

Phases (each raises on failure, and the script then exits non-zero):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (into ``build/repro_torch/``);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones: max/min bit for bit (NaN and
   signed zeros included), sums within 1e-5 of each key's sum of absolute
   values, and two runs of each kernel bit for bit;
3. main path, additive: ``MapReduce(KMeans()).run`` on 2^24 points of the
   Phoenix kmeans shape (3 dimensions, 100 means); the plan must be the
   stream flow with a derived monoid, ``onehot_fold`` must have launched,
   the counts must equal ``np.bincount`` and the centroids a float64 numpy
   reference (rtol = atol = 1e-5);
4. main path, dense: the bounding-box (max/min) app on the same points;
   ``chunk_monoid_fold`` must have launched and the boxes must equal
   numpy's per-key max/min bit for bit; then the seven Phoenix apps, on
   small inputs, must give on the card what they give on the CPU;
5. time each kernel, its plain version and one PyTorch library call at the
   main path's shapes (CUDA events), each main-path run after warm-up, and
   profile one run of each (device time by kernel, busy share).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' numbers as JSON.  Without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_POINTS = 1 << 24  # Phoenix kmeans: 3 dimensions, 100 means
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SUM_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bits(t):
    import torch
    return t.contiguous().view(torch.int32)


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after a warm-up call."""
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


def fold_inputs(rng, n, d, k, *, specials: bool, bad_keys: bool):
    import torch
    keys = rng.integers(0, k, size=n).astype(np.int32)
    if bad_keys:  # sentinel k and out-of-range keys never land
        bad = rng.random(n) < 0.1
        keys[bad] = rng.choice(np.array([k, k + 3, -1, -7], np.int32),
                               size=int(bad.sum()))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    acc = rng.standard_normal((k, d)).astype(np.float32)
    if specials:
        for arr in (vals, acc):
            flat = arr.reshape(-1)
            p = rng.random(flat.size)
            flat[p < 0.1] = 0.0
            flat[(p >= 0.1) & (p < 0.2)] = -0.0
            flat[(p >= 0.2) & (p < 0.201)] = np.nan
    return tuple(torch.from_numpy(a).cuda() for a in (keys, vals, acc))


def check_kernels(rng) -> None:
    """Phase 2: every kernel against its plain version, on the card."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import onehot_fold_plain
    from repro_torch.kernels.segment_reduce import chunk_monoid_fold_plain

    cases = [  # (n, d, k, block_k, label)
        (CUDA_CHUNK_PAIRS, 4, 100, None, "main path (KMeans fused [K, 3+1])"),
        (CUDA_CHUNK_PAIRS, 3, 100, None, "main path (bounding-box leaf)"),
        (1_000_003, 9, 300, None, "ragged"),
        (5_001, 13, 1000, 96, "block_k not dividing K"),
        (777, 1, 1, None, "one key"),
        (3, 2, 50, 7, "fewer pairs than a tile"),
    ]

    def twice(fn, what):
        a, b = fn(), fn()
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{what}: two runs differ")
        return a

    for n, d, k, block_k, label in cases:
        keys, vals, acc = fold_inputs(rng, n, d, k, specials=False,
                                      bad_keys=True)
        plain = onehot_fold_plain(keys, vals, acc, block_k=block_k)
        # an f32 sum in another order: within SUM_RTOL of sum |terms|
        tol = SUM_RTOL * onehot_fold_plain(keys, vals.abs(), acc.abs()) \
            + SUM_RTOL
        for name, fn in (
                ("onehot_fold", lambda: ops.onehot_fold(
                    keys, vals, acc, block_k=block_k)),
                ("chunk_monoid_fold", lambda: ops.chunk_monoid_fold(
                    keys, vals, acc, "add", block_k=block_k))):
            err = (twice(fn, f"{name} add ({label})") - plain).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"{name} add != plain ({label}): max "
                                     f"abs err {err.max().item()}")
        for op in ("max", "min"):
            keys, vals, acc = fold_inputs(rng, n, d, k, specials=True,
                                          bad_keys=True)
            got = twice(lambda: ops.chunk_monoid_fold(
                keys, vals, acc, op, block_k=block_k),
                f"chunk_monoid_fold {op} ({label})")
            want = chunk_monoid_fold_plain(keys, vals, acc, op)
            if not torch.equal(bits(got), bits(want)):
                diff = (bits(got) != bits(want)).sum().item()
                raise AssertionError(
                    f"chunk_monoid_fold {op} != plain bitwise ({label}): "
                    f"{diff} elements differ")
        log(f"kernels == plain: {label} n={n} d={d} k={k} "
            f"block_k={block_k}")


def main_path_additive(pts, assign):
    """Phase 3."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.kernels import ops

    mr = MapReduce(apps.KMeans())
    plan = mr.plan
    if (plan.flow, plan.derivation.strategy, mr.tiling.mode) != (
            "stream", "monoid", "additive") or not mr.use_kernels:
        raise AssertionError(f"unexpected plan:\n{mr.explain()}")
    items = (torch.from_numpy(assign).cuda(), torch.from_numpy(pts).cuda())
    ops.reset_launch_counts()
    res = mr.run(items)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["onehot_fold"] <= 0:
        raise AssertionError(f"onehot_fold never launched: {launches}")
    log(mr.explain())
    want_counts = np.bincount(assign, minlength=100)
    counts = res.counts.cpu().numpy()
    if not np.array_equal(counts, want_counts):
        raise AssertionError("KMeans counts != np.bincount")
    sums = np.stack([np.bincount(assign, weights=pts[:, j].astype(np.float64),
                                 minlength=100) for j in range(3)], axis=1)
    want = sums / np.maximum(want_counts, 1)[:, None]
    got = res.values.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    log(f"main path additive: KMeans {len(assign)} points, counts exact "
        f"(max {want_counts.max()} per key), centroids max abs err "
        f"{np.abs(got - want).max():.3g}, launches {launches}")
    return mr, items, launches


def main_path_dense(pts, assign, items):
    """Phase 4."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.kernels import ops

    mr = MapReduce(apps.BoundingBox())
    if (mr.plan.flow, mr.tiling.mode) != ("stream", "dense"):
        raise AssertionError(f"unexpected plan:\n{mr.explain()}")
    ops.reset_launch_counts()
    res = mr.run(items)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["chunk_monoid_fold"] <= 0:
        raise AssertionError(f"chunk_monoid_fold never launched: {launches}")
    order = np.argsort(assign, kind="stable")
    starts = np.searchsorted(assign[order], np.arange(100))
    spts = pts[order]
    want = np.concatenate([np.maximum.reduceat(spts, starts, axis=0),
                           np.minimum.reduceat(spts, starts, axis=0)], axis=1)
    got = res.values.cpu().numpy()
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("bounding boxes != numpy per-key max/min")
    log(f"main path dense: bounding boxes bitwise equal to numpy, launches "
        f"{launches}")
    return mr, launches


def phoenix_on_card() -> None:
    """Phase 4b: the seven Phoenix apps (small inputs) on the card equal
    the same runs on the CPU — integer results and counts exactly, float
    sums within rtol = atol = 1e-5 (another summation order)."""
    from repro_torch import MapReduce, apps

    for name in apps.ALL:
        app, items = apps.build(name, np.random.default_rng(2), scale=0.05)
        card = MapReduce(app).run(items)
        host = MapReduce(app, device="cpu").run(items)
        if not np.array_equal(card.counts.cpu().numpy(),
                              host.counts.numpy()):
            raise AssertionError(f"{name}: counts differ card vs CPU")
        got, want = card.values.cpu().numpy(), host.values.numpy()
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    log(f"Phoenix apps on the card == on the CPU: {', '.join(apps.ALL)}")


def kernel_rows(rng, launches_add, launches_dense) -> list[dict]:
    """Phase 5: kernel, plain and library times at the main path's shapes."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.onehot_combine import onehot_fold_plain
    from repro_torch.kernels.segment_reduce import chunk_monoid_fold_plain

    n, k = CUDA_CHUNK_PAIRS, 100
    rows = []
    for name, d, op in (("onehot_fold", 4, "add"),
                        ("chunk_monoid_fold", 3, "max")):
        keys, vals, acc = fold_inputs(rng, n, d, k, specials=False,
                                      bad_keys=False)
        keys64 = keys.long()
        if name == "onehot_fold":
            kern = lambda: ops.onehot_fold(keys, vals, acc)  # noqa: E731
            plain = lambda: onehot_fold_plain(keys, vals, acc)  # noqa: E731
            lib = lambda: acc.index_add(0, keys64, vals)  # noqa: E731
            launches = launches_add[name]
        else:
            idx = keys64[:, None].expand(n, d).contiguous()
            kern = lambda: ops.chunk_monoid_fold(  # noqa: E731
                keys, vals, acc, op)
            plain = lambda: chunk_monoid_fold_plain(  # noqa: E731
                keys, vals, acc, op)
            lib = lambda: acc.scatter_reduce(  # noqa: E731
                0, idx, vals, "amax", include_self=True)
            launches = launches_dense[name]
        err = (kern() - plain()).abs().max().item()
        nbytes = n * (4 + 4 * d) + 2 * k * d * 4
        n_ops = n * d  # one add (or compare) per value
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        ms = time_ms(kern, 20)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": ("src/repro/kernels/onehot_combine.py:69"
                         if name == "onehot_fold"
                         else "src/repro/kernels/segment_reduce.py:102"),
            "launches": launches, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": time_ms(plain, 5),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib, 20),
            "shape": {"n": n, "d": d, "k": k, "op": op},
        })
    return rows


def profile(mr, items, wall_ms: float, top: int = 8) -> dict:
    """Device time of one warm main-path run by kernel (torch.profiler),
    and its share of ``wall_ms``, the run's median wall time measured
    without the profiler (which slows the host side)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    mr.run(items)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        mr.run(items)
        torch.cuda.synchronize()
    # device-side events only: an op's own entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [{"name": name[:80], "ms": ms, "calls": calls}
                    for name, ms, calls in rows[:top]]}


def run_ms(mr, items, reps: int = 3) -> float:
    """Median wall milliseconds of ``mr.run(items)`` after a warm-up run."""
    import torch
    mr.run(items)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        mr.run(items)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data import datasets
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # IEEE f32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)  # name, power limit: as nvidia-smi prints them
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, "
        f"{len(_build.KERNELS)} kernels, into {_build.build_dir()})")

    rng = np.random.default_rng(0)
    check_kernels(rng)

    pts, assign, clusters = datasets.kmeans_data(
        np.random.default_rng(1), points=N_POINTS)
    assert clusters == 100
    mr_add, items, launches_add = main_path_additive(pts, assign)
    mr_dense, launches_dense = main_path_dense(pts, assign, items)
    phoenix_on_card()

    rows = kernel_rows(rng, launches_add, launches_dense)
    main_ms = {"kmeans_ms": run_ms(mr_add, items),
               "bounding_box_ms": run_ms(mr_dense, items),
               "points": N_POINTS, "card": card}
    log(json.dumps({"main_path": main_ms}))
    for label, mr in (("kmeans", mr_add), ("bounding_box", mr_dense)):
        log(json.dumps({"profile": label,
                        **profile(mr, items, main_ms[f"{label}_ms"])}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
