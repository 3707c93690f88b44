#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

Phases (each raises on failure, and the script then exits non-zero):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (into ``build/repro_torch/``), one
   nvcc per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones: max/min bit for bit (NaN and
   signed zeros included), sums within 1e-5 of each key's sum of absolute
   values, and two runs of each kernel bit for bit.  The sort flow's
   kernels too: the radix partitions' layouts bit for bit (keys, starts,
   values at real slots), the hierarchy's leaf layout equal to the
   one-level partition's, and segment_reduce on those layouts, with
   ragged sizes, a key space that is no multiple of the bucket, sentinel
   and out-of-range keys, and pad_align 8, 16 and 256;
3. main path, additive: ``MapReduce(KMeans()).run`` on 2^24 points of the
   Phoenix kmeans shape (3 dimensions, 100 means); the plan must be the
   stream flow with a derived monoid, ``onehot_fold`` must have launched,
   the counts must equal ``np.bincount`` and the centroids a float64 numpy
   reference (rtol = atol = 1e-5);
4. main path, dense: the bounding-box (max/min) app on the same points;
   ``chunk_monoid_fold`` must have launched and the boxes must equal
   numpy's per-key max/min bit for bit; then the seven Phoenix apps, on
   small inputs, must give on the card what they give on the CPU;
5. the sort flow's main paths: ``MapReduce(KeyedSum(K), flow="sort").run``
   on 2^24 pairs (2^21 items of 8 keys, f32 weights drawn from a seed) at
   K = 2^18 (one radix level) and K = 2^20 (two levels);
   ``radix_partition`` or ``radix_partition_multi``, and
   ``segment_reduce``, must have launched, the counts must equal
   ``np.bincount`` and the sums a float64 numpy reference (rtol = atol =
   1e-5); then the seven Phoenix apps under ``flow="sort"``, card == CPU;
6. time each kernel, its plain version and one PyTorch library call at the
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
SORT_ITEMS = 1 << 21  # KeyedSum: 8 keys per item, 2^24 pairs
SORT_KEY_SPACES = (1 << 18, 1 << 20)  # one radix level; two levels
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


def phoenix_on_card(flow: str = "auto") -> None:
    """Phases 4b and 5b: the seven Phoenix apps (small inputs) on the card
    equal the same runs on the CPU — integer results and counts exactly,
    float sums within rtol = atol = 1e-5 (another summation order)."""
    from repro_torch import MapReduce, apps

    for name in apps.ALL:
        app, items = apps.build(name, np.random.default_rng(2), scale=0.05)
        card = MapReduce(app, flow=flow).run(items)
        host = MapReduce(app, flow=flow, device="cpu").run(items)
        if not np.array_equal(card.counts.cpu().numpy(),
                              host.counts.numpy()):
            raise AssertionError(f"{name}: counts differ card vs CPU")
        got, want = card.values.cpu().numpy(), host.values.numpy()
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    log(f"Phoenix apps (flow={flow}) on the card == on the CPU: "
        f"{', '.join(apps.ALL)}")


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


# -- the sort flow -----------------------------------------------------------


def sort_pairs(rng, n, d, k, *, specials: bool):
    """Keys in [0, K) with sentinel (K), keys past the last bucket and
    negative keys mixed in; f32 values (NaN and signed zeros with
    ``specials``)."""
    import torch
    keys = rng.integers(0, k, size=n).astype(np.int32)
    bad = rng.random(n) < 0.1
    keys[bad] = rng.choice(np.array([k, k + 3, 2 * k + 5, -1, -7], np.int32),
                           size=int(bad.sum()))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    if specials:
        flat = vals.reshape(-1)
        p = rng.random(flat.size)
        flat[p < 0.1] = 0.0
        flat[(p >= 0.1) & (p < 0.2)] = -0.0
        flat[(p >= 0.2) & (p < 0.201)] = np.nan
    return torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()


def same_layout(got, want, k, what):
    """pkeys and starts bit for bit, values bit for bit at real slots."""
    import torch
    gk, gv, gs = got
    wk, wv, ws = want
    if not torch.equal(gs, ws):
        raise AssertionError(f"{what}: starts differ")
    if not torch.equal(gk, wk):
        raise AssertionError(f"{what}: keys differ at "
                             f"{int((gk != wk).sum())} slots")
    real = wk < k
    if not torch.equal(bits(gv[real]), bits(wv[real])):
        raise AssertionError(f"{what}: values differ at real slots")


def check_sort_kernels(rng) -> None:
    """Phase 2, sort flow: radix_partition, radix_partition_multi and
    segment_reduce against their plain versions on the card."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.radix_partition import (
        radix_partition_multi_plain, radix_partition_plain)
    from repro_torch.kernels.segment_reduce import segment_reduce_plain

    def twice(fn, what):
        a, b = fn(), fn()
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if not torch.equal(bits(x) if x.is_floating_point() else x,
                               bits(y) if y.is_floating_point() else y):
                raise AssertionError(f"{what}: two runs differ")
        return a

    def check_reduce(pk, pv, k, bs, pa, label):
        for op in ("add", "max", "min"):
            specials = op != "add"
            if specials:  # the same layout, values with NaN and zeros
                pv = pv.clone()
                flat = pv.view(-1)
                p = torch.rand(flat.numel(), device=flat.device)
                flat[p < 0.1] = 0.0
                flat[(p >= 0.1) & (p < 0.2)] = -0.0
                flat[(p >= 0.2) & (p < 0.201)] = float("nan")
            acc = torch.randn((k, pv.shape[1]), device=pv.device)
            got = twice(lambda: ops.segment_reduce(pk, pv, k, op, tile_n=pa,
                                                   block_k=bs),
                        f"segment_reduce {op} ({label})")
            want = segment_reduce_plain(pk, pv, k, op)
            folded = twice(lambda: ops.segment_reduce(
                pk, pv, k, op, tile_n=pa, block_k=bs, acc=acc),
                f"segment_reduce {op} + acc ({label})")
            if op == "add":
                tol = SUM_RTOL * segment_reduce_plain(pk, pv.abs(), k, op) \
                    + 1e-6
                err = (got - want).abs()
                err_f = (folded - (acc + want)).abs()
                if not bool((err <= tol).all()) or not bool(
                        (err_f <= tol + SUM_RTOL * acc.abs()).all()):
                    raise AssertionError(
                        f"segment_reduce add != plain ({label}): max abs "
                        f"err {err.max().item()}")
            else:
                from repro_torch import numerics
                f = numerics.maximum if op == "max" else numerics.minimum
                if not torch.equal(bits(got), bits(want)) or not torch.equal(
                        bits(folded), bits(f(acc, want))):
                    raise AssertionError(
                        f"segment_reduce {op} != plain bitwise ({label})")

    one_level = [  # (n, d, k, bucket_size, pad_align, label)
        (CUDA_CHUNK_PAIRS, 2, 1 << 18, 8192, 256,
         "main path (KeyedSum K=2^18 [K, 1+1])"),
        (1_000_003, 3, 100_000, 4096, 16, "ragged, K % bucket != 0"),
        (5_001, 1, 1000, 64, 16, "small buckets"),
        (777, 2, 300, 300, 16, "one bucket"),
        (3, 2, 50, 16, 256, "fewer pairs than a tile"),
    ]
    for n, d, k, bs, pa, label in one_level:
        keys, vals = sort_pairs(rng, n, d, k, specials=False)
        got = twice(lambda: ops.radix_partition(keys, vals, k,
                                                bucket_size=bs, pad_align=pa),
                    f"radix_partition ({label})")
        want = radix_partition_plain(keys, vals, k, bucket_size=bs,
                                     pad_align=pa)
        same_layout(got, want, k, f"radix_partition ({label})")
        check_reduce(got[0], got[1], k, bs, pa, label)
        log(f"radix_partition + segment_reduce == plain: {label} n={n} "
            f"d={d} k={k} bucket={bs} pad={pa}")

    multi = [  # (n, d, k, bucket_size, fanouts, pad_align, label)
        (CUDA_CHUNK_PAIRS, 2, 1 << 20, 16384, (8, 8), 256,
         "main path (KeyedSum K=2^20 [K, 1+1])"),
        (200_001, 3, 100, 8, (4, 4), 16, "cover > K"),
        (500_000, 2, 1000, 16, (4, 4, 4), 16, "three levels"),
        (333_333, 1, 2000, 64, (8, 4), 256, "uneven fan-outs"),
        (1, 1, 13, 4, (2, 2), 8, "one pair, pad 8 (the reference's C.1)"),
    ]
    for n, d, k, bs, fan, pa, label in multi:
        keys, vals = sort_pairs(rng, n, d, k, specials=False)
        got = twice(lambda: ops.radix_partition(
            keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa),
            f"radix_partition_multi ({label})")
        same_layout(got, radix_partition_multi_plain(
            keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa), k,
            f"radix_partition_multi ({label})")
        same_layout(got, ops.radix_partition(keys, vals, k, bucket_size=bs,
                                             pad_align=pa), k,
                    f"radix_partition_multi vs one level ({label})")
        check_reduce(got[0], got[1], k, bs, pa, label)
        log(f"radix_partition_multi == plain == one level: {label} n={n} "
            f"d={d} k={k} bucket={bs} fanouts={fan} pad={pa}")

    keys, vals = sort_pairs(rng, 100_000, 2, 5000, specials=False)
    skeys, order = torch.sort(keys)
    svals = vals[order].contiguous()
    for op in ("max", "min"):
        got = ops.segment_reduce(skeys, svals, 5000, op)
        if not torch.equal(bits(got), bits(segment_reduce_plain(
                skeys, svals, 5000, op))):
            raise AssertionError(f"segment_reduce {op} on a sorted stream")
    log("segment_reduce on a key-sorted stream (block_k from the keys) == "
        "plain")


def sort_items(key_space: int):
    """(items on the card, flat keys, flat weights) of the KeyedSum app."""
    import torch
    from repro_torch.data import datasets
    keys, weights = datasets.keyed_sum_data(
        np.random.default_rng(3), items=SORT_ITEMS, key_space=key_space)
    items = (torch.from_numpy(keys).cuda(), torch.from_numpy(weights).cuda())
    return items, keys.reshape(-1), weights.reshape(-1)


def main_path_sort(key_space: int):
    """Phase 5: the sort flow on 2^24 pairs at one key space."""
    import torch
    from repro_torch import MapReduce, apps
    from repro_torch.kernels import ops

    mr = MapReduce(apps.KeyedSum(key_space), flow="sort")
    levels = 1 if key_space == SORT_KEY_SPACES[0] else 2
    partition = "radix_partition" if levels == 1 else "radix_partition_multi"
    t = mr.tiling
    if (mr.plan.flow, t.levels, t.use_kernel) != ("sort", levels, True):
        raise AssertionError(f"unexpected plan:\n{mr.explain()}")
    items, keys, weights = sort_items(key_space)
    ops.reset_launch_counts()
    res = mr.run(items)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches[partition] <= 0 or launches["segment_reduce"] <= 0:
        raise AssertionError(f"{partition} / segment_reduce never "
                             f"launched: {launches}")
    log(mr.explain())
    want_counts = np.bincount(keys, minlength=key_space)
    if not np.array_equal(res.counts.cpu().numpy(), want_counts):
        raise AssertionError(f"KeyedSum K={key_space}: counts != bincount")
    want = np.bincount(keys, weights=weights.astype(np.float64),
                       minlength=key_space)
    got = res.values.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=SUM_RTOL)
    log(f"main path sort: KeyedSum K={key_space} {keys.size} pairs, "
        f"{levels} radix level(s), counts exact, sums max abs err "
        f"{np.abs(got - want).max():.3g}, launches {launches}")
    return mr, items, launches


def sort_kernel_rows(rng, launches) -> list[dict]:
    """Phase 6, sort flow: B3, B4 and B5 at the main paths' shapes."""
    import torch
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS
    from repro_torch.kernels import ops
    from repro_torch.kernels.radix_partition import (
        radix_partition_multi_plain, radix_partition_plain)
    from repro_torch.kernels.segment_reduce import segment_reduce_plain

    n, d, pa = CUDA_CHUNK_PAIRS, 2, 256
    rows = []
    src = "src/repro_torch/kernels/csrc/"
    for name, k, bs, fan in (("radix_partition", 1 << 18, 8192, ()),
                             ("radix_partition_multi", 1 << 20, 16384,
                              (8, 8))):
        keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda")
        vals = torch.rand((n, d), device="cuda")
        kern = lambda: ops.radix_partition(  # noqa: E731
            keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa)
        if fan:
            plain = lambda: radix_partition_multi_plain(  # noqa: E731
                keys, vals, k, bucket_size=bs, fanouts=fan, pad_align=pa)
        else:
            plain = lambda: radix_partition_plain(  # noqa: E731
                keys, vals, k, bucket_size=bs, pad_align=pa)

        def lib():
            order = torch.argsort(keys // bs, stable=True)
            return keys[order], vals[order]

        got, want = kern(), plain()
        same_layout(got, want, k, name)
        real = want[0] < k
        err = (got[1][real] - want[1][real]).abs().max().item()
        np_ = got[0].shape[0]
        nbytes = n * (4 + 4 * d) + np_ * (4 + 4 * d) + got[2].numel() * 4
        ms = time_ms(kern, 20)
        rows.append({
            "name": name, "route": "cuda", "source": src + name + ".cu",
            "replaces": ("src/repro/kernels/radix_partition.py:189"
                         if not fan else
                         "src/repro/kernels/radix_partition.py:268"),
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": time_ms(plain, 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(lib, 20),
            "shape": {"n": n, "d": d, "k": k, "bucket_size": bs,
                      "fanouts": list(fan), "pad_align": pa, "slots": np_},
        })
    k, bs = 1 << 18, 8192
    keys = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda")
    vals = torch.rand((n, d), device="cuda")
    pk, pv, _ = ops.radix_partition(keys, vals, k, bucket_size=bs,
                                    pad_align=pa)
    acc = torch.rand((k, d), device="cuda")
    kern = lambda: ops.segment_reduce(  # noqa: E731
        pk, pv, k, "add", tile_n=pa, block_k=bs, acc=acc)
    plain = lambda: acc + segment_reduce_plain(pk, pv, k, "add")  # noqa
    pk64 = pk.long()
    lib = lambda: torch.cat([acc, torch.zeros((1, d), device="cuda")]  # noqa
                            ).index_add_(0, pk64, pv)[:k]
    err = (kern() - plain()).abs().max().item()
    np_ = pk.shape[0]
    nbytes = np_ * (4 + 4 * d) + 2 * k * d * 4
    ms = time_ms(kern, 20)
    rows.append({
        "name": "segment_reduce", "route": "cuda",
        "source": src + "segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:152",
        "launches": launches["segment_reduce"], "max_abs_err": err,
        "ms": ms, "kernel_ms": ms, "plain_ms": time_ms(plain, 5),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(lib, 20),
        "shape": {"slots": np_, "d": d, "k": k, "block_k": bs, "tile": pa,
                  "op": "add", "with_acc": True},
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
    check_sort_kernels(rng)

    pts, assign, clusters = datasets.kmeans_data(
        np.random.default_rng(1), points=N_POINTS)
    assert clusters == 100
    mr_add, items, launches_add = main_path_additive(pts, assign)
    mr_dense, launches_dense = main_path_dense(pts, assign, items)
    phoenix_on_card()
    sort_runs = {k: main_path_sort(k) for k in SORT_KEY_SPACES}
    phoenix_on_card("sort")

    rows = kernel_rows(rng, launches_add, launches_dense)
    launches_sort = {name: sum(run[2][name] for run in sort_runs.values())
                     for name in ("radix_partition", "radix_partition_multi",
                                  "segment_reduce")}
    rows += sort_kernel_rows(rng, launches_sort)
    main_ms = {"kmeans_ms": run_ms(mr_add, items),
               "bounding_box_ms": run_ms(mr_dense, items),
               "points": N_POINTS, "card": card}
    for k, (mr, sitems, _) in sort_runs.items():
        main_ms[f"keyed_sum_K{k}_ms"] = run_ms(mr, sitems)
    main_ms["sort_pairs"] = SORT_ITEMS * 8
    log(json.dumps({"main_path": main_ms}))
    for label, mr in (("kmeans", mr_add), ("bounding_box", mr_dense)):
        log(json.dumps({"profile": label,
                        **profile(mr, items, main_ms[f"{label}_ms"])}))
    for k, (mr, sitems, _) in sort_runs.items():
        label = f"keyed_sum_K{k}"
        log(json.dumps({"profile": label,
                        **profile(mr, sitems, main_ms[f"{label}_ms"])}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
