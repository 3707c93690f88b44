#!/usr/bin/env python3
"""Design variants of the ``int_fold`` kernel on the card, side by side.

    python3 tools/ab_int_fold.py            # from the repository root

Builds ``src/repro_torch/kernels/csrc/int_fold.cu`` as it stands
(``tree``) and variants made from it by text substitution, each into its
own library under ``build/ab_int_fold/``:

* ``redux``: each key group's sum by ``__reduce_add_sync`` over 16-bit
  limbs under the group's lane mask, in place of the pointer jumping;
* ``shared64``: the shared-memory rows as 64-bit cells added with
  ``atomicAdd`` on ``unsigned long long``, in place of two 32-bit words;
* ``redux_shared64``: both;
* ``unroll8``: rounds of 8 warp tiles (``kUnroll``) instead of 4;
* ``base``, with ``--base FILE``: an earlier ``int_fold.cu`` as it is
  (``git show <commit>:src/repro_torch/kernels/csrc/int_fold.cu``).

Each library runs in a process of its own (two libraries with the same
kernel names in one process are not taken), in the order tree, base,
variants, base, tree: at each shape of :data:`SHAPES` its tables and counts must equal
``int_fold_plain``'s bit for bit, then it is timed from a CUDA graph of
``--iters`` calls and by CUDA events.  Prints one JSON line a process
and a table; needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: (label, pairs, D, K, key mix, row dtype): the main path's shapes
SHAPES = (("wordcount", 1 << 22, 1, 1 << 16, "zipf", "int64"),
          ("wordcount_int32", 1 << 22, 1, 1 << 16, "zipf", "int32"),
          ("histogram", 1 << 22, 1, 768, "uniform", "int64"),
          ("counts_k100", 1 << 22, 0, 100, "uniform", "int64"))

_GROUP_SUM_CALL = "const unsigned long long s = group_sum(v, next, steps);"
_REDUX = r'''
__device__ __forceinline__ unsigned long long redux_sum(unsigned peers,
                                                        long long v) {
  const unsigned long long u = (unsigned long long)v;
  unsigned long long s = 0;
#pragma unroll
  for (int limb = 0; limb < 4; ++limb) {
    const unsigned part = (unsigned)(u >> (16 * limb)) & 0xffffu;
    s += (unsigned long long)__reduce_add_sync(peers, part) << (16 * limb);
  }
  return s;
}

'''
_SHARED_ADD = "shared_add64(stab + ((size_t)kk * d + c) * 2, s);"
_SHARED_ADD64 = ("atomicAdd((unsigned long long*)(stab + ((size_t)kk * d + c)"
                 " * 2), s);")
_KERNEL_HEAD = "template <typename T, bool CNT>\n__global__"
_UNROLL = "constexpr int kUnroll = 4;"
VARIANTS = ("tree", "redux", "shared64", "redux_shared64", "unroll8")


def variant_source(name: str, src: str) -> str:
    """The kernel's source with ``name``'s substitutions."""
    for target in (_KERNEL_HEAD, _GROUP_SUM_CALL, _SHARED_ADD, _UNROLL):
        if src.count(target) != 1:
            raise RuntimeError(f"int_fold.cu no longer holds {target!r} "
                               f"once; update the variants")
    if "redux" in name:  # every lane in one ballot, then its group's mask
        src = src.replace(_KERNEL_HEAD, _REDUX + _KERNEL_HEAD)
        src = src.replace(_GROUP_SUM_CALL, (
            "const unsigned invalid = ~__ballot_sync(kFull, ok);\n"
            "          const unsigned long long s = redux_sum(ok ? peers : "
            "invalid, (long long)v);"))
    if "shared64" in name:
        src = src.replace(_SHARED_ADD, _SHARED_ADD64)
    if name == "unroll8":
        src = src.replace(_UNROLL, "constexpr int kUnroll = 8;")
    return src


def build(out_dir: Path, base: Path | None = None) -> dict[str, Path]:
    """One library a variant (and ``base``), nvcc all at once."""
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "int_fold.cu").read_text()
    sources = {name: variant_source(name, src) for name in VARIANTS}
    if base is not None:
        sources["base"] = base.read_text()
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"int_fold_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libint_fold_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{out.decode()}")
        libs[name] = lib
    return libs


def child(name: str, lib_path: str, iters: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.int_fold import int_fold_plain

    lib = ctypes.CDLL(lib_path)
    lib.int_fold_launch.argtypes = _build._ARGTYPES["int_fold"]
    lib.int_fold_launch.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    out = {"variant": name, "shapes": {}}
    for label, n, d, k, mix, dt in SHAPES:
        keys = ((rng.zipf(1.2, n) % k) if mix == "zipf"
                else rng.integers(0, k, n)).astype(np.int32)
        rows = rng.integers(-1000, 1000, (n, d)).astype(dt)
        table = rng.integers(-2**40, 2**40, (k, d)).astype(np.int64)
        counts = rng.integers(0, 1000, k).astype(np.int32)
        keys, rows, table, counts = (torch.from_numpy(a).cuda() for a in
                                     (keys, rows, table, counts))

        def call():
            t, c = torch.empty_like(table), torch.empty_like(counts)
            err = lib.int_fold_launch(
                keys.data_ptr(), rows.data_ptr(),
                int(rows.dtype == torch.int64), table.data_ptr(),
                t.data_ptr(), counts.data_ptr(), c.data_ptr(), n, d, k,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} {label}: CUDA error {err}")
            return t, c

        got, want = call(), int_fold_plain(keys, rows, table, counts)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        if not same:
            raise AssertionError(f"{name} {label}: != int_fold_plain")
        call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                call()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        graph_ms = start.elapsed_time(stop) / iters
        start.record()
        for _ in range(iters):
            call()
        stop.record()
        torch.cuda.synchronize()
        out["shapes"][label] = {"graph_ms": graph_ms,
                                "event_ms": start.elapsed_time(stop) / iters,
                                "equal_plain": same}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--base", type=Path, default=None,
                    help="an earlier int_fold.cu to time beside the tree")
    ap.add_argument("--child", nargs=2, metavar=("VARIANT", "LIB"))
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(*args.child, args.iters)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_int_fold: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = build(ROOT / "build" / "ab_int_fold", args.base)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = []
    order = ["tree", *VARIANTS[1:], "tree"]
    if args.base is not None:
        order[1:1], order[-1:-1] = ["base"], ["base"]
    for name in order:
        proc = subprocess.run([sys.executable, __file__, "--child", name,
                               str(libs[name]), "--iters", str(args.iters)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, flush=True)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({"card": card, **runs[-1]}), flush=True)
    print(f"{'variant':<16}" + "".join(f"{s[0]:>18}" for s in SHAPES))
    for run in runs:
        print(f"{run['variant']:<16}" + "".join(
            f"{run['shapes'][s[0]]['graph_ms']:>18.4f}" for s in SHAPES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
