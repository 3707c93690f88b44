"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/lib<name>-<digest>.so`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` moves it), the first time a kernel is launched or
when :func:`build` is called.  The digest covers the sources and the flags,
so an edited kernel is rebuilt and never confused with an old library.  The
sources have a plain C interface and include no PyTorch header, so a build
takes seconds.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch import spans

CSRC = Path(__file__).resolve().parent / "csrc"

#: one shared library per source; each maps to its launch function's name.
LIBRARIES = ("onehot_fold", "chunk_monoid_fold", "radix_partition",
             "segment_reduce", "onehot_combine", "combine_scatter",
             "flash_decode", "int_fold")

#: the kernels whose launches are counted: each library's, and
#: radix_partition_multi, the hierarchy's partition, which the
#: radix_partition library launches
KERNELS = LIBRARIES[:3] + ("radix_partition_multi",) + LIBRARIES[3:]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: argument types of each ``<name>_launch``; every pointer and the stream are
#: c_void_p so that ctypes passes them at full width.  The keyed folds end
#: with their route's arguments (``ops.FoldPlan.route_args``: the
#: partition's passes, their count, the scratch's bytes, and the segments
#: of the partitioned route's fold).
_ROUTE = [_P, _I, _L, _I, _I]
_ARGTYPES = {
    "onehot_fold": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, *_ROUTE, _P],
    "chunk_monoid_fold": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, *_ROUTE, _P],
    "radix_partition": [_P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    "segment_reduce": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "onehot_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, *_ROUTE, _P],
    "combine_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, *_ROUTE, _P],
    "flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _P],
    "int_fold": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
}
#: argument types of ``<name>_scratch_bytes``, for the kernels whose scratch
#: the launch function sizes itself (it returns -1 for a shape it refuses).
_SCRATCH_ARGTYPES = {
    "radix_partition": [_I, _I, _I, _I, _P, _I],
    "segment_reduce": [_I, _I, _I, _I, _I],
}

_libs: dict[str, ctypes.CDLL] = {}

#: nvcc's output of each library built by this process (ptxas's report of
#: every kernel's registers, shared memory and spills)
_nvcc_out: dict[str, str] = {}

#: the counter of each kernel's launches in the port's counter registry
#: (``repro_torch.spans``); a binding counts one right after its kernel
#: was launched, and nowhere else
_LAUNCHES = {name: f"launches.{name}" for name in KERNELS}


def count_launch(name: str, key=None) -> None:
    """Count one launch of kernel ``name``, by ``key`` too when given (a
    shape, such as flash_decode's KV positions)."""
    spans.count(_LAUNCHES[name], key=key)


def count_fold(n: int, scans: int, partitioned: bool = False) -> None:
    """Count one keyed fold of ``n`` pairs that reads them ``scans`` times
    in all (``n`` × ``ops.FoldPlan.scans`` on the card: key tiles ×
    column tiles on the tile route, passes + column tiles on the
    partitioned one); ``partitioned``: the fold took the partitioned
    route (counter ``fold_partitioned``)."""
    spans.count("fold_pairs", n)
    spans.count("fold_scans", scans)
    if partitioned:
        spans.count("fold_partitioned")


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: spans.total(c) for name, c in _LAUNCHES.items()}


def launch_counts_by_key(name: str) -> dict:
    """``name``'s launches since the last reset, by the key counted with
    each (launches counted with no key are left out)."""
    return dict(sorted(spans.by_key(_LAUNCHES[name]).items()))


def reset_launch_counts() -> None:
    spans.reset(_LAUNCHES.values())


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR", "").strip()
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels of repro_torch cannot be built")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=LIBRARIES) -> float:
    """Compile every library of ``names`` that is missing, one nvcc per
    source, all started together.  Returns the seconds spent; raises with
    nvcc's output if a build fails."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        final = _library_path(name)
        tmp = final.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, final, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, final, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, final)
            _nvcc_out[name] = out.decode(errors="replace")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> list[dict]:
    """Registers, shared memory (static, bytes) and spill bytes of each
    kernel of library ``name``, as ptxas reported them when this process
    built it (empty if the library was already built)."""
    rows, fn, spill = [], None, 0
    for line in _nvcc_out.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"function": fn, "registers": int(m.group(1)),
                         "smem_bytes": int(smem.group(1)) if smem else 0,
                         "spill_bytes": spill})
            fn = None
    return rows


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with spans.span("kernels.load"):
        build((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = _ARGTYPES[name]
        launch.restype = ctypes.c_int
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        if name in _SCRATCH_ARGTYPES:
            scratch = getattr(lib, f"{name}_scratch_bytes")
            scratch.argtypes = _SCRATCH_ARGTYPES[name]
            scratch.restype = ctypes.c_longlong
        _libs[name] = lib
    return lib


def check(name: str, lib: ctypes.CDLL, err: int) -> None:
    """Raise if a launch function reported a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({msg})")
