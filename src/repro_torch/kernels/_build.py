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
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

#: one shared library per source; each maps to its launch function's name.
KERNELS = ("onehot_fold", "chunk_monoid_fold", "radix_partition",
           "radix_partition_multi", "segment_reduce")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argument types of each ``<name>_launch``; every pointer and the stream are
#: c_void_p so that ctypes passes them at full width.
_ARGTYPES = {
    "onehot_fold": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "chunk_monoid_fold": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    "radix_partition": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "radix_partition_multi": [_P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P,
                              _P, _P],
    "segment_reduce": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
}
#: argument types of ``<name>_scratch_bytes``, for the kernels whose scratch
#: the launch function sizes itself (it returns -1 for a shape it refuses).
_SCRATCH_ARGTYPES = {
    "radix_partition": [_I, _I, _I, _I, _I],
    "radix_partition_multi": [_I, _I, _I, _I, _P, _I, _I],
    "segment_reduce": [_I, _I, _I, _I, _I],
}

_libs: dict[str, ctypes.CDLL] = {}

#: launches of each kernel since the last :func:`reset_launch_counts`; a
#: binding adds one right after its kernel was launched, and nowhere else.
_launches = {name: 0 for name in KERNELS}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


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


def build(names=KERNELS) -> float:
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
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
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
