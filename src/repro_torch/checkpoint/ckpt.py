"""Atomic, async, checksummed checkpoints of tensor pytrees.

Counterpart of ``repro/checkpoint/ckpt.py``, in its on-disk format, so
that each package reads the other's checkpoints:

    <dir>/step_<N>/
        manifest.json       tree structure, shapes, dtypes, step,
                            checksum {algo, arrays}
        manifest.crc        <algo>:<hex crc of manifest.json bytes>
        arrays.npz          flat leaf arrays (leaf_<i>)
    <dir>/LATEST            text file naming the newest complete step
    <dir>/step_<N>.corrupt  quarantined checkpoint (failed verification)

``leaf_<i>`` follows JAX's flatten order: dict entries by sorted key,
lists and tuples in order, ``None`` holds no leaf (``torch.utils._pytree``
takes dicts in insertion order, which would number the leaves of
``{"slots": ..., "meta": ...}`` otherwise).  A bfloat16 leaf, which numpy
has no type for, is stored as its raw 16-bit pattern (the ``|V2`` bytes
numpy writes for the reference's ``ml_dtypes`` arrays) and named
``bfloat16`` in the manifest.  Leaves keep their dtypes: the port's
integer tables are int64 where the reference's are int32 (ROADMAP C.5);
``repro_torch.interop.service_state_from_repro`` converts a reference
service's tree.

Writes go to ``step_<N>.tmp`` and are moved in place with ``os.replace``
(atomic on POSIX), so a crashed writer never leaves a torn ``step_<N>``
or ``LATEST``.  Every payload carries a CRC (crc32c when its wheel is
installed, else zlib's crc32; the algorithm is named in the manifest).
``verify_step`` checks both; ``restore`` quarantines a corrupt step to
``step_<N>.corrupt`` and, asked for no particular step, falls back to the
newest valid one.  ``AsyncCheckpointer`` saves on a writer thread.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import warnings
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

try:  # pragma: no cover - exercised only where the wheel exists
    from crc32c import crc32c as _crc_fn
    CRC_ALGO = "crc32c"
except ImportError:
    _crc_fn = zlib.crc32
    CRC_ALGO = "crc32"

_ALGOS = {"crc32": zlib.crc32,
          "crc32c": _crc_fn if CRC_ALGO == "crc32c" else None}

#: the manifest's name of a leaf stored as its raw 16-bit pattern
BF16 = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (torn write, bit rot,
    truncated copy).  Carries the offending ``step`` and ``path``; the
    artifact is quarantined to ``<path>.corrupt``, never deleted."""

    def __init__(self, reason: str, *, step: int | None = None,
                 path: str | None = None):
        super().__init__(f"corrupt checkpoint at step {step} ({path}): "
                         f"{reason}")
        self.step = step
        self.path = path
        self.reason = reason


def _crc_bytes(data: bytes, algo: str = CRC_ALGO) -> int:
    fn = _ALGOS.get(algo)
    if fn is None:  # written with an algorithm this process lacks
        return -1
    return fn(data) & 0xFFFFFFFF


def _crc_file(path: str, algo: str = CRC_ALGO) -> int:
    fn = _ALGOS.get(algo)
    if fn is None:
        return -1
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = fn(chunk, crc)
    return crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Trees in JAX's flatten order
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(x, leaves: list) -> str:
    if x is None:
        return "None"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_walk(x[k], leaves)}"
                               for k in sorted(x)) + "}"
    if isinstance(x, list):
        return "[" + ", ".join(_walk(v, leaves) for v in x) + "]"
    if isinstance(x, tuple):
        inner = [_walk(v, leaves) for v in x]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1
                                          else "") + ")"
    leaves.append(x)
    return "*"


def flatten(tree) -> tuple[list, str]:
    """``(leaves, treedef)`` in JAX's order (dict keys sorted, ``None``
    empty); ``treedef`` is the structure written as JAX prints it.  The
    walkers are module functions, not recursive closures: a closure that
    calls itself is a reference cycle, which would keep the leaves (device
    tensors in a train step) alive until the garbage collector runs."""
    leaves: list = []
    treedef = _walk(tree, leaves)
    return leaves, f"PyTreeDef({treedef})"


def _build(x, it):
    if x is None:
        return None
    if isinstance(x, dict):
        got = {k: _build(x[k], it) for k in sorted(x)}
        return {k: got[k] for k in x}
    if isinstance(x, list):
        return [_build(v, it) for v in x]
    if _is_namedtuple(x):
        return type(x)(*[_build(v, it) for v in x])
    if isinstance(x, tuple):
        return tuple(_build(v, it) for v in x)
    return next(it)


def unflatten(example, leaves: list):
    """``leaves`` (JAX's order) in the structure of ``example``."""
    return _build(example, iter(leaves))


def _whole(x):
    """A DTensor leaf's whole tensor (an all-gather: every rank of its mesh
    calls), any other leaf as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, with its manifest dtype."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), BF16
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


# ---------------------------------------------------------------------------
# Save, verify, restore
# ---------------------------------------------------------------------------


def _sharded(leaves) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in leaves)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Write ``tree`` (tensors, numpy arrays or numbers at the leaves) as
    ``step`` atomically, move ``LATEST`` to it and keep the newest
    ``keep`` steps; returns the step's directory.

    DTensor leaves (a sharded train state) are written whole, in the
    layout the reference writes: every rank of the process group calls
    ``save`` (each leaf's shards are all-gathered), rank 0 writes, and all
    ranks return once the step is on disk."""
    leaves, treedef = flatten(tree)
    if _sharded(leaves):
        import torch.distributed as dist

        whole = unflatten(tree, [_whole(x) for x in leaves])
        final = os.path.join(ckpt_dir, f"step_{step}")
        if dist.get_rank() == 0:
            final = save(ckpt_dir, step, whole, keep=keep)
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    converted = [_to_numpy(x) for x in leaves]
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(converted)}
    apath = os.path.join(tmp, "arrays.npz")
    np.savez(apath, **arrays)
    manifest = {
        "step": step,
        "treedef": treedef,
        "num_leaves": len(leaves),
        "shapes": [list(a.shape) for a, _ in converted],
        "dtypes": [dt for _, dt in converted],
        "checksum": {"algo": CRC_ALGO, "arrays": _crc_file(apath)},
    }
    body = json.dumps(manifest).encode()
    with open(os.path.join(tmp, "manifest.json"), "wb") as f:
        f.write(body)
    with open(os.path.join(tmp, "manifest.crc"), "w") as f:
        f.write(f"{CRC_ALGO}:{_crc_bytes(body):08x}\n")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _step_dirs(ckpt_dir: str) -> list[int]:
    """Steps of the complete checkpoints (not ``.tmp``, not
    ``.corrupt``), ascending."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    out = []
    for d in names:
        if not d.startswith("step_") or d.endswith((".tmp", ".corrupt")):
            continue
        try:
            out.append(int(d.split("_", 1)[1]))
        except ValueError:
            continue
    return sorted(out)


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in _step_dirs(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def has_step(ckpt_dir: str, step: int) -> bool:
    """Whether a complete ``step_<N>`` exists (it may still fail its
    checksums; see :func:`verify_step`)."""
    return os.path.isdir(os.path.join(ckpt_dir, f"step_{step}"))


def _manifest(d: str, step: int) -> dict:
    """The parsed, CRC-checked manifest of the step directory ``d``."""
    mpath = os.path.join(d, "manifest.json")
    with open(mpath, "rb") as f:
        body = f.read()
    cpath = os.path.join(d, "manifest.crc")
    if os.path.exists(cpath):
        with open(cpath) as f:
            rec = f.read().strip()
        try:
            algo, hexcrc = rec.split(":", 1)
            want = int(hexcrc, 16)
        except ValueError:
            raise CheckpointCorruptError(
                f"unparseable manifest.crc {rec!r}", step=step, path=d)
        got = _crc_bytes(body, algo)
        if got != -1 and got != want:
            raise CheckpointCorruptError(
                f"manifest checksum mismatch ({algo} {got:08x} != "
                f"{want:08x})", step=step, path=d)
    try:
        return json.loads(body.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"unparseable manifest (torn write?): {e}", step=step, path=d)


def verify_step(ckpt_dir: str, step: int) -> None:
    """Integrity-check one checkpoint; raises ``CheckpointCorruptError``
    (naming the step and path) on a torn, truncated or bit-rotted one, and
    ``FileNotFoundError`` when there is no such step.  A manifest without
    a ``checksum`` field is accepted: the zip's own member CRCs still
    guard the array reads."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.isdir(d):
        raise FileNotFoundError(f"no checkpoint for step {step} under "
                                f"{ckpt_dir}")
    apath = os.path.join(d, "arrays.npz")
    for name in ("manifest.json", "arrays.npz"):
        if not os.path.exists(os.path.join(d, name)):
            raise CheckpointCorruptError(f"missing {name} (torn write)",
                                         step=step, path=d)
    ck = _manifest(d, step).get("checksum")
    if ck:
        algo = ck.get("algo", "crc32")
        got = _crc_file(apath, algo)
        want = int(ck.get("arrays", -1))
        if got != -1 and got != want:
            raise CheckpointCorruptError(
                f"payload checksum mismatch ({algo} {got:08x} != "
                f"{want:08x})", step=step, path=d)


def has_valid_step(ckpt_dir: str, step: int) -> bool:
    """:func:`has_step` and :func:`verify_step`, without raising."""
    try:
        verify_step(ckpt_dir, step)
    except (CheckpointCorruptError, FileNotFoundError):
        return False
    return True


def quarantine_step(ckpt_dir: str, step: int) -> str:
    """Move a corrupt checkpoint aside to ``step_<N>.corrupt`` (never
    collected); returns the new path."""
    src = os.path.join(ckpt_dir, f"step_{step}")
    dst = src + ".corrupt"
    if os.path.exists(dst):
        shutil.rmtree(dst, ignore_errors=True)
    os.replace(src, dst)
    return dst


def shard_partial_dir(ckpt_dir: str, shard: int) -> str:
    """Where a resilient run checkpoints one shard's partial tables."""
    return os.path.join(ckpt_dir, f"shard_{shard}")


def service_state_dir(ckpt_dir: str) -> str:
    """Where a streaming service checkpoints its window-slot states, the
    step being the number of micro-batches ingested."""
    return os.path.join(ckpt_dir, "service")


def latest_step(ckpt_dir: str) -> int | None:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _load_leaves(ckpt_dir: str, step: int) -> tuple[list[np.ndarray],
                                                    list[str]]:
    """Verify and read one checkpoint: its leaf arrays and their manifest
    dtypes.  Any read failure is a ``CheckpointCorruptError`` naming the
    step and path."""
    verify_step(ckpt_dir, step)
    d = os.path.join(ckpt_dir, f"step_{step}")
    try:
        dtypes = _manifest(d, step).get("dtypes")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"unreadable arrays.npz ({type(e).__name__}: {e})",
            step=step, path=d)
    if dtypes is None or len(dtypes) != len(leaves):
        dtypes = [str(a.dtype) for a in leaves]
    return leaves, dtypes


def restore(ckpt_dir: str, example_tree: Any, *, step: int | None = None,
            shardings: Any = None, device=None) -> tuple[Any, int]:
    """Restore into the structure of ``example_tree`` (any leaves: only
    the structure is read); returns ``(tree, step)``, the leaves tensors
    on ``device`` (``None``: the card) in their stored dtypes.

    With an explicit ``step``, a corrupt checkpoint is quarantined and
    ``CheckpointCorruptError`` raised.  With ``step=None`` the candidates
    are tried newest first (``LATEST``, then the step directories);
    corrupt ones are quarantined with a ``RuntimeWarning`` and skipped, so
    a torn newest write degrades to the previous checkpoint.

    ``shardings`` (a ``distributed.sharding.Sharding`` a leaf, as
    ``param_shardings`` gives them) restores onto a mesh instead: each
    leaf is read whole and every rank keeps its shard, as DTensors
    (``sharding.distribute``), on the mesh's device type."""
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute

        mesh = flatten(shardings)[0][0].mesh
        tree, step = restore(ckpt_dir, example_tree, step=step,
                             device=mesh.device_type)
        return distribute(tree, shardings), step
    dev = resolve_device(device)
    if step is not None:
        try:
            leaves, dtypes = _load_leaves(ckpt_dir, step)
        except CheckpointCorruptError:
            if has_step(ckpt_dir, step):
                quarantine_step(ckpt_dir, step)
            raise
    else:
        latest = latest_step(ckpt_dir)
        candidates = sorted(set(_step_dirs(ckpt_dir))
                            | ({latest} if latest is not None else set()),
                            reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        leaves = None
        for cand in candidates:
            try:
                leaves, dtypes = _load_leaves(ckpt_dir, cand)
            except FileNotFoundError:
                continue
            except CheckpointCorruptError as e:
                if has_step(ckpt_dir, cand):
                    q = quarantine_step(ckpt_dir, cand)
                    warnings.warn(
                        f"skipping corrupt checkpoint step {cand} "
                        f"(quarantined to {q}): {e.reason}; falling back "
                        f"to the newest valid checkpoint", RuntimeWarning,
                        stacklevel=2)
                continue
            step = cand
            break
        if leaves is None:
            raise FileNotFoundError(
                f"no VALID checkpoint under {ckpt_dir} "
                f"(candidates {candidates} all corrupt or missing)")
    want = len(flatten(example_tree)[0])
    if want != len(leaves):
        raise ValueError(f"checkpoint step {step} under {ckpt_dir} holds "
                         f"{len(leaves)} leaves, the example tree {want}")
    tensors = [_from_numpy(a, dt, dev) for a, dt in zip(leaves, dtypes)]
    return unflatten(example_tree, tensors), step


class AsyncCheckpointer:
    """Background writer thread; a save error surfaces on the next
    ``submit`` or on ``close``."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save(self.ckpt_dir, step, tree, keep=self.keep)
            except Exception as e:  # surfaced on next submit/close
                self._err = e

    def submit(self, step: int, tree: Any):
        """Queue ``tree`` for saving as ``step``; its leaves are copied to
        the host first, so later writes to them do not reach the file."""
        if self._err:
            raise self._err
        leaves, _ = flatten(tree)
        host = [x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else np.array(x)
                for x in leaves]
        self._q.put((step, unflatten(tree, host)))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
