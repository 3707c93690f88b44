"""Tiling of the stream flow: chunk size, key block and fold lowering.

Counterpart of ``repro/core/autotune.py::autotune_stream``.  The reference
sized chunks against its roofline model and XLA's fused-contraction regime
(2048 pairs per fold).  The port's chunk loop is a Python loop with a few
launches per chunk, so on the card a chunk holds :data:`CUDA_CHUNK_PAIRS`
pairs: 2^22 pairs of a 3-float KMeans value are 64 MB, far above the
launch overhead and far below device memory.  The decision is recorded on
the plan (``explain()``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import collector as col

#: emitted pairs per stream chunk on the card
CUDA_CHUNK_PAIRS = 1 << 22
#: emitted pairs per stream chunk on the CPU (the reference's chunk cap)
CPU_CHUNK_PAIRS = 1 << 16


@dataclasses.dataclass(frozen=True)
class StreamTiling:
    """The tiling decision, carried on the ExecutionPlan."""

    chunk_pairs: int
    key_block: int  # == key_space -> single block (unblocked)
    key_space: int
    mode: str  # the stream fold lowering (collector.stream_mode)
    source: str  # "auto" | "manual"
    notes: tuple[str, ...] = ()

    @property
    def n_key_blocks(self) -> int:
        return -(-self.key_space // self.key_block)

    @property
    def blocked(self) -> bool:
        return self.key_block < self.key_space

    def describe(self) -> str:
        blk = (f"key_block={self.key_block}×{self.n_key_blocks}"
               if self.blocked else f"key_block={self.key_block} (single)")
        return (f"chunk_pairs={self.chunk_pairs} {blk} mode={self.mode} "
                f"[{self.source}]")


def autotune_stream(app, spec, *, device, use_kernels: bool = False,
                    chunk_pairs: int | str = "auto",
                    key_block: int | str | None = "auto") -> StreamTiling:
    """Pick the stream-fold tiling for ``app`` under ``spec``.

    ``chunk_pairs`` / ``key_block`` take ints to pin either knob;
    ``key_block=None`` disables blocking."""
    notes: list[str] = []
    K = app.key_space
    kernel_additive = use_kernels and spec.kernel_additive_ok(app.value_spec)
    kernel_monoid = use_kernels and spec.kernel_monoid_ok(app.value_spec)
    manual_chunk = isinstance(chunk_pairs, int)
    if manual_chunk:
        chunk = int(chunk_pairs)
    else:
        chunk = (CUDA_CHUNK_PAIRS if torch.device(device).type == "cuda"
                 else CPU_CHUNK_PAIRS)
    chunk = max(chunk, app.emit_capacity, 1)

    if key_block is None:
        blk = K
    elif isinstance(key_block, int):
        blk = max(1, min(int(key_block), K))
    elif kernel_additive or kernel_monoid:
        from repro_torch.kernels import ops

        blk = min(ops.auto_key_block(K), K)
        notes.append(f"fold kernels: {blk} keys per block, "
                     f"{-(-K // blk)} key block(s)")
    else:
        blk = col.choose_dense_key_block(K, chunk)

    dense_ok = kernel_monoid or chunk * blk <= col.DENSE_FOLD_ELEMS_BUDGET
    mode = col.stream_mode(spec, dense_ok=dense_ok,
                           additive_ok=kernel_additive or dense_ok)
    if spec.sum_lowerable and mode == "scatter":
        notes.append(f"FALLBACK: chunk_pairs={chunk} × key_block={blk} "
                     f"exceeds the dense fold budget; exact scatter fold")
    manual = manual_chunk and (key_block is None or isinstance(key_block, int))
    return StreamTiling(chunk_pairs=chunk, key_block=blk, key_space=K,
                        mode=mode, source="manual" if manual else "auto",
                        notes=tuple(notes))
