"""The paper's 7 Phoenix benchmarks as apps of the port, plus BoundingBox.

The port's own copy of ``benchmarks/apps.py``, written with torch ops.  Each
app writes only ``map`` and ``reduce``; the optimizer derives every
combiner.  ``build`` makes the same inputs as the reference's ``build``
from the same numpy generator, on the given device.

Map functions run under ``torch.func.vmap``: a tensor a map creates must be
made on the item's device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import MapReduceApp, ValueSpec
from repro_torch.data import datasets
from repro_torch.device import resolve_device

I32 = torch.int32
F32 = torch.float32


class Histogram(MapReduceApp):
    """HG: pixel -> (channel*256 + intensity, 1); reduce = sum."""

    key_space = 768
    value_spec = ValueSpec((), I32)
    emit_capacity = 3
    max_values_per_key = 4096

    def map(self, pixel, emit):  # pixel: [3] int32 rgb
        keys = torch.arange(3, dtype=I32, device=pixel.device) * 256 + pixel
        emit(keys, torch.ones(3, dtype=I32, device=pixel.device))

    def reduce(self, key, values, count):
        return values.sum()


class KMeans(MapReduceApp):
    """KM: (cluster, point) -> centroid = coordinate sum / count."""

    key_space = 100
    value_spec = ValueSpec((3,), F32)
    emit_capacity = 1
    max_values_per_key = 1024

    def map(self, item, emit):
        cid, pt = item
        emit(cid, pt)

    def reduce(self, key, values, count):
        return values.sum(0) / count.clamp(min=1).to(F32)


class BoundingBox(KMeans):
    """Per-cluster bounding box of the KMeans points: the max and min
    monoids (the stream flow's dense fold)."""

    def reduce(self, key, values, count):
        return torch.cat([values.amax(0), values.amin(0)])


class LinearRegression(MapReduceApp):
    """LR: sufficient statistics (Σx, Σy, Σxx, Σxy, n) as a 5-vector sum."""

    key_space = 1
    value_spec = ValueSpec((5,), F32)
    emit_capacity = 1
    max_values_per_key = 1 << 17

    def map(self, item, emit):  # item: [2] = (x, y)
        x, y = item[0], item[1]
        emit(torch.zeros((), dtype=I32, device=item.device),
             torch.stack([x, y, x * x, x * y, torch.ones_like(x)]))

    def reduce(self, key, values, count):
        return values.sum(0)


class MatrixMultiply(MapReduceApp):
    """MM: C[i, :] contributions keyed by row; reduce = sum of partials."""

    emit_capacity = 1

    def __init__(self, n: int, tile: int = 16):
        self.n = n
        self.tile = tile
        self.key_space = n
        self.value_spec = ValueSpec((n,), F32)
        self.max_values_per_key = n // tile

    def map(self, item, emit):
        row, a_strip, b_strip = item
        emit(row, a_strip @ b_strip)

    def reduce(self, key, values, count):
        return values.sum(0)


class PCA(MapReduceApp):
    """PC: per-row sum and sum of squares of the matrix."""

    emit_capacity = 1
    max_values_per_key = 4

    def __init__(self, rows: int, cols: int):
        self.key_space = rows
        self.value_spec = ValueSpec((2,), F32)

    def map(self, item, emit):
        rid, row = item
        emit(rid, torch.stack([row.sum(), (row * row).sum()]))

    def reduce(self, key, values, count):
        return values.sum(0)


class StringMatch(MapReduceApp):
    """SM: few keys, few values, no compute — the paper's regression case."""

    key_space = 4
    value_spec = ValueSpec((), I32)
    emit_capacity = 1
    max_values_per_key = 4096

    def map(self, item, emit):  # item: candidate id or -1
        emit(item.clamp(min=0), torch.ones((), dtype=I32, device=item.device),
             valid=item >= 0)

    def reduce(self, key, values, count):
        return values.sum()


class WordCount(MapReduceApp):
    """WC: the running example (Figs 1-3)."""

    emit_capacity = 16
    max_values_per_key = 16384

    def __init__(self, vocab: int):
        self.key_space = vocab
        self.value_spec = ValueSpec((), I32)

    def map(self, window, emit):  # [16] token ids
        emit(window, torch.ones_like(window))

    def reduce(self, key, values, count):
        return values.sum()


class KeyedSum(MapReduceApp):
    """Per-key sums over a large sparse key space: items of 8 keys, each
    emitted with its weight (``datasets.keyed_sum_data``); the sort flow's
    workload, as ``benchmarks/bench_flow_sweep.py::make_app`` in the
    reference."""

    emit_capacity = 8
    max_values_per_key = 64

    def __init__(self, key_space: int, dtype: torch.dtype = F32):
        self.key_space = key_space
        self.value_spec = ValueSpec((), dtype)

    def map(self, item, emit):  # item: ([8] keys, [8] weights)
        keys, weights = item
        emit(keys, weights)

    def reduce(self, key, values, count):
        return values.sum(0)


def build(name: str, rng: np.random.Generator, scale: float = 1.0,
          device=None):
    """(app, items) of benchmark ``name``; the inputs are those of the
    reference's ``benchmarks/apps.py::build`` for the same generator, on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    s = lambda n: max(16, int(n * scale))  # noqa: E731

    def t(*arrays):
        out = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in arrays)
        return out[0] if len(out) == 1 else out

    if name == "HG":
        return Histogram(), t(datasets.histogram_data(rng, pixels=s(1 << 17)))
    if name in ("KM", "BB"):
        pts, assign, _ = datasets.kmeans_data(rng, points=s(1 << 14))
        return (KMeans() if name == "KM" else BoundingBox()), t(assign, pts)
    if name == "LR":
        return LinearRegression(), t(
            datasets.linear_regression_data(rng, points=s(1 << 16)))
    if name == "MM":
        n, tile = 96, 16
        a, b = datasets.matmul_data(rng, n=n)
        rows = np.repeat(np.arange(n), n // tile).astype(np.int32)
        a_strips = a.reshape(n, n // tile, tile)[
            np.arange(n)[:, None], np.arange(n // tile)[None, :]].reshape(
            -1, tile)
        b_strips = np.broadcast_to(
            b.reshape(n // tile, tile, n)[None], (n, n // tile, tile, n)
        ).reshape(-1, tile, n)
        return MatrixMultiply(n, tile), t(rows, a_strips, b_strips)
    if name == "PC":
        m = datasets.pca_data(rng, rows=128, cols=64)
        return PCA(128, 64), t(np.arange(128, dtype=np.int32), m)
    if name == "SM":
        return StringMatch(), t(datasets.string_match_data(rng, n=s(1 << 12)))
    if name == "WC":
        n_tok = max(256, s(1 << 16) // 16 * 16)  # window-aligned
        toks, vocab = datasets.wordcount_data(rng, tokens=n_tok, vocab=4096)
        return WordCount(vocab), t(toks[:n_tok].reshape(-1, 16))
    raise KeyError(name)


ALL = ("HG", "KM", "LR", "MM", "PC", "SM", "WC")
