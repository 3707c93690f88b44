"""Synthetic datasets for the paper's 7 Phoenix benchmarks (Table 2).

The port's own copy of ``repro/data/datasets.py``: the same numpy
generators, so that both packages get identical inputs from one seed.

  HG  image pixels       -> 768 keys (256×3 channels), huge value count
  KM  3-d points         -> 100 cluster keys, large values
  LR  (x, y) points      -> 5 statistic keys (the sufficient statistics)
  MM  matrix tiles       -> medium keys, medium values
  PC  matrix rows        -> medium keys (row stats)
  SM  match keys         -> 4 keys, few values  (the paper's regression case)
  WC  zipf text          -> large keys, large values
"""

from __future__ import annotations

import numpy as np


def histogram_data(rng, *, pixels: int = 1 << 18):
    """24-bit bitmap -> [N, 3] rgb; keys = channel*256 + intensity."""
    return rng.integers(0, 256, size=(pixels, 3)).astype(np.int32)


def kmeans_data(rng, *, points: int = 1 << 14, clusters: int = 100, d: int = 3):
    centers = rng.standard_normal((clusters, d)) * 5
    assign = rng.integers(0, clusters, size=points)
    pts = centers[assign] + rng.standard_normal((points, d))
    return pts.astype(np.float32), assign.astype(np.int32), clusters


def linear_regression_data(rng, *, points: int = 1 << 16):
    x = rng.standard_normal(points).astype(np.float32)
    y = (2.5 * x + 1.0 + 0.1 * rng.standard_normal(points)).astype(np.float32)
    return np.stack([x, y], axis=1)  # [N, 2]


def matmul_data(rng, *, n: int = 96):
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    return a, b


def pca_data(rng, *, rows: int = 128, cols: int = 64):
    return rng.standard_normal((rows, cols)).astype(np.float32)


def string_match_data(rng, *, n: int = 1 << 12, match_rate: float = 0.22):
    """Stream of candidate ids; 4 target keys (the paper's SM shape)."""
    hits = rng.random(n) < match_rate
    which = rng.integers(0, 4, size=n)
    return np.where(hits, which, -1).astype(np.int32)


def keyed_sum_data(rng, *, items: int, key_space: int, width: int = 8):
    """Items of ``width`` uniform keys in ``[0, key_space)`` and as many f32
    weights in ``[0, 1)``: the large sparse key space of the sort flow
    (the reference's ``benchmarks/bench_flow_sweep.py`` app, with drawn
    weights in place of ones so that sums are tested, not only counts)."""
    keys = rng.integers(0, key_space, size=(items, width)).astype(np.int32)
    weights = rng.random((items, width), dtype=np.float32)
    return keys, weights


def wordcount_data(rng, *, tokens: int = 1 << 16, vocab: int = 8192,
                   zipf_a: float = 1.2):
    t = rng.zipf(zipf_a, size=tokens) % vocab
    return t.astype(np.int32), vocab
