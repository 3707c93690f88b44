"""Deterministic, stateless data pipeline.

Counterpart of ``repro/data/pipeline.py``, in numpy alone (the
reference's module is numpy too, apart from an unused ``import jax``), so
its batches are the reference's bit for bit.  A batch is a pure function
of ``(seed, step, host)``: ``global_batch(seed, step)`` is the same
wherever it is computed and ``host_batch`` slices a host's shard, so a
restarted or re-ranked run reproduces the same bytes with no
coordination.

Tokenization: string keys become dense int ids here; the word-count
pipeline hashes whitespace tokens into a fixed vocab, which is the
collector's ``key_space``.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    zipf_a: float = 1.2  # token distribution skew (WC-like workloads)


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def global_batch(dc: DataConfig, step: int) -> dict:
    """Synthetic LM batch: zipf-distributed tokens, shifted labels."""
    rng = _rng_for(dc.seed, step)
    toks = rng.zipf(dc.zipf_a, size=(dc.global_batch, dc.seq_len + 1))
    toks = (toks % (dc.vocab_size - 1)) + 1
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def host_batch(dc: DataConfig, step: int, host: int, num_hosts: int) -> dict:
    gb = global_batch(dc, step)
    per = dc.global_batch // num_hosts
    lo = host * per
    return {k: v[lo:lo + per] for k, v in gb.items()}


def tokenize_words(text: str, vocab: int) -> np.ndarray:
    """Whitespace tokens -> stable dense ids in [0, vocab)."""
    return np.asarray(
        [zlib.crc32(w.lower().encode()) % vocab for w in text.split()],
        np.int32)
