"""Quickstart on the PyTorch port: the paper's Fig 2 word count.

The user writes map + reduce; the semantic-aware optimizer derives the
combiner from the reduce's graph and runs the stream flow with it.

  PYTHONPATH=src python examples/torch/quickstart.py               # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import MapReduce, MapReduceApp, ValueSpec  # noqa: E402
from repro_torch.data.pipeline import tokenize_words  # noqa: E402

TEXT = """the quick brown fox jumps over the lazy dog
the dog barks and the fox runs the end"""
VOCAB = 4096


class WordCount(MapReduceApp):
    key_space = VOCAB
    value_spec = ValueSpec((), torch.int32)
    emit_capacity = 8
    max_values_per_key = 64

    def map(self, window, emit):          # window: [8] token ids
        emit(window, torch.ones_like(window))

    def reduce(self, key, values, count):  # what the user writes...
        return values.sum()                # ...the combiner is DERIVED


def windows_of(text: str) -> np.ndarray:
    """The text's token ids in windows of 8, padded with the sentinel."""
    ids = tokenize_words(text, VOCAB)
    pad = (-len(ids)) % 8
    return np.pad(ids, (0, pad), constant_values=VOCAB).reshape(-1, 8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    mr = MapReduce(WordCount(), device=args.device)
    print(f"optimizer plan: {mr.plan.flow} ({mr.plan.reason}) on "
          f"{mr.device}")
    d = mr.plan.derivation
    print(f"  detect {d.detect_s * 1e6:.0f}us | synthesize "
          f"{d.transform_s * 1e6:.0f}us | validate {d.validate_s * 1e3:.1f}ms"
          f"  (paper: 81us / 7.6ms)")

    res = mr.run(torch.from_numpy(windows_of(TEXT)).to(mr.device))
    inv = {int(tokenize_words(w, VOCAB)[0]): w.lower() for w in TEXT.split()}
    counts = {inv[k]: int(v) for k, v in res.to_dict().items() if k in inv}
    print("word counts:", dict(sorted(counts.items(), key=lambda kv: -kv[1])))
    assert counts["the"] == 5
    return res


if __name__ == "__main__":
    main()
