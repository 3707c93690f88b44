"""Two-job pipeline on the PyTorch port: word count feeding a
count-of-counts histogram.

The follow-up job reads only the counts table.  A ``Pipeline`` runs the
two MapReduce jobs in one dispatch: no host round trip between them, the
producer's value column is not finalized when the consumer ignores it, and
an edge predicate (``where=``) is pushed below the shuffle.  The fused
result equals the jobs run one after the other, bit for bit.

  PYTHONPATH=src python examples/torch/pipeline_wordcount_topk.py
  PYTHONPATH=src python examples/torch/pipeline_wordcount_topk.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import Pipeline, ValueSpec, make_app  # noqa: E402

VOCAB = 256
BUCKETS = 16
I32 = torch.int32


def wc_map(item, emit):  # ones_like: the value on the item's device
    emit.emit(item % VOCAB, torch.ones_like(item, dtype=I32))


def wordcount():
    return make_app(map_fn=wc_map, reduce_fn=lambda k, vs, n: vs.sum(),
                    key_space=VOCAB, value_spec=ValueSpec((), I32))


def hist_map(item, emit):
    # item is one (key, value, count) row of the word-count table; bucket
    # words by count magnitude: the "how hot is the hot set" histogram
    count = item[1]
    emit.emit(torch.clamp(count // 32, 0, BUCKETS - 1).to(I32),
              torch.ones_like(count, dtype=I32))


def histogram():
    return make_app(map_fn=hist_map, reduce_fn=lambda k, vs, n: vs.sum(),
                    key_space=BUCKETS, value_spec=ValueSpec((), I32))


def tokens(n: int = 200_000, seed: int = 0) -> np.ndarray:
    """A zipf-like token stream: a hot head and a long tail."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, size=n) % VOCAB).astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tokens", type=int, default=200_000)
    args = ap.parse_args(argv)

    items = torch.from_numpy(tokens(args.tokens))
    # only histogram words that occur >= 8 times: the predicate is
    # evaluated inside the fused consumer map, below the shuffle
    pipe = Pipeline(wordcount(), device=args.device).then(
        histogram(), where=lambda key, count, n: count >= 8)

    fused = pipe.run(items)
    unfused = pipe.run_unfused(items)
    assert torch.equal(fused.values, unfused.values)
    assert torch.equal(fused.counts, unfused.counts)

    print("count-of-counts buckets:", fused.values.cpu().tolist())
    print()
    print("fusion decisions:")
    for line in pipe.fusion_report():
        print(" ", line)
    n = int(items.shape[0])
    print()
    print(f"modeled bytes  fused: {pipe.model_bytes(n, fused=True) / 1e6:.2f}"
          f"MB  unfused: {pipe.model_bytes(n, fused=False) / 1e6:.2f}MB")
    return fused, pipe


if __name__ == "__main__":
    main()
