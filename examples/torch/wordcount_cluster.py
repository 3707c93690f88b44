"""Distributed word count on the PyTorch port, over a mesh of S shards
(``LocalMesh``: the shards run in turn on one device): the stream flow
merges holder tables with an all-reduce (O(K)); the baseline reduce flow
shuffles raw pairs with an all-to-all (O(N)).  Prints each flow's
collectives, read from a trace of the run's own calls, and checks both
results against ``np.bincount``.

  PYTHONPATH=src python examples/torch/wordcount_cluster.py
  PYTHONPATH=src python examples/torch/wordcount_cluster.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import (ExecutionOptions, MapReduce, MapReduceApp,  # noqa: E402
                         ShuffleOptions, ValueSpec)
from repro_torch.distributed import LocalMesh  # noqa: E402

VOCAB = 64


class WordCount(MapReduceApp):
    key_space = VOCAB
    value_spec = ValueSpec((), torch.int32)
    emit_capacity = 8
    max_values_per_key = 512

    def map(self, item, emit):
        emit(item, torch.ones_like(item))

    def reduce(self, key, values, count):
        return values.sum()


def tokens(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (128, 8)).astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)

    toks = tokens()
    want = np.bincount(toks.reshape(-1), minlength=VOCAB)
    out = {}
    for flow in ("auto", "reduce"):
        mr = MapReduce(WordCount(), flow=flow, device=args.device)
        items = torch.from_numpy(toks).to(mr.device)
        mesh = LocalMesh(args.shards, mr.device)
        low = mr.lower(items, options=ExecutionOptions(
            mesh=mesh, shuffle=ShuffleOptions(capacity=toks.size,
                                              strict=True)))
        res = low.compile()(items).gather_result()
        colls = sorted(k for k in low.traced_cost(items).collective_ops
                       if not k.startswith("_"))
        print(f"{mr.plan.flow:8s} flow -> collectives: {colls}")
        assert np.array_equal(res.values.cpu().numpy(), want)
        assert np.array_equal(res.counts.cpu().numpy(), want)
        out[mr.plan.flow] = (res, colls)
    print(f"distributed word count OK on LocalMesh({args.shards}) "
          f"({mesh.device})")
    return out


if __name__ == "__main__":
    main()
