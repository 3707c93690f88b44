"""Train a reduced llama-family model on the PyTorch port with the
combiner-based gradient accumulation, checkpointing every 50 steps;
random weights from a seed, batches from ``data.pipeline``.

  PYTHONPATH=src python examples/torch/train_lm.py --steps 300   # the card
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 2

(40 steps by default, so that the example ends quickly.)  The checkpoints
go to ``--ckpt-dir``, by default a temporary directory removed at the
end.  Other flags go to ``repro_torch.launch.train``.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None) -> dict[int, float]:
    """Returns each step's loss."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=None)
    args, rest = ap.parse_known_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        return train_main(
            ["--arch", "llama3-8b", "--reduced", "--steps", str(args.steps),
             "--batch", "8", "--seq", "64", "--microbatches", "4",
             "--ckpt-dir", args.ckpt_dir or tmp, "--ckpt-every", "50"]
            + rest)


if __name__ == "__main__":
    main()
