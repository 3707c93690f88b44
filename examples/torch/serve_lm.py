"""Serve a small model on the PyTorch port with batched requests: prefill
and greedy decode with an int8 KV cache (the serving-side combiner
integrations), random weights from a seed; nothing is downloaded.

  PYTHONPATH=src python examples/torch/serve_lm.py               # the card
  PYTHONPATH=src python examples/torch/serve_lm.py --device cpu

Other flags go to ``repro_torch.launch.serve`` after these defaults (a
later ``--max-new 4`` wins).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402

DEFAULTS = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--batch", "4",
            "--prompt-len", "12", "--max-new", "12", "--kv-dtype", "int8"]


def main(argv=None):
    """Returns the generated ``[batch, prompt_len + max_new]`` tokens."""
    return serve_main(DEFAULTS + list(sys.argv[1:] if argv is None
                                      else argv))


if __name__ == "__main__":
    main()
