"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which the last lines of standard error repeat.
Without a CUDA card, or with fewer cards than the cell asks for, or with
JAX or the JAX package loaded in the process, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

_T_MAIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux:
    from ``/proc/self/stat``, to the clock tick; else this module's
    start)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age if 0 <= age < 60 else _T_MAIN
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_MAIN


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from portbench import harness

    bench = harness.benchmark(ROOT)
    chips = int(harness.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 2
    out = harness.run(bench, args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      t_start=t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in the run's process: {', '.join(found)}; "
              f"no result", file=sys.stderr)
        return 3
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
