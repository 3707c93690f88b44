"""The readings that a cell's limits are set from: for each seed, the
numbers the program's job gives against the plain reference (the lower
readings), and those the control gives (the upper readings).  The control
is the reference computed in the precision below the configuration's,
put in the program's place (``reference/<config>.py``'s ``control``).

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

runs every seed in one process, on the card at the cell's own size, and
prints one JSON line a seed and a last line with the largest program
reading and the smallest control reading of each number.  The benchmark's
own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(bench: dict, name: str, seeds, *, device: str = "cuda",
             sizes: dict | None = None, program: bool = True):
    """One ``{"seed", "program", "control"}`` record a seed (``program``
    False leaves the program out)."""
    import torch

    from portbench import gen, harness

    wl = harness.workload(bench, name)
    cfg, tr = harness.config(wl["config"]), harness.traffic(wl["traffic"])
    sizes = dict(cfg["sizes"], **(sizes or {}))
    refmod = harness.reference(wl["config"])
    mr = None
    if program:
        from repro_torch.core import MapReduce

        mr = MapReduce(harness.build_app(tr, sizes), device=device,
                       **tr["mapreduce"])
    for seed in seeds:
        cols = gen.columns(cfg, seed, device, sizes)
        ref = refmod.reference(cols, tr["reference"], sizes)
        rec = {"seed": seed}
        if mr is not None:
            res = mr.run(gen.items(tr, cols))
            rec["program"] = refmod.numbers(res.values, res.counts, ref)
            del res
        ctl = refmod.control(cols, tr["reference"], sizes)
        rec["control"] = refmod.numbers(ctl["values"], ctl["counts"], ref)
        del cols, ref, ctl
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for rec in readings(harness.benchmark(ROOT), args.workload, args.seeds):
        print(json.dumps(rec), flush=True)
        for k, v in rec["program"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in rec["control"].items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "program_max": lower, "control_min": upper,
                      "card": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
