"""One run of one cell: set-up, then the measured window (``--trace 0``) or
a profiled stretch of whole jobs (``--trace 1``), the comparison of the
jobs' results with the plain reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``configs/<config>.json``, with the plain
reference ``reference/<config>.py`` beside it) and its traffic
(``traffic/<traffic>.json``); each metric is read by
``metrics/<metric>.py``.  The program under test is ``repro_torch``; this
harness takes from it only ``MapReduce``, the apps, and what a job
returns.

A job is ``MapReduce(app).run(items)`` over the whole input followed by a
synchronize: a closed loop of one client, each job started when the last
one returned.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import itertools
import json
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import gen, least_bytes, syncs, tracing

ROOT = Path(__file__).resolve().parents[1]

#: top-level module names that must not be loaded in a run's process
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})

#: the port's cache files, off in every run: a run writes inside its
#: checkout only
CACHE_ENV = ("REPRO_TORCH_PLAN_CACHE", "REPRO_TORCH_TUNE_CACHE")

#: results of the window's (or the traced stretch's) jobs kept for the
#: comparison, drawn from the seed
KEPT_JOBS = 2

#: the profiled stretch of a traced run: at least this many whole jobs, and
#: at least this many seconds
TRACE_MIN_JOBS = 3
TRACE_MIN_S = 1.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "portbench" / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "portbench" / "traffic" / f"{name}.json")


def load_module(path: Path):
    """A module of this folder loaded from its file (the names of
    references and metrics are names, not identifiers)."""
    spec = importlib.util.spec_from_file_location(
        "portbench._" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config_name: str, root: Path = ROOT):
    return load_module(root / "portbench" / "reference" / f"{config_name}.py")


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "portbench" / "metrics" / f"{name}.py")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name``
    reports: those with no ``workloads`` list, and those that list it."""
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded in this process), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def build_app(tr: dict, sizes: dict):
    from repro_torch import apps

    args = {k: gen.size(v, sizes) for k, v in tr["app_args"].items()}
    return getattr(apps, tr["app"])(**args)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


@dataclasses.dataclass
class Readings:
    """What a run measured; the metric readers reduce it to numbers."""

    setup_s: float
    spans: tracing.Spans
    latencies_s: list[float]
    window_s: float
    least_bytes: int
    device_name: str
    job_peak_bytes: int | None = None
    trace: tracing.DeviceTrace | None = None
    host_syncs: int | None = None
    traced_bytes: float | None = None

    @property
    def jobs(self) -> int:
        return len(self.latencies_s)

    def p90_s(self) -> float:
        lat = self.latencies_s
        return statistics.quantiles(lat, n=10)[-1] if len(lat) > 1 else lat[0]


def _keep(kept: list, result, index: int, rng: random.Random) -> None:
    """Reservoir sampling: ``kept`` holds a uniform sample of the results
    seen so far, at most ``KEPT_JOBS`` of them."""
    if len(kept) < KEPT_JOBS:
        kept.append((index, result))
        return
    j = rng.randrange(index + 1)
    if j < KEPT_JOBS:
        kept[j] = (index, result)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run(bench: dict, name: str, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", sizes: dict | None = None,
        t_start: float | None = None, root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``sizes`` replaces the configuration's sizes (the tests' small copies
    on the CPU); ``t_start`` is the process's start on the
    ``time.perf_counter`` clock; ``root`` is the checkout whose
    ``portbench/`` holds the cell's files."""
    t_enter = time.perf_counter()
    t_start = t_enter if t_start is None else t_start
    for var in CACHE_ENV:
        os.environ.pop(var, None)
    wl = workload(bench, name)
    cfg, tr = config(wl["config"], root), traffic(wl["traffic"], root)
    sizes = dict(cfg["sizes"], **(sizes or {}))
    cuda = torch.device(device).type == "cuda"
    spans = tracing.Spans()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with spans("cuda_init"):
        if cuda:
            torch.cuda.init()
            torch.empty(1, device=device)
            sync()
    with spans("import_port"):
        from repro_torch.core import MapReduce
        app = build_app(tr, sizes)
    with spans("inputs"):
        cols = gen.columns(cfg, seed, device, sizes)
        items = gen.items(tr, cols)
        sync()
    with spans("plan"):
        mr = MapReduce(app, device=device, **tr["mapreduce"])
    with spans("compile"):
        mr.lower(items).compile()
        sync()
    log(mr.explain())

    def job():
        with spans("run"):
            res = mr.run(items)
        with spans("sync"):
            sync()
        return res

    with spans("warm_job"):
        job()
    setup_s = time.perf_counter() - t_start
    rng = random.Random(seed)
    kept: list = []
    lat: list[float] = []
    window_s = 0.0
    memory_peak = job_peak = None

    dtrace = None
    if trace:
        # the traced run: whole jobs under the profiler and no window; its
        # jobs' results are the ones compared
        index = itertools.count()

        def traced_job():
            _keep(kept, job(), next(index), rng)

        dtrace = tracing.profile_jobs(traced_job, spans,
                                      min_jobs=TRACE_MIN_JOBS,
                                      min_s=TRACE_MIN_S)
        attempted = dtrace.jobs
        if cuda:
            memory_peak = torch.cuda.max_memory_allocated()
    else:
        # the measured window; the peak so far is the set-up's (the compile
        # reset the counter after the inputs were made)
        setup_peak = torch.cuda.max_memory_allocated() if cuda else None
        job_peak = 0 if cuda else None
        abs_peak = 0
        t_w0 = t1 = time.perf_counter()
        while t1 - t_w0 < seconds:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = job()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if cuda:
                top = torch.cuda.max_memory_allocated()
                job_peak = max(job_peak, top - base)
                abs_peak = max(abs_peak, top)
            _keep(kept, res, len(lat) - 1, rng)
            del res
        window_s = t1 - t_w0
        attempted = len(lat)
        log("job ms:", " ".join(f"{x * 1e3:.1f}" for x in lat))
        if cuda:
            memory_peak = max(setup_peak, abs_peak)

    host_syncs = traced_bytes = None
    if trace:
        with spans("host_syncs"):
            host_syncs = (syncs.host_syncs(lambda: mr.run(items))["count"]
                          if cuda else None)
        with spans("traced_cost"):
            traced_bytes = float(mr.lower(items).compile().traced_cost(
                items).bytes_accessed)

    # drop the program's objects before the reference runs
    del mr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refmod = reference(wl["config"], root)
    with spans("reference"):
        ref = refmod.reference(cols, tr["reference"], sizes)
        read = [refmod.numbers(r.values, r.counts, ref) for _, r in kept]
    limits = cfg["limits"]
    checks = {k: {"value": max(n[k] for n in read), "limit": limits[k]}
              for k in limits}
    failed = sum(any(n[k] > limits[k] for k in limits) for n in read)
    correct = bool(read) and failed == 0

    dev_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    readings = Readings(
        setup_s=setup_s, spans=spans, latencies_s=lat, window_s=window_s,
        least_bytes=least_bytes.job_bytes(cfg, tr, sizes),
        device_name=dev_name, job_peak_bytes=job_peak,
        trace=dtrace, host_syncs=host_syncs, traced_bytes=traced_bytes)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, name, kind):
        value = metric_reader(m["name"], root).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else "cpu", "kind": dev_name,
                   "count": int(wl["chips"]) if cuda else 0,
                   "memory_peak_bytes": memory_peak}
    if cuda:
        device_info["power_limit"] = power_limit()
    if dtrace is not None:
        device_info["busy_s"] = dtrace.busy_s()
        device_info["window_s"] = dtrace.window_s
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if dtrace is not None:
        out["breakdown"] = {"device_ops": dtrace.top_ops(),
                            "idle_gaps": dtrace.idle_gaps()}
    parts = {n: spans.seconds(n) for n in ("cuda_init", "import_port",
                                            "inputs", "plan", "compile",
                                            "warm_job")}
    parts["start_and_import"] = t_enter - t_start
    out["setup_parts_s"] = parts
    out["checks"] = checks
    return out
