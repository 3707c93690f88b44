"""Every file the harness finds by name parses and meets the benchmark's
contract; no module of this folder imports JAX, the JAX package or the
reference benchmarks, and no plain reference imports the port."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness, tracing

ROOT = harness.ROOT
PB = ROOT / "portbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")


def _bench():
    return harness.benchmark()


def test_benchmark_json_has_the_contract_keys():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    b = _bench()
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[kind]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append(e["name"])
    for w in b["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert LINE.fullmatch(w["why"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert LINE.fullmatch(m["layer"])
    assert len(set(names)) == len(names)


def test_end_to_end_metrics_and_bounds():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_metrics_need():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            reported = {x["name"] for x in
                        harness.cell_metrics(b, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in cells:
        e = {x["name"] for x in harness.cell_metrics(b, cell, "end_to_end")}
        assert "setup_s" in e and len(e) >= 2
        assert harness.cell_metrics(b, cell, "per_layer")


def test_each_layer_name_is_one_line_and_spelt_alike():
    layers = {m["layer"] for m in _bench()["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_every_file_the_harness_finds_by_name_is_there_and_parses():
    b = _bench()
    used = set()
    for c in b["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(PB)
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) and set(cfg["columns"])
        assert (PB / "reference" / f"{c['name']}.py").is_file()
        mod = harness.reference(c["name"])
        assert callable(mod.reference) and callable(mod.control)
        assert callable(mod.numbers)
    for w in b["workloads"]:
        cfg = harness.config(w["config"])
        tr = harness.traffic(w["traffic"])
        used.add(w["config"])
        assert tr["name"] == w["traffic"]
        for part in tr["items"]:
            assert part["column"] in cfg["columns"]
        assert (w["config"], w["traffic"]) not in {
            (x["config"], x["traffic"]) for x in b["workloads"]
            if x is not w}
    assert used == {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read), m["name"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert not bad, bad
    if path.parent.name == "reference":
        assert not _imports(path) & {"repro_torch", "portbench"}


def test_the_import_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom jaxtyping import x\n"
                 "import repro.core as r\nfrom jax import numpy\n")
    assert _imports(p) == {"repro_torch", "jaxtyping", "repro", "jax"}


def test_device_trace_busy_idle_and_breakdown():
    ns = 1_000
    ev = tracing.Event
    t = tracing.DeviceTrace(
        jobs=2, window_ns=(0, 100 * ns),
        device_ops=[ev("a", 10 * ns, 30 * ns, True),
                    ev("b", 20 * ns, 40 * ns, True),
                    ev("a", 60 * ns, 70 * ns, True),
                    ev("c", 95 * ns, 120 * ns, True)],
        host=[ev("portbench.run", 0, 50 * ns, False),
              ev("portbench.run", 55 * ns, 99 * ns, False),
              ev("aten::cat", 50 * ns, 61 * ns, False),
              ev("cudaLaunchKernel", 94 * ns, 96 * ns, False)])
    assert t.busy_intervals() == [(10 * ns, 40 * ns), (60 * ns, 70 * ns),
                                  (95 * ns, 100 * ns)]
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.device_s() == pytest.approx(75e-6)
    assert t.top_ops() == [["a", pytest.approx(30e-6)],
                           ["c", pytest.approx(25e-6)],
                           ["b", pytest.approx(20e-6)]]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    assert gaps == {"run": pytest.approx(10e-6),
                    "run/aten::cat": pytest.approx(20e-6),
                    "run/cudaLaunchKernel": pytest.approx(25e-6)}


def test_metric_readers_reduce_the_readings():
    spans = tracing.Spans()
    spans.records += [("plan", 0.0, 0.25), ("compile", 1.0, 1.5)]
    ns = 1_000_000
    trace = tracing.DeviceTrace(
        jobs=2, window_ns=(0, 100 * ns),
        device_ops=[tracing.Event("k", 0, 20 * ns, True)], host=[])
    r = harness.Readings(
        setup_s=12.5, spans=spans, latencies_s=[0.1 * i for i in range(1, 11)],
        window_s=5.5, least_bytes=int(3.35e9),
        device_name="NVIDIA H100 80GB HBM3", job_peak_bytes=2**30,
        trace=trace, host_syncs=1, traced_bytes=8.5e9)
    got = {m["name"]: harness.metric_reader(m["name"]).read(r)
           for m in _bench()["end_to_end"] + _bench()["per_layer"]}
    assert got["job_ms"] == pytest.approx(550.0)
    assert 900.0 <= got["job_ms_p90"] <= 1000.0
    assert got["job_peak_gib"] == 1.0 and got["setup_s"] == 12.5
    assert got["plan_ms"] == pytest.approx(250.0)
    assert got["compile_ms"] == pytest.approx(500.0)
    assert got["host_syncs_per_job"] == 1.0
    assert got["device_ops_per_job"] == 0.5
    assert got["traced_gb_per_job"] == 8.5
    # 1 ms of least time over 10 ms of device time a job
    assert got["job_roofline"] == pytest.approx(10.0)
    assert got["device_idle_pct"] == pytest.approx(80.0)
