"""The harness's run on the CPU at small sizes: the result line, a sound
run read correct, each fault the cells can have read not correct, a cell
added as files only, and ``run.py`` with no card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, tracing

ROOT = harness.ROOT
KEYS_ORDER = ["correct", "attempted", "failed", "metrics", "device"]
EXTRA = ["setup_parts_s", "checks"]

# three stream chunks a job on the CPU (65 536 pairs a chunk there)
SMALL = {"uv.sourceip": {"records": 3 * 65_536, "groups": 1000}}


def _run(bench, cell, trace=False, seed=2**31 + 77):
    return harness.run(bench, cell, seed=seed, seconds=0.05, trace=trace,
                       device="cpu", sizes=SMALL.get(cell))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct_and_its_line_has_the_keys(cell):
    bench = harness.benchmark()
    out = _run(bench, cell)
    assert list(out)[:5] == KEYS_ORDER
    assert list(out)[5:] == EXTRA  # ``checks`` comes last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    want = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
    # off the card there is no device memory to read
    assert set(out["metrics"]) == want - {"job_peak_gib"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    limits = harness.config(harness.workload(bench, cell)["config"])["limits"]
    assert set(out["checks"]) == set(limits)
    json.dumps(out)


def _fake_trace(job, spans, *, min_jobs, min_s):
    for _ in range(min_jobs):
        job()
    ns = 1_000_000
    ops = [tracing.Event("fold", 1 * ns, 4 * ns, True),
           tracing.Event("copy", 6 * ns, 7 * ns, True)]
    host = [tracing.Event("portbench.run", 0, 9 * ns, False),
            tracing.Event("aten::cat", 4 * ns, 6 * ns, False)]
    return tracing.DeviceTrace(jobs=min_jobs, window_ns=(0, 10 * ns),
                               device_ops=ops, host=host)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_line_has_the_per_layer_metrics_and_a_breakdown(
        cell, monkeypatch):
    monkeypatch.setattr(tracing, "profile_jobs", _fake_trace)
    bench = harness.benchmark()
    out = _run(bench, cell, trace=True)
    assert list(out) == [*KEYS_ORDER, "breakdown", *EXTRA]
    assert out["correct"] is True
    # no window: the profiled jobs are the ones attempted and compared
    assert out["attempted"] == harness.TRACE_MIN_JOBS
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["busy_s"] == pytest.approx(0.004)
    assert out["device"]["window_s"] == pytest.approx(0.01)
    want = {m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")}
    # off the card: no host syncs to count, no published peak
    assert set(out["metrics"]) == want - {"host_syncs_per_job",
                                          "job_roofline"}
    assert out["metrics"]["device_idle_pct"]["value"] == pytest.approx(60.0)
    assert out["metrics"]["traced_gb_per_job"]["value"] > 0
    assert out["metrics"]["compile_ms"]["value"] > 0


def _skip_every_third_fold(monkeypatch):
    from repro_torch.core import collector

    real = collector.StreamCombiner.fold_chunk
    calls = [0]

    def fold_chunk(self, state, stream):
        calls[0] += 1
        return state if calls[0] % 3 == 0 else real(self, state, stream)

    monkeypatch.setattr(collector.StreamCombiner, "fold_chunk", fold_chunk)


def _half_the_items(monkeypatch):
    from repro_torch.core import engine

    real = engine.fold_items_chunked

    def fold(app, combiner, items, chunk_items, n_valid=None, state=None):
        n = engine.valid_items(items, n_valid)
        return real(app, combiner, items, chunk_items, n_valid=n // 2,
                    state=state)

    monkeypatch.setattr(engine, "fold_items_chunked", fold)


def _one_answer_altered(monkeypatch):
    from repro_torch.core import collector

    real = collector.finalize_tables

    def finalize(*args, **kwargs):
        g = real(*args, **kwargs)
        g.values[1] += 1
        return g

    monkeypatch.setattr(collector, "finalize_tables", finalize)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("fault", [_skip_every_third_fold, _half_the_items,
                                   _one_answer_altered])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_timed_path_reads_not_correct(cell, fault, trace,
                                               monkeypatch):
    fault(monkeypatch)
    if trace:
        monkeypatch.setattr(tracing, "profile_jobs", _fake_trace)
    out = _run(harness.benchmark(), cell, trace=trace)
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_cell_added_as_files_only_runs(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    pb = tmp_path / "portbench"
    cfg = harness.config("uservisits-node")
    cfg.update(name="uservisits-tiny", sizes={"records": 4096, "groups": 64})
    (pb / "configs" / "uservisits-tiny.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "reference" / "uservisits-node.py",
                pb / "reference" / "uservisits-tiny.py")
    tr = harness.traffic("groupby-sourceip")
    tr["name"] = "groupby-sourceip-sort"
    tr["mapreduce"] = {"flow": "sort"}
    (pb / "traffic" / "groupby-sourceip-sort.json").write_text(json.dumps(tr))
    bench["workloads"].append({"name": "uv.tiny", "config": "uservisits-tiny",
                               "traffic": "groupby-sourceip-sort", "chips": 1,
                               "why": "a throwaway cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run(harness.benchmark(tmp_path), "uv.tiny", seed=5,
                      seconds=0.05, trace=False, device="cpu", root=tmp_path)
    assert out["correct"] is True
    assert "job_ms" in out["metrics"]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: run.py would run the cell")
    p = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "uv.sourceip", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch.core", "jaxtyping", "portbench.harness", "torch"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax.numpy", "flax", "repro_torch"]) == [
        "flax", "jax", "repro"]
