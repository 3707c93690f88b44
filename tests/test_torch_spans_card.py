"""The program's spans on the card: a traced stream job's device ops each
go to the program span that launched them, and the keyed fold's scan
counter is its plan's.

Skips where there is no CUDA card (``tests/test_torch_spans.py`` and
``portbench/test_portbench_program.py`` hold the recorder and the
attribution to the same rules on the CPU).  ``portbench/program.py``
reads a whole benchmark cell so on the card.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import apps  # noqa: E402
from repro_torch.core import MapReduce  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K = 1 << 21  # past one fold table: 64 key tiles on the tile route
ITEMS = 1 << 20  # of 8 pairs
CHUNK_PAIRS = 1 << 22  # 2 chunks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels and their trace run only there")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["eager", "replayed"])
def test_a_traced_stream_job_is_attributed_to_its_spans(loop, card,
                                                        monkeypatch):
    """Eager, a job's device ops go to the spans that launched them, the
    fold's the most; replayed from its captured CUDA graph
    (``engine.CapturedLoop``), to ``graph.replay``, with the capture's
    counters credited to the job."""
    from portbench import program

    g = torch.Generator(device=card).manual_seed(0)
    items = (torch.randint(0, K, (ITEMS, 8), device=card, generator=g,
                           dtype=torch.int32),
             torch.rand((ITEMS, 8), device=card, generator=g))
    mr = MapReduce(apps.KeyedSum(K), flow="stream", device=card,
                   stream_chunk_pairs=CHUNK_PAIRS)
    run = mr.lower(items).compile()._entry.executable
    if loop == "eager":  # the cached run: held eager for this case only
        monkeypatch.setattr(run, "_no_capture", "held eager by the test")
    mr.run(items)
    mr.run(items)  # replayed: the capture
    torch.cuda.synchronize()

    def job(marks):
        with marks("run"):
            mr.run(items)
        with marks("sync"):
            torch.cuda.synchronize()

    stretch, evs, trace = program.profile(job, jobs=2)
    att = program.Attribution(evs, *trace.window_ns)
    assert att.ops and len(att.ops) == len(trace.device_ops)
    dev = att.device_s()
    assert dev.get(None, 0.0) < 0.01 * sum(dev.values()), dev
    top = "fold" if loop == "eager" else "graph.replay"
    assert dev[top] > 0.5 * sum(dev.values()), dev
    assert run.loop_path.startswith(
        "eager" if loop == "eager" else "cuda graph, replayed")
    assert [j.counters["chunks"] for j in stretch.named("job")] == [2, 2]

    plan = ops.fold_plan(CHUNK_PAIRS, K, 2, "add", mr.tiling.key_block,
                         True, True)
    got = stretch.counters["fold_scans"] / stretch.counters["fold_pairs"]
    assert got == plan.scans
