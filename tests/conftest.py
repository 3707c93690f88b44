import os
import sys

import pytest

# allow running without PYTHONPATH=src
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# ---------------------------------------------------------------------------
# CI flow×lowering matrix overrides
#
# The `flow-matrix` CI job runs the core + integration suites across every
# execution flow and both lowerings so each flow's path is exercised on
# every PR, not only the default:
#
#   REPRO_TEST_FLOW=stream|sort|combine|reduce
#       resolves flow="auto" MapReduce constructions to the given flow.
#       Only the AUTO default is overridden — tests that force a specific
#       flow keep it, and apps whose combiner cannot run the forced flow
#       (derivation failure) silently fall back to "auto" so
#       reduce-only workloads still pass.  Tests that assert the auto
#       resolution itself skip under the override (they declare it).
#   REPRO_TEST_KERNELS=1
#       flips the use_kernels default to True (combine with
#       JAX_PALLAS_INTERPRET=1 to exercise the Pallas kernel lowerings).
#   REPRO_TEST_SKEW=zipf
#       flips the ShuffleOptions.skew default to "auto", so every
#       distributed/resilient run in the suite goes through the sampled-
#       histogram shuffle planner (bitwise-parity guarantees make this a
#       pure routing change).  Tests that assert the fixed-width shuffle
#       arithmetic itself mark themselves `fixed_shuffle` and skip.
#   REPRO_TEST_WIRE=delta
#       flips the ShuffleOptions.wire default, so every distributed/
#       resilient shuffle encodes its all-to-all + checkpointed partials
#       under the given wire codec (delta is lossless and bitwise —
#       another pure routing change).  Tests that assert the raw wire
#       layout itself mark themselves `raw_wire` and skip.
# ---------------------------------------------------------------------------

def _env_override(name: str) -> str | None:
    """Matrix override value, with the ci.yml "off" default (the matrix
    sets ``REPRO_TEST_*: ${{ matrix.x || 'off' }}``) parsed as absent."""
    v = os.environ.get(name, "").strip().lower()
    return None if v in ("", "off", "0", "false", "no") else v


FLOW_OVERRIDE = _env_override("REPRO_TEST_FLOW")
KERNELS_OVERRIDE = (os.environ.get("REPRO_TEST_KERNELS", "").strip().lower()
                    not in ("", "0", "false", "no"))
SKEW_OVERRIDE = _env_override("REPRO_TEST_SKEW")
WIRE_OVERRIDE = _env_override("REPRO_TEST_WIRE")


def _apply_shuffle_overrides() -> None:
    if SKEW_OVERRIDE is None and WIRE_OVERRIDE is None:
        return
    import dataclasses

    from repro.core import skew

    # flip only the DEFAULTS of the frozen options record: every field has
    # a default, so __init__.__defaults__ lines up with the field order
    fields = [f.name for f in dataclasses.fields(skew.ShuffleOptions)]
    defaults = list(skew.ShuffleOptions.__init__.__defaults__)
    if SKEW_OVERRIDE is not None:
        defaults[fields.index("skew")] = "auto"
    if WIRE_OVERRIDE is not None:
        defaults[fields.index("wire")] = WIRE_OVERRIDE
    skew.ShuffleOptions.__init__.__defaults__ = tuple(defaults)

    # ExecutionOptions(shuffle=None) must also route through the planner/
    # codec: materialize the overridden record where None would have kept
    # the legacy fixed-width arithmetic / raw wire
    from repro.core import api

    orig_post = api.ExecutionOptions.__post_init__

    def patched_post(self):
        orig_post(self)
        if self.shuffle is None:
            object.__setattr__(self, "shuffle", skew.ShuffleOptions())

    api.ExecutionOptions.__post_init__ = patched_post


def _apply_matrix_overrides() -> None:
    _apply_shuffle_overrides()
    if FLOW_OVERRIDE is None and not KERNELS_OVERRIDE:
        return
    from repro.core import api

    orig_init = api.MapReduce.__init__

    def patched(self, app, *, flow="auto", **kw):
        # flip only the DEFAULTS: an explicit use_kernels=False (an A/B
        # contrast leg) or a forced flow keeps what the test asked for
        if KERNELS_OVERRIDE and "use_kernels" not in kw:
            kw["use_kernels"] = True
        if FLOW_OVERRIDE is not None and flow == "auto":
            try:
                orig_init(self, app, flow=FLOW_OVERRIDE, **kw)
                return
            except ValueError:
                pass  # not derivable under the forced flow -> keep auto
        orig_init(self, app, flow=flow, **kw)

    api.MapReduce.__init__ = patched


_apply_matrix_overrides()


@pytest.fixture
def matrix_flows():
    """Flow list for tests that iterate execution flows EXPLICITLY (the
    fault-injection recovery drills): under the REPRO_TEST_FLOW matrix
    override, restrict to the overridden flow so each matrix leg
    exercises its own flow instead of re-running all of them."""

    def pick(flows=("stream", "sort", "combine", "reduce")):
        if FLOW_OVERRIDE is not None and FLOW_OVERRIDE in flows:
            return (FLOW_OVERRIDE,)
        return tuple(flows)

    return pick


@pytest.fixture
def matrix_use_kernels():
    """True on the flow-matrix kernels leg (REPRO_TEST_KERNELS): tests
    that build engine runs directly (not through the patched MapReduce
    API) use this to put the Pallas lowerings under the same override."""
    return KERNELS_OVERRIDE


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "auto_flow: asserts how flow='auto' resolves (skipped "
        "under the REPRO_TEST_FLOW matrix override)")
    config.addinivalue_line(
        "markers", "purejax_lowering: measures the pure-JAX default "
        "lowering's compiled profile (skipped under REPRO_TEST_KERNELS)")
    config.addinivalue_line(
        "markers", "fixed_shuffle: asserts the fixed-width shuffle "
        "arithmetic/overflow behaviour (skipped under REPRO_TEST_SKEW)")
    config.addinivalue_line(
        "markers", "raw_wire: asserts the raw wire layout / bucket bytes "
        "(skipped under REPRO_TEST_WIRE)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
        "where there is none")


def pytest_collection_modifyitems(config, items):
    """One source of truth for the matrix-override skips (the markers
    above); the override env reads live at the top of this file."""
    skip_flow = pytest.mark.skip(
        reason="asserts flow='auto' resolution; REPRO_TEST_FLOW overrides it")
    skip_kern = pytest.mark.skip(
        reason="measures the pure-JAX lowering's compiled profile; "
               "REPRO_TEST_KERNELS overrides the lowering")
    skip_skew = pytest.mark.skip(
        reason="asserts the fixed-width shuffle arithmetic; "
               "REPRO_TEST_SKEW routes through the skew planner")
    skip_wire = pytest.mark.skip(
        reason="asserts the raw wire layout; REPRO_TEST_WIRE re-encodes "
               "the shuffle wire")
    for item in items:
        if FLOW_OVERRIDE is not None and "auto_flow" in item.keywords:
            item.add_marker(skip_flow)
        if KERNELS_OVERRIDE and "purejax_lowering" in item.keywords:
            item.add_marker(skip_kern)
        if SKEW_OVERRIDE is not None and "fixed_shuffle" in item.keywords:
            item.add_marker(skip_skew)
        if WIRE_OVERRIDE is not None and "raw_wire" in item.keywords:
            item.add_marker(skip_wire)
