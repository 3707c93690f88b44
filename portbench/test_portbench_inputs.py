"""The generator, the plain references, the controls and the least-bytes
arithmetic, on the CPU at small sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen, harness, least_bytes

UV_SMALL = {"records": 62_000, "groups": 1000}


@pytest.mark.parametrize("cfg_name, sizes", [
    ("uservisits-node", UV_SMALL),
])
def test_columns_are_deterministic_by_seed(cfg_name, sizes):
    cfg = harness.config(cfg_name)
    big = 2**31 + 12345
    a = gen.columns(cfg, big, "cpu", sizes)
    b = gen.columns(cfg, big, "cpu", sizes)
    c = gen.columns(cfg, big + 1, "cpu", sizes)
    assert list(a) == list(cfg["columns"])
    for name in a:
        assert torch.equal(a[name], b[name])
        assert a[name].shape == c[name].shape
        assert a[name].dtype == c[name].dtype
        assert not torch.equal(a[name], c[name])


def test_columns_follow_their_specs():
    cols = gen.columns(harness.config("uservisits-node"), 7, "cpu", UV_SMALL)
    keys, rev = cols["sourceip"], cols["adrevenue"]
    assert keys.shape == (62_000,) and keys.dtype == torch.int32
    assert int(keys.min()) >= 0 and int(keys.max()) < 1000
    assert rev.dtype == torch.float32
    assert float(rev.min()) >= 0.0 and float(rev.max()) < 1.0
    url = cols["desturl"]
    assert url.shape == (62_000, 100) and url.dtype == torch.uint8
    assert int(url.min()) >= 32 and int(url.max()) < 127


def test_the_partition_holds_every_column_at_its_declared_width():
    """All nine UserVisits columns, each at the schema's width (sourceIP
    as its dictionary's 16-byte strings and a 4-byte code a record)."""
    cfg = harness.config("uservisits-node")
    widths = {name: least_bytes.column_bytes(spec, {"records": 1,
                                                    "groups": 1})
              for name, spec in cfg["columns"].items()}
    assert widths == {"sourceip": 4, "adrevenue": 4, "sourceip_dictionary": 16,
                      "desturl": 100, "visitdate": 4, "useragent": 64,
                      "countrycode": 3, "languagecode": 6, "searchword": 32,
                      "duration": 4}
    assert cfg["reduced"] == []
    held = sum(least_bytes.column_bytes(spec, cfg["sizes"])
               for spec in cfg["columns"].values())
    assert held == 155_000_000 * 221 + 2_500_000 * 16


def test_the_read_columns_do_not_depend_on_the_others():
    """The columns the job reads come first from the generator: a seed
    draws them alike whatever columns follow."""
    cfg = harness.config("uservisits-node")
    two = dict(cfg, columns={k: cfg["columns"][k]
                             for k in ("sourceip", "adrevenue")})
    a = gen.columns(cfg, 2**31 + 5, "cpu", UV_SMALL)
    b = gen.columns(two, 2**31 + 5, "cpu", UV_SMALL)
    assert torch.equal(a["sourceip"], b["sourceip"])
    assert torch.equal(a["adrevenue"], b["adrevenue"])


def test_items_group_the_rows_without_a_copy():
    cfg = harness.config("uservisits-node")
    tr = harness.traffic("groupby-sourceip")
    cols = gen.columns(cfg, 1, "cpu", UV_SMALL)
    keys, rev = gen.items(tr, cols)
    assert keys.shape == (62_000 // 8, 8) and rev.shape == (62_000 // 8, 8)
    assert keys.data_ptr() == cols["sourceip"].data_ptr()


def test_uservisits_reference_equals_numpy():
    cfg = harness.config("uservisits-node")
    tr = harness.traffic("groupby-sourceip")
    sizes = dict(cfg["sizes"], **UV_SMALL)
    cols = gen.columns(cfg, 5, "cpu", UV_SMALL)
    ref = harness.reference("uservisits-node").reference(
        cols, tr["reference"], sizes)
    k = cols["sourceip"].numpy()
    v = cols["adrevenue"].numpy().astype(np.float64)
    sums = np.zeros(1000)
    np.add.at(sums, k, v)
    np.testing.assert_allclose(ref["values"].numpy(), sums, rtol=1e-12)
    np.testing.assert_allclose(ref["magnitudes"].numpy(), sums, rtol=1e-12)
    np.testing.assert_array_equal(ref["counts"].numpy(),
                                  np.bincount(k, minlength=1000))


def test_numbers_read_nought_on_the_reference_itself():
    cfg = harness.config("uservisits-node")
    tr = harness.traffic("groupby-sourceip")
    sizes = dict(cfg["sizes"], **UV_SMALL)
    mod = harness.reference("uservisits-node")
    cols = gen.columns(cfg, 9, "cpu", UV_SMALL)
    ref = mod.reference(cols, tr["reference"], sizes)
    assert mod.numbers(ref["values"], ref["counts"], ref) == {
        "count_mismatch": 0, "sum_rel_err": 0.0}
    off = ref["values"].clone()
    off[3] += 1.0
    n = mod.numbers(off, ref["counts"], ref)
    assert n["sum_rel_err"] > cfg["limits"]["sum_rel_err"]


@pytest.mark.parametrize("cell, sizes", [
    # about 62 records a group, as in the cell
    ("uv.sourceip", UV_SMALL),
])
def test_control_fails_the_limits(cell, sizes):
    from portbench import control

    bench = harness.benchmark()
    limits = harness.config(harness.workload(bench, cell)["config"])["limits"]
    for rec in control.readings(bench, cell, [11, 12, 13], device="cpu",
                                sizes=sizes, program=False):
        assert any(v > limits[k] for k, v in rec["control"].items()), rec


def test_least_bytes_of_the_cells():
    uv = (harness.config("uservisits-node"),
          harness.traffic("groupby-sourceip"))
    assert least_bytes.job_bytes(*uv) == (
        155_000_000 * (4 + 4) + 2_500_000 * (4 + 4))
    assert least_bytes.job_bytes(*uv, UV_SMALL) == 62_000 * 8 + 1000 * 8
    t = least_bytes.least_seconds(3.35e12, "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(1.0)
    assert least_bytes.least_seconds(1e9, "cpu") is None
