"""The least work a job needs, and the card's peaks it is held against.

A job's least bytes are each input byte read once and each result byte
written once: the columns its items take, at their shapes and dtypes, and
the result's rows.  They follow from the cell's shapes alone, so they are
the same whatever kernels or passes the program uses.
"""

from __future__ import annotations

from portbench import gen

#: published memory bandwidth by ``torch.cuda.get_device_name()``
#: (NVIDIA's data sheet, the SXM part at its 700 W limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _itemsize(dtype: str) -> int:
    return gen.DTYPES[dtype].itemsize


def column_bytes(spec: dict, sizes: dict) -> int:
    n = 1
    for d in spec["shape"]:
        n *= gen.size(d, sizes)
    return n * _itemsize(spec["dtype"])


def job_bytes(config: dict, traffic: dict, sizes: dict | None = None) -> int:
    """The bytes a job must move: every column its items read, once, and
    its result (``traffic["result"]``: rows, and a dtype a column) written
    once."""
    sizes = dict(config["sizes"], **(sizes or {}))
    read = sum(column_bytes(config["columns"][part["column"]], sizes)
               for part in traffic["items"])
    res = traffic["result"]
    written = gen.size(res["rows"], sizes) * sum(
        _itemsize(d) for d in res["columns"])
    return read + written


def least_seconds(nbytes: float, device_name: str) -> float | None:
    """``nbytes`` at the card's published bandwidth; None for a card with
    no entry in :data:`HBM_BYTES_PER_S`."""
    peak = HBM_BYTES_PER_S.get(device_name)
    return None if peak is None else nbytes / peak
