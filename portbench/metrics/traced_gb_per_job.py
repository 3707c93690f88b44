"""``traced_gb_per_job``: the bytes one job's ops read and write, each of
the port's kernels counted as one op (``Compiled.traced_cost``), in GB."""


def read(r):
    return None if r.traced_bytes is None else r.traced_bytes / 1e9
