"""``job_ms_p90``: the 90th percentile of the window's job times (host
clock, each job ended by a synchronize)."""


def read(r):
    return r.p90_s() * 1e3
