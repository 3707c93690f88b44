"""``job_ms``: the window's host-clock time over the jobs completed in it."""


def read(r):
    return r.window_s / r.jobs * 1e3
