"""``device_ops_per_job``: the profiler's device events (kernels, copies,
fills) in the traced stretch, over its whole jobs."""


def read(r):
    if r.trace is None:
        return None
    return len(r.trace.device_ops) / r.trace.jobs
