"""``device_idle_pct``: the share of the traced stretch in which no device
op ran (the union of the device ops' intervals), in %."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
