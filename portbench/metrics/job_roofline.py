"""``job_roofline``: the job's least bytes (each input byte read once, each
result byte written once; ``least_bytes.job_bytes``) at the card's
published bandwidth, over the summed device time of a job's device ops,
in %.  Nothing for a card with no published peak here, or with no trace."""

from portbench import least_bytes


def read(r):
    if r.trace is None:
        return None
    least = least_bytes.least_seconds(r.least_bytes, r.device_name)
    device_s = r.trace.device_s() / r.trace.jobs
    if least is None or device_s <= 0:
        return None
    return 100.0 * least / device_s
