"""``host_syncs_per_job``: host synchronizations one job makes, by the
warnings of ``torch.cuda.set_sync_debug_mode("warn")``."""


def read(r):
    return None if r.host_syncs is None else float(r.host_syncs)
