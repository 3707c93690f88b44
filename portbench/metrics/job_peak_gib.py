"""``job_peak_gib``: the most device memory a window's job allocated
beyond what was held when it started (``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats``), in GiB; nothing off the card."""


def read(r):
    if r.job_peak_bytes is None:
        return None
    return r.job_peak_bytes / 2**30
