"""Host synchronizations of one call, counted by the warnings of
``torch.cuda.set_sync_debug_mode("warn")``: their count, and for each the
innermost line of the port on the stack when it was raised."""

from __future__ import annotations

import os
import traceback
import warnings

import torch


def host_syncs(fn) -> dict:
    where: dict[str, int] = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        at = f"{os.path.basename(filename)}:{lineno}"
        for frame in reversed(traceback.extract_stack()[:-1]):
            if "repro_torch" in frame.filename:
                at = f"{os.path.basename(frame.filename)}:{frame.lineno}"
                break
        where[at] = where.get(at, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"count": sum(where.values()), "at": where}
