"""``plan_ms``: host clock around ``MapReduce(app, ...)``, the first plan
of the run's process (the optimizer, the plan key, the tiling)."""


def read(r):
    return r.spans.seconds("plan") * 1e3
