"""``compile_ms``: host clock around ``lower(items).compile()``: the
prepared run, the kernels' libraries loaded (built first in a fresh
checkout), and the program's warm-up job over zeros of the items' shape,
which runs through the engine and the kernels."""


def read(r):
    return r.spans.seconds("compile") * 1e3
