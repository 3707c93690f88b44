"""``setup_s``: from the process's start to the measured window's: imports,
CUDA start-up, the inputs, the plan, the compile (the kernels' build in a
fresh checkout, their load, the program's warm-up) and a warm job."""


def read(r):
    return r.setup_s
