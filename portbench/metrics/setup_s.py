"""Process start to the window's start: imports, weights, quantization,
warm-up of the cell's shapes (and, in a fresh checkout, the kernel build)."""


def read(run):
    return run.setup_s
