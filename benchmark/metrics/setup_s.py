"""Everything before the window: imports, the kernel build or its cache,
weights, the program's set-up and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
