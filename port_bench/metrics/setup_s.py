"""setup_s: seconds from the start of the process to the start of the
window: imports, the card's context, the kernels' build or load, the
pool's rendering, the weights, two warm-up steps."""


def read(run):
    return run.setup_s
