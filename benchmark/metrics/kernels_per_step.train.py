"""Step dispatch: device kernels (no copies or sets) in the traced window
over the steps it holds."""


def read(run):
    kernels = run.trace.kernels()
    return len(kernels) / run.stats["count"] if kernels else None
