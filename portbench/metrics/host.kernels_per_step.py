"""host.kernels_per_step: device kernels the host launched a step, over the
traced stretch (moves the cell's throughput)."""


def read(trace):
    n = len(trace.kernels())
    return n / trace.steps if n and trace.steps else None
