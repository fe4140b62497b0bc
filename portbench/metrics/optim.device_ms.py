"""optim.device_ms: device milliseconds a step of the optimizer's update,
the operations launched inside the harness's range around it (moves
the cell's throughput)."""
from portbench.trace import OPTIM


def read(trace):
    ns = sum(o.dur_ns for o in trace.ops if o.range == OPTIM)
    return ns / 1e6 / trace.steps if ns and trace.steps else None
