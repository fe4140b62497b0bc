"""grads.device_ms: device milliseconds a step of the per-worker
gradients: the operations launched inside the harness's range around the
program's gradient function; in a cell without the wire (no such hook),
every operation outside the optimizer's range (moves the cell's
throughput)."""
from portbench.trace import GRADS, OPTIM


def read(trace):
    if not trace.steps:
        return None
    if trace.context["wire"]:
        ns = sum(o.dur_ns for o in trace.ops if o.range == GRADS)
    else:
        ns = sum(o.dur_ns for o in trace.ops if o.range != OPTIM)
    return ns / 1e6 / trace.steps if ns else None
