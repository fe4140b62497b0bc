"""wire.device_ms: device milliseconds a step of the Artemis wire, every
operation launched outside the gradients' and the optimizer's ranges
(bucketize, noise, encode, ring, decode, memories, downlink, unbucketize,
and the parameters' update ``p - u``); nothing in a cell without the wire
(moves the cell's throughput)."""
from portbench.trace import GRADS, OPTIM


def read(trace):
    if not trace.context["wire"] or not trace.steps:
        return None
    ns = sum(o.dur_ns for o in trace.ops if o.range not in (GRADS, OPTIM))
    return ns / 1e6 / trace.steps if ns else None
