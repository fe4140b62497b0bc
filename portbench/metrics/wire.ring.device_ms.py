"""wire.ring.device_ms: device milliseconds a step of the ring, the
program's phase ``wire/ring`` (the accumulator and the W hops of
``bucket_acc_hop_kernel``; moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "wire/ring")
