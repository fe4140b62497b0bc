"""wire.memory.device_ms: device milliseconds a step of the memories, the
program's phase ``wire/memory`` (the f32 casts, participation masks, the
difference to h, error feedback, h, hbar and the estimate ghat; moves the
cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "wire/memory")
