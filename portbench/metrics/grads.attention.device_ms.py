"""grads.attention.device_ms: device milliseconds a step of attention,
self and cross, with its input norm, in every pass: the program's phase
``grads/attention`` (``models/model.py``; moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "grads/attention")
