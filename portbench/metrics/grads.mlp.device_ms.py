"""grads.mlp.device_ms: device milliseconds a step of the feed-forward
blocks with their input norm, in every pass: the program's phase
``grads/mlp`` (``models/model.py``; moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "grads/mlp")
