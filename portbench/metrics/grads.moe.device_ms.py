"""grads.moe.device_ms: device milliseconds a step of the expert layers
with their input norm (routing, dispatch, the experts, the combine), in
every pass: the program's phase ``grads/moe`` (``models/model.py``; moves
the cell's throughput).  Nothing where the program has no such phase."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "grads/moe")
