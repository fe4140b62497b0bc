"""grads.recompute.device_ms: device milliseconds a step of the gradients'
recompute pass, the operations inside the program's phase ``grads`` whose
pass (``obs/spans.py``) reads recompute (moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "grads", pass_="recompute")
