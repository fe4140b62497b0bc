"""grads.backward.device_ms: device milliseconds a step of the gradients'
backward pass, the operations inside the program's phase ``grads`` whose
pass (``obs/spans.py``) reads backward (moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "grads", pass_="backward")
