"""grads.head.device_ms: device milliseconds a step of the head, the final
norm and the chunked cross-entropy over the vocabulary, both passes: the
program's phase ``grads/head`` (``models/model.py``; moves the cell's
throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "grads/head")
