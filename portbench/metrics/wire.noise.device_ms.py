"""wire.noise.device_ms: device milliseconds a step of the wire's uniform
draws, the program's phase ``wire/noise`` (``core/dist.py::_draws``; moves
the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "wire/noise")
