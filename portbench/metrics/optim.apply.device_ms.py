"""optim.apply.device_ms: device milliseconds a step of the parameters'
update ``p - u``, the program's phase ``optim/apply`` (outside the
harness's optimizer range; moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "optim/apply")
