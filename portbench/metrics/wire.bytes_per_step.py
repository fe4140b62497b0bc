"""wire.bytes_per_step: gigabytes (1e9 bytes) the ring moves a step, summed
over the workers: the ``wire_bytes`` count of the program's ``wire/ring``
records (hops times each payload's bytes; moves the cell's throughput)."""
from portbench import phases


def read(trace):
    n = phases.count_per_step(trace, "wire_bytes")
    return None if n is None else n / 1e9
