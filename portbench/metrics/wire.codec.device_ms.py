"""wire.codec.device_ms: device milliseconds a step of the codec, the
program's phases ``wire/encode`` (the uplink's encode, mask, faults and
checksum), ``wire/decode`` (each worker's own payload) and ``wire/downlink``
(the aggregate encoded and decoded; moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "wire/encode", "wire/decode",
                            "wire/downlink")
