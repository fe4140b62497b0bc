"""wire.layout.device_ms: device milliseconds a step of the bucket layout,
the program's phases ``wire/bucketize`` and ``wire/unbucketize`` (the
gradients into ``[W, B, R, C]`` buckets and the aggregate back into the
leaves; moves the cell's throughput)."""
from portbench import phases


def read(trace):
    return phases.device_ms(trace, "wire/bucketize", "wire/unbucketize")
