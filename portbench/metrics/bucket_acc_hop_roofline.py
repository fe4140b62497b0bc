"""bucket_acc_hop_roofline: the ring's hop kernel (B3, ``bucket_acc_hop_kernel``) as a
share of its roofline: the bytes its launches must move at the HBM peak
(``portbench/rooflines/bucket_acc_hop_kernel.py``) over their measured
device time (moves the cell's throughput)."""
from portbench.rooflines import bucket_acc_hop_kernel as B3


def read(trace):
    ops = [o for o in trace.kernels() if B3.matches(o.name)]
    wire = trace.context["wire"]
    # the ring launches the kernel once a worker a step, and the bound
    # counts those launches: any other count has no bound here
    if not ops or not wire or len(ops) != wire["workers"] * trace.steps:
        return None
    bound_s = B3.step_bytes(wire["workers"], wire["shape"]) * trace.steps \
        / B3.peaks.HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(o.dur_ns for o in ops) / 1e9)
