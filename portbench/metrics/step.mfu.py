"""step.mfu: the whole step's share of the card's dense bf16 peak, the
benchmark's model FLOPs a step (``portbench/flops.py``) times the steps of
the untraced window over its seconds, host clock (moves
the cell's throughput)."""
from portbench import peaks


def read(trace):
    flops, paced = trace.context.get("flops_per_step"), trace.context["paced"]
    if not flops or not paced["steps"]:
        return None
    return 100.0 * flops * paced["steps"] / paced["seconds"] \
        / peaks.BF16_DENSE_FLOPS
