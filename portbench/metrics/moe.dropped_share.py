"""moe.dropped_share: the share (%) of the token-expert assignments to the
experts this chip holds that fell beyond their capacity, over the forward
pass's ``grads/moe`` records of the traced stretch, their counts
``moe_dropped`` over ``moe_routed`` (``models/moe.py``; moves the cell's
throughput, as the capacity's work).  Nothing where no record counts
them."""
from portbench import records


def read(trace):
    recs = records.chosen(trace)
    if recs is None:
        return None
    fwd = [r for r in recs if r.name == "grads/moe"
           and r.pass_ == "forward" and "moe_routed" in r.counts]
    routed = sum(float(r.counts["moe_routed"]) for r in fwd)
    if not routed:
        return None
    return 100.0 * sum(float(r.counts["moe_dropped"]) for r in fwd) / routed
