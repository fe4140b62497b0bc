"""grads.attention.fused_per_step: the attention calls a step that went
through the fused kernel, the ``attn_fused`` count of the program's
``grads/attention`` records (``models/model.py``), forward and remat's
recompute each counting one a call (moves the cell's throughput).  Nothing
where the program's records carry no such count."""
from portbench import phases


def read(trace):
    return phases.count_per_step(trace, "attn_fused")
