"""device.idle_share: the share of an untraced step in which no operation
runs on the device: one less the traced stretch's busy device time a step
over the untraced window's seconds a step (moves the cell's
throughput)."""


def read(trace):
    paced = trace.context["paced"]
    if not trace.ops or not trace.steps or not paced["steps"]:
        return None
    busy = trace.busy_s() / trace.steps
    return 100.0 * (1.0 - busy / (paced["seconds"] / paced["steps"]))
