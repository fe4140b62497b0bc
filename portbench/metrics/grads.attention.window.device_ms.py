"""grads.attention.window.device_ms: device milliseconds a step of the
windowed attentions, in every pass: the program's ``grads/attention``
records whose count ``window`` is above 0 (``models/model.py``), their
backward records included (moves the cell's throughput).  Nothing where
no record counts a window (an older port, or no windowed layer)."""
from portbench import records


def read(trace):
    recs = records.record_ns(trace)
    if recs is None:
        return None
    ns = [n for r, n in recs if r.name == "grads/attention"
          and r.counts.get("window", 0) > 0]
    return sum(ns) / 1e6 / trace.steps if ns else None
