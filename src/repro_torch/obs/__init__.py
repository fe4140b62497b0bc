"""repro_torch.obs: telemetry, host spans, structured event logs and the
benchmark ledger (port of ``repro/obs``, DESIGN.md §11).

  * ``obs.telemetry``: the metric catalogue and the sweep's metrics carry,
    in tensors on the run's device;
  * ``obs.events``: the JSONL event sink, its schema (the reference's,
    field for field) and ``summarize``;
  * ``obs.spans``: ``span()`` host timers mirrored into
    ``torch.profiler``, and ``profile`` captures of a Chrome trace;
  * ``obs.bench``: the append-only benchmark ledger and its tolerance gate.

CLI: ``python -m repro_torch.obs {summary,validate,diff,dashboard,
bench-append,bench-check,smoke} ...``
"""
from repro_torch.obs import bench, events, spans, telemetry  # noqa: F401
from repro_torch.obs.events import EventLog, read_events, summarize  # noqa: F401,E501
from repro_torch.obs.spans import profile, span  # noqa: F401
