"""Telemetry: the metric catalogue and the sweep's metrics carry (port of
``repro/obs/telemetry.py``, DESIGN.md §11).

  * a **metric catalogue** (``Metric`` descriptors registered in
    ``CATALOGUE``) naming each counter, gauge and histogram once, with
    kind, unit and doc: the JSONL event schema (``obs/events.py``) and the
    dashboard derive from it.  The names and their order are the
    reference's, so the two packages write the same schema;
  * a **telemetry carry** for the sweep (``core/sweep.py``): one packed
    float32 vector of the counters and the stride-gauge sums, and a
    fixed-edge histogram, with a leading axis of grid cells.  Counters
    accumulate, stride gauges accumulate a sum that the eval point divides
    by the stride, the histogram counts rounds per bucket.

Everything here is tensor arithmetic on the run's device: nothing waits
for it, and the readings come back with the eval series at the end of the
run.  A sweep without telemetry never builds the carry, so its numbers are
those of a build without this module.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

KINDS = ("counter", "gauge", "hist")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One registered metric: the unit of the catalogue and the schema."""
    name: str
    kind: str                 # 'counter' | 'gauge' | 'hist'
    doc: str
    unit: str = ""
    edges: Optional[Tuple[float, ...]] = None   # hist bucket edges (static)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"metric kind {self.kind!r} not in {KINDS}")
        if (self.kind == "hist") != (self.edges is not None):
            raise ValueError(f"metric {self.name!r}: hist <=> edges")


_CATALOGUE: Dict[str, Metric] = {}


def register(m: Metric) -> Metric:
    if m.name in _CATALOGUE and _CATALOGUE[m.name] != m:
        raise ValueError(f"metric {m.name!r} already registered differently")
    _CATALOGUE[m.name] = m
    return m


def catalogue() -> Tuple[Metric, ...]:
    """All registered metrics, in registration order."""
    return tuple(_CATALOGUE.values())


def get(name: str) -> Metric:
    return _CATALOGUE[name]


# log10-spaced edges for squared-error histograms: bucket 0 is underflow
# (< 1e-12), the last bucket catches overflow and NaN
ERR_EDGES = tuple(float(10.0 ** e) for e in range(-12, 7, 2))


def hist_zeros(m: Metric, batch: Tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch) + (len(m.edges) + 1,), device=device)


@functools.lru_cache(maxsize=16)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, copied there once (without waiting
    for the device) and kept."""
    return torch.tensor(values, dtype=torch.float32).to(device,
                                                        non_blocking=True)


def hist_add(counts: torch.Tensor, m: Metric, value) -> torch.Tensor:
    """Bucket one observation per cell (``value [...]``, counts ``[...,
    B]``): the bucket is the number of edges below the value (the left
    side of ``searchsorted``), and NaN lands past every edge, as the
    reference's sort order puts it."""
    v = torch.as_tensor(value, dtype=torch.float32, device=counts.device)
    edges = _const(m.edges, counts.device)
    below = (edges < v[..., None]) | torch.isnan(v)[..., None]
    idx = below.sum(-1)
    hot = torch.arange(counts.shape[-1], device=counts.device) == idx[..., None]
    return counts + hot.to(counts.dtype)


def hist_edges_list(m: Metric):
    return [float(e) for e in m.edges]


# ---------------------------------------------------------------------------
# sweep-engine telemetry (core/sweep.py; one entry per round, emit per eval)
# ---------------------------------------------------------------------------

SWEEP_COUNTERS = tuple(register(Metric(n, "counter", d, unit=u)).name
                       for n, u, d in [
    ("avail", "workers", "availability draws that came up active "
                         "(pre-straggler Bernoulli/Markov mask)"),
    ("active", "workers", "workers that actually completed the round "
                          "(post straggler drop + entry scrub)"),
    ("straggler_drops", "workers", "available workers that missed the "
                                   "round deadline"),
    ("blowup_hits", "workers", "gradients replaced by blowup_value by the "
                               "fault injector"),
    ("entry_scrub_drops", "workers", "workers masked inactive because their "
                                     "gradient arrived non-finite"),
    ("wire_scrubbed", "payloads", "uplink payloads dropped by the server "
                                  "checksum (codec.validate)"),
    ("uplink_bits", "bits", "paper-side Elias-coded uplink cost "
                            "(DESIGN.md §4)"),
    ("dwnlink_bits", "bits", "paper-side downlink broadcast cost"),
    ("catchup_bits", "bits", "Remark-3 catch-up downloads of returning "
                             "workers"),
])

SWEEP_GAUGES = tuple(register(Metric(n, "gauge", d, unit=u)).name
                     for n, u, d in [
    ("err_up", "norm^2", "mean per-worker uplink compression error "
                         "||Delta_hat - Delta||^2 (Assumption 5), stride "
                         "mean"),
    ("err_dwn", "norm^2", "downlink compression error ||omega - ghat||^2, "
                          "stride mean"),
    ("ghat_norm", "norm", "server aggregate norm ||ghat||, stride mean"),
])

SWEEP_EVAL_GAUGES = tuple(register(Metric(n, "gauge", d, unit=u)).name
                          for n, u, d in [
    ("mem_drift", "norm", "mean_i ||h_i - grad F_i(w*)|| — the memory-"
                          "drift term of the linear-rate threshold "
                          "(sampled at eval points; w*=0 when no w_star "
                          "was passed)"),
    ("e_norm", "norm", "mean error-feedback buffer norm ||e_i|| (zero "
                       "unless Dore/EF)"),
    ("rollbacks", "count", "divergence-sentinel rollbacks so far "
                           "(cumulative at eval points)"),
])

ERR_UP_HIST = register(Metric(
    "err_up_hist", "hist",
    "distribution of per-round uplink compression error (log10 buckets; "
    "first bucket underflow, last bucket overflow/NaN)",
    unit="rounds", edges=ERR_EDGES))

SWEEP_METRICS = SWEEP_COUNTERS + SWEEP_GAUGES + SWEEP_EVAL_GAUGES + (
    ERR_UP_HIST.name,)

# the carry: one packed float32 vector per cell for every scalar slot
# (counters first, then stride-gauge sums) and the histogram, so a round
# adds one vector instead of twelve scalars
_PACK = SWEEP_COUNTERS + SWEEP_GAUGES
_PACK_IDX = {n: i for i, n in enumerate(_PACK)}
# reset multiplier: keep counters (1), zero stride-gauge sums (0)
_STRIDE_KEEP = np.asarray([0.0 if n in SWEEP_GAUGES else 1.0
                           for n in _PACK], np.float32)


def sweep_zeros(batch: Tuple[int, ...] = (),
                device=None) -> Dict[str, torch.Tensor]:
    """A fresh telemetry carry for ``batch`` cells."""
    return {"pack": torch.zeros(tuple(batch) + (len(_PACK),),
                                device=device),
            ERR_UP_HIST.name: hist_zeros(ERR_UP_HIST, batch, device)}


def sweep_round(**values) -> torch.Tensor:
    """One round's readings as the packed vector ``[..., len(_PACK)]``;
    a missing entry is zero, a number is the same for every cell."""
    like = next(v for v in values.values() if isinstance(v, torch.Tensor))

    def slot(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).expand(like.shape)
        return torch.full(like.shape, float(v), device=like.device)
    return torch.stack([slot(values.get(n, 0.0)) for n in _PACK], -1)


def sweep_accumulate(acc: Dict[str, torch.Tensor],
                     tel: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"pack": acc["pack"] + tel,
            ERR_UP_HIST.name: hist_add(acc[ERR_UP_HIST.name], ERR_UP_HIST,
                                       tel[..., _PACK_IDX["err_up"]])}


def sweep_emit(acc: Dict[str, torch.Tensor], eval_every: int,
               **eval_gauges) -> Dict[str, torch.Tensor]:
    """The reading at an eval point, by metric name: cumulative counters
    and histogram, stride-mean gauges, and the eval-time gauges
    (mem_drift, e_norm, rollbacks)."""
    pack = acc["pack"]
    out = {c: pack[..., _PACK_IDX[c]] for c in SWEEP_COUNTERS}
    for g in SWEEP_GAUGES:
        out[g] = pack[..., _PACK_IDX[g]] / float(eval_every)
    out[ERR_UP_HIST.name] = acc[ERR_UP_HIST.name]
    for g in SWEEP_EVAL_GAUGES:
        v = eval_gauges.get(g)
        out[g] = (torch.zeros(pack.shape[:-1], device=pack.device)
                  if v is None else v.to(torch.float32).expand(
                      pack.shape[:-1]))
    return out


def sweep_reset_stride(acc: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Zero the stride-mean sums after an eval reading (counters and the
    histogram stay cumulative)."""
    keep = _const(tuple(_STRIDE_KEEP.tolist()), acc["pack"].device)
    return {"pack": acc["pack"] * keep,
            ERR_UP_HIST.name: acc[ERR_UP_HIST.name]}


# ---------------------------------------------------------------------------
# mesh telemetry (core/dist.py; per-step values, no carry)
# ---------------------------------------------------------------------------

MESH_METRICS = tuple(register(Metric(n, "gauge", d, unit=u)).name
                     for n, u, d in [
    ("wire_bytes", "bytes", "physical payload bytes this worker moved on "
                            "the inter-worker wire this step (hops x "
                            "codec.wire_bytes; reconciles against "
                            "launch/roofline wire models)"),
    ("mesh_active", "frac", "participation mask of this round (pmean over "
                            "workers = participating fraction)"),
    ("mesh_scrubbed", "payloads", "payload units (buckets/leaves) dropped "
                                  "by the server checksum this step"),
    ("mesh_blowup_hits", "count", "gradient blowups injected this step"),
])


def mesh_zeros(device=None) -> Dict[str, torch.Tensor]:
    return {m: torch.zeros((), device=device) for m in MESH_METRICS}


def tree_to_numpy(tel) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v) for k, v in tel.items()}
