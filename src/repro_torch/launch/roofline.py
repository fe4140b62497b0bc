"""Wire models of the mesh's compressed collectives and the dry run's
roofline (port of ``repro/launch/roofline.py``: ``_codec_split``,
``_default_bucket_split``, ``bucketed_wire_model``, ``leaf_wire_model``,
``Roofline``, ``count_params``, ``active_params``, ``model_flops`` and
``markdown_table``).
The reference's HLO parsers have no meaning in torch and are not copied.

The models count the bytes one worker puts on the inter-worker wire per
step, ``wire_bytes_per_step`` (hops times the payload, split by dtype from
the codec's own ``wire_bytes``), which the mesh telemetry's
``wire_bytes`` (``core/dist.py``) must equal.  Their times are estimates
from the rates passed in; the defaults are an H100 SXM's (NVIDIA's data
sheet): 3.35 TB/s of device memory and 450 GB/s each way over NVLink.
``COLL_LAT``, a collective's fixed cost, is an assumed figure, not a
measurement.

``Roofline`` turns a dry run's counts (``launch/dryrun.py``) into the
terms against one H100: compute (FLOPs at the dense bf16 peak, the
models' compute dtype), memory (bytes at ``HBM_BW``), the wire (the
simulated workers' ring, from the wire model), and, on a mesh, the
collectives: this rank's collective bytes (by mesh axis and op, the
result of each collective and the payload of each send) at ``LINK_BW``,
one link a rank as the reference's model has one a chip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

HBM_BW = 3.35e12          # bytes/s, H100 SXM device memory
# bytes/s a rank sends: one H100 SXM's NVLink 4, 900 GB/s both ways over
# its 18 links (NVIDIA's H100 data sheet), so 450 GB/s each way; the
# wire models and the mesh's collective term price a rank's bytes at it
LINK_BW = 450e9
COLL_LAT = 2e-6           # s per collective (assumed, not measured)
# dense bf16 tensor-core peak of one H100 SXM (NVIDIA's H100 data sheet,
# without sparsity; at the full 700 W power limit)
PEAK_BF16_FLOPS = 989e12


def _codec_split(codec, shape) -> Dict[str, float]:
    """Per-message payload bytes by dtype, read off the codec itself
    (``core/codec.Codec.wire_bytes``)."""
    return {dt: float(b) for dt, b in codec.wire_bytes(tuple(shape)).items()}


def _default_bucket_split(rows: int, row: int) -> Dict[str, float]:
    # the native row-scale squant wire: int8 levels + f32 per-row scales
    return {"s8": float(rows * row), "f32": float(4 * rows)}


def bucketed_wire_model(*, n_workers: int, n_buckets: int, rows: int,
                        row: int, codec=None, link_bw: float = LINK_BW,
                        hbm_bw: float = HBM_BW,
                        coll_lat: float = COLL_LAT) -> Dict[str, float]:
    """Bytes and an exposed-time estimate for the bucketed ring
    (``core/dist.bucket_ring_reduce``; geometry from
    ``core/bucketing.BucketLayout``).  Per hop ONE stacked payload moves:
    for the default squant wire ``n_buckets*rows*row`` int8 levels plus
    ``4*n_buckets*rows`` f32 row-scales; a codec gives its own split from
    ``wire_bytes((rows, row))``.  The ring makes ``n_workers - 1`` hops
    (``wire_bytes_per_step``); the pipelined schedule overlaps each hop's
    wire time with the previous payload's dequant-accumulate."""
    hops = n_workers - 1
    split = (_codec_split(codec, (rows, row)) if codec is not None
             else _default_bucket_split(rows, row))
    by_dtype = {dt: n_buckets * b for dt, b in split.items()}
    level_b = by_dtype.get("s8", 0.0)          # int8 levels (0 for identity)
    scale_b = sum(b for dt, b in by_dtype.items() if dt != "s8")
    payload = level_b + scale_b
    n_leaves = len([b for b in by_dtype.values() if b > 0])
    hop_comm = payload / link_bw + max(n_leaves, 1) * coll_lat
    # dequant-accumulate: read payload + acc (4B/elem), write acc (4B/elem)
    elems = float(n_buckets * rows * row)
    hop_deq = (payload + 8.0 * elems) / hbm_bw
    return {
        "payload_bytes": payload,
        "s8_bytes": level_b,
        "scale_bytes": scale_b,
        "bytes_by_dtype": by_dtype,
        "wire_bytes_per_step": hops * payload,
        "comm_s": hops * hop_comm,
        "dequant_s": n_workers * hop_deq,
        "step_comm_serial_s": hops * (hop_comm + hop_deq) + hop_deq,
        "step_comm_pipelined_s": hops * max(hop_comm, hop_deq) + hop_deq,
        "exposed_comm_s": hops * max(0.0, hop_comm - hop_deq),
    }


def leaf_wire_model(leaf_shapes, *, n_workers: int, codec=None,
                    link_bw: float = LINK_BW, hbm_bw: float = HBM_BW,
                    coll_lat: float = COLL_LAT) -> Dict[str, float]:
    """The same accounting for the per-leaf rings: every leaf pays its own
    N-1 blocking hops (one collective per payload leaf and a dequant stall
    each)."""
    hops = n_workers - 1
    by_dtype: Dict[str, float] = {}
    for s in leaf_shapes:
        split = (_codec_split(codec, s) if codec is not None
                 else _default_bucket_split(
                     int(np.prod(s[:-1])) if len(s) > 1 else 1,
                     int(s[-1]) if s else 1))
        for dt, b in split.items():
            by_dtype[dt] = by_dtype.get(dt, 0.0) + b
    level_b = by_dtype.get("s8", 0.0)
    scale_b = sum(b for dt, b in by_dtype.items() if dt != "s8")
    n_leaves = len(leaf_shapes)
    payload = level_b + scale_b
    elems = float(sum(int(np.prod(s)) if s else 1 for s in leaf_shapes))
    comm = hops * (payload / link_bw + 2 * n_leaves * coll_lat)
    deq = n_workers * (payload + 8.0 * elems) / hbm_bw
    return {
        "payload_bytes": payload,
        "s8_bytes": hops * level_b,
        "scale_bytes": hops * scale_b,
        "bytes_by_dtype": {dt: hops * b for dt, b in by_dtype.items()},
        "wire_bytes_per_step": hops * payload,
        "comm_s": comm,
        "dequant_s": deq,
        "step_comm_serial_s": comm + deq,
        "step_comm_pipelined_s": comm + deq,     # nothing overlaps
        "exposed_comm_s": comm,
    }


@dataclasses.dataclass
class Roofline:
    """One dry-run combo against one H100 (a rank's counts on a mesh):
    ``compute_s`` = FLOPs at ``PEAK_BF16_FLOPS``, ``memory_s`` = bytes
    accessed at ``HBM_BW``, ``wire_s`` the simulated workers' ring from the
    wire model, ``collective_s`` the mesh's collective bytes
    (``coll_bytes``: {axis: {op: bytes}}) at ``LINK_BW``; ``dominant`` the
    largest term, ``useful_ratio`` = MODEL_FLOPS / counted FLOPs."""
    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    flops: float
    bytes_accessed: float
    wire_s: float
    model_flops: float
    coll_bytes: Optional[Dict[str, Dict[str, float]]] = None
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.flops / PEAK_BF16_FLOPS
        self.memory_s = self.bytes_accessed / HBM_BW
        self.collective_s = collective_s(self.coll_bytes or {})
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "wire": self.wire_s, "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        self.useful_ratio = self.model_flops / max(self.flops, 1.0)
        return self

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def collective_s(coll_bytes: Dict[str, Dict[str, float]],
                 link_bw: float = LINK_BW) -> float:
    """A rank's collective time: all its collective bytes (over every mesh
    axis and op) through its one link."""
    return sum(sum(ops.values()) for ops in coll_bytes.values()) / link_bw


def count_params(params) -> int:
    """The number of parameters of a flat params dict (or a sequence of
    tensors)."""
    leaves = params.values() if isinstance(params, dict) else params
    return int(sum(leaf.numel() for leaf in leaves))


def active_params(cfg, params) -> float:
    """Active parameter count of a flat params dict: the MoE's experts
    scaled by top_k / n_experts (the router counts whole)."""
    total, expert_total = 0.0, 0.0
    for key, leaf in params.items():
        n = float(leaf.numel())
        if "moe" in key and "router" not in key:
            expert_total += n
        else:
            total += n
    if cfg.n_experts:
        total += expert_total * cfg.top_k / cfg.n_experts
    return total


def model_flops(cfg, params, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS: 6 N_active D a train step, 2 N_active D a prefill, 2
    N_active per token a decode step."""
    n_active = active_params(cfg, params)
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch


def markdown_table(rows) -> str:
    """The one-card rows (simulated workers, the ring's wire term)."""
    hdr = ("| arch | shape | dist | W | kind | compute (s) | memory (s) | "
           "wire (s) | dominant | MODEL/counted flops | peak (GB) |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = [
        f"| {r['arch']} | {r['shape']} | {r.get('dist', 'none')} | "
        f"{r.get('workers', 1)} | {r['kind']} | {r['compute_s']:.3e} | "
        f"{r['memory_s']:.3e} | {r['wire_s']:.3e} | **{r['dominant']}** | "
        f"{r['useful_ratio']:.2f} | {r['peak_bytes'] / 1e9:.2f} |"
        for r in rows]
    return hdr + "\n".join(lines)


def mesh_table(rows) -> str:
    """The mesh rows, one rank's terms, as the reference's table prints
    them, with the rank's peak estimate and its attention blocks (query
    heads / KV heads / head-dim lanes)."""
    hdr = ("| arch | shape | mesh | dist | kind | compute (s) | memory (s) | "
           "collective (s) | dominant | MODEL/counted flops | peak (GB) | "
           "attention a rank |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = [
        f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
        f"{r.get('dist', 'none')} | {r['kind']} | {r['compute_s']:.3e} | "
        f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
        f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
        f"{r['peak_bytes'] / 1e9:.2f} | "
        f"{', '.join('/'.join(map(str, b)) for b in r.get('attn_blocks', []))}"
        f" |"
        for r in rows]
    return hdr + "\n".join(lines)
