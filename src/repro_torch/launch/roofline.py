"""Wire models of the mesh's compressed collectives (port of the numpy wire
models of ``repro/launch/roofline.py``: ``_codec_split``,
``_default_bucket_split``, ``bucketed_wire_model`` and
``leaf_wire_model``).  The reference's HLO parsers have no meaning here and
are not copied.

The models count the bytes one worker puts on the inter-worker wire per
step, ``wire_bytes_per_step`` (hops times the payload, split by dtype from
the codec's own ``wire_bytes``), which the mesh telemetry's
``wire_bytes`` (``core/dist.py``) must equal.  Their times are estimates
from the rates passed in; the defaults are an H100 SXM's (NVIDIA's data
sheet): 3.35 TB/s of device memory and 450 GB/s each way over NVLink.
``COLL_LAT``, a collective's fixed cost, is an assumed figure, not a
measurement.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

HBM_BW = 3.35e12          # bytes/s, H100 SXM device memory
LINK_BW = 450e9           # bytes/s, H100 NVLink, one direction
COLL_LAT = 2e-6           # s per collective (assumed, not measured)


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
