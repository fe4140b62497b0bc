"""Flat fixed-size bucketing of gradients for the compressed mesh wire (port
of ``repro/core/bucketing.py``).

The mesh wire does not ship one message per parameter: it flattens the
whole gradient into ``<= max_buckets`` equal f32 buckets of ``rows x row``
elements (the tail zero-padded) and ships one ``int8 levels + f32 row-scales``
payload per bucket.  ``make_layout`` is the static index map, pure integer
maths; ``bucketize`` and ``unbucketize`` move tensors through it.

Leaves are an ORDERED sequence of tensors.  The order is the reference's
pytree flatten order (sorted dict keys: ``head, layer_00/b, layer_00/w, ...``
for ToyMLP), which the models expose (``models/toy.py``); any other order
puts other numbers in each bucket.

Leading axes: ``bucketize`` and ``unbucketize`` accept leaves with extra
leading axes (the simulated worker axis ``[W]``); they carry through to the
bucket stack as ``[W, B, R, C]``.

Randomness: the reference folds the bucket index into a PRNG key per bucket
(``bucket_keys``); here the codec uniforms come in as a tensor of the bucket
stack's shape, one row per wire message (``core/noise.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

DEFAULT_BUCKET_BYTES = 1 << 16      # 64 KiB of f32 payload per bucket
DEFAULT_MAX_BUCKETS = 16            # the "<= K" cap of DESIGN.md §7
DEFAULT_ROW = 256                   # wire row length C (per-row scale tile)

ShapeLike = Union[torch.Tensor, Sequence[int]]


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static index map between an ordered list of leaves and its
    [B, R, C] bucket stack."""
    shapes: Tuple[Tuple[int, ...], ...]   # leaf shapes, flatten order
    sizes: Tuple[int, ...]                # leaf element counts
    offsets: Tuple[int, ...]              # leaf start offsets in the flat vec
    total: int                            # sum(sizes)
    n_buckets: int                        # B
    rows: int                             # R
    row: int                              # C

    @property
    def bucket_elems(self) -> int:
        return self.rows * self.row

    @property
    def padded_total(self) -> int:
        return self.n_buckets * self.bucket_elems

    @property
    def pad(self) -> int:
        return self.padded_total - self.total

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.n_buckets, self.rows, self.row)

    @property
    def level_bytes(self) -> int:
        """int8 wire bytes of one worker's levels payload."""
        return self.padded_total

    @property
    def scale_bytes(self) -> int:
        """f32 wire bytes of one worker's per-row scales payload."""
        return 4 * self.n_buckets * self.rows


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _shape(leaf: ShapeLike) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if isinstance(leaf, torch.Tensor)
                                  else leaf))


def make_layout(leaves: Sequence[ShapeLike], *,
                bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                max_buckets: int = DEFAULT_MAX_BUCKETS,
                row: int = DEFAULT_ROW) -> BucketLayout:
    """Bucket geometry for ``leaves`` (tensors or shapes, in flatten order).

    The target bucket is ``bucket_bytes`` of f32 payload rounded up to a
    multiple of ``row``; if that needs more than ``max_buckets`` buckets,
    buckets grow so exactly ``max_buckets`` cover the leaves.  The
    reference's arithmetic, step for step.
    """
    if bucket_bytes <= 0 or max_buckets <= 0 or row <= 0:
        raise ValueError((bucket_bytes, max_buckets, row))
    shapes = tuple(_shape(l) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    total = off
    if total == 0:
        raise ValueError("cannot bucketize an empty list of leaves")
    elems = _round_up(max(bucket_bytes // 4, row), row)
    elems = min(elems, _round_up(total, row))    # bucket_bytes=inf -> B=1
    n_buckets = -(-total // elems)
    if n_buckets > max_buckets:
        elems = _round_up(-(-total // max_buckets), row)
        n_buckets = -(-total // elems)
    return BucketLayout(shapes=shapes, sizes=sizes, offsets=tuple(offsets),
                        total=total, n_buckets=n_buckets, rows=elems // row,
                        row=row)


def _lead(layout: BucketLayout, leaf: torch.Tensor) -> Tuple[int, ...]:
    nd = leaf.dim() - len(layout.shapes[0])
    if nd < 0 or tuple(leaf.shape[nd:]) != layout.shapes[0]:
        raise ValueError(f"leaf of shape {tuple(leaf.shape)} does not end in "
                         f"the layout's first shape {layout.shapes[0]}")
    return tuple(leaf.shape[:nd])


def bucketize(layout: BucketLayout,
              leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Leaves (each ``lead + shape``) -> ``lead + [B, R, C]`` f32 bucket
    stack, tail zero-padded."""
    if len(leaves) != len(layout.shapes):
        raise ValueError(f"{len(leaves)} leaves for a layout of "
                         f"{len(layout.shapes)}")
    lead = _lead(layout, leaves[0])
    parts = [l.reshape(lead + (-1,)).to(torch.float32) for l in leaves]
    if layout.pad:
        parts.append(leaves[0].new_zeros(lead + (layout.pad,),
                                         dtype=torch.float32))
    return torch.cat(parts, dim=-1).reshape(lead + layout.shape)


def unbucketize(layout: BucketLayout, buckets: torch.Tensor,
                like: Optional[Sequence[torch.Tensor]] = None):
    """Exact inverse of ``bucketize`` (padding dropped): a list of leaves,
    each ``lead + shape``.  ``like``: leaves whose dtypes the output takes."""
    lead = tuple(buckets.shape[:-3])
    flat = buckets.reshape(lead + (-1,))[..., :layout.total]
    out = [flat[..., o:o + s].reshape(lead + shape)
           for o, s, shape in zip(layout.offsets, layout.sizes,
                                  layout.shapes)]
    if like is not None:
        out = [o.to(l.dtype) for o, l in zip(out, like)]
    return out


def encode_buckets(codec, buckets: torch.Tensor, u: torch.Tensor):
    """Encode a ``[..., B, R, C]`` bucket stack with any ``core/codec.py``
    codec; ``u`` holds its uniforms, of the stack's shape.  The codec treats
    every row as one message, so the payload's leaves keep the leading axes
    (the unit the ring moves)."""
    return codec.encode(buckets, u)


def decode_buckets(codec, payload) -> torch.Tensor:
    """Inverse of ``encode_buckets``: payload -> ``[..., B, R, C]`` f32."""
    return codec.decode(payload)
