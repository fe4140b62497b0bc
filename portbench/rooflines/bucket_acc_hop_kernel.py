"""B3, ``csrc/bucket_ring.cu``'s ``bucket_acc_hop_kernel``: one hop of the
ring over the ``[W, B, R, C]`` payload stack, ``acc[w] += float(q[w -
hop]) * scale[w - hop]`` in place (hop 0 writes ``acc`` without reading
it).  The bytes a launch must move, each input read once and each output
written once: int8 levels (1 B an element), f32 scales (4 B a row), the
f32 accumulator read (4 B, not at hop 0) and written (4 B).  A frozen copy
of the count of the port's ``bench/kernel_bench.py``."""
from __future__ import annotations

import math
import re
from typing import Sequence

from portbench import peaks

KERNEL = "bucket_acc_hop_kernel"
_NAME = re.compile(r"(^|[\s:])bucket_acc_hop_kernel[<(]")


def matches(name: str) -> bool:
    """Whether a device trace's kernel name is this kernel's (a template
    instance, demangled: ``void (anonymous namespace)::bucket_acc_hop_kernel
    <16>(...)``)."""
    return bool(_NAME.search(name))


def launch_bytes(stack: Sequence[int], hop: int) -> float:
    """Bytes of one launch over a payload stack of shape ``stack`` (its
    last axis the row)."""
    n = math.prod(stack)
    return (9.0 if hop else 5.0) * n + 4.0 * (n // stack[-1])


def step_bytes(workers: int, shape: Sequence[int]) -> float:
    """Bytes of one step's ring: W launches over ``[W, B, R, C]``."""
    stack = (workers,) + tuple(shape)
    return sum(launch_bytes(stack, hop) for hop in range(workers))


def bound_us(nbytes: float) -> float:
    return nbytes / peaks.HBM_BYTES_PER_S * 1e6
