"""Server dequant-accumulate over N compressed worker payloads.

Replaces the Pallas kernel ``repro/kernels/ring_sum.py::ring_sum`` with the
hand-written CUDA kernel ``csrc/ring_sum.cu``: for q [N, M, C] int8 and
scales [N, M, 1] f32 it returns ``sum_i q[i] * scales[i]`` as [M, C] f32,
summed in worker order with one write per output element.

Bound on an H100 SXM: bytes.  It reads N*M*C int8 levels and N*M f32 scales
and writes M*C f32, at 3.35 TB/s.  No partial sum reaches device memory,
and each sum's loads are in flight at once: wide rows (C a multiple of 16,
16-byte aligned) take 16 levels a thread with one 16-byte load per worker;
narrow cells (the round's [20, 128, 40]) are staged whole in shared memory,
a block a cell; anything else takes one thread an output.  See the source.

Strides: the wrapper passes the strides of q's and scales' first two axes to
the kernel, so the Artemis round hands it its [M cells, N workers] layout
transposed to [N, M] as a view, without a copy.  q's last axis must be
contiguous.

``ring_sum`` launches the kernel for CUDA tensors (or raises) and takes
``ring_sum_plain`` only for CPU tensors.  ``ring_sum.launches`` counts kernel
launches.

``worker_sum`` is a helper of the same kernel, not a TPU kernel of its own:
the sum over the worker axis of float32 rows ``x [..., N, d] -> [..., d]``,
in worker order from 0.0, as ``jnp.sum(x, axis=0)`` adds on the CPU (the
Artemis round's server sums, the sweep's bit meter).  The same loop as
ring_sum's, templated on its load: a float32 row instead of a level times a
scale.  One launch replaces torch's one reduction, whose order is not the
workers'.  ``worker_sum.launches`` counts its launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(q: torch.Tensor, scales: torch.Tensor) -> None:
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scales float32, got {q.dtype} "
                        f"and {scales.dtype}")
    if q.dim() != 3 or tuple(scales.shape) != (q.shape[0], q.shape[1], 1):
        raise ValueError(f"q [N, M, C] needs scales [N, M, 1]: "
                         f"{tuple(q.shape)}, {tuple(scales.shape)}")
    if scales.device != q.device:
        raise ValueError(f"scales on {scales.device}, q on {q.device}")


def ring_sum_plain(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The kernel's sum in plain PyTorch: an explicit loop over workers, so
    the summation order is the kernel's."""
    _check(q, scales)
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for i in range(q.shape[0]):
        acc = acc + q[i].to(torch.float32) * scales[i]
    return acc


def launch(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q [N, M, C], scales [N, M, 1] and
    return [M, C].  Counts nothing: each wrapper that launches it counts its
    own launches."""
    if q.device.type != "cuda":
        raise ValueError(f"the ring_sum kernel runs on cuda, not {q.device}")
    _check(q, scales)
    n, m, c = q.shape
    if c > 1 and q.stride(2) != 1:
        raise ValueError("q's last axis must be contiguous")
    out = torch.empty((m, c), dtype=torch.float32, device=q.device)
    lib = _build.load("ring_sum")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.ring_sum(q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                            n, m, c, q.stride(0), q.stride(1),
                            scales.stride(0), scales.stride(1), stream)
    _build.check("ring_sum", code)
    return out


def ring_sum(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: [N, M, C] int8, scales: [N, M, 1] f32 -> [M, C] f32."""
    if q.device.type == "cpu":
        return ring_sum_plain(q, scales)
    out = launch(q, scales)
    ring_sum.launches += 1
    return out


ring_sum.launches = 0


def _check_rows(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"worker_sum adds float32 rows, not {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"worker_sum needs [..., N, d], got "
                         f"{tuple(x.shape)}")


def worker_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's sum in plain PyTorch: a loop over the N workers, each
    step one add over every other axis."""
    _check_rows(x)
    acc = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.float32,
                      device=x.device)
    for i in range(x.shape[-2]):
        acc = acc + x[..., i, :]
    return acc


def worker_sum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., N, d] float32 -> [..., d], summed over N in worker order."""
    if x.device.type == "cpu":
        return worker_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"worker_sum runs on cuda or cpu, not {x.device}")
    _check_rows(x)
    *lead, n, d = x.shape
    if d > 1 and x.stride(-1) != 1:
        x = x.contiguous()
    rows = x.reshape(-1, n, d)              # a view where the strides allow
    m = rows.shape[0]
    out = torch.empty((m, d), dtype=torch.float32, device=x.device)
    lib = _build.load("ring_sum")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.worker_sum(rows.data_ptr(), out.data_ptr(), n, m, d,
                              rows.stride(1), rows.stride(0), stream)
    _build.check("ring_sum", code)
    worker_sum.launches += 1
    return out.reshape(*lead, d)


worker_sum.launches = 0
