"""Fused dequant-accumulate for the bucketed ring.

``bucket_acc`` replaces the Pallas kernel
``repro/kernels/bucket_ring.py::bucket_acc`` with the hand-written CUDA
kernel ``csrc/bucket_ring.cu``: one ring hop folds the arriving payload,
``q [..., R, C] int8`` levels and ``scales [..., R, 1] f32`` per-row scales,
into the f32 accumulator, ``acc + float(q) * scales``.  The leading axes may
be any number; the simulated ring hands it ``[W, B, R, C]`` and the wrapper
flattens them to one.  The reference's ``block_rows`` tiles TPU VMEM and has
no meaning on the card, so it is dropped.

Bound on an H100 SXM: bytes (4 + 1 read and 4 written per element, 4 per row
of scales, at 3.35 TB/s).  The kernel rounds the multiply and the add
separately, so a chain of hops equals the decode-then-add ring bit for bit.

``bucket_ring_sum`` is the all-at-once reduce, ``sum_i q[i] * scales[i]``
over ``[N, B, R, C]``: the same function as ``ring_sum`` on the view
``[N, B*R, C]``, in the same worker order with the same rounding, so it
launches the hand-written ``csrc/ring_sum.cu`` on that view.  It is the
oracle of the hop chain, and the mesh's ``reduce_impl="psum"`` on the
simulated worker axis.

Both wrappers launch their kernel for CUDA tensors (or raise) and take their
plain versions only for CPU tensors; ``bucket_acc.launches`` and
``bucket_ring_sum.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ring_sum as _ring_sum


def _check(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor) -> None:
    if (acc.dtype != torch.float32 or q.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise TypeError(f"acc must be float32, q int8 and scales float32, "
                        f"got {acc.dtype}, {q.dtype} and {scales.dtype}")
    if (q.dim() < 2 or acc.shape != q.shape
            or tuple(scales.shape) != tuple(q.shape[:-1]) + (1,)):
        raise ValueError(f"acc and q [..., R, C] need scales [..., R, 1]: "
                         f"{tuple(acc.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scales.shape)}")
    if not acc.device == q.device == scales.device:
        raise ValueError(f"acc on {acc.device}, q on {q.device}, scales on "
                         f"{scales.device}")


def bucket_acc_plain(acc: torch.Tensor, q: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """The kernel's hop in plain PyTorch: decode, then add."""
    _check(acc, q, scales)
    return acc + q.to(torch.float32) * scales


def bucket_acc(acc: torch.Tensor, q: torch.Tensor,
               scales: torch.Tensor) -> torch.Tensor:
    """acc [..., R, C] f32, q [..., R, C] int8, scales [..., R, 1] f32 ->
    ``acc + float(q) * scales`` [..., R, C] f32, in a new tensor."""
    if q.device.type == "cpu":
        return bucket_acc_plain(acc, q, scales)
    if q.device.type != "cuda":
        raise ValueError(f"bucket_acc runs on cuda or cpu, not {q.device}")
    _check(acc, q, scales)
    if not (acc.is_contiguous() and q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("bucket_acc needs contiguous acc, q and scales")
    c = q.shape[-1]
    m = q.numel() // c if c else 0
    out = torch.empty_like(acc)
    lib = _build.load("bucket_ring")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.bucket_acc(acc.data_ptr(), q.data_ptr(), scales.data_ptr(),
                              out.data_ptr(), m, c, stream)
    _build.check("bucket_ring", code)
    bucket_acc.launches += 1
    return out


bucket_acc.launches = 0


def _check_stack(q: torch.Tensor, scales: torch.Tensor) -> None:
    if q.dim() != 4 or tuple(scales.shape) != tuple(q.shape[:3]) + (1,):
        raise ValueError(f"q [N, B, R, C] needs scales [N, B, R, 1]: "
                         f"{tuple(q.shape)}, {tuple(scales.shape)}")


def bucket_ring_sum_plain(q: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """The all-at-once sum in plain PyTorch: an explicit loop over workers
    from zeros, so the summation order is the kernel's (and the hop
    chain's)."""
    _check_stack(q, scales)
    return _ring_sum.ring_sum_plain(q.flatten(1, 2),
                                    scales.flatten(1, 2)).view(q.shape[1:])


def bucket_ring_sum(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q [N, B, R, C] int8, scales [N, B, R, 1] f32 -> [B, R, C] f32."""
    _check_stack(q, scales)
    if q.device.type == "cpu":
        return bucket_ring_sum_plain(q, scales)
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("bucket_ring_sum needs contiguous q and scales")
    out = _ring_sum.launch(q.flatten(1, 2), scales.flatten(1, 2))
    bucket_ring_sum.launches += 1
    return out.view(q.shape[1:])


bucket_ring_sum.launches = 0
