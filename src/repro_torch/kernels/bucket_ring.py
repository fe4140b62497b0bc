"""Fused dequant-accumulate for the bucketed ring.

``bucket_acc`` replaces the Pallas kernel
``repro/kernels/bucket_ring.py::bucket_acc`` with the hand-written CUDA
kernel ``csrc/bucket_ring.cu``: one ring hop folds the arriving payload,
``q [..., R, C] int8`` levels and ``scales [..., R, 1] f32`` per-row scales,
into the f32 accumulator, ``acc + float(q) * scales``, in a new tensor.  The
leading axes may be any number.  The reference's ``block_rows`` tiles TPU
VMEM and has no meaning on the card, so it is dropped.

``bucket_acc_hop_`` is the same fold for one hop of the simulated ring over
a ``[W, B, R, C]`` stack, in place: worker w adds the payload of worker
``(w - hop) mod W``, the one ``torch.roll(q, hop, 0)`` puts in its slot, so
the ring needs no roll of the levels; hop 0 starts the sum.  Both wrappers
launch the same kernel, and both count in ``bucket_acc.launches``.

Bound on an H100 SXM: bytes (4 + 1 read and 4 written per element, 4 per row
of scales, at 3.35 TB/s; hop 0 reads no accumulator).  The kernel rounds the
multiply and the add separately, so a chain of hops equals the
decode-then-add ring bit for bit.

``bucket_ring_sum`` is the all-at-once reduce, ``sum_i q[i] * scales[i]``
over ``[N, B, R, C]``: the same function as ``ring_sum`` on the view
``[N, B*R, C]``, in the same worker order with the same rounding, so it
launches the hand-written ``csrc/ring_sum.cu`` on that view.  It is the
oracle of the hop chain, and the mesh's ``reduce_impl="psum"`` on the
simulated worker axis.

Every wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version only for CPU tensors; ``bucket_acc.launches`` and
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


def _launch(acc_in, q: torch.Tensor, scales: torch.Tensor,
            out: torch.Tensor, w: int, hop: int) -> None:
    """One launch of the hop kernel over ``q`` as ``[w, S]``; ``acc_in`` is
    None to start the sum from 0.0."""
    if not all(t is None or t.is_contiguous()
               for t in (acc_in, out, q, scales)):
        raise ValueError("bucket_acc needs contiguous acc, q and scales")
    c = q.shape[-1]
    lib = _build.load("bucket_ring")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.bucket_acc_hop(
            None if acc_in is None else acc_in.data_ptr(), q.data_ptr(),
            scales.data_ptr(), out.data_ptr(), w, q.numel() // w, c, hop,
            stream)
    _build.check("bucket_ring", code)
    bucket_acc.launches += 1


def _on_card(name: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return q.device.type == "cuda"


def bucket_acc(acc: torch.Tensor, q: torch.Tensor,
               scales: torch.Tensor) -> torch.Tensor:
    """acc [..., R, C] f32, q [..., R, C] int8, scales [..., R, 1] f32 ->
    ``acc + float(q) * scales`` [..., R, C] f32, in a new tensor."""
    if not _on_card("bucket_acc", q):
        return bucket_acc_plain(acc, q, scales)
    _check(acc, q, scales)
    out = torch.empty(acc.shape, dtype=acc.dtype, device=acc.device)
    if q.numel():
        _launch(acc, q, scales, out, 1, 0)
    return out


bucket_acc.launches = 0


def _check_hop(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
               hop: int) -> None:
    _check(acc, q, scales)
    if q.dim() < 3 or not 0 <= hop < q.shape[0]:
        raise ValueError(f"a hop of the ring over q [W, ..., R, C] needs "
                         f"0 <= hop < W: hop {hop}, q {tuple(q.shape)}")


def bucket_acc_hop_plain_(acc: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, hop: int) -> torch.Tensor:
    """The kernel's hop in plain PyTorch: roll the payload ``hop`` workers
    on, decode, then add into ``acc`` (into 0.0 at hop 0)."""
    _check_hop(acc, q, scales, hop)
    p = torch.roll(q, hop, 0).to(torch.float32) * torch.roll(scales, hop, 0)
    if hop == 0:
        acc.zero_()
    return acc.add_(p)


def bucket_acc_hop_(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                    hop: int) -> torch.Tensor:
    """Hop ``hop`` of the ring over a ``[W, B, R, C]`` stack, in place:
    ``acc[w] += float(q[(w - hop) % W]) * scales[(w - hop) % W]`` for every
    worker w, and returns ``acc``.  At hop 0 it overwrites ``acc`` with the
    start of the sum, ``0.0 + float(q[w]) * scales[w]``, whatever ``acc``
    held.  acc f32, q int8 and scales [W, B, R, 1] f32, all contiguous."""
    hop = int(hop)
    if not _on_card("bucket_acc_hop_", q):
        return bucket_acc_hop_plain_(acc, q, scales, hop)
    _check_hop(acc, q, scales, hop)
    if q.numel():
        _launch(None if hop == 0 else acc, q, scales, acc, q.shape[0], hop)
    return acc


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
