"""Hand-written CUDA kernels of the port (``attention`` in Triton), each
beside its plain PyTorch version.  Importing this package builds nothing:
each kernel is compiled at its first launch (``_build.py``; Triton's own
cache for ``attention``).  ``ops`` is the shape-agnostic compression
API over them."""
from repro_torch.kernels import (attention, bucket_ring, fused_memory,
                                 ring_sum, squant)

KERNELS = (fused_memory.fused_memory_update, ring_sum.ring_sum,
           ring_sum.worker_sum, bucket_ring.bucket_acc,
           bucket_ring.bucket_ring_sum, squant.squant_encode,
           squant.squant_decode, squant.dequant_apply,
           attention.flash_attention)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
