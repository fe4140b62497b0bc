"""recurrentgemma-2b [arXiv:2402.19427] — Griffin: RG-LRU + local attention.

26 layers in a (rg, rg, local-attn) repeating pattern, d_model=2560,
10 heads (MQA kv=1), d_ff=7680, local window 2048.  Sub-quadratic decode:
O(1) recurrent states + O(window) local KV cache.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680, vocab=256000,
    activation="silu", pattern=("rg", "rg", "la"), lru_width=2560,
    local_window=2048,
    source="arXiv:2402.19427",
)

REDUCED = dataclasses.replace(
    CONFIG, name="recurrentgemma-reduced", n_layers=3, d_model=256,
    n_heads=4, n_kv=1, d_ff=512, vocab=512, lru_width=256, local_window=64,
    scan_chunk=32, q_chunk=64, xent_chunk=64, remat=False)
