"""mixtral-8x22b [arXiv:2401.04088] — 8-expert top-2 MoE with sliding-window
attention.

56 layers, d_model=6144, 48 heads (kv=8), d_ff=16384/expert, vocab=32768,
SWA window 4096.  Sub-quadratic decode via O(window) ring-buffer KV cache.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    activation="silu", n_experts=8, top_k=2,
    attn_kind="sliding", window=4096,
    source="arXiv:2401.04088",
)

REDUCED = dataclasses.replace(
    CONFIG, name="mixtral-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv=2, d_ff=256, vocab=512, n_experts=4, top_k=2, moe_group=64,
    window=64, q_chunk=64, xent_chunk=64, remat=False)
