"""olmoe-1b-7b [arXiv:2409.02060] — 64-expert top-8 MoE, 1B active / 7B total.

16 layers, d_model=2048, 16 heads (kv=16), d_ff=1024 per expert, vocab=50304.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024, vocab=50304,
    activation="silu", n_experts=64, top_k=8,
    source="arXiv:2409.02060",
)

REDUCED = dataclasses.replace(
    CONFIG, name="olmoe-reduced", n_layers=2, d_model=128, n_heads=4, n_kv=4,
    d_ff=128, vocab=512, n_experts=4, top_k=2, moe_group=64,
    q_chunk=64, xent_chunk=64, remat=False)
