"""starcoder2-7b [arXiv:2402.19173] — dense code model, GQA kv=4, RoPE.

32 layers, d_model=4608, 36 heads (kv=4), d_ff=18432, vocab=49152, GELU MLP.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4, d_ff=18432, vocab=49152,
    activation="gelu",
    source="arXiv:2402.19173",
)

REDUCED = dataclasses.replace(
    CONFIG, name="starcoder2-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv=2, d_ff=512, vocab=512, q_chunk=64, xent_chunk=64, remat=False)
