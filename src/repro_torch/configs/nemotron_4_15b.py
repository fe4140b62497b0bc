"""nemotron-4-15b [arXiv:2402.16819] — dense, GQA, squared-ReLU.

32 layers, d_model=6144, 48 heads (kv=8), d_ff=24576, vocab=256000.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv=8, d_ff=24576, vocab=256000,
    activation="relu2",
    source="arXiv:2402.16819",
)

REDUCED = dataclasses.replace(
    CONFIG, name="nemotron-reduced", n_layers=2, d_model=256, n_heads=8,
    n_kv=2, d_ff=512, vocab=512, q_chunk=64, xent_chunk=64, remat=False)
