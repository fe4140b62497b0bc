"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407] — dense 123B.

88 layers, d_model=12288, 96 heads (kv=8), d_ff=28672, vocab=32768.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_ff=28672, vocab=32768,
    activation="silu",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

REDUCED = dataclasses.replace(
    CONFIG, name="mistral-large-reduced", n_layers=2, d_model=256, n_heads=8,
    n_kv=2, d_ff=512, vocab=512, q_chunk=64, xent_chunk=64, remat=False)
