"""minitron-8b [arXiv:2407.14679] — width-pruned Nemotron-4.

32 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000,
squared-ReLU MLP (inherited from Nemotron-4).
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=16384, vocab=256000,
    activation="relu2",
    source="arXiv:2407.14679",
)

REDUCED = dataclasses.replace(
    CONFIG, name="minitron-reduced", n_layers=2, d_model=256, n_heads=4,
    n_kv=2, d_ff=512, vocab=512, q_chunk=64, xent_chunk=64, remat=False)
