"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf] — VLM.

Mistral-7B language backbone: 32L, d_model=4096, 32H (kv=8), d_ff=14336,
vocab=32000.  The SigLIP/CLIP vision tower is STUBBED: ``input_specs``
supplies anyres patch embeddings [B, 2560, 4096] (base tile + 4 anyres tiles
x 512 tokens), consumed through a learned projector.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    activation="silu", n_patches=2560,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

REDUCED = dataclasses.replace(
    CONFIG, name="llava-reduced", n_layers=2, d_model=256, n_heads=4, n_kv=2,
    d_ff=512, vocab=512, n_patches=16, q_chunk=64, xent_chunk=64, remat=False)
