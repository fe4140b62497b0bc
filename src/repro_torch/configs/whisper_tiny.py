"""whisper-tiny [arXiv:2212.04356] — encoder-decoder ASR transformer.

4 decoder + 4 encoder layers, d_model=384, 6 heads (kv=6), d_ff=1536,
vocab=51865.  The mel-spectrogram + conv feature extractor is STUBBED:
``input_specs`` provides precomputed frame embeddings [B, 1500, 384].
Deviation: RoPE replaces sinusoidal absolute positions (TPU-idiomatic stack);
documented in DESIGN.md.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
    activation="gelu", enc_layers=4, n_frames=1500,
    source="arXiv:2212.04356",
)

REDUCED = dataclasses.replace(
    CONFIG, name="whisper-tiny-reduced", n_layers=2, enc_layers=2,
    d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512, n_frames=8,
    q_chunk=64, xent_chunk=64, remat=False)
