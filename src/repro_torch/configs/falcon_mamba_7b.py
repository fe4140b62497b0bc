"""falcon-mamba-7b [arXiv:2410.05355] — attention-free Mamba-1 SSM.

64 layers, d_model=4096, ssm_state=16, vocab=65024. Sub-quadratic: runs
long_500k decode with O(1) recurrent state.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv=0, d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2410.05355",
)

REDUCED = dataclasses.replace(
    CONFIG, name="falcon-mamba-reduced", n_layers=2, d_model=256, vocab=512,
    scan_chunk=32, q_chunk=64, xent_chunk=64, remat=False)
