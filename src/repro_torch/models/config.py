"""ModelConfig: one dataclass describing every supported architecture family
(port of ``repro/models/config.py``, the same fields and defaults).

``remat`` and ``remat_policy`` rematerialise a train step's layers as the
reference's ``jax.checkpoint`` does (``models/remat.py``, which lists the
policies the port has).  ``scan_unroll``, the unroll factor of the
reference's layer scan, stays a field so that a config carries across
unchanged and has no effect: the port runs its layers in an eager Python
loop, which has no scan to unroll.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free families
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    activation: str = "silu"    # silu (gated) | gelu | relu2
    # attention
    attn_kind: str = "full"     # full | sliding
    window: int = 4096          # sliding-window size when attn_kind == sliding
    rope_theta: float = 10000.0
    q_chunk: int = 512
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 4096
    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    scan_chunk: int = 256
    # hybrid (RG-LRU + local attention)
    pattern: Tuple[str, ...] = ()      # period, e.g. ('rg','rg','la')
    lru_width: int = 0
    local_window: int = 2048
    # encoder-decoder (audio)
    enc_layers: int = 0
    n_frames: int = 0           # stubbed audio frame embeddings
    # VLM
    n_patches: int = 0          # stubbed vision patch embeddings
    # numerics / training
    norm_eps: float = 1e-6
    xent_chunk: int = 512
    softmax_dtype: str = "float32"   # attention score/softmax accumulation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True               # rematerialise each layer (train)
    remat_policy: Optional[str] = None   # None = full remat; models/remat.py
    scan_unroll: int = 1             # XLA only: no effect in the port
    source: str = ""            # citation for the assigned config

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve long_500k decode (O(1)/O(window) state)?"""
        return self.family in ("ssm", "hybrid") or self.attn_kind == "sliding"

    @property
    def has_decode(self) -> bool:
        return True   # all assigned families have a decoder

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind list of length n_layers."""
        if self.family == "ssm":
            return ("mamba",) * self.n_layers
        if self.family == "hybrid":
            assert self.pattern
            reps = -(-self.n_layers // len(self.pattern))
            return (self.pattern * reps)[: self.n_layers]
        if self.family == "moe":
            return ("attn+moe",) * self.n_layers
        return ("attn+mlp",) * self.n_layers   # dense, vlm, encdec decoder

    def validate(self):
        if self.n_heads:
            assert self.n_heads % max(self.n_kv, 1) == 0, "GQA requires H % KV == 0"
        if self.family == "moe":
            assert self.n_experts > 0 and 0 < self.top_k <= self.n_experts
        if self.family == "ssm":
            assert self.ssm_state > 0
        if self.family == "hybrid":
            assert self.pattern and self.lru_width > 0
        if self.family == "encdec":
            assert self.enc_layers > 0 and self.n_frames > 0
        if self.family == "vlm":
            assert self.n_patches > 0
        return self
