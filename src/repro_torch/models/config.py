"""ModelConfig: one dataclass describing every supported architecture family
(port of ``repro/models/config.py``, the same fields and defaults).

``remat`` and ``remat_policy`` rematerialise a train step's layers as the
reference's ``jax.checkpoint`` does (``models/remat.py``, which lists the
policies the port has).  ``scan_unroll``, the unroll factor of the
reference's layer scan, stays a field so that a config carries across
unchanged and has no effect: the port runs its layers in an eager Python
loop, which has no scan to unroll.

Fields the reference does not have, each off at its default, so that every
configuration of the registry runs as the reference's does:

* ``experts_held`` (0: all) and ``expert_offset``: an expert layer holds
  experts ``expert_offset .. expert_offset + experts_held - 1`` of the
  router's ``n_experts``, one chip's share under expert parallelism
  (``models/moe.py``);
* ``rope_yarn_factor`` (0: off) with ``rope_yarn_original``,
  ``rope_yarn_beta_fast``, ``rope_yarn_beta_slow`` and
  ``rope_yarn_attn_factor``: YaRN's rotary frequencies and scale on the
  layers of full attention (``layers.rope``);
* ``pattern`` in the ``moe`` family: the layers' kinds, ``la+moe`` (local
  attention within ``local_window``) and ``attn+moe``.
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
    # not in the reference: off at their defaults (see the module's doc)
    experts_held: int = 0       # 0 = every expert
    expert_offset: int = 0
    rope_yarn_factor: float = 0.0   # 0 = plain RoPE
    rope_yarn_original: int = 0
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_yarn_attn_factor: float = 1.0

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
    def rope_yarn(self) -> Optional[Tuple[float, int, float, float, float]]:
        """YaRN's (factor, original length, beta_fast, beta_slow, attention
        factor), or None where it is off."""
        if not self.rope_yarn_factor:
            return None
        return (self.rope_yarn_factor, self.rope_yarn_original,
                self.rope_yarn_beta_fast, self.rope_yarn_beta_slow,
                self.rope_yarn_attn_factor)

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
        if self.family == "hybrid" or (self.family == "moe"
                                        and self.pattern):
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
            assert all(k.endswith("+moe") for k in self.pattern)
        assert 0 <= self.experts_held and 0 <= self.expert_offset
        assert self.expert_offset + self.experts_held <= max(
            self.n_experts, 1), "the held experts lie among the router's"
        assert not self.expert_offset or self.experts_held
        if self.family == "ssm":
            assert self.ssm_state > 0
        if self.family == "hybrid":
            assert self.pattern and self.lru_width > 0
        if self.family == "encdec":
            assert self.enc_layers > 0 and self.n_frames > 0
        if self.family == "vlm":
            assert self.n_patches > 0
        return self
