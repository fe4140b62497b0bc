"""Architecture registry and the 4 assigned input shapes (port of
``repro/configs/__init__.py``; the ten config modules are copies of the
reference's).

The reference's ``input_specs`` (``jax.ShapeDtypeStruct`` stand-ins for
the multi-pod dry-run) belongs with ``launch/dryrun.py`` and is not ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig

ARCHS = {
    "whisper-tiny": "whisper_tiny",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "minitron-8b": "minitron_8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mistral-large-123b": "mistral_large_123b",
    "starcoder2-7b": "starcoder2_7b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def applicable(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """Returns None if (arch, shape) should run, else a skip reason."""
    if cfg.family == "encdec" and shape.name == "long_500k":
        return "encoder-decoder ASR family: 500k-token decode is meaningless"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention architecture: long_500k requires sub-quadratic "
                "decode (skip noted in DESIGN.md)")
    return None
