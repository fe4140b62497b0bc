"""Plain PyTorch references of what the benchmark's cells compute.  They
import nothing of the program.

A configuration names its reference by its file's ``"reference"`` key:
the module ``portbench/reference/<reference>.py``, which gives
``REFERENCE_API``.  Without the key it is ``model`` (the dense and
encoder-decoder families).  The workers, the wire and Adam around it
(``train.py``) are shared by every family.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

# what a configuration's reference module gives: its parameters as
# (path, shape, initial std) and their count; the float32 products and the
# float8 control; the mean loss and its gradient over a block of rows at a
# time; a batch's rows; TF32 off; and a step's model FLOPs at
# (cfg, rows, seq, frames)
REFERENCE_API = ("param_spec", "param_count", "Numerics", "mean_loss_grad",
                 "rows", "no_tf32", "step_flops")
DEFAULT = "model"


def for_config(cfg: dict, root: Optional[Path] = None):
    """The reference module of the configuration ``cfg``, found by name
    in the checkout at ``root`` (this package's own by default)."""
    from portbench import bench
    name = cfg.get("reference", DEFAULT)
    mod = bench.module("reference", name, root or bench.ROOT)
    missing = [a for a in REFERENCE_API if not hasattr(mod, a)]
    if missing:
        raise AttributeError(f"reference {name!r} lacks {missing}")
    return mod
