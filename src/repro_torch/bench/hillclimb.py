"""One dry-run combo with overrides, in a subprocess, and its three
roofline terms (port of ``benchmarks/hillclimb.py``):

  PYTHONPATH=src python -m repro_torch.bench.hillclimb starcoder2-7b \\
      train_4k artemis q_chunk=256 dist.s=2

The arguments are the arch, the shape, the dist variant and any number of
``field=value`` overrides of the ``ModelConfig`` (``dist.field=value`` of
the ``DistConfig``).  There is no mesh argument: the dry run is one card's
(``launch/dryrun.py``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile


def run(arch, shape, dist, cfg_over=(), dist_over=()):
    """The dry run's record of one combo (status "error" with its stderr's
    tail if the subprocess failed)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rec.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--dist", dist, "--out", out]
        for o in cfg_over:
            cmd += ["--cfg-override", o]
        for o in dist_over:
            cmd += ["--dist-override", o]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1800)
        try:
            with open(out) as fh:
                return json.load(fh)[0]
        except (OSError, ValueError, IndexError):
            return {"status": "error",
                    "error": (proc.stderr or "?")[-400:]}


def show(tag: str, rec: dict) -> str:
    if rec.get("status") != "ok":
        return f"{tag:58s} {rec.get('status', '?').upper()} " \
               f"{rec.get('error', rec.get('reason', ''))[:120]}"
    return (f"{tag:58s} C={rec['compute_s']:.3f}s M={rec['memory_s']:.3f}s "
            f"X={rec['wire_s']:.3f}s dom={rec['dominant']:8s} "
            f"peak={rec['peak_bytes'] / 1e9:.1f}GB "
            f"useful={rec['useful_ratio']:.3f}")


def main(argv) -> int:
    if len(argv) < 3:
        raise SystemExit(__doc__)
    arch, shape, dist = argv[:3]
    overrides = argv[3:]
    cfg_over = [o for o in overrides if not o.startswith("dist.")]
    dist_over = [o[5:] for o in overrides if o.startswith("dist.")]
    rec = run(arch, shape, dist, cfg_over, dist_over)
    print(show(f"{arch}x{shape}x{dist} {' '.join(overrides)}", rec))  # repro-lint: allow=print-in-library (CLI)
    return 0 if rec.get("status") in ("ok", "skip") else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
