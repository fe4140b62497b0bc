"""Render the dry run's table (port of ``repro/launch/report.py``):

  PYTHONPATH=src python -m repro_torch.launch.report dryrun.json

The table of every combo on one H100, then, as the reference prints them,
the single-pod table (16 x 16 = 256 ranks) and the multi-pod table (2 x 16
x 16 = 512 ranks), each row one rank's terms; the skips, the errors, and
the peak-bytes estimates (a rank's, on a mesh) against the card's 80 GB.
"""
from __future__ import annotations

import json
import sys

from repro_torch.launch.dryrun import H100_BYTES
from repro_torch.launch.roofline import markdown_table, mesh_table


def main(path: str) -> None:
    with open(path) as fh:
        rows = json.load(fh)
    ok = [r for r in rows if r.get("status") == "ok"]
    skip = [r for r in rows if r.get("status") == "skip"]
    err = [r for r in rows if r.get("status") == "error"]

    def on(mesh):
        return sorted((r for r in ok if r.get("mesh", "one-card") == mesh),
                      key=lambda r: (r["arch"], r["shape"],
                                     r.get("dist", "none")))

    print("### Roofline: one H100 (the dry run on fake tensors)\n")
    print(markdown_table(on("one-card")))
    print("\n### Single-pod (16 x 16 = 256 ranks), one rank's terms\n")
    print(mesh_table(on("pod")))
    print("\n### Multi-pod (2 x 16 x 16 = 512 ranks): the pod axis and "
          "Artemis\n")
    print(mesh_table(on("multipod")))
    print("\n### Skips\n")
    for r in skip:
        if r.get("mesh", "one-card") in ("one-card", "pod"):
            print(f"* {r['arch']} x {r['shape']}: {r['reason']}")
    if err:
        print("\n### ERRORS\n")
        for r in err:
            print(f"* {r['arch']} x {r['shape']} x "
                  f"{r.get('mesh', 'one-card')} x {r.get('dist', 'none')}")
    print("\n### Peak bytes (a rank's on a mesh; fits 80 GB H100?)\n")
    for r in sorted(ok, key=lambda r: -r["peak_bytes"])[:8]:
        pk = r["peak_bytes"]
        print(f"* {r['arch']} x {r['shape']} x {r.get('mesh', 'one-card')} "
              f"x {r.get('dist', 'none')}: {pk / 1e9:.2f} GB "
              f"{'OK' if pk < H100_BYTES else 'OVER'}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "dryrun.json")
