"""Render the dry run's table (port of ``repro/launch/report.py``):

  PYTHONPATH=src python -m repro_torch.launch.report dryrun.json

One table of every combo on one H100 (no pod or multi-pod mesh), the skips,
the errors, and the peak-bytes estimates against the card's 80 GB.
"""
from __future__ import annotations

import json
import sys

from repro_torch.launch.dryrun import H100_BYTES
from repro_torch.launch.roofline import markdown_table


def main(path: str) -> None:
    with open(path) as fh:
        rows = json.load(fh)
    ok = [r for r in rows if r.get("status") == "ok"]
    skip = [r for r in rows if r.get("status") == "skip"]
    err = [r for r in rows if r.get("status") == "error"]
    print("### Roofline: one H100 (the dry run on fake tensors)\n")
    print(markdown_table(sorted(ok, key=lambda r: (r["arch"], r["shape"],
                                                   r.get("dist", "none")))))
    print("\n### Skips\n")
    for r in skip:
        print(f"* {r['arch']} x {r['shape']}: {r['reason']}")
    if err:
        print("\n### ERRORS\n")
        for r in err:
            print(f"* {r['arch']} x {r['shape']} x {r.get('dist', 'none')}")
    print("\n### Peak bytes (fits 80 GB H100?)\n")
    for r in sorted(ok, key=lambda r: -r["peak_bytes"])[:8]:
        pk = r["peak_bytes"]
        print(f"* {r['arch']} x {r['shape']} x {r.get('dist', 'none')}: "
              f"{pk / 1e9:.2f} GB {'OK' if pk < H100_BYTES else 'OVER'}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "dryrun.json")
