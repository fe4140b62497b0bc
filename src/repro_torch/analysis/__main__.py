"""CLI: ``python -m repro_torch.analysis``.

Exit status: 0 when no active finding remains (errors and warnings count;
info and suppressed findings do not), 1 otherwise, so ``--ci`` is a shell
gate.  The audits run on ``--device`` (CUDA unless ``--device cpu``); the
``host-sync`` check needs the card and is skipped, with a line on stdout
saying so, on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import astlint
from repro_torch.analysis import findings as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's lint and its work and wire audits")
    ap.add_argument("--paths", nargs="*", default=list(astlint.DEFAULT_PATHS),
                    help="files, directories or globs to lint, relative to "
                         "the repository (default: the port, chip_smoke.py "
                         "and the port's tests)")
    ap.add_argument("--ci", action="store_true",
                    help="the full gate: lint, hygiene, the launch audit "
                         "and the wire checks")
    ap.add_argument("--device", default=None,
                    help="device of the audits (default: cuda; raises "
                         "without it); cpu skips host-sync")
    ap.add_argument("--baseline", default=BASELINE,
                    help="suppression file (default: the port's "
                         "src/repro_torch/analysis/baseline.json)")
    ap.add_argument("--json", metavar="FILE",
                    help="write findings as JSON (- for stdout)")
    ap.add_argument("--sarif", metavar="FILE",
                    help="write findings as SARIF 2.1.0 (- for stdout)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="no per-finding text report")
    args = ap.parse_args(argv)

    fs = astlint.lint_paths(args.paths, root=ROOT)
    fs.extend(astlint.hygiene_findings(ROOT))
    if args.ci:
        from repro_torch import default_device
        from repro_torch.analysis import launch_audit, wire_checks
        dev = default_device(args.device)
        fs.extend(launch_audit.audit_entry_points(dev))
        fs.extend(wire_checks.audit_all(dev))
        if dev.type != "cuda":
            print(f"repro_torch.analysis: host-sync skipped: it needs the "
                  f"card, and the audits ran on {dev}")

    F.apply_baseline(fs, F.load_baseline(args.baseline))
    act = F.active(fs)
    if not args.quiet:
        for f in fs:
            print(f.format())
        n_sup = sum(1 for f in fs if f.suppressed)
        print(f"repro_torch.analysis: {len(act)} active finding(s), "
              f"{n_sup} suppressed, {len(fs)} total")
    for path, render in ((args.json, F.to_json), (args.sarif, F.to_sarif)):
        if not path:
            continue
        text = render(fs)
        if path == "-":
            print(text)
        else:
            with open(path, "w") as fh:
                fh.write(text + "\n")
    return 1 if act else 0


if __name__ == "__main__":
    sys.exit(main())
