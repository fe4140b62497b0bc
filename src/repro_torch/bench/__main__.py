"""CLI: ``python -m repro_torch.bench [filter] [--fast] [--events PATH]
[--device D] [--out-dir DIR]`` (port of ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV, one row per measurement, for every
suite whose name contains ``filter`` (all without one): the paper's figures
(``fig3a``, ``fig3b``, ``fig4_bits``, ``fig56``, ``table3``, ``thm3``), the
kernels (``kernel``, and ``kernel/b1_probe``: B1 and B5 at the probe
shape), the sweep engine and the mesh wire (``sweep_engine``,
``bucketed_ring``, ``dist_step``) and the fault defenses
(``fault_overhead``).  Each suite runs inside an ``obs.span``; with
``--events PATH`` every row is also a ``bench`` event of
``obs.events.EventLog``.  ``--fast`` is the smoke size.  The suites run on
``--device`` (CUDA unless ``--device cpu``, where only the plain versions
of the kernels run, and the rows say so) and write their reports under
``--out-dir`` (default ``chiprun_out/bench``).  A suite that raises is
printed with its traceback and a ``<suite>,NaN,ERROR`` row; the exit code
is then 1.
"""
from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch import default_device
from repro_torch.bench import DEFAULT_OUT_DIR, Context
from repro_torch.bench import dist_bench, fault_bench, kernel_bench, paper_figs
from repro_torch.obs import EventLog, span

SUITES = (paper_figs.SUITES + kernel_bench.SUITES + dist_bench.SUITES
          + fault_bench.SUITES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__.split("\n\n")[1])
    ap.add_argument("filter", nargs="?", default=None,
                    help="run only the suites whose name contains it")
    ap.add_argument("--fast", action="store_true",
                    help="the smoke size: one cell, few rounds")
    ap.add_argument("--events", metavar="PATH", default=None,
                    help="mirror every row into a JSONL event log")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help=f"reports go here (default: {DEFAULT_OUT_DIR})")
    args = ap.parse_args(argv)
    ctx = Context(fast=args.fast, device=default_device(args.device),
                  out_dir=args.out_dir)
    log = EventLog(args.events) if args.events else None
    if log is not None:
        log.start(config={"fast": args.fast, "filter": args.filter,
                          "device": str(ctx.device)},
                  fingerprint=f"bench:{'fast' if args.fast else 'full'}")
    print("name,us_per_call,derived")
    failures = 0
    for name, suite in SUITES:
        if args.filter and args.filter not in name:
            continue
        try:
            with span(f"bench/{name}"):
                rows = list(suite(ctx))
        except Exception:  # noqa: BLE001 (a suite's failure is reported)
            failures += 1
            traceback.print_exc()
            print(f"{name},NaN,ERROR", flush=True)
            continue
        for row, us, derived in rows:
            print(f"{row},{us:.3f},{derived}", flush=True)
            if log is not None:
                log.emit("bench", name=row, value=float(us),
                         unit="us_per_call", derived=str(derived))
    if log is not None:
        log.end(status="fail" if failures else "ok")
        log.close()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
