"""The readings the limits of ``portbench/limits/<cell>.json`` are set from,
on the card at the cell's own size, in one process:

    python3 portbench/readings.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--fault-seeds 11,12,13] [--out FILE]

Each side comes from the cell's own runner (its ``program_readings`` and
``reference_readings``).  For each seed of ``--seeds``, the program's
checked steps against the plain reference's (the sound runs: the lower
readings).  For each of ``--control-seeds``, the control, the reference in
the program's place through float8 products, against the same reference;
for each of ``--fault-seeds``, the reference in the program's place with
each fault of ``portbench/reference/train.py`` that the cell can have (the
exchange only where the wire has more than one worker).  One JSON line a
reading, on standard output and appended to ``--out``.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from portbench import check
    from portbench.bench import load_cell, runner
    if not torch.cuda.is_available():
        print("portbench readings: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench readings: {torch.cuda.device_count()} CUDA "
              f"devices, the cell needs {cell.chips}", file=sys.stderr)
        return 3
    run = runner(cell.traffic["runner"], ROOT)
    dev = torch.device("cuda", 0)
    wire = cell.traffic.get("wire")
    faults = ["half_batch"] + (["no_exchange"]
                               if wire and cell.traffic["workers"] > 1
                               else [])
    out = open(args.out, "a") if args.out else None

    def emit(side: str, seed: int, prog: dict, ref: dict, t: float):
        raw = ref["raw_grad_norms"]
        rec = {"cell": cell.name, "side": side, "seed": seed,
               "gaps": check.gaps(prog, ref), "seconds": time.time() - t,
               "least_leaf_over_median": min(raw) / statistics.median(raw),
               "losses": prog["losses"], "ref_losses": ref["losses"]}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = sorted(set(_seeds(args.seeds) + _seeds(args.control_seeds)
                       + _seeds(args.fault_seeds)))
    for seed in seeds:
        t = time.time()
        ref = run.reference_readings(cell, seed, dev)
        if seed in _seeds(args.seeds):
            t = time.time()
            prog = run.program_readings(cell, seed, dev)
            torch.cuda.empty_cache()
            emit("program", seed, prog, ref, t)
        if seed in _seeds(args.control_seeds):
            t = time.time()
            emit("control", seed,
                 run.reference_readings(cell, seed, dev, precision="fp8"),
                 ref, t)
        if seed in _seeds(args.fault_seeds):
            for fault in faults:
                t = time.time()
                emit(fault, seed,
                     run.reference_readings(cell, seed, dev, fault=fault),
                     ref, t)
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).parent]
    sys.exit(main())
