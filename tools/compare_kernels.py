#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one NVIDIA card, in turns.

    python3 tools/compare_kernels.py parent=build/parent change=. \\
        --order parent,change,change,parent --out build/compare

Each ``label=DIR`` names the root of a checkout (the parent is unpacked with
``git archive`` into a directory that ``.gitignore`` lists).  For each turn
of ``--order`` it runs, in fresh processes:

1. the kernel cases of fused_memory_update (B1), ring_sum (B2) and its
   worker_sum helper, bucket_ring_sum (B4), bucket_acc (B3, out of place
   and the ring's hops), squant_encode (B5) and dequant_apply (B7) that
   this checkout's ``chip_smoke.py`` defines, with its case functions and
   the kernels of DIR (built there, from DIR's sources): device µs per
   launch from the profiler's CUDA trace, against the bound.  A case a
   checkout's port cannot run (bf16 in B1, the worker sum, before they
   existed) is left out of that checkout's turns;
2. unless ``--no-smoke``, DIR's own ``chip_smoke.py`` from DIR, whose log
   holds the path timings (µs per round per cell, per mesh, wide and ops
   step, the grid profile's device time).

It writes ``<out>/<turn>_<label>_kernels.json`` and
``<out>/<turn>_<label>_smoke.txt`` and prints one line per kernel case and
turn.  Needs a card; exits non-zero if any run fails.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_cases(src):
    """Time this checkout's B1, B2, B4, B3, B5 and B7 cases and the worker
    sum with the kernels under ``src``; returns a list of dicts."""
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: CUDA is not available")
    import repro_torch
    if os.path.dirname(os.path.abspath(repro_torch.__file__)) != \
            os.path.join(os.path.abspath(src), "repro_torch"):
        raise SystemExit(f"compare_kernels: imported {repro_torch.__file__}, "
                         f"not the port under {src}")
    from repro_torch.kernels import fused_memory, ring_sum
    bf16_fused = hasattr(fused_memory, "FLOATS")
    worker_sum = hasattr(ring_sum, "worker_sum")
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    out = []
    for i, (r, d) in enumerate(cs.FUSED_CASES):
        out.append(dict(kernel="fused_memory_update", block=[1, d],
                        **cs.fused_case(dev, r, d, i)))
    for i, (r, d) in enumerate(cs.FUSED_BF16_CASES if bf16_fused else []):
        out.append(dict(kernel="fused_memory_update", block=[1, d],
                        **cs.fused_case(dev, r, d, 5 + i, bf16)))
    for i, sh in enumerate(cs.FUSED_TILE_CASES):
        out.append(dict(kernel="fused_memory_update",
                        **cs.fused_tile_case(dev, sh, 70 + i)))
    if bf16_fused:
        out.append(dict(kernel="fused_memory_update",
                        **cs.fused_tile_case(dev, cs.MAIN_OPS, 73, bf16)))
    for i, (n, m, c, layout) in enumerate(cs.RING_CASES):
        out.append(dict(kernel="ring_sum",
                        **cs.ring_case(dev, n, m, c, layout, 10 + i)))
    for i, sh in enumerate(cs.WSUM_CASES if worker_sum else []):
        out.append(dict(kernel="worker_sum", **cs.wsum_case(dev, *sh,
                                                           15 + i)))
    # B5 on the ops shapes and one tile, B7 on the ops shapes and where N
    # is not a multiple of 16
    for i, sh in enumerate(cs.OPS_CASES + [cs.ONE_TILE]):
        out.append(dict(kernel="squant_encode",
                        **cs.encode_case(dev, sh, f32, f32, 40 + i)))
    out.append(dict(kernel="squant_encode",
                    **cs.encode_case(dev, cs.MAIN_OPS, bf16, bf16, 43)))
    for i, sh in enumerate(cs.OPS_CASES):
        for dt in (f32, bf16):
            out.append(dict(kernel="dequant_apply",
                            **cs.apply_case(dev, sh, dt, 60 + i)))
    out.append(dict(kernel="dequant_apply", **cs.apply_case(
        dev, cs.APPLY_NARROW[0], f32, 62, block=cs.APPLY_NARROW[1])))
    for i, sh in enumerate(cs.BSUM_CASES):
        out.append(dict(kernel="bucket_ring_sum",
                        **cs.bsum_case(dev, sh, 30 + i)))
    # bucket_acc shares the warp trade (csrc/warp_trade.cuh) with ring_sum
    for i, sh in enumerate(cs.ACC_CASES):
        out.append(dict(kernel="bucket_acc", **cs.acc_case(dev, sh, 20 + i)))
    for i, sh in enumerate(cs.HOP_CASES):
        for hop in (0, 1):
            out.append(dict(kernel="bucket_acc_hop_",
                            **cs.hop_case(dev, sh, hop, 25 + i)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="*", help="label=DIR")
    ap.add_argument("--order", default="")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "compare"))
    ap.add_argument("--no-smoke", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)   # SRC: one kernel run
    args = ap.parse_args()
    if args.one:
        print(json.dumps(kernel_cases(args.one)))
        return 0
    dirs = dict(c.split("=", 1) for c in args.checkouts)
    order = args.order.split(",") if args.order else list(dirs)
    os.makedirs(args.out, exist_ok=True)
    failed = []
    for turn, label in enumerate(order, 1):
        root = os.path.abspath(dirs[label])
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.join(root, "src")], capture_output=True, text=True,
            cwd=ROOT)
        stem = os.path.join(args.out, f"{turn}_{label}")
        if run.returncode != 0:
            failed.append(f"{label} kernels (turn {turn})")
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
        else:
            cases = json.loads(run.stdout.strip().splitlines()[-1])
            with open(f"{stem}_kernels.json", "w") as f:
                json.dump(cases, f, indent=1)
            for c in cases:
                extra = c.get("layout") or (
                    f"in {tuple(c['block'])}" if "block" in c else "") or (
                    f"hop {c['hop']}" if "hop" in c else "")
                extra += f" {c['dtype']}" if "dtype" in c else ""
                print(f"turn {turn} {label}: {c['kernel']} {c['shape']} "
                      f"{extra}: device {c['ms'] * 1e3:.3f} us "
                      f"({c['ms_from']}), bound {c['bound_ms'] * 1e3:.3f} "
                      f"us, per call {c['call_ms'] * 1e3:.3f} us",
                      flush=True)
        if args.no_smoke:
            continue
        smoke = subprocess.run([sys.executable, "chip_smoke.py"],
                               capture_output=True, text=True, cwd=root)
        with open(f"{stem}_smoke.txt", "w") as f:
            f.write(smoke.stdout + "\n--- stderr ---\n" + smoke.stderr)
        ok = smoke.returncode == 0
        print(f"turn {turn} {label}: chip_smoke.py rc={smoke.returncode}",
              flush=True)
        if not ok:
            failed.append(f"{label} chip_smoke.py (turn {turn})")
    if failed:
        print(f"compare_kernels: failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
