"""Run one cell of the port's benchmark once, on the CUDA card of the machine
it is started on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).  It
prints, as its last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit),
and the same numbers as its last lines of standard error.  It exits with
another code than 0, and prints no result, where there is no CUDA card or
fewer than the cell asks for, where the port is missing, or where JAX or
the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MAX_SEED = 2**40


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def _fail(code: int, msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not 0 <= args.seed < MAX_SEED:
        return _fail(2, f"--seed must lie in [0, 2**40): {args.seed}")

    # caches of whatever compiles, at fixed paths inside the checkout; a
    # library that would load JAX by itself is told not to
    build = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "extensions"))
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    from portbench.bench import load_cell
    try:
        cell = load_cell(args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        return _fail(2, f"cannot load the cell: {e}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(2, f"no port under {ROOT / 'src' / 'repro_torch'}")

    import torch
    if not torch.cuda.is_available():
        return _fail(3, "no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return _fail(3, f"{torch.cuda.device_count()} CUDA devices, the "
                        f"cell needs {cell.chips}")

    from portbench.bench import Run, runner
    from portbench.check import lines
    run = runner(cell.traffic["runner"], ROOT)
    if cell.chips not in run.CHIPS:
        return _fail(2, f"runner {cell.traffic['runner']!r} runs on "
                        f"{run.CHIPS} chips, the cell asks for {cell.chips}")
    result = run.run(Run(cell=cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace),
                         device=torch.device("cuda", 0), t0=T0))
    leaked = forbidden_modules(sys.modules)
    if leaked:
        return _fail(4, f"JAX or the JAX package was loaded: {leaked}")
    sys.stdout.flush()
    for line in lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # this file's folder is no place to import from: its modules are
    # portbench's, and would shadow others (the standard library's trace)
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).parent]
    sys.exit(main())
