"""Nothing under ``portbench/`` imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port), the
reference imports nothing of the port, and a run leaves neither in
``sys.modules``."""
import ast
import importlib.util
import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HERE = ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not FORBIDDEN & set(_imports(f)), f


def test_reference_imports_nothing_of_the_port():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert not (FORBIDDEN | {"repro_torch"}) & set(_imports(f)), f


def test_forbidden_modules_compares_whole_names():
    spec = importlib.util.spec_from_file_location("portbench_run",
                                                  HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_modules(["repro_torch.core", "jaxtyping", "torch",
                                  "reproduce"]) == []
    assert run.forbidden_modules(["repro.core.dist", "jax._src", "flax",
                                  "jaxlib"]) == ["flax", "jax._src",
                                                 "jaxlib", "repro.core.dist"]


RUN = """
import json, sys, time
import torch
torch.set_num_threads(1)
from portbench import bench
from portbench.tests.conftest import SIZED_CELLS, reduced_cell
cell = reduced_cell(SIZED_CELLS[0])
r = bench.runner(cell.traffic["runner"]).run(bench.Run(
    cell=cell, seed=3, seconds=0.2, trace=False,
    device=torch.device("cpu"), t0=time.perf_counter()))
print(json.dumps({"steps": r["attempted"], "modules": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                   "repro"))}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["steps"] >= 1 and rec["modules"] == []
