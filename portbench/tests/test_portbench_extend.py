"""A configuration of a new family, its cell, and a cell on four chips under
a runner of its own go in as new files and new entries in
``BENCHMARK.json`` alone.

In a copy of the benchmark (``BENCHMARK.json`` and ``portbench/``) the test
adds, each as a new file: a toy mixture-of-experts family's reference
module, its configuration, traffic, limits and CPU sizes; a runner that
declares ``CHIPS = (4,)`` with a traffic and limits for a starcoder2 cell
on it.  ``BENCHMARK.json`` gets the two cells, the configuration, and the
cells' names appended to the ``workloads`` lists of the metrics they
report.  The spec's checks and ``reduced_cell`` then pass against the copy;
the toy family's reference runs through ``simulated_train`` with no runner
of its own; and no file of the copy changed but ``BENCHMARK.json``, by
those entries alone.
"""
import hashlib
import json
import math
import shutil
from pathlib import Path

import pytest
import torch

from portbench import bench
from portbench.reference import for_config
from portbench.tests import test_portbench_spec as SPEC
from portbench.tests.conftest import ROOT, cells, reduced_cell

CPU = torch.device("cpu")

TOY_REFERENCE = '''"""A toy mixture-of-experts family: one layer of top-k
routed MLP experts over the token embeddings, then a norm and the output
head."""
import torch

from portbench.reference.model import (Numerics, no_tf32, param_count,
                                       rms_norm, rows)

__all__ = ["Numerics", "no_tf32", "param_count", "rows"]


def param_spec(cfg):
    d, v, e, ff = cfg["d_model"], cfg["vocab"], cfg["n_experts"], cfg["d_ff"]
    spec = [("embed", (v, d), 0.02), ("final_norm", (d,), 0.0),
            ("moe/router", (d, e), d ** -0.5),
            ("moe/w_up", (e, d, ff), d ** -0.5),
            ("moe/w_down", (e, ff, d), ff ** -0.5),
            ("unembed", (d, v), 0.02)]
    return sorted(spec, key=lambda s: s[0].split("/"))


def _nll_sum(num, cfg, p, batch):
    tok = batch["tokens"].long()
    x = p["embed"][tok]
    top, idx = torch.softmax(num.mm(x, p["moe/router"]), -1).topk(
        cfg["top_k"], -1)
    y = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        w = (top * (idx == e)).sum(-1, keepdim=True)
        hid = torch.nn.functional.gelu(num.mm(x, p["moe/w_up"][e]))
        y = y + w * num.mm(hid, p["moe/w_down"][e])
    x = rms_norm(x + y, p["final_norm"], cfg["norm_eps"])
    logits = num.mm(x[:, :-1], p["unembed"])
    gold = torch.gather(logits, -1, tok[:, 1:, None])[..., 0]
    return ((torch.logsumexp(logits, -1) - gold).sum(),
            tok.shape[0] * (tok.shape[1] - 1))


def mean_loss_grad(num, cfg, p, batch, block):
    names = list(p)
    leaves = [p[k].detach().requires_grad_(True) for k in names]
    pl = dict(zip(names, leaves))
    grads = [torch.zeros_like(t) for t in leaves]
    total, count, n = 0.0, 0, batch["tokens"].shape[0]
    for lo in range(0, n, block):
        s, c = _nll_sum(num, cfg, pl, rows(batch, lo, min(n, lo + block)))
        for g, d in zip(grads, torch.autograd.grad(s, leaves)):
            g += d
        total, count = total + float(s.detach()), count + c
    return total / count, [g / count for g in grads]


def step_flops(cfg, rows, seq, frames=0):
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    per_token = d * cfg["n_experts"] + cfg["top_k"] * 2 * d * ff + d * v
    return 6.0 * per_token * rows * seq
'''

STUB_RUNNER = '''"""A runner on four chips that runs nothing: it declares
what a runner provides."""
CHIPS = (4,)


def run(r):
    raise NotImplementedError("a stub")


def program_readings(cell, seed, device):
    raise NotImplementedError("a stub")


def reference_readings(cell, seed, device, precision="f32", fault=None):
    raise NotImplementedError("a stub")
'''

ADAM = {"name": "adam", "lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8}
STREAM = {"zipf_a": 1.2, "bigram_weight": 0.65}
WIRE = {"variant": "artemis", "s": 1, "p": 1.0, "bucket_bytes": 65536,
        "max_buckets": 16, "row": 256, "reduce_impl": "pipelined"}
TOY_WIDTHS = {"d_model": 8, "n_experts": 4, "d_ff": 16, "vocab": 32}

FILES = {
    "portbench/reference/toy_moe.py": TOY_REFERENCE,
    "portbench/configs/toy-moe.json": {
        "name": "toy-moe", "family": "moe", "reference": "toy_moe",
        "n_layers": 1, "d_model": 64, "n_experts": 8, "top_k": 2,
        "d_ff": 128, "vocab": 512, "norm_eps": 1e-5, "reduced": []},
    "portbench/traffic/toy-plain-4x64.json": {
        "runner": "simulated_train", "rows": 4, "seq": 64, "workers": 1,
        "wire": None, "optimizer": ADAM, "stream": STREAM,
        "reference_block": 2},
    "portbench/limits/toy-moe.plain.json": {
        "loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2},
    "portbench/tests/sizes/configs/toy-moe.json": {"widths": TOY_WIDTHS},
    "portbench/tests/sizes/traffic/toy-plain-4x64.json": {
        "rows": 2, "seq": 8},
    "portbench/runners/stub_ranks.py": STUB_RUNNER,
    "portbench/traffic/ranks4-4x4096.json": {
        "runner": "stub_ranks", "rows": 4, "seq": 4096, "workers": 4,
        "wire": WIRE, "optimizer": ADAM, "stream": STREAM,
        "reference_block": 1},
    "portbench/limits/starcoder2-7b-1layer.ranks4.json": {
        "loss_gap": None, "grad_gap": None, "change_gap": 0.01,
        "h_gap": 2.5e-3, "hbar_gap": 2.5e-3},
    "portbench/tests/sizes/traffic/ranks4-4x4096.json": {
        "rows": 4, "seq": 32, "workers": 4},
}
NEW_CONFIGS = [{"name": "toy-moe", "source": "https://example.org/toy-moe",
                "file": "portbench/configs/toy-moe.json", "reduced": [],
                "why": "a family with no reference in model.py"}]
NEW_CELLS = [
    {"name": "toy-moe.plain", "config": "toy-moe",
     "traffic": "toy-plain-4x64", "chips": 1,
     "why": "a new family through simulated_train"},
    {"name": "starcoder2-7b-1layer.ranks4", "config": "starcoder2-7b-1layer",
     "traffic": "ranks4-4x4096", "chips": 4,
     "why": "a cell on four chips under a runner of its own"}]
# the metrics the new cells report, beside setup_s and peak_mem_gib
REPORTS = ("train_tok_per_s", "step.mfu.lm", "grads.device_ms.lm")


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def _add(root: Path, rel: str, content) -> None:
    """A new file: one that is there is never written over."""
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    text = content if isinstance(content, str) else json.dumps(content)
    with open(path, "x") as f:
        f.write(text)


def _extend(spec: dict) -> dict:
    out = json.loads(json.dumps(spec))
    out["configs"] += NEW_CONFIGS
    out["workloads"] += NEW_CELLS
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in REPORTS:
            m["workloads"] += [c["name"] for c in NEW_CELLS]
    return out


def _only_appended(old, new) -> None:
    """``new`` is ``old`` with entries added at the ends of lists."""
    if isinstance(old, dict):
        assert set(new) == set(old)
        for k in old:
            _only_appended(old[k], new[k])
    elif isinstance(old, list):
        assert len(new) >= len(old)
        for a, b in zip(old, new):
            _only_appended(a, b)
    else:
        assert new == old


@pytest.fixture(scope="module")
def extended(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    old = json.loads((root / "BENCHMARK.json").read_text())
    for rel, content in FILES.items():
        _add(root, rel, content)
    (root / "BENCHMARK.json").write_text(json.dumps(_extend(old), indent=2))
    return root, before, old


def test_only_new_files_and_appended_entries(extended):
    root, before, old = extended
    after = _digests(root)
    changed = sorted(k for k in before if after.get(k) != before[k])
    assert changed == ["BENCHMARK.json"]
    assert sorted(set(after) - set(before)) == sorted(FILES)
    new = json.loads((root / "BENCHMARK.json").read_text())
    _only_appended(old, new)


def test_the_spec_holds_for_the_added_cells(extended):
    root = extended[0]
    spec = json.loads((root / "BENCHMARK.json").read_text())
    SPEC.check_top_level(spec)
    SPEC.check_names(spec, root)
    for cell in cells(root):
        SPEC.check_cell(cell, root)
    for cell in NEW_CELLS:
        SPEC.check_sizes(cell["name"], root)
    for m in spec["per_layer"]:
        assert callable(bench.metric_reader(m["name"], root))
    four = bench.load_cell("starcoder2-7b-1layer.ranks4", root)
    assert four.chips == 4
    assert bench.runner(four.traffic["runner"], root).CHIPS == (4,)


@pytest.mark.parametrize("cell", [c["name"] for c in NEW_CELLS])
def test_reduced_cell_finds_the_added_sizes(extended, cell):
    c = reduced_cell(cell, extended[0])
    sizes = json.loads((extended[0] / "portbench/tests/sizes/traffic"
                        / f"{c.traffic_name}.json").read_text())
    assert {k: c.traffic[k] for k in sizes} == sizes
    if cell.startswith("toy"):
        assert {k: c.config[k] for k in TOY_WIDTHS} == TOY_WIDTHS


def test_a_new_family_runs_through_simulated_train(extended):
    """The toy family's reference, found by the configuration's name for
    it, drives the shared runner's reference side, its FLOPs and its
    weights; the control through float8 products reads apart from it."""
    root = extended[0]
    c = reduced_cell("toy-moe.plain", root)
    ref = for_config(c.config, root)
    assert ref.__name__.endswith("reference_toy_moe")
    run = bench.runner(c.traffic["runner"], root)
    seed = 2**31 + 5
    f32 = run.reference_readings(c, seed, CPU)
    again = run.reference_readings(c, seed, CPU)
    assert f32 == again
    assert len(f32["change_norms"]) == len(ref.param_spec(c.config))
    assert all(math.isfinite(v) for v in f32["losses"])
    control = run.reference_readings(c, seed, CPU, precision="fp8")
    assert control["losses"] != f32["losses"]
    ctx = run.trace_context(c, 1, 1.0)
    tr = c.traffic
    assert ctx["flops_per_step"] == ref.step_flops(c.config, tr["rows"],
                                                   tr["seq"])
