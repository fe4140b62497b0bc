"""The present configurations read as they did before the reference
became a module found by name: each one's parameters (paths, shapes and
initial stds, in order), their count, and a step's model FLOPs at each of
its cells' traffic, through its reference module, against numbers written
here (the counts of ``portbench/reference/model.py`` and
``portbench/flops.py`` as they stood when they were the only ones)."""
import json

import pytest

from portbench import bench
from portbench.reference import for_config
from portbench.tests.conftest import ROOT

E, D = 0.05103103630798288, 0.02551551815399144      # 384 ** -0.5, 1536's
S, F = 0.01473139127471974, 0.00736569563735987      # 4608's, 18432's

SPECS = {
    "whisper-tiny": [
        ("embed", (51865, 384), 0.02),
        ("enc_norm", (384,), 0.0),
        ("encoder/attn/wk", (4, 384, 384), E),
        ("encoder/attn/wo", (4, 384, 384), E),
        ("encoder/attn/wq", (4, 384, 384), E),
        ("encoder/attn/wv", (4, 384, 384), E),
        ("encoder/ln1", (4, 384), 0.0),
        ("encoder/ln2", (4, 384), 0.0),
        ("encoder/mlp/w_down", (4, 1536, 384), D),
        ("encoder/mlp/w_up", (4, 384, 1536), E),
        ("final_norm", (384,), 0.0),
        ("frontend_proj", (384, 384), E),
        ("layers/attn/wk", (4, 384, 384), E),
        ("layers/attn/wo", (4, 384, 384), E),
        ("layers/attn/wq", (4, 384, 384), E),
        ("layers/attn/wv", (4, 384, 384), E),
        ("layers/ln1", (4, 384), 0.0),
        ("layers/ln2", (4, 384), 0.0),
        ("layers/lnx", (4, 384), 0.0),
        ("layers/mlp/w_down", (4, 1536, 384), D),
        ("layers/mlp/w_up", (4, 384, 1536), E),
        ("layers/xattn/wk", (4, 384, 384), E),
        ("layers/xattn/wo", (4, 384, 384), E),
        ("layers/xattn/wq", (4, 384, 384), E),
        ("layers/xattn/wv", (4, 384, 384), E),
        ("unembed", (384, 51865), 0.02),
    ],
    "starcoder2-7b-1layer": [
        ("embed", (49152, 4608), 0.02),
        ("final_norm", (4608,), 0.0),
        ("layers/attn/wk", (1, 4608, 512), S),
        ("layers/attn/wo", (1, 4608, 4608), S),
        ("layers/attn/wq", (1, 4608, 4608), S),
        ("layers/attn/wv", (1, 4608, 512), S),
        ("layers/ln1", (1, 4608), 0.0),
        ("layers/ln2", (1, 4608), 0.0),
        ("layers/mlp/w_down", (1, 18432, 4608), F),
        ("layers/mlp/w_up", (1, 4608, 18432), S),
        ("unembed", (4608, 49152), 0.02),
    ],
}
COUNTS = {"whisper-tiny": 56_503_296, "starcoder2-7b-1layer": 670_053_888}
# a step's model FLOPs at each cell's traffic (rows, seq, frames), and the
# wire's bucket stack where the cell has a wire
STEP_FLOPS = {
    "whisper-tiny.fed20": 8283517747200.0,
    "starcoder2-7b-1layer.artemis": 45458386845696.0,
    "starcoder2-7b-1layer.plain": 45458386845696.0,
    "whisper-tiny.central": 8283517747200.0,
}
STACKS = {"whisper-tiny.fed20": (16, 13795, 256),
          "starcoder2-7b-1layer.artemis": (16, 163588, 256)}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FILES = {c["name"]: ROOT / c["file"] for c in BENCH["configs"]}


@pytest.mark.parametrize("config", sorted(SPECS))
def test_param_spec_and_count_as_before(config):
    cfg = json.loads(FILES[config].read_text())
    ref = for_config(cfg, ROOT)
    spec = ref.param_spec(cfg)
    assert [(k, tuple(s), std) for k, s, std in spec] == SPECS[config]
    assert ref.param_count(spec) == COUNTS[config]


@pytest.mark.parametrize("cell", sorted(STEP_FLOPS))
def test_step_flops_as_before(cell):
    """As the runner hands them to the trace's readers."""
    c = bench.load_cell(cell, ROOT)
    ctx = bench.runner(c.traffic["runner"], ROOT).trace_context(c, 1, 1.0)
    assert ctx["flops_per_step"] == STEP_FLOPS[cell]
    wire = ctx["wire"] and tuple(ctx["wire"]["shape"])
    assert wire == STACKS.get(cell)
