"""The ``moe_window`` reference (``portbench/reference/moe_window.py``) and
the readers of the expert layer and the windowed attention: the program
against the reference at small widths on the CPU, in float32 (losses and
every leaf's gradient); the reference's blocked attention against one
block; the parameters and FLOPs of the configuration as run and by hand;
the readers on a synthetic trace."""
import copy
import json

import pytest
import torch

from portbench import bench
from portbench import trace as TR
from portbench.reference import for_config
from portbench.reference import moe_window as MW
from portbench.tests.conftest import ROOT, reduced_cell
from portbench.traffic import generator as G
from portbench.weights import make_weights
from repro_torch.obs import spans

CELL = "mellum2-12b-a2.5b-1period-ep8.artemis"
CONFIG = ROOT / "portbench/configs/mellum2-12b-a2.5b-1period-ep8.json"
CPU = torch.device("cpu")


def _small(**kw) -> dict:
    cfg = copy.deepcopy(reduced_cell(CELL).config)
    cfg.update(kw, compute_dtype="float32")
    return cfg


@pytest.mark.parametrize("offset", [0, 8])
def test_the_program_is_the_reference_in_float32(offset):
    """The program's loss and gradient at float32 compute against the
    reference's, on its seeded weights and a batch of the traffic's
    stream: the same function up to float32 rounding."""
    from repro_torch.models.model import build_model
    cfg = _small(expert_offset=offset)
    ref = for_config(cfg, ROOT)
    assert ref is MW or ref.__name__.endswith("moe_window")
    w = make_weights(ref.param_spec(cfg), 2**31 + 3, CPU)
    tr = dict(reduced_cell(CELL).traffic)
    batch = G.make_batches(tr, cfg, 2**31 + 3, CPU, 1)[0]
    run = bench.runner(tr["runner"], ROOT)
    model = build_model(run.program_config(cfg))
    grads, (loss, _) = torch.func.grad_and_value(model.loss, has_aux=True)(
        w, batch)
    rloss, rgrads = ref.mean_loss_grad(ref.Numerics("f32"), cfg, w, batch,
                                       1)
    assert float(loss) == pytest.approx(rloss, rel=1e-5)
    assert list(grads) == [k for k, _, _ in ref.param_spec(cfg)]
    for (k, g), r in zip(grads.items(), rgrads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6 * float(
            r.abs().max()), msg=k)


@pytest.mark.parametrize("window", [0, 5])
def test_blocked_attention_is_one_block(window, monkeypatch):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 13, 4, 8, generator=g)
    k, v = (torch.randn(2, 13, 2, 8, generator=g) for _ in range(2))
    num = MW.Numerics("f32")
    whole = MW.attention(num, q, k, v, window)
    monkeypatch.setattr(MW, "Q_BLOCK", 4)
    torch.testing.assert_close(MW.attention(num, q, k, v, window), whole,
                               rtol=1e-6, atol=1e-6)
    # each query sees itself and its window's past alone: a key moved
    # outside the window changes nothing
    if window:
        k2 = k.clone()
        k2[:, 0] += 10.0
        out2 = MW.attention(num, q, k2, v, window)
        torch.testing.assert_close(out2[:, window:], whole[:, window:])


def test_the_configuration_as_run():
    """340,349,184 parameters: 70,930,944 a layer (attention 21,233,664,
    the norms 4,608, the router 147,456, 8 held experts 49,545,216) and
    56,623,104 of embedding and head, with the final norm."""
    cfg = json.loads(CONFIG.read_text())
    ref = for_config(cfg, ROOT)
    spec = ref.param_spec(cfg)
    count = ref.param_count(spec)
    assert count == 340_349_184
    layer = ref.param_count([s for s in spec if s[0].startswith("groups/0/")])
    assert layer == 70_930_944 == 21_233_664 + 4_608 + 147_456 + 49_545_216
    assert count == 4 * layer + 56_623_104 + 2304
    # every width as published, the cut as the file says
    assert (cfg["d_model"], cfg["n_heads"], cfg["n_kv"], cfg["head_dim"],
            cfg["d_ff"], cfg["n_experts"], cfg["top_k"],
            cfg["local_window"]) == (cfg["hidden_size"],
                                     cfg["num_attention_heads"],
                                     cfg["num_key_value_heads"], 128,
                                     cfg["moe_intermediate_size"], 64, 8,
                                     cfg["sliding_window"])
    assert cfg["experts_held"] == cfg["num_experts"] == 8
    assert cfg["vocab"] == cfg["vocab_size"] == 98304 // 8
    assert cfg["n_layers"] == cfg["num_hidden_layers"] == 4
    yarn = cfg["rope_parameters"]["full_attention"]
    assert (cfg["rope_yarn_factor"], cfg["rope_yarn_original"],
            cfg["rope_yarn_beta_fast"], cfg["rope_yarn_beta_slow"],
            cfg["rope_yarn_attn_factor"]) == (
        yarn["factor"], yarn["original_max_position_embeddings"],
        yarn["beta_fast"], yarn["beta_slow"], yarn["attention_factor"])
    assert [k.startswith("la") for k in cfg["pattern"]] == [
        t == "sliding_attention" for t in cfg["layer_types"]]


def test_step_flops_by_hand():
    cfg = dict(family="moe", d_model=4, n_heads=2, n_kv=1, head_dim=2,
               d_ff=8, vocab=10, n_experts=4, top_k=2, experts_held=2,
               pattern=["la+moe", "attn+moe"], local_window=2)
    # a token a layer: wq 16, wk 8, wv 8, wo 16, router 16, and 2 choices
    # of which 2/4 here, each 3 * 4 * 8 = 96: 64 + 96 = 160; two layers
    # and the head 40: 360 multiply-adds, x6 at 3 tokens: 6480
    # pairs: windowed 1 + 2 + 2 = 5, full 6; 11 * 12 * 4 = 528
    assert MW.step_flops(cfg, rows=1, seq=3) == 6480 + 528


def test_the_cells_step_flops():
    """8 x 8192 tokens: 6 x 65,536 x (4 x 27,574,272 + 28,311,552) =
    54,503,134,986,240 on the weights (a layer's token: the projections
    21,233,664, the router 147,456, one expected assignment here of
    6,193,152; the head), and 12 x 4096 a pair over 457,224,192 pairs
    (8 rows of three windowed layers' 7,864,832 and a full one's
    33,558,528)."""
    c = bench.load_cell(CELL, ROOT)
    ctx = bench.runner(c.traffic["runner"], ROOT).trace_context(c, 1, 1.0)
    assert ctx["flops_per_step"] == 54503134986240.0 + 12 * 4096 * 457224192
    assert tuple(ctx["wire"]["shape"]) == (16, 83094, 256)


# ---------------------------------------------------------------------------
# the readers, on a synthetic trace
# ---------------------------------------------------------------------------

MARK = f"void (anonymous namespace)::{spans.MARKER}()"
F, R, B = "forward", "recompute", "backward"


def _rec(name, parent, seq, end_seq, pass_=F, **counts):
    return spans.PhaseRecord(name, parent, 7, pass_, seq, counts, pass_,
                             end_seq)


# grads > a windowed attention, a full one, two expert layers (forward),
# then the windowed attention's backward and an expert layer's recompute
RECORDS = [
    _rec("grads", None, 0, 13),
    _rec("grads/attention", "grads", 1, 2, attn_fused=1, window=1024),
    _rec("grads/attention", "grads", 3, 4, attn_fused=1, window=0),
    _rec("grads/moe", "grads", 5, 6, moe_routed=100, moe_dropped=5),
    _rec("grads/moe", "grads", 7, 8, moe_routed=300, moe_dropped=15),
    _rec("grads/attention", "grads", 9, 10, B, window=1024),
    _rec("grads/moe", "grads", 11, 12, R, moe_routed=100, moe_dropped=50),
]


def _trace():
    starts = range(0, 14 * 100, 100)
    ops = [TR.DeviceOp(MARK, "kernel", t, 1, None) for t in starts]
    for i, dur in enumerate((10, 20, 30, 40, 50, 60, 70), start=0):
        # an operation inside each record, after its opening marker
        ops.append(TR.DeviceOp(f"op{i}", "kernel", 200 * i + 150, dur,
                               TR.GRADS))
    ops.sort(key=lambda o: o.start_ns)
    return TR.Trace(ops, steps=1, window_s=1e-6,
                    context={"wire": None, "paced": {"steps": 1,
                                                     "seconds": 1e-6}})


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(spans, "phases", lambda: list(RECORDS))


def test_the_readers(log):
    t = _trace()
    read = {m: bench.metric_reader(m + ".lm", ROOT)(t) for m in (
        "grads.moe.device_ms", "grads.attention.window.device_ms",
        "moe.dropped_share", "grads.attention.device_ms",
        "grads.attention.fused_per_step")}
    # op0 (10 ns) windowed forward, op1 (20) full, op2 and op3 (30, 40)
    # the experts' forward, op4 (50) the windowed backward, op5 (60) the
    # experts' recompute
    assert read["grads.moe.device_ms"] == pytest.approx((30 + 40 + 60) / 1e6)
    assert read["grads.attention.window.device_ms"] == pytest.approx(
        (10 + 50) / 1e6)
    assert read["grads.attention.device_ms"] == pytest.approx(80 / 1e6)
    # the forward's records alone: 20 of 400
    assert read["moe.dropped_share"] == pytest.approx(5.0)
    assert read["grads.attention.fused_per_step"] == 2


def test_the_readers_read_nothing_without_the_counts(monkeypatch):
    old = [_rec(r.name, r.parent, r.seq, r.end_seq, r.pass_,
                **{k: v for k, v in r.counts.items() if k == "attn_fused"})
           for r in RECORDS]
    monkeypatch.setattr(spans, "phases", lambda: old)
    t = _trace()
    for m in ("grads.attention.window.device_ms", "moe.dropped_share"):
        assert bench.metric_reader(m + ".lm", ROOT)(t) is None
    monkeypatch.delattr(spans, "phases")
    for m in ("grads.attention.window.device_ms", "moe.dropped_share",
              "grads.moe.device_ms"):
        assert bench.metric_reader(m + ".lm", ROOT)(_trace()) is None
