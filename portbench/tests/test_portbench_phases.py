"""The program's phases in the trace (``portbench/phases.py``) and their
readers: on a synthetic trace, the markers matched to the log's
boundaries and their own time left out; and on the card (marked ``cuda``), one traced step of
fed20 and of .central, whose phases add up to the harness's ranges."""
import gc
import time

import pytest
import torch

from portbench import bench, phases
from portbench import trace as TR
from portbench.tests.conftest import ROOT
from repro_torch.obs import spans

MARK = f"void (anonymous namespace)::{spans.MARKER}()"
F, B = "forward", "backward"


def _rec(name, parent, seq, end_seq, pass_=F, end_pass=F, step=7,
         **counts):
    return spans.PhaseRecord(name, parent, step, pass_, seq, counts,
                             end_pass, end_seq)


# one step: step > grads > (the attention's forward, then its backward),
# then the ring
RECORDS = [
    _rec("step", None, 0, 9),
    _rec("grads", "step", 1, 6),
    _rec("grads/attention", "grads", 2, 3),
    _rec("grads/attention", "grads", 4, 5, B, B),
    _rec("wire/ring", "step", 7, 8, wire_bytes=2e9),
]


def _ops(drop_marker=False):
    ops = [TR.DeviceOp(MARK, "kernel", t, 1, None)
           for t in (100, 110, 120, 175, 200, 265, 290, 400, 455, 460)]
    ops += [TR.DeviceOp("qk", "kernel", 130, 40, TR.GRADS),
            TR.DeviceOp("res", "kernel", 180, 10, TR.GRADS),
            TR.DeviceOp("dqk", "kernel", 210, 50, TR.GRADS),
            TR.DeviceOp("dres", "kernel", 270, 10, TR.GRADS),
            TR.DeviceOp("hop", "kernel", 410, 40, None)]
    ops.sort(key=lambda o: o.start_ns)
    if drop_marker:
        ops.remove(next(o for o in ops if o.start_ns == 265))
    return ops


def _trace(steps=1, **kw):
    return TR.Trace(_ops(**kw), steps=steps, window_s=1e-6,
                    context={"wire": None, "paced": {"steps": 1,
                                                     "seconds": 1e-6}})


@pytest.fixture
def log(monkeypatch):
    # an older step in front: the stretch is the log's last steps
    older = [_rec("step", None, -2, -1, step=6)]
    monkeypatch.setattr(spans, "phases", lambda: older + RECORDS)


def test_markers_take_the_phases_and_pass_and_are_left_out(log):
    s = phases.split(_trace())
    assert s.markers == 10
    step, grads, attn = ("step",), ("step", "grads"), \
        ("step", "grads", "grads/attention")
    assert s.device_ns == {(attn, F): 40, (grads, F): 10, (attn, B): 50,
                           (grads, B): 10, (("step", "wire/ring"), F): 40}
    assert s.device_ms(["grads"], F) == pytest.approx(50e-6)
    assert s.device_ms(["grads"], B) == pytest.approx(60e-6)
    assert s.device_ms(["grads/attention"]) == pytest.approx(90e-6)
    assert s.device_ms(["optim/apply"]) is None
    assert step not in {p for p, _ in s.device_ns}
    # the result is cached in the trace's context
    t = _trace()
    assert phases.split(t) is phases.split(t) is t.context[phases.KEY]


def test_a_count_or_nesting_mismatch_gives_none(log, monkeypatch):
    assert phases.split(_trace(drop_marker=True)) is None
    # more steps than the log holds
    assert phases.split(_trace(steps=3)) is None
    # a record left open (a backward whose input took no gradient)
    bad = [_rec("step", None, 0, -1)] + RECORDS[1:]
    monkeypatch.setattr(spans, "phases", lambda: bad)
    assert phases.split(_trace()) is None


def test_a_port_without_phases_reads_nothing(monkeypatch):
    monkeypatch.delattr(spans, "phases")
    t = _trace()
    assert phases.split(t) is None
    assert bench.metric_reader("grads.forward.device_ms.speech")(t) is None


READS = {"grads.forward.device_ms": 50e-6, "grads.backward.device_ms": 60e-6,
         "grads.recompute.device_ms": 0.0,
         "grads.attention.device_ms": 90e-6, "wire.ring.device_ms": 40e-6,
         "wire.bytes_per_step": 2.0,
         "grads.mlp.device_ms": None, "grads.head.device_ms": None,
         "wire.noise.device_ms": None, "wire.layout.device_ms": None,
         "wire.codec.device_ms": None, "wire.memory.device_ms": None,
         "optim.apply.device_ms": None}


@pytest.mark.parametrize("stem", sorted(READS))
def test_each_reader(stem, log):
    got = bench.metric_reader(stem + ".speech")(_trace())
    want = READS[stem]
    assert got == (None if want is None else pytest.approx(want))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

SEED = 2**31 + 901
WIRE = ("wire.noise.device_ms", "wire.layout.device_ms",
        "wire.codec.device_ms", "wire.ring.device_ms", "wire.memory.device_ms")
PASSES = ("grads.forward.device_ms", "grads.backward.device_ms",
          "grads.recompute.device_ms")
BLOCKS = ("grads.attention.device_ms", "grads.mlp.device_ms",
          "grads.head.device_ms")


def _traced_step(cell, step, held, pool):
    def one():
        t = time.perf_counter()
        held["state"], _ = step(held["state"], pool[0])
        torch.cuda.synchronize()
        return 1, time.perf_counter() - t
    from portbench.runners import simulated_train as ST
    return TR.traced(one, one, ST.trace_context(cell, 1, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whisper-tiny.fed20",
                                  "whisper-tiny.central"])
def test_one_traced_step_adds_up_on_the_card(name, cuda_device,
                                             monkeypatch):
    from portbench.runners import simulated_train as ST
    cell = bench.load_cell(name, ROOT)
    weights, pool = ST.inputs(cell, SEED, cuda_device, 1)
    init, step = ST.build_step(cell, SEED, cuda_device)
    held = {"state": init(weights)}
    del weights
    try:
        held["state"], _ = step(held["state"], pool[0])
        trace = _traced_step(cell, step, held, pool)
        _adds_up(cell, trace)
        # the markers are all the kernels the phases add
        s = phases.split(trace)
        with_phases = len(trace.kernels())
        monkeypatch.setattr(spans.phase, "__enter__", lambda self: self)
        without = _traced_step(cell, step, held, pool)
        assert with_phases - s.markers == len(without.kernels())
    finally:
        held.clear()
        pool.clear()
        gc.collect()
        torch.cuda.empty_cache()


def _adds_up(cell, trace):
    read = {m["name"].rsplit(".", 1)[0]: bench.metric_reader(m["name"])(
        trace) for m in cell.per_layer}
    s = phases.split(trace)
    assert s is not None and None not in read.values(), read
    if cell.traffic["wire"]:
        wire = sum(read[k] for k in WIRE) + read["optim.apply.device_ms"]
        assert wire == pytest.approx(read["wire.device_ms"], rel=0.02)
        grads = read["grads.device_ms"]
    else:
        grads = read["grads.device_ms"] - read["optim.apply.device_ms"]
    assert sum(read[k] for k in PASSES) == pytest.approx(grads, rel=0.02)
    assert sum(read[k] for k in BLOCKS) <= read["grads.device_ms"]
