"""The trace's reduction and the per-layer readers, on a synthetic trace:
which range a device operation belongs to, the busy time as a union, and
each metric's arithmetic."""
import pytest

from portbench import bench, flops, peaks
from portbench import trace as TR
from portbench.rooflines import bucket_acc_hop_kernel as B3


class Event:
    """A stand-in for a Kineto event, as torch 2.11 gives it (no
    ``activity_type``)."""

    def __init__(self, name, device, start, dur, corr=0, linked=0):
        self._v = (name, device, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


HOP = "void (anonymous namespace)::bucket_acc_hop_kernel<16>(float const*)"
MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
# the device's events, out of order; the host's runtime calls are no device
# operation; a step before the first marker (the stretch's start) is not
# the stretch's; the markers open GRADS, close it, open OPTIM and close it
EVENTS = [
    Event("cudaLaunchKernel", "CPU", 112, 2, corr=901),
    Event("warm step", "CUDA", 100, 50),
    Event(MARK, "CUDA", 290, 2),
    Event("gemm", "CUDA", 300, 50, corr=901),
    Event(HOP, "CUDA", 360, 40, corr=902),
    Event(MARK, "CUDA", 405, 2),
    Event("add", "CUDA", 420, 30, corr=903),
    Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 600, 10),
    Event(MARK, "CUDA", 598, 1),
    Event(MARK, "CUDA", 612, 1),
]
MARKS = [TR.GRADS, None, TR.OPTIM, None]


def test_ops_take_the_range_open_at_their_launch():
    ops = {o.name: o for o in TR.reduce_events(EVENTS, MARKS)}
    assert set(ops) == {"gemm", HOP, "add",
                        "Memcpy HtoD (Pageable -> Device)"}
    assert ops["gemm"].range == TR.GRADS and ops[HOP].range == TR.GRADS
    assert ops["add"].range is None
    memcpy = ops["Memcpy HtoD (Pageable -> Device)"]
    assert memcpy.range == TR.OPTIM and memcpy.kind == "gpu_memcpy"
    # a marker the trace lost, or one too many, leaves no range to trust
    with pytest.raises(RuntimeError):
        TR.reduce_events(EVENTS, MARKS[:3])
    with pytest.raises(RuntimeError):
        TR.reduce_events(EVENTS, MARKS + [TR.GRADS])


def test_spans_mark_only_while_a_trace_runs(monkeypatch):
    launched = []
    monkeypatch.setattr(TR, "_mark", lambda name: launched.append(name))
    with TR.span(TR.GRADS):
        pass
    assert launched == []
    monkeypatch.setattr(TR, "_marks", [])
    with TR.span(TR.GRADS):
        with TR.span(TR.OPTIM):
            pass
    assert launched == [TR.GRADS, TR.OPTIM, TR.GRADS, None]


def _trace(wire=None):
    ops = TR.reduce_events(EVENTS, MARKS)
    return TR.Trace(ops, steps=1, window_s=1e-6,
                    context={"flops_per_step": 1e3, "wire": wire,
                             "paced": {"steps": 1, "seconds": 1e-6}})


def test_busy_is_the_union_and_the_readers_add_up():
    t = _trace({"workers": 1, "shape": (1, 2, 256)})
    # 300-350 (gemm), 360-400 (the hop), 420-450, 600-610
    assert t.busy_s() == pytest.approx(130e-9)
    read = {m: bench.metric_reader(m) for m in (
        "device.idle_share", "host.kernels_per_step", "grads.device_ms",
        "wire.device_ms", "optim.device_ms", "step.mfu", "bucket_acc_hop_roofline")}
    assert read["device.idle_share"](t) == pytest.approx(87.0)
    assert read["host.kernels_per_step"](t) == 3
    assert read["grads.device_ms"](t) == pytest.approx(90e-6)
    assert read["wire.device_ms"](t) == pytest.approx(30e-6)
    assert read["optim.device_ms"](t) == pytest.approx(10e-6)
    assert read["step.mfu"](t) == pytest.approx(
        100 * 1e3 / 1e-6 / peaks.BF16_DENSE_FLOPS)
    bound_s = B3.step_bytes(1, (1, 2, 256)) / peaks.HBM_BYTES_PER_S
    assert read["bucket_acc_hop_roofline"](t) == pytest.approx(100 * bound_s / 40e-9)
    # a launch count other than one a worker a step has no bound
    t.steps = 2
    assert read["bucket_acc_hop_roofline"](t) is None


def test_idle_and_mfu_take_the_untraced_pace():
    t = _trace()
    t.context["paced"] = {"steps": 2, "seconds": 4e-6}
    assert bench.metric_reader("device.idle_share")(t) == pytest.approx(
        100 * (1 - 130e-9 / 2e-6))
    assert bench.metric_reader("step.mfu")(t) == pytest.approx(
        100 * 1e3 * 2 / 4e-6 / peaks.BF16_DENSE_FLOPS)


def test_a_cell_without_the_wire_reads_no_wire_and_no_ring():
    t = _trace()
    assert bench.metric_reader("wire.device_ms")(t) is None
    assert bench.metric_reader("bucket_acc_hop_roofline")(t) is None
    # without the gradients' hook, everything outside the optimizer
    assert bench.metric_reader("grads.device_ms")(t) == pytest.approx(
        120e-6)


def test_breakdown_names_ops_and_gaps():
    b = TR.breakdown(_trace())
    assert b["device_ops"][0] == ["gemm", 50e-9]
    assert b["idle_gaps"][0] == [
        "optim at +0.000 s: before Memcpy HtoD (Pageable -> Device)",
        150e-9]


def test_flops_of_the_cells_configs():
    import json
    from portbench.tests.conftest import ROOT
    cfg = json.loads((ROOT / "portbench/configs/whisper-tiny.json")
                     .read_text())
    assert flops.step_flops(cfg, 40, 448, 1500) == pytest.approx(8.284e12,
                                                                 rel=1e-3)
