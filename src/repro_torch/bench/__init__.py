"""The port's benchmark suites (port of ``benchmarks/``): the paper's
figures (``paper_figs``), the hand-written kernels (``kernel_bench``), the
sweep engine and the mesh wire (``dist_bench``), the fault defenses
(``fault_bench``) and one dry-run combo (``hillclimb``).

Each suite is a function ``suite(ctx) -> [(name, us_per_call, derived)]``
taking a ``Context``: whether to run at the smoke size (``fast``), the
device, and the directory its reports go to.  ``python -m repro_torch.bench``
runs them and prints ``name,us_per_call,derived`` CSV.

Times are named for where they come from: a kernel's device time from the
``torch.profiler`` CUDA trace, a step or round from the host clock around
work that ends in a synchronize.  On the CPU only the plain versions run,
and the rows say so.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Callable, Collection, List, Optional, Tuple

import torch

Row = Tuple[str, float, str]

DEFAULT_OUT_DIR = os.path.join("chiprun_out", "bench")


@dataclasses.dataclass(frozen=True)
class Context:
    fast: bool                  # the smoke size: one cell, few rounds
    device: torch.device
    out_dir: str = DEFAULT_OUT_DIR

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def path(self, name: str) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        return os.path.join(self.out_dir, name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_us(fn: Callable, device: torch.device, reps: int = 5,
            warmup: int = 1) -> float:
    """Median host-clock µs of one call of ``fn``, each call ending in a
    synchronize, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def device_trace(fn: Callable, calls: int = 25, pad: int = 8,
                 tries: int = 3, skip: Collection[str] = ()
                 ) -> Tuple[Optional[float], float, List[str]]:
    """The CUDA kernels that ``calls`` calls of ``fn`` ran, from the
    ``torch.profiler`` trace: (summed device µs per call, kernels per call,
    kernel names), or (None, 0, []) if ``tries`` traces in a row hold no
    kernel (a process that has opened many profiler sessions now and then
    gets an empty one).  The calls run between ``pad`` spin kernels on each
    side, left out of the sums: a trace can drop kernels at its ends.
    Kernels named in ``skip`` are left out too."""
    for _ in range(tries):
        out = _trace(fn, calls, pad, skip)
        if out[0] is not None:
            return out
    return out


def _trace(fn: Callable, calls: int, pad: int, skip: Collection[str]):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        for _ in range(pad):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda
              and "spin_kernel" not in e.name and e.name not in skip]
    if not events:
        return None, 0.0, []
    us = sum(e.time_range.elapsed_us() for e in events) / calls
    return us, len(events) / calls, sorted({e.name for e in events})


def fmt(x: Optional[float], digits: int = 3) -> str:
    return "not_measured" if x is None else f"{x:.{digits}f}"
