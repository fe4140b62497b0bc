#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each fails the run with a non-zero exit if it goes wrong):

1. card identity: ``nvidia-smi --query-gpu=name,power.limit``;
2. build: every kernel of the path from ``src/repro_torch/csrc`` with nvcc,
   one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at one large probe, with device times
   (``ring_sum`` on the round's own strided [N, M, d] view of its [M, N, d]
   levels and on a contiguous copy, bit for bit; fused_memory_update also
   in bf16 on the round's rows and on rows of 2^20; ``worker_sum``, B2's
   loop on float32 rows, on the round's [M, N, d] server sum and the
   sweep's [M, N, 1] bit meter, bit for bit; every fused_memory_update,
   ring_sum, worker_sum and bucket_ring_sum case launched twice for the
   same bits); the ring's in-place hop (``bucket_acc_hop_``) at the mesh
   and wide stacks, hops 0 and 1;
4. slice: the paper's experiments exp1 to exp4 through ``run_sweep`` with
   ``backend="cuda"``; the four claims must hold and every squant-uplink
   variant must have launched both kernels once per round (and the worker
   sum ran: the bit meter's sum every round, the dense sgd uplink's and
   PP1's server sums);
5. grid: the Fig. 4 clustered problem at its published size over 5 variants
   x 8 step sizes x 16 seeds = 640 cells;
6. profile: the device-busy share from ``torch.profiler`` over 20 rounds of
   one variant's 128 grid cells (after the launch counts are read);
7. mesh: the bucketed mesh wire (``experiments.toy_mesh_train``), ToyMLP(12,
   64) on W = 8 simulated workers for 20 steps: the six variants on the
   pipelined ring, artemis also on the sequential ring and on psum, with
   p = 0.5 and with local_steps = 2.  Losses must stay finite and fall
   (dore's, which diverges later as the reference's does, must first
   fall), pipelined must equal sequential bit for bit and psum to 1e-5
   over 3 steps (the reference's scenario), and ``bucket_acc`` must
   launch exactly W times per communicating step of every compressing
   variant on the pipelined ring;
8. wide: ToyMLP(12, 1024) (12.6 M parameters) with the default
   ``DistConfig`` layout [16, 3076, 256], artemis, sgd(0.01), W = 8, 10
   steps after 2 of warm-up, under ``torch.profiler``: µs per step, the
   device-busy share, the peak device memory, the top device kernels and
   any roll among them; the loss must fall;
9. ops kernels: the compression API's kernels (squant_encode, squant_decode
   to f32 and bf16, dequant_apply in f32 and bf16, and fused_memory_update
   on (256, 256) tiles, in f32 and bf16) against their plain versions at
   [4096, 256] (one ToyMLP(12, 1024) weight as the API packs it) and at a
   [16384, 4096] probe, with device times, bounds and one-call library
   times; squant_encode also on one tile, [256, 256] (13 of the 25 leaves
   are one tile), and for all four (x, u) dtype pairs; decode also on
   (256, 8) blocks and dequant_apply on [4096, 248] in (256, 8) blocks,
   which take one element a thread; fused_memory_update also on one
   tile;
10. ops: the compression API (``repro_torch.kernels.ops``) on ToyMLP(12,
   1024): ``tree_compress`` of a gradient tree (finite, shapes, signs),
   ``tree_memory_update`` twice (h_new = h + alpha * delta_hat) and once on
   the tree in bf16 (h_new in bf16), then 10
   steps after 2 of warm-up of compressed SGD (``experiments.
   compressed_sgd_step``: encode and the fused apply per leaf, s = 1,
   lr = 0.01) under ``torch.profiler``; the loss must fall, and every step
   must launch squant_encode and dequant_apply once per leaf (25 each).

11. fault kernels (after phase 3): fused_memory_update on the round's rows
   [2560, 40] with NaN, +-Inf, -0.0, blown-up and overflowing rows and NaN
   in h (bit for bit with the plain version on the rows with a non-finite
   or zero norm, levels saturating to the int8 range where a NaN norm
   sends them past it; NaN placement everywhere), and ring_sum on the
   round's strided [20, 128, 40] view of corrupted payloads (levels over
   the whole int8 range, NaN, +-Inf, -0.0, negative and overflowing
   scales; bit for bit, NaN placement included);
12. codecs (after the mesh kernels): tile_squant (tiles of 1024 and 32),
   sparsify and topk on the card against the same codec on CPU tensors
   (sparsify and topk bit for bit; tile_squant's scales to rtol 1e-6 and
   its levels equal where the scales agree), each payload's bytes against
   ``wire_bytes``;
13. faults (after phase 6): ``experiments.fault_matrix`` (the zero-fault
   identity bit for bit, scrub recovery, sentinel rollbacks with a backed
   off step size, the bit-flip run on the fused wire finite),
   ``exp5_faults`` (every final loss finite), and the Fig. 4 grid of
   phase 5 under bit flips, scrubbing and the sentinel (``GRID_FAULTS``),
   with one launch of each fused kernel per round of every squant-uplink
   variant;
14. figures: ``table3_gamma_max`` (the theory's gamma_max converges for
   sgd, qsgd and artemis) and ``thm3_variance_lower_bound`` (q = 0.25
   saturates above q = 1);
15. resume: the faulted grid (640 cells, 100 rounds) checkpointed every 50
   rounds, rewound to its first snapshot and resumed, bit for bit with
   the uninterrupted run; the time of one save of its snapshot; then the
   profile of phase 6 again under ``GRID_FAULTS``.

The simulator's path (phases 4 and 5), the fault path (phases 13 to 15),
the mesh's (phases 7 and 8) and the compression API's (phase 10) are each
driven with every launch count set to 0 just before and read just after;
the kernels line adds the simulator's and the fault path's launches.

It prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
It imports nothing of JAX or of the JAX package.
"""
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

# main-path shapes: the fig4-sized grid lays B = 128 cells of N = 20 workers
# on the rows of the fused uplink, and M = 128 cells on the ring sum, which
# the round hands its [M, N, d] levels as the strided view [N, M, d]
B, N = 128, 20
FUSED_CASES = [(B * N, 2), (B * N, 20), (B * N, 40), (20, 2**20)]
RING_CASES = [(N, B, 40, "strided"), (N, B, 40, "contiguous"),
              (N, 1, 2**20, "contiguous")]
MAIN_FUSED, MAIN_RING = (B * N, 40), (N, B, 40)
# B1 in bf16 on the round's rows and on rows of 2^20 (lane groups and a
# streaming cluster; the cluster's registers: the ops kernel phase)
FUSED_BF16_CASES = [(B * N, 40), (20, 2**20)]
# the worker sum: the round's server sum over [M, N, d] and the sweep's
# bit meter over [M, N, 1], as [lead, N, d]
WSUM_CASES = [(B, N, 40), (B, N, 1)]
MAIN_WSUM = WSUM_CASES[0]
# the grid's 8 step sizes (multiples of the reference's 0.5/L) x 16 seeds
GRID_MULTS = [2.0 ** (-0.5 * i) for i in range(8)]
GRID_SEEDS = list(range(16))

# mesh-wire shapes: W = 8 workers; ToyMLP(12, 64) lays out as [16, 49, 64]
# (the mesh phase), ToyMLP(12, 1024) under the default DistConfig as
# [16, 3076, 256] (the wide phase, where the ring spends its time, so
# bucket_acc's main shape).  bucket_acc sees [W * B, R, C] out of place, and
# the ring's in-place hops see the [W, B, R, C] stack
W = 8
ACC_CASES = [(W * 16, 49, 64), (W * 16, 3076, 256)]
BSUM_CASES = [(W, 16, 49, 64), (W, 16, 3076, 256)]
HOP_CASES = BSUM_CASES
MAIN_ACC, MAIN_BSUM = ACC_CASES[1], BSUM_CASES[0]
MESH_STEPS, WIDE_STEPS = 20, 10

# compression-API shapes: ops._pack lays a ToyMLP(12, 1024) weight
# (1024 x 1024) out as [4096, 256] in (256, 256) tiles (the main shape);
# the probe holds 67.1 M elements
OPS_BLOCK = (256, 256)
OPS_CASES = [(4096, 256), (16384, 4096)]
MAIN_OPS = OPS_CASES[0]
# B1 and the encode on the API's tiles also at one tile, as a one-tile leaf
# (a bias) has it
ONE_TILE = (256, 256)
FUSED_TILE_CASES = [ONE_TILE] + OPS_CASES
# dequant_apply where N is not a multiple of 16: one element a thread
APPLY_NARROW = ((4096, 248), (256, 8))
OPS_STEPS, OPS_S, OPS_LR, OPS_ALPHA = 10, 1, 0.01, 0.5

# the fault path: the Fig. 4 grid again, every variant under bit flips,
# scrubbing and the sentinel; the resume phase's checkpointed faulted grid
# (all 640 cells, 100 rounds, a snapshot every 50)
GRID_FAULTS = dict(bitflip_rate=0.01, scrub=True, sentinel=1e6)
RESUME_ITERS, RESUME_EVERY = 100, 50
# the codecs phase: (codec, kwargs, shape) on the card against the CPU;
# [128, 20, 40] is a grid variant's uplink, [20, 5000] a longer message
CODEC_CASES = [("tile_squant", {"s": 1, "tile": 1024}, (20, 5000)),
               ("tile_squant", {"s": 1, "tile": 32}, (20, 5000)),
               ("tile_squant", {"s": 1, "tile": 32}, (B, N, 40)),
               ("sparsify", {"q": 0.25}, (B, N, 40)),
               ("sparsify", {"q": 0.5}, (20, 5000)),
               ("topk", {"frac": 0.1}, (B, N, 40)),
               ("topk", {"frac": 0.1}, (20, 5000))]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    line = out.stdout.strip().splitlines()[0]
    log(f"card: {line}")
    return line


def build_phase():
    from repro_torch.kernels import _build
    names = sorted(_build.SIGNATURES)
    t0 = time.perf_counter()
    _build.build(names)
    secs = time.perf_counter() - t0
    log(f"build: {names} in {secs:.2f} s")
    for name in names:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return secs


def call_ms(fn, runs=25, per_run=10):
    """Median over ``runs`` CUDA-event timings of ``per_run`` calls, in ms
    per call, after a warm-up.  Host-inclusive: when the host issues work
    slower than the card runs it, this is the host's rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def device_trace(fn, calls=25, pad=8):
    """The device kernels that ``calls`` calls of ``fn`` ran, as the
    profiler's CUDA trace records them: (summed duration in ms per call,
    kernels per call, kernel names), or (None, 0, []) if the trace holds no
    kernel.  A trace can drop a few kernels at its ends, so the calls run
    between ``pad`` spin kernels on each side, left out of the sums."""
    import torch
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
              and "spin_kernel" not in e.name]
    if not events:
        return None, 0, []
    ms = sum(e.time_range.elapsed_us() for e in events) / calls / 1e3
    return ms, len(events) / calls, sorted({e.name for e in events})


def device_ms(fn, calls=25):
    """Device time per call in ms (``device_trace``), or None."""
    return device_trace(fn, calls)[0]


def timings(kernel, plain):
    """Device times of the kernel and of its plain version (the profiler's
    trace; the host-inclusive event time where the trace is empty), and
    their host-inclusive times per call.  Each wrapper launches one kernel
    per call: ``kernels_per_call`` other than 1 says its trace was
    incomplete."""
    t = dict(call_ms=call_ms(kernel), plain_call_ms=call_ms(plain))
    ms, per_call, _ = device_trace(kernel)
    plain_ms = device_ms(plain)
    t["kernels_per_call"] = per_call
    if ms and per_call != 1:
        log(f"  the kernel's trace holds {per_call:g} kernels per call")
    t["ms_from"] = "profiler" if ms and plain_ms else "events"
    t["ms"] = ms if ms and plain_ms else t["call_ms"]
    t["plain_ms"] = plain_ms if ms and plain_ms else t["plain_call_ms"]
    return t


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fused_agrees(name, out, plain, block):
    """B1 against its plain version: levels off by at most 1 on fewer than
    1e-4 of the entries, scales to rtol 1e-6, and where the levels agree
    h_new to rtol 1e-5, atol 1e-6 in f32, bit for bit in bf16 where the
    scales rounded to bf16 (the update's factor) agree too.  Returns
    (max abs error, level mismatch)."""
    import torch
    (q, sc, hn), (qp, scp, hnp) = out, plain
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    mismatch = float((diff != 0).float().mean())
    check(mismatch < 1e-4 and int(diff.max()) <= 1,
          f"{name}: level mismatch {mismatch} max {diff.max()}")
    check(torch.allclose(sc, scp, rtol=1e-6, atol=0),
          f"{name}: scales differ by {float((sc - scp).abs().max())}")
    agree = diff == 0
    bf16 = hn.dtype == torch.bfloat16
    if bf16:
        same = (sc.to(hn.dtype) == scp.to(hn.dtype))
        agree &= same.repeat_interleave(block[0], 0).repeat_interleave(
            block[1], 1)
    err_h = float((hn.float() - hnp.float()).abs()[agree].max())
    ok = (torch.equal(hn[agree], hnp[agree]) if bf16 else
          torch.allclose(hn[agree], hnp[agree], rtol=1e-5, atol=1e-6))
    check(ok, f"{name}: h_new differs by {err_h}")
    return max(float((sc - scp).abs().max()), err_h), mismatch


def fused_case(dev, rows, d, seed, dtype=None):
    import torch
    from repro_torch.kernels.fused_memory import (
        fused_memory_update, fused_memory_update_plain)
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    g, h = (torch.randn(rows, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    u = torch.rand(rows, d, generator=gen, device=dev).to(dtype)
    alpha, s = 0.25, 1
    name = f"fused [{rows},{d}] {_dt(dtype)}"
    before = fused_memory_update.launches
    out = fused_memory_update(g, h, u, alpha, s=s, block=(1, d))
    torch.cuda.synchronize()
    check(fused_memory_update.launches == before + 1,
          "fused_memory_update did not count its launch")
    check(_same_bits(out, fused_memory_update(g, h, u, alpha, s=s,
                                               block=(1, d))),
          f"{name}: a second launch gave other bits")
    err, mismatch = _fused_agrees(
        name, out, fused_memory_update_plain(g, h, u, alpha, s=s,
                                             block=(1, d)), (1, d))
    n_el = rows * d
    times = timings(
        lambda: fused_memory_update(g, h, u, alpha, s=s, block=(1, d)),
        lambda: fused_memory_update_plain(g, h, u, alpha, s=s, block=(1, d)))
    # reads g, h, u, writes q (1 B) and h_new per element (17 B in f32, 9 B
    # in bf16) and one 4 B scale per row; ~15 float ops per element (norm
    # 3, levels and memory update 12)
    b_ms, b_by = bound((4 * g.element_size() + 1) * n_el + 4 * rows,
                       15 * n_el)
    return dict(shape=[rows, d], dtype=_dt(dtype), max_abs_err=err,
                level_mismatch=mismatch, bound_ms=b_ms, bound_by=b_by,
                **times)


def _same_bits(a, b):
    """Whether two launches' outputs (tensors or tuples of them) are
    identical."""
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def ring_case(dev, n, m, c, layout, seed):
    """``layout`` "strided": q and scales made as [M, N, ...] and passed as
    their [N, M, ...] transposes, as the Artemis round passes them."""
    import torch
    from repro_torch.kernels.ring_sum import ring_sum, ring_sum_plain
    gen = torch.Generator(device=dev).manual_seed(seed)
    if layout == "strided":
        q = torch.randint(-2, 3, (m, n, c), generator=gen, device=dev,
                          dtype=torch.int8).transpose(0, 1)
        scales = torch.rand(m, n, 1, generator=gen, device=dev).transpose(0, 1)
    else:
        q = torch.randint(-2, 3, (n, m, c), generator=gen, device=dev,
                          dtype=torch.int8)
        scales = torch.rand(n, m, 1, generator=gen, device=dev)
    before = ring_sum.launches
    out = ring_sum(q, scales)
    torch.cuda.synchronize()
    check(ring_sum.launches == before + 1, "ring_sum did not count its launch")
    ref = ring_sum_plain(q, scales)
    err = float((out - ref).abs().max())
    name = f"ring_sum [{n},{m},{c}] {layout}"
    check(torch.equal(out, ref), f"{name}: differs from its plain version "
                                 f"by {err}")
    check(_same_bits(out, ring_sum(q, scales)),
          f"{name}: a second launch gave other bits")
    times = timings(lambda: ring_sum(q, scales),
                    lambda: ring_sum_plain(q, scales))
    # reads N*M*C int8 levels and N*M scales, writes M*C floats; a multiply
    # and an add per level
    b_ms, b_by = bound(n * m * c + 4 * n * m + 4 * m * c, 2 * n * m * c)
    return dict(shape=[n, m, c], layout=layout, max_abs_err=err,
                bound_ms=b_ms, bound_by=b_by, **times)


def wsum_case(dev, lead, n, d, seed):
    """The worker sum over x [lead, N, d] made contiguous, as the round and
    the sweep hand it their [M, N, d] and [M, N, 1] stacks."""
    import torch
    from repro_torch.kernels.ring_sum import worker_sum, worker_sum_plain
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(lead, n, d, generator=gen, device=dev)
    name = f"worker_sum [{lead},{n},{d}]"
    before = worker_sum.launches
    out = worker_sum(x)
    torch.cuda.synchronize()
    check(worker_sum.launches == before + 1,
          "worker_sum did not count its launch")
    ref = worker_sum_plain(x)
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"{name}: differs from its plain version "
                                 f"by {err}")
    check(_same_bits(out, worker_sum(x)),
          f"{name}: a second launch gave other bits")
    # reads the N rows once and writes one sum per output; an add per term
    b_ms, b_by = bound(4 * x.numel() + 4 * out.numel(), x.numel())
    lib, lib_kernels = _library_one_kernel(lambda: torch.sum(x, dim=-2))
    return dict(shape=[lead, n, d], max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, library="torch.sum",
                library_kernels=lib_kernels,
                **timings(lambda: worker_sum(x),
                          lambda: worker_sum_plain(x)))


def _payload(dev, shape, seed):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-4, 5, shape, generator=gen, device=dev,
                      dtype=torch.int8)
    scales = torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
    return gen, q, scales


def library_ms(fn):
    """Device time of one PyTorch call computing the same function, or None
    where that call refuses the operands."""
    import torch
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as exc:
        log(f"  library call refused: {exc}")
        return None
    return device_ms(fn) or call_ms(fn)


def acc_case(dev, shape, seed):
    import torch
    from repro_torch.kernels.bucket_ring import bucket_acc, bucket_acc_plain
    gen, q, scales = _payload(dev, shape, seed)
    acc = torch.randn(shape, generator=gen, device=dev)
    before = bucket_acc.launches
    out = bucket_acc(acc, q, scales)
    torch.cuda.synchronize()
    check(bucket_acc.launches == before + 1,
          "bucket_acc did not count its launch")
    ref = bucket_acc_plain(acc, q, scales)
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"bucket_acc {list(shape)}: differs from "
                                 f"its plain version by {err}")
    times = timings(lambda: bucket_acc(acc, q, scales),
                    lambda: bucket_acc_plain(acc, q, scales))
    n_el, rows = q.numel(), q.numel() // shape[-1]
    # reads acc (4 B) and q (1 B), writes out (4 B) per element, reads one
    # 4 B scale per row; a multiply and an add per element
    b_ms, b_by = bound(9 * n_el + 4 * rows, 2 * n_el)
    lib, lib_kernels = _library_one_kernel(
        lambda: torch.addcmul(acc, q, scales))
    return dict(shape=list(shape), max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, library="torch.addcmul",
                library_kernels=lib_kernels, **times)


def hop_case(dev, shape, hop, seed):
    """One hop of the simulated ring, in place over the [W, B, R, C] stack.
    The accumulator starts as NaN, which hop 0 must not read."""
    import torch
    from repro_torch.kernels.bucket_ring import (
        bucket_acc, bucket_acc_hop_, bucket_acc_hop_plain_)
    _, q, scales = _payload(dev, shape, seed)
    acc = torch.full(shape, float("nan"), device=dev)
    ref = acc.clone()
    if hop:
        bucket_acc_hop_plain_(acc, q, scales, 0)
        ref.copy_(acc)
    before = bucket_acc.launches
    out = bucket_acc_hop_(acc, q, scales, hop)
    torch.cuda.synchronize()
    check(bucket_acc.launches == before + 1 and out is acc,
          "bucket_acc_hop_ did not count its launch or left acc")
    bucket_acc_hop_plain_(ref, q, scales, hop)
    err = float((acc - ref).abs().max())
    name = f"bucket_acc_hop_ {list(shape)} hop {hop}"
    check(torch.equal(acc, ref), f"{name}: differs from its plain version "
                                 f"by {err}")
    n_el, rows = q.numel(), q.numel() // shape[-1]
    # reads q (1 B) and, after hop 0, acc (4 B), writes acc (4 B) per
    # element, reads one 4 B scale per row; a multiply and an add per element
    b_ms, b_by = bound((9 if hop else 5) * n_el + 4 * rows, 2 * n_el)
    # the same bytes without the worker offset: one in-place addcmul_
    lib, lib_kernels = _library_one_kernel(
        lambda: ref.addcmul_(q, scales))
    return dict(shape=list(shape), hop=hop, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib,
                library="Tensor.addcmul_ (no worker offset)",
                library_kernels=lib_kernels, **timings(
                    lambda: bucket_acc_hop_(acc, q, scales, hop),
                    lambda: bucket_acc_hop_plain_(ref, q, scales, hop)))


def bsum_case(dev, shape, seed):
    import torch
    from repro_torch.kernels.bucket_ring import (
        bucket_acc, bucket_ring_sum, bucket_ring_sum_plain)
    _, q, scales = _payload(dev, shape, seed)
    before = bucket_ring_sum.launches
    out = bucket_ring_sum(q, scales)
    torch.cuda.synchronize()
    check(bucket_ring_sum.launches == before + 1,
          "bucket_ring_sum did not count its launch")
    ref = bucket_ring_sum_plain(q, scales)
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"bucket_ring_sum {list(shape)}: differs "
                                 f"from its plain version by {err}")
    check(_same_bits(out, bucket_ring_sum(q, scales)),
          f"bucket_ring_sum {list(shape)}: a second launch gave other bits")
    chain = torch.zeros(shape[1:], device=dev)
    for i in range(shape[0]):
        chain = bucket_acc(chain, q[i], scales[i])
    check(torch.equal(out, chain), f"bucket_ring_sum {list(shape)}: differs "
                                   f"from the bucket_acc hop chain")
    times = timings(lambda: bucket_ring_sum(q, scales),
                    lambda: bucket_ring_sum_plain(q, scales))
    n, n_el = shape[0], q.numel()
    out_el = n_el // n
    # reads N*B*R*C int8 levels and N*B*R scales, writes B*R*C floats; a
    # multiply and an add per level
    b_ms, b_by = bound(n_el + 4 * (n_el // shape[-1]) + 4 * out_el,
                       2 * n_el)
    return dict(shape=list(shape), max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, **times)


def mesh_kernel_phase(dev):
    acc = [acc_case(dev, sh, 20 + i) for i, sh in enumerate(ACC_CASES)]
    acc += [hop_case(dev, sh, hop, 25 + i) for i, sh in enumerate(HOP_CASES)
            for hop in (0, 1)]
    bsum = [bsum_case(dev, sh, 30 + i) for i, sh in enumerate(BSUM_CASES)]
    for name, cases in (("bucket_acc", acc), ("bucket_ring_sum", bsum)):
        for cs in cases:
            hop = f" hop {cs['hop']}" if "hop" in cs else ""
            log(f"kernel {name} {cs['shape']}{hop}: device {_us(cs['ms'])} "
                f"(plain {_us(cs['plain_ms'])}, library "
                f"{_us(cs['library_ms'])}), per call {_us(cs['call_ms'])} "
                f"(plain {_us(cs['plain_call_ms'])}), bound "
                f"{_us(cs['bound_ms'])} by {cs['bound_by']}, max_abs_err "
                f"{cs['max_abs_err']:.3g}")
    return acc, bsum


def _us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.3f} us"


def kernel_phase(dev):
    import torch
    fused = [fused_case(dev, r, d, i) for i, (r, d) in enumerate(FUSED_CASES)]
    fused += [fused_case(dev, r, d, 5 + i, torch.bfloat16)
              for i, (r, d) in enumerate(FUSED_BF16_CASES)]
    ring = [ring_case(dev, n, m, c, layout, 10 + i)
            for i, (n, m, c, layout) in enumerate(RING_CASES)]
    wsum = [wsum_case(dev, *sh, 15 + i) for i, sh in enumerate(WSUM_CASES)]
    for name, cases in (("fused_memory_update", fused), ("ring_sum", ring),
                        ("worker_sum", wsum)):
        for cs in cases:
            extra = f" {cs['layout']}" if "layout" in cs else ""
            extra += f" {cs['dtype']}" if "dtype" in cs else ""
            log(f"kernel {name} {cs['shape']}{extra}: device "
                f"{_us(cs['ms'])} (plain {_us(cs['plain_ms'])}, library "
                f"{_us(cs.get('library_ms'))}), per call "
                f"{_us(cs['call_ms'])} (plain {_us(cs['plain_call_ms'])}), "
                f"bound {_us(cs['bound_ms'])} by {cs['bound_by']}, "
                f"max_abs_err {cs['max_abs_err']:.3g}")
    return fused, ring, wsum


def expected_launches(cfgs, iters):
    """Rounds that go through the fused kernels: one launch of each kernel
    per round of every variant whose uplink codec rides them."""
    return sum(iters for c in cfgs
               if c.codecs()[0].fused_uplink == "squant_rows")


def slice_phase(dev):
    from repro_torch import experiments as ex
    from repro_torch.core import artemis as art
    from repro_torch.kernels.fused_memory import fused_memory_update
    from repro_torch.kernels.ring_sum import ring_sum
    v = art.variant_config
    runs = [
        ("exp1", ex.exp1_saturation,
         [v(x, 20, 20) for x in ("sgd", "qsgd", "diana", "biqsgd",
                                 "artemis")], 3000),
        # exp2 runs its 4 variants over a 4-gamma grid: 4 cells each
        ("exp2", ex.exp2_linear,
         [v(x, 20, 20) for x in ("sgd", "qsgd", "biqsgd", "artemis")], 600),
        ("exp3", ex.exp3_memory,
         [v(x, 2, 20) for x in ("biqsgd", "artemis")], 800),
        ("exp4", ex.exp4_pp,
         [v("artemis", 2, 20, p=0.5, pp_mode=m) for m in ("pp1", "pp2")],
         800),
    ]
    out = {}
    for name, fn, cfgs, iters in runs:
        f0, r0 = fused_memory_update.launches, ring_sum.launches
        t0 = time.perf_counter()
        res = fn(device=dev)
        secs = time.perf_counter() - t0
        want = expected_launches(cfgs, iters)
        got = (fused_memory_update.launches - f0, ring_sum.launches - r0)
        check(want > 0 and got == (want, want),
              f"{name}: kernel launches {got}, expected {want} each")
        res["seconds"] = secs
        res["launches"] = got[0]
        out[name] = res
        log(f"slice {name}: {json.dumps(res, default=float)}")

    sat = out["exp1"]["saturation"]
    check(sat["sgd"] < min(sat["qsgd"], sat["diana"])
          and max(sat["qsgd"], sat["diana"])
          < min(sat["biqsgd"], sat["artemis"]),
          f"exp1: saturation ordering sgd < one-way < two-way fails: {sat}")
    loss = out["exp2"]["loss"]
    for x in ("sgd", "qsgd", "biqsgd"):
        check(loss[x] < 1e-10, f"exp2: {x} loss {loss[x]} not below 1e-10")
    # artemis's gamma_max is ~10x below biqsgd's: in 600 rounds it shows a
    # steady linear decrease rather than reaching machine precision
    first = out["exp2"]["first_loss"]["artemis"]
    check(loss["artemis"] < first / 10,
          f"exp2: artemis loss {loss['artemis']} vs {first} at round 100")
    exc = out["exp3"]["excess"]
    check(exc["artemis"] < exc["biqsgd"],
          f"exp3: artemis excess not below biqsgd's: {exc}")
    exc = out["exp4"]["excess"]
    check(exc["pp2"] < exc["pp1"], f"exp4: pp2 excess not below pp1's: {exc}")
    log("slice: the four claims hold")
    return out


def grid_phase(dev):
    from repro_torch import experiments as ex
    from repro_torch.core import artemis as art
    from repro_torch.kernels.fused_memory import fused_memory_update
    from repro_torch.kernels.ring_sum import ring_sum
    cfgs = [art.variant_config(x, 40, 20)
            for x in ("sgd", "qsgd", "diana", "biqsgd", "artemis")]
    f0, r0 = fused_memory_update.launches, ring_sum.launches
    t0 = time.perf_counter()
    res = ex.fig4_bits(device=dev, gamma_mults=GRID_MULTS, seeds=GRID_SEEDS)
    secs = time.perf_counter() - t0
    check(res["cells"] == 640, f"grid: {res['cells']} cells, expected 640")
    check(res["finite"], "grid: non-finite losses")
    want = expected_launches(cfgs, 600)
    got = (fused_memory_update.launches - f0, ring_sum.launches - r0)
    check(got == (want, want),
          f"grid: kernel launches {got}, expected {want} each")
    res["seconds"] = secs
    log(f"grid: {json.dumps(res, default=float)}")
    return res


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` with CUDA activity only
    (tracing the host's ops would slow the host, which issues the work),
    ending in a synchronize.  Returns the host wall time and the device
    time in µs, the device-busy share (None if the trace holds no device
    op), the count of device ops, and the top 10 device kernels as
    [name, µs, launches]."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    dev_us = sum(e.time_range.elapsed_us() for e in dev_events)
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    kern.sort(key=lambda e: -e.self_device_time_total)
    top = [[e.key, e.self_device_time_total, e.count] for e in kern[:10]]
    busy = dev_us / wall_us if dev_us > 0 else None
    return wall_us, dev_us, busy, len(dev_events), top


def log_top(top):
    for key, us, count in top:
        log(f"  {key[:70]:70s} {us:10.1f} us x{count}")


def _fmt_share(busy):
    return "not measured" if busy is None else f"{busy:.4f}"


def profile_phase(dev, fault_config=None):
    """Device-busy share over 20 rounds of one variant's 128 grid cells
    (under ``fault_config``, a dict of FaultConfig fields, if given)."""
    import dataclasses
    import torch
    from repro_torch.core import artemis as art
    from repro_torch.core import faults
    from repro_torch.core import federated as fed
    from repro_torch.core import sweep as sw
    prob = fed.make_clustered_problem(5, n_workers=20, n_per=300, d=40,
                                      device=dev)
    cfg = art.variant_config("artemis", 40, 20)
    if fault_config is not None:
        cfg = dataclasses.replace(
            cfg, faults=faults.FaultConfig(**fault_config))
    gammas = [0.5 / prob.smoothness() * m for m in GRID_MULTS]
    kw = dict(batch=16, eval_every=5, backend="cuda", device=dev)
    sw.run_sweep(prob, [cfg], gammas, GRID_SEEDS, 10, **kw)   # warm-up
    torch.cuda.synchronize()
    wall_us, dev_us, busy, n_ops, top = profiled(
        lambda: sw.run_sweep(prob, [cfg], gammas, GRID_SEEDS, 20, **kw))
    label = "grid profile" + (" (faulted)" if fault_config else "")
    log(f"{label}: 20 rounds x 128 cells, wall {wall_us:.0f} us, "
        f"device busy {dev_us:.0f} us, share {_fmt_share(busy)}, "
        f"{n_ops / 20:.1f} device ops per round")
    log_top(top)
    return {"busy_share": busy, "device_ops_per_round": n_ops / 20,
            "us_per_round_cell": wall_us / (20 * 128)}


def mesh_phase(dev):
    """ToyMLP(12, 64) on W = 8 simulated workers through every variant."""
    import torch
    from repro_torch import experiments as ex
    from repro_torch.core import dist
    runs = [(v, "pipelined", {}) for v in dist.VARIANTS] + [
        ("artemis", "sequential", {}), ("artemis", "psum", {}),
        ("artemis", "pipelined", {"p_participation": 0.5}),
        ("artemis", "pipelined", {"local_steps": 2})]
    out = {}
    for variant, impl, kw in runs:
        name = "/".join([variant, impl] + [f"{k}={v}" for k, v in kw.items()])
        res = ex.toy_mesh_train(variant, impl, steps=MESH_STEPS, n_workers=W,
                                device=dev, **kw)
        first, last = res["losses"][0], res["losses"][-1]
        check(all(math.isfinite(x) for x in res["losses"]),
              f"mesh {name}: non-finite loss in {res['losses']}")
        # dore's error feedback diverges at this configuration within 20
        # steps in the reference as well (its own mesh step, 8 workers):
        # it is held to a first descent, the others to a final loss below
        # the first
        fell = (min(res["losses"]) if variant == "dore" else last) < first
        check(fell, f"mesh {name}: loss {first} -> {last} did not fall")
        compresses = dist.DistConfig(variant=variant).up_compress
        want_acc = (W * res["comm_steps"]
                    if compresses and impl == "pipelined" else 0)
        want_sum = res["comm_steps"] if compresses and impl == "psum" else 0
        got = res["launches"]
        check(got == {"bucket_acc": want_acc, "bucket_ring_sum": want_sum},
              f"mesh {name}: launches {got}, expected bucket_acc "
              f"{want_acc} and bucket_ring_sum {want_sum}")
        out[name] = res
        log(f"mesh {name}: loss {first:.6f} -> {last:.6f}, "
            f"{res['us_per_step']:.1f} us per step, {res['comm_steps']} "
            f"communicating steps, launches {got}")
    pipe, seq, psum = (out[f"artemis/{i}"]["params"]
                       for i in ("pipelined", "sequential", "psum"))
    for k, p in pipe.items():
        check(torch.equal(p, seq[k]),
              f"mesh: pipelined differs from sequential in {k}")
    drift = max(float((p - psum[k]).abs().max()) for k, p in pipe.items())
    # psum adds in another order; the downlink quantizer turns the last
    # bits into whole levels now and then, and those compound over 20
    # steps.  The reference holds the two to 1e-5 over 3 steps
    # (tests/helpers/bucket_scenarios.py::scenario_ring_matches_psum)
    short = [ex.toy_mesh_train("artemis", impl, steps=3, n_workers=W,
                               device=dev)["params"]
             for impl in ("pipelined", "psum")]
    err = max(float((p - short[1][k]).abs().max())
              for k, p in short[0].items())
    check(err <= 1e-5, f"mesh: pipelined and psum differ by {err} after "
                       f"3 steps")
    log(f"mesh: pipelined == sequential bit for bit after {MESH_STEPS} "
        f"steps; pipelined vs psum max |diff| {err:.3g} after 3 steps, "
        f"{drift:.3g} after {MESH_STEPS}")
    return {name: {k: v for k, v in res.items() if k != "params"}
            for name, res in out.items()}


def wide_phase(dev):
    """ToyMLP(12, 1024) under the default DistConfig, artemis, W = 8."""
    import torch
    from repro_torch.core import dist
    from repro_torch.kernels.bucket_ring import bucket_acc
    from repro_torch.models.toy import ToyMLP
    from repro_torch.optim import sgd
    model = ToyMLP(12, 1024).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=4 * W)
    dcfg = dist.DistConfig(variant="artemis")
    layout = dcfg.layout(list(params.values()))
    # sgd(0.01): at the mesh phase's 0.05, s = 1 on rows of 256 diverges
    # within 10 steps, in the reference's own mesh step as well
    init_state, step_fn = dist.make_train_step(model, sgd(0.01), dcfg, W,
                                               device=dev)
    state = init_state(params)
    for _ in range(2):                                  # warm-up
        state, (loss0, _) = step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    a0 = bucket_acc.launches
    losses = []

    def run():
        nonlocal state
        for _ in range(WIDE_STEPS):
            state, (loss, _) = step_fn(state, batch)
            losses.append(loss)

    wall_us, dev_us, busy, n_ops, top = profiled(run)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < float(loss0),
          f"wide: loss {float(loss0)} -> {losses} did not fall")
    launched = bucket_acc.launches - a0
    check(launched == W * WIDE_STEPS,
          f"wide: bucket_acc launched {launched}, expected {W * WIDE_STEPS}")
    n_params = sum(p.numel() for p in params.values())
    log(f"wide: ToyMLP(12, 1024), {n_params} parameters, layout "
        f"{list(layout.shape)}, {WIDE_STEPS} steps: "
        f"{wall_us / WIDE_STEPS:.1f} us per step, device busy "
        f"{dev_us / WIDE_STEPS:.1f} us per step, share {_fmt_share(busy)}, "
        f"{n_ops / WIDE_STEPS:.1f} device ops per step, loss "
        f"{float(loss0):.6f} -> {losses[-1]:.6f}, peak memory {peak} bytes")
    log_top(top)
    # torch.roll's kernel (at::native::roll_cuda_kernel), not "unrolled_..."
    rolls = [key for key, _, _ in top if re.search(r"(?<![A-Za-z])roll", key)]
    log(f"wide: roll kernels among the top device ops: {rolls or 'none'}")
    return {"us_per_step": wall_us / WIDE_STEPS, "busy_share": busy,
            "device_us_per_step": dev_us / WIDE_STEPS, "top": top,
            "layout": list(layout.shape), "launches": launched,
            "peak_bytes": peak, "top_rolls": rolls}


def _library_one_kernel(fn):
    """``library_ms(fn)`` where one PyTorch call runs as one device kernel,
    else None (it is then no one-call yardstick); and the names of the
    device kernels the calls ran."""
    _, per_call, names = device_trace(fn)
    if per_call != 1 or len(names) != 1:
        log(f"  library call ran {per_call:g} kernels per call "
            f"{names}: no one-call yardstick")
        return None, names
    return library_ms(fn), names


def _tiles(shape, block=OPS_BLOCK):
    return (shape[0] // block[0]) * (shape[1] // block[1])


def _tile_views(shape, block=OPS_BLOCK):
    """[M, N] -> [gm, bm, gn, bn] and the scales' broadcast [gm, 1, gn, 1]."""
    (m, n), (bm, bn) = shape, block
    return (m // bm, bm, n // bn, bn), (m // bm, 1, n // bn, 1)


def _dt(dtype):
    import torch
    return "bf16" if dtype == torch.bfloat16 else "f32"


def encode_case(dev, shape, xdt, udt, seed, timed=True):
    import torch
    from repro_torch.kernels.squant import squant_encode, squant_encode_plain
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev).to(xdt)
    u = torch.rand(shape, generator=gen, device=dev).to(udt)
    before = squant_encode.launches
    q, sc = squant_encode(x, u, s=OPS_S, block=OPS_BLOCK)
    torch.cuda.synchronize()
    check(squant_encode.launches == before + 1,
          "squant_encode did not count its launch")
    qp, scp = squant_encode_plain(x, u, s=OPS_S, block=OPS_BLOCK)
    diff = (q.to(torch.int32) - qp.to(torch.int32)).abs()
    mismatch = float((diff != 0).float().mean())
    name = f"squant_encode {list(shape)} x {_dt(xdt)} u {_dt(udt)}"
    check(mismatch < 1e-4 and int(diff.max()) <= 1,
          f"{name}: level mismatch {mismatch} max {diff.max()}")
    check(torch.allclose(sc, scp, rtol=1e-6, atol=0),
          f"{name}: scales differ by {float((sc - scp).abs().max())}")
    check(_same_bits((q, sc), squant_encode(x, u, s=OPS_S,
                                            block=OPS_BLOCK)),
          f"{name}: a second launch gave other bits")
    out = dict(shape=list(shape), dtype=f"{_dt(xdt)}/{_dt(udt)}",
               max_abs_err=float((sc - scp).abs().max()),
               level_mismatch=mismatch)
    if timed:
        n_el = x.numel()
        # reads x and u, writes the levels, per element; one 4 B scale per
        # tile; ~10 float ops per element (the square-sum 2, the levels 8)
        b_ms, b_by = bound((x.element_size() + u.element_size() + 1) * n_el
                           + 4 * _tiles(shape), 10 * n_el)
        out.update(bound_ms=b_ms, bound_by=b_by, library_ms=None, **timings(
            lambda: squant_encode(x, u, s=OPS_S, block=OPS_BLOCK),
            lambda: squant_encode_plain(x, u, s=OPS_S, block=OPS_BLOCK)))
    return out


def _payload2d(dev, shape, seed, block=OPS_BLOCK):
    import torch
    from repro_torch.kernels.squant import squant_encode
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev)
    u = torch.rand(shape, generator=gen, device=dev)
    w = torch.randn(shape, generator=gen, device=dev)
    q, sc = squant_encode(x, u, s=OPS_S, block=block)
    return w, q, sc


def decode_case(dev, shape, dtype, seed, block=OPS_BLOCK):
    """A block of width 16k takes the kernel's 16-element chunks; any other
    width one element a thread."""
    import torch
    from repro_torch.kernels.squant import squant_decode, squant_decode_plain
    _, q, sc = _payload2d(dev, shape, seed, block)
    before = squant_decode.launches
    out = squant_decode(q, sc, block=block, dtype=dtype)
    torch.cuda.synchronize()
    check(squant_decode.launches == before + 1,
          "squant_decode did not count its launch")
    ref = squant_decode_plain(q, sc, block=block, dtype=dtype)
    err = float((out.float() - ref.float()).abs().max())
    name = f"squant_decode {list(shape)} in {block} to {_dt(dtype)}"
    check(torch.equal(out, ref), f"{name}: differs from its plain version "
                                 f"by {err}")
    n_el = q.numel()
    # reads the levels, writes the values, per element; one 4 B scale per
    # tile; one multiply per element
    b_ms, b_by = bound((1 + out.element_size()) * n_el
                       + 4 * _tiles(shape, block), n_el)
    lib, lib_kernels = None, None
    if dtype == torch.float32:
        qv, sv = _tile_views(shape, block)
        lib, lib_kernels = _library_one_kernel(
            lambda: torch.mul(q.view(qv), sc.view(sv)))
    return dict(shape=list(shape), block=list(block), dtype=_dt(dtype),
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, library="torch.mul",
                library_kernels=lib_kernels, **timings(
                    lambda: squant_decode(q, sc, block=block, dtype=dtype),
                    lambda: squant_decode_plain(q, sc, block=block,
                                                dtype=dtype)))


def apply_case(dev, shape, dtype, seed, block=OPS_BLOCK):
    """A block of width 16k over N = 16k' takes the kernel's 16-level
    chunks; any other one element a thread."""
    import torch
    from repro_torch.kernels.squant import dequant_apply, dequant_apply_plain
    w, q, sc = _payload2d(dev, shape, seed, block)
    w = w.to(dtype)
    gamma = OPS_LR
    before = dequant_apply.launches
    out = dequant_apply(w, q, sc, gamma, block=block)
    torch.cuda.synchronize()
    check(dequant_apply.launches == before + 1,
          "dequant_apply did not count its launch")
    ref = dequant_apply_plain(w, q, sc, gamma, block=block)
    err = float((out.float() - ref.float()).abs().max())
    name = f"dequant_apply {list(shape)} in {block} {_dt(dtype)}"
    check(torch.equal(out, ref), f"{name}: differs from its plain version "
                                 f"by {err}")
    check(_same_bits(out, dequant_apply(w, q, sc, gamma, block=block)),
          f"{name}: a second launch gave other bits")
    n_el = q.numel()
    # reads w and the levels, writes w', per element; one 4 B scale per
    # tile; three float ops per element
    b_ms, b_by = bound((2 * w.element_size() + 1) * n_el
                       + 4 * _tiles(shape, block), 3 * n_el)
    lib, lib_kernels = None, None
    if dtype == torch.float32:
        qv, sv = _tile_views(shape, block)
        lib, lib_kernels = _library_one_kernel(
            lambda: torch.addcmul(w.view(qv), q.view(qv), sc.view(sv),
                                  value=-gamma))
    return dict(shape=list(shape), block=list(block), dtype=_dt(dtype),
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, library="torch.addcmul",
                library_kernels=lib_kernels, **timings(
                    lambda: dequant_apply(w, q, sc, gamma, block=block),
                    lambda: dequant_apply_plain(w, q, sc, gamma,
                                                block=block)))


def fused_tile_case(dev, shape, seed, dtype=None):
    """fused_memory_update on the compression API's (256, 256) tiles."""
    import torch
    from repro_torch.kernels.fused_memory import (
        fused_memory_update, fused_memory_update_plain)
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    g, h = (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    u = torch.rand(shape, generator=gen, device=dev).to(dtype)
    args = (g, h, u, OPS_ALPHA)
    kw = dict(s=OPS_S, block=OPS_BLOCK)
    name = (f"fused_memory_update {list(shape)} in {OPS_BLOCK} tiles "
            f"{_dt(dtype)}")
    before = fused_memory_update.launches
    out = fused_memory_update(*args, **kw)
    torch.cuda.synchronize()
    check(fused_memory_update.launches == before + 1,
          "fused_memory_update did not count its launch")
    check(_same_bits(out, fused_memory_update(*args, **kw)),
          f"{name}: a second launch gave other bits")
    err, mismatch = _fused_agrees(
        name, out, fused_memory_update_plain(*args, **kw), OPS_BLOCK)
    n_el = g.numel()
    b_ms, b_by = bound((4 * g.element_size() + 1) * n_el
                       + 4 * _tiles(shape), 15 * n_el)
    return dict(shape=list(shape), block=list(OPS_BLOCK), dtype=_dt(dtype),
                max_abs_err=err, level_mismatch=mismatch, bound_ms=b_ms,
                bound_by=b_by,
                **timings(lambda: fused_memory_update(*args, **kw),
                          lambda: fused_memory_update_plain(*args, **kw)))


def ops_kernel_phase(dev):
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    enc = [encode_case(dev, sh, f32, f32, 40 + i)
           for i, sh in enumerate(OPS_CASES + [ONE_TILE])]
    enc += [encode_case(dev, MAIN_OPS, bf16, bf16, 43),
            encode_case(dev, MAIN_OPS, f32, bf16, 44, timed=False),
            encode_case(dev, MAIN_OPS, bf16, f32, 45, timed=False)]
    dec = [decode_case(dev, sh, dt, 50 + i)
           for i, sh in enumerate(OPS_CASES) for dt in (f32, bf16)]
    # a block 8 wide: one element a thread
    dec += [decode_case(dev, MAIN_OPS, f32, 52, block=(256, 8))]
    app = [apply_case(dev, sh, dt, 60 + i)
           for i, sh in enumerate(OPS_CASES) for dt in (f32, bf16)]
    app += [apply_case(dev, APPLY_NARROW[0], f32, 62,
                       block=APPLY_NARROW[1])]
    fused = [fused_tile_case(dev, sh, 70 + i)
             for i, sh in enumerate(FUSED_TILE_CASES)]
    fused += [fused_tile_case(dev, MAIN_OPS, 73, bf16)]
    for name, cases in (("squant_encode", enc), ("squant_decode", dec),
                        ("dequant_apply", app),
                        ("fused_memory_update (256, 256)", fused)):
        for cs in cases:
            if "ms" not in cs:
                log(f"kernel {name} {cs['shape']} {cs['dtype']}: agrees "
                    f"(level mismatch {cs['level_mismatch']:.3g})")
                continue
            block = f" in {tuple(cs['block'])}" if "block" in cs else ""
            log(f"kernel {name} {cs['shape']}{block} "
                f"{cs.get('dtype', 'f32')}: "
                f"device {_us(cs['ms'])} (plain {_us(cs['plain_ms'])}, "
                f"library {_us(cs.get('library_ms'))}), per call "
                f"{_us(cs['call_ms'])} (plain {_us(cs['plain_call_ms'])}), "
                f"bound {_us(cs['bound_ms'])} by {cs['bound_by']}, "
                f"max_abs_err {cs['max_abs_err']:.3g}")
    return enc, dec, app, fused


def _leaves_ok(tree, ref, name):
    import torch
    for k, v in tree.items():
        check(v.shape == ref[k].shape and v.dtype == ref[k].dtype,
              f"ops {name}: leaf {k} is {tuple(v.shape)} {v.dtype}")
        check(bool(torch.isfinite(v).all()),
              f"ops {name}: leaf {k} is not finite")


def ops_phase(dev):
    """The compression API on ToyMLP(12, 1024): tree_compress,
    tree_memory_update twice, then compressed SGD."""
    import torch
    from repro_torch.experiments import compressed_sgd_step
    from repro_torch.kernels import ops
    from repro_torch.kernels.squant import dequant_apply, squant_encode
    from repro_torch.models.toy import ToyMLP
    model = ToyMLP(12, 1024).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=4 * W)
    n_leaves = len(params)
    grads = torch.func.grad(lambda p: model.loss(p, batch)[0])(params)
    packed = sum(ops._pack(g, OPS_BLOCK)[0].numel() for g in grads.values())
    # (a) one gradient tree through the round trip
    out = ops.tree_compress(grads, generator=gen, s=OPS_S)
    _leaves_ok(out, grads, "tree_compress")
    for k, v in out.items():
        check(bool(((torch.sign(v) == 0)
                    | (torch.sign(v) == torch.sign(grads[k]))).all()),
              f"ops tree_compress: leaf {k} flips a sign")
    # (b) the fused memory update from h = 0, then from the new h
    h = {k: torch.zeros_like(v) for k, v in grads.items()}
    for rnd in range(2):
        dh, h_new = ops.tree_memory_update(grads, h, OPS_ALPHA,
                                           generator=gen, s=OPS_S)
        _leaves_ok(h_new, grads, "tree_memory_update")
        for k in grads:
            check(torch.allclose(h_new[k], h[k] + OPS_ALPHA * dh[k],
                                 rtol=1e-5, atol=1e-6),
                  f"ops tree_memory_update {rnd}: h_new != h + alpha * "
                  f"delta_hat in {k}")
        h = h_new
    # (b') the same on the tree in bf16: h_new comes back in bf16
    g16 = {k: v.bfloat16() for k, v in grads.items()}
    h16 = {k: v.bfloat16() for k, v in h.items()}
    dh, h_new = ops.tree_memory_update(g16, h16, OPS_ALPHA, generator=gen,
                                       s=OPS_S)
    _leaves_ok(h_new, g16, "tree_memory_update bf16")
    _leaves_ok(dh, g16, "tree_memory_update bf16 delta_hat")
    # (c) compressed SGD through encode and the fused apply
    wire = sum(ops.encode(g, generator=gen, s=OPS_S)[0].wire_bytes
               for g in grads.values())

    def step():
        nonlocal params
        params, loss = compressed_sgd_step(model, params, batch, OPS_LR,
                                           s=OPS_S, generator=gen)
        return loss

    loss0 = step()
    step()                                              # warm-up
    torch.cuda.synchronize()
    e0, a0 = squant_encode.launches, dequant_apply.launches
    losses = []
    wall_us, dev_us, busy, n_ops, top = profiled(
        lambda: losses.extend(step() for _ in range(OPS_STEPS)))
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses)
          and losses[-1] < float(loss0),
          f"ops: loss {float(loss0)} -> {losses} did not fall")
    per_step = ((squant_encode.launches - e0) / OPS_STEPS,
                (dequant_apply.launches - a0) / OPS_STEPS)
    check(per_step == (n_leaves, n_leaves),
          f"ops: launches per step {per_step}, expected {n_leaves} of "
          f"squant_encode and of dequant_apply")
    log(f"ops: ToyMLP(12, 1024), {n_leaves} leaves packed into {packed} "
        f"elements, {wire} wire bytes per gradient; compressed sgd s = "
        f"{OPS_S}, lr = {OPS_LR}, {OPS_STEPS} steps: "
        f"{wall_us / OPS_STEPS:.1f} us per step, device busy "
        f"{dev_us / OPS_STEPS:.1f} us per step, share {_fmt_share(busy)}, "
        f"{n_ops / OPS_STEPS:.1f} device ops per step, loss "
        f"{float(loss0):.6f} -> {losses[-1]:.6f}, launches per step "
        f"{per_step}")
    log_top(top)
    return {"us_per_step": wall_us / OPS_STEPS, "busy_share": busy,
            "device_us_per_step": dev_us / OPS_STEPS, "top": top,
            "packed": packed, "wire_bytes": wire, "losses": losses}


def _same_values(a, b):
    """Bit for bit, NaN placement included (any NaN bits count as NaN; a
    -0.0 differs from a 0.0)."""
    import torch
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {torch.float32: torch.int32, torch.int8: torch.int8}
    return torch.equal(a.view(ints[a.dtype])[~nan],
                       b.view(ints[b.dtype])[~nan])


def fault_fused_case(dev, seed):
    """B1 on the round's rows [2560, 40] where faults reach it: NaN, +-Inf,
    -0.0, blown-up (1e15) and overflowing (3e38) rows of g, NaN in h (an
    unscrubbed run's memory).  Rows with a non-finite or zero norm must
    match the plain version bit for bit (a zero scale, zero levels, h_new
    = h + 0 with its NaNs); the others keep B1's usual bar (the norm's
    order differs); NaN placement must match everywhere."""
    import torch
    from repro_torch.kernels.fused_memory import (
        fused_memory_update, fused_memory_update_plain)
    rows, d = MAIN_FUSED
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(rows, d, generator=gen, device=dev)
    h = torch.randn(rows, d, generator=gen, device=dev)
    u = torch.rand(rows, d, generator=gen, device=dev)
    nan, inf = float("nan"), float("inf")
    g[0] = nan
    g[1, 7] = nan
    g[2, 3], g[3, 5] = inf, -inf
    g[4], h[4] = -0.0, -0.0
    g[5:40] *= 1e15
    g[40, :3] = 3e38
    h[41, 11] = nan
    h[42] = nan
    # a NaN norm with blown-up entries: safe = 1 sends r past int8, which
    # saturates as XLA converts
    g[43] *= 1e15
    h[43, 0] = nan
    out = fused_memory_update(g, h, u, 0.25, s=1, block=(1, d))
    plain = fused_memory_update_plain(g, h, u, 0.25, s=1, block=(1, d))
    torch.cuda.synchronize()
    (q, sc, hn), (qp, scp, hnp) = out, plain
    check(torch.equal(torch.isnan(hn), torch.isnan(hnp)),
          "fault B1: NaN placement of h_new differs")
    special = ~torch.isfinite((g - h).pow(2).sum(-1)) | (scp[:, 0] == 0)
    check(int(special.sum()) >= 8, "fault B1: the special rows are missing")
    check(set(q[43].unique().tolist()) <= {-128, 0, 127}
          and set(qp[43].unique().tolist()) <= {-128, 0, 127},
          "fault B1: the NaN-norm row's levels did not saturate")
    for name, a, b in (("q", q, qp), ("scales", sc, scp), ("h_new", hn, hnp)):
        check(_same_values(a[special], b[special]),
              f"fault B1: {name} differs on the non-finite or zero rows")
    finite = ~special
    err, mismatch = _fused_agrees(
        "fault B1 finite rows", (q[finite], sc[finite], hn[finite]),
        (qp[finite], scp[finite], hnp[finite]), (1, d))
    return dict(shape=[rows, d], special_rows=int(special.sum()),
                nan_h_new=int(torch.isnan(hn).sum()), max_abs_err=err,
                level_mismatch=mismatch)


def fault_ring_case(dev, seed):
    """B2 on the round's strided [20, 128, 40] view of corrupted payloads:
    levels over the whole int8 range (-128 included) and scales that are
    NaN, +-Inf, -0.0, negative or 3e38 (whose products overflow).  Bit for
    bit with the plain version, NaN placement included."""
    import torch
    from repro_torch.kernels.ring_sum import ring_sum, ring_sum_plain
    n, m, c = MAIN_RING
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-128, 128, (m, n, c), generator=gen, device=dev,
                      dtype=torch.int8)
    q[0, :, 0] = -128
    q[1, 3, :] = 0
    sc = torch.rand(m, n, 1, generator=gen, device=dev)
    sc[0, 0], sc[1, 3], sc[2, 4] = float("nan"), float("inf"), -0.0
    sc[3, 5], sc[4, 6], sc[5, :2] = -float("inf"), -2.5, 3e38
    qt, st = q.transpose(0, 1), sc.transpose(0, 1)
    out = ring_sum(qt, st)
    ref = ring_sum_plain(qt, st)
    torch.cuda.synchronize()
    check(_same_values(out, ref),
          "fault B2: differs from its plain version on corrupted payloads")
    check(bool(torch.isnan(out).any()) and bool(torch.isinf(out).any()),
          "fault B2: the corrupted cells did not reach the sum")
    return dict(shape=[n, m, c], nan_out=int(torch.isnan(out).sum()),
                inf_out=int(torch.isinf(out).sum()), max_abs_err=0.0)


def fault_kernel_phase(dev):
    fused, ring = fault_fused_case(dev, 90), fault_ring_case(dev, 91)
    log(f"fault kernels: fused_memory_update {fused['shape']}: "
        f"{fused['special_rows']} non-finite or zero rows bit for bit, "
        f"{fused['nan_h_new']} NaN in h_new in place, finite rows "
        f"level mismatch {fused['level_mismatch']:.3g}; ring_sum "
        f"{ring['shape']} strided: bit for bit with {ring['nan_out']} NaN "
        f"and {ring['inf_out']} Inf sums")
    return fused, ring


def codec_phase(dev):
    """tile_squant, sparsify and topk on the card against the same codec on
    CPU tensors, and each payload's bytes against ``wire_bytes``."""
    import torch
    from repro_torch.core import codec as wire
    names = {torch.int8: "s8", torch.int32: "s32", torch.float32: "f32"}
    out = []
    for i, (name, kw, shape) in enumerate(CODEC_CASES):
        codec = wire.make_codec(name, shape[-1], **kw)
        gen = torch.Generator().manual_seed(80 + i)
        x, u = torch.randn(shape, generator=gen), torch.rand(shape,
                                                             generator=gen)
        cpu = codec.encode(x, u)
        xd, ud = x.to(dev), u.to(dev)
        card = codec.encode(xd, ud)
        dec = codec.decode(card)
        torch.cuda.synchronize()
        label = f"codec {codec.name} {list(shape)}"
        check(card.keys() == cpu.keys(), f"{label}: leaves {card.keys()}")
        if name == "tile_squant":
            sc, scc = card["scales"].cpu(), cpu["scales"]
            check(torch.allclose(sc, scc, rtol=1e-6, atol=0),
                  f"{label}: scales differ beyond rtol 1e-6")
            same = (sc == scc).expand(card["levels"].shape)
            diff = (card["levels"].cpu().to(torch.int32)
                    - cpu["levels"].to(torch.int32)).abs()
            check(int(diff[same].sum()) == 0 and int(diff.max()) <= 1,
                  f"{label}: levels differ where the scales agree")
            mismatch = int((diff != 0).sum())
        else:
            for k in cpu.keys():
                check(torch.equal(card[k].cpu(), cpu[k]),
                      f"{label}: leaf {k} differs from the CPU's")
            check(torch.equal(dec.cpu(), codec.decode(cpu)),
                  f"{label}: decode differs from the CPU's")
            mismatch = 0
        emitted = {}
        for t in card.leaves():
            key = names[t.dtype]
            emitted[key] = emitted.get(key, 0) + t.numel() * t.element_size()
        check(emitted == codec.wire_bytes(shape),
              f"{label}: emits {emitted}, wire_bytes says "
              f"{codec.wire_bytes(shape)}")
        us = call_ms(lambda: codec.decode(codec.encode(xd, ud)), runs=5) * 1e3
        out.append(dict(codec=codec.name, shape=list(shape),
                        wire_bytes=emitted, level_mismatch=mismatch,
                        round_trip_us=us))
        log(f"{label}: agrees with the CPU (level mismatch {mismatch}), "
            f"wire bytes {emitted}, round trip {us:.1f} us per call")
    return out


def fault_phase(dev):
    """The fault model on the card: the recovery matrix, exp5 and the
    Fig. 4 grid under bit flips, scrubbing and the sentinel."""
    from repro_torch import experiments as ex
    from repro_torch.core import artemis as art
    from repro_torch.core import faults
    from repro_torch.kernels.fused_memory import fused_memory_update
    from repro_torch.kernels.ring_sum import ring_sum
    t0 = time.perf_counter()
    fm = ex.fault_matrix(device=dev)
    for name in ("identity", "scrub", "sentinel", "bitflip"):
        check(fm[name], f"fault matrix: the {name} check fails: {fm}")
    log(f"faults matrix: identity, scrub, sentinel and bitflip hold "
        f"({time.perf_counter() - t0:.1f} s): {json.dumps(fm)}")
    t0 = time.perf_counter()
    e5 = ex.exp5_faults(device=dev)
    check(e5["finite"], f"exp5: a final loss is not finite: {e5}")
    log(f"faults exp5 ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(e5, default=float)}")
    fc = faults.FaultConfig(**GRID_FAULTS)
    cfgs = [art.variant_config(x, 40, 20)
            for x in ("sgd", "qsgd", "diana", "biqsgd", "artemis")]
    f0, r0 = fused_memory_update.launches, ring_sum.launches
    t0 = time.perf_counter()
    res = ex.fig4_bits(device=dev, gamma_mults=GRID_MULTS, seeds=GRID_SEEDS,
                       fault_config=fc)
    res["seconds"] = time.perf_counter() - t0
    check(res["cells"] == 640, f"faulted grid: {res['cells']} cells")
    check(res["finite"], "faulted grid: non-finite losses")
    want = expected_launches(cfgs, 600)
    got = (fused_memory_update.launches - f0, ring_sum.launches - r0)
    check(got == (want, want), f"faulted grid: kernel launches {got}, "
                               f"expected {want} each")
    res["launches"] = got[0]
    log(f"faults grid ({GRID_FAULTS}): {json.dumps(res, default=float)}")
    return {"matrix": fm, "exp5": e5, "grid": res}


def figures_phase(dev):
    """Table 3 and Thm 3 on the card."""
    from repro_torch import experiments as ex
    t0 = time.perf_counter()
    t3 = ex.table3_gamma_max(device=dev)
    for v, r in t3["variants"].items():
        check(r["converges"], f"table3: {v} does not converge at the "
                              f"theory's gamma_max: {r}")
    t3["seconds"] = time.perf_counter() - t0
    log(f"figures table3: {json.dumps(t3, default=float)}")
    t0 = time.perf_counter()
    th = ex.thm3_variance_lower_bound(device=dev)
    sat = th["saturation"]
    check(sat[0.25] > sat[1.0], f"thm3: q = 0.25 does not saturate above "
                                f"q = 1: {sat}")
    th["seconds"] = time.perf_counter() - t0
    log(f"figures thm3: {json.dumps(th, default=float)}")
    return {"table3": t3, "thm3": th}


def resume_phase(dev):
    """A checkpointed faulted grid (the Fig. 4 problem, 640 cells), rewound
    to its first snapshot and resumed, against the uninterrupted run; and
    the time of one save of the grid's snapshot."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.core import artemis as art
    from repro_torch.core import faults
    from repro_torch.core import federated as fed
    from repro_torch.core import sweep as sw
    prob = fed.make_clustered_problem(5, n_workers=20, n_per=300, d=40,
                                      device=dev)
    fc = faults.FaultConfig(**GRID_FAULTS)
    cfgs = [dataclasses.replace(art.variant_config(x, 40, 20), faults=fc)
            for x in ("sgd", "qsgd", "diana", "biqsgd", "artemis")]
    gammas = [0.5 / prob.smoothness() * m for m in GRID_MULTS]
    ckdir = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    kw = dict(batch=16, eval_every=5, backend="cuda", device=dev,
              checkpoint_dir=ckdir, checkpoint_every=RESUME_EVERY)
    try:
        t0 = time.perf_counter()
        full = sw.run_sweep(prob, cfgs, gammas, GRID_SEEDS, RESUME_ITERS,
                            **kw)
        full_s = time.perf_counter() - t0
        half = RESUME_EVERY // 5
        with open(os.path.join(ckdir, "LATEST"), "w") as f:
            f.write(str(half))
        t0 = time.perf_counter()
        res = sw.run_sweep(prob, cfgs, gammas, GRID_SEEDS, RESUME_ITERS,
                           resume=True, **kw)
        resumed_s = time.perf_counter() - t0
        for f in ("losses", "bits", "dists", "w_final", "w_avg",
                  "w_tail_avg", "rollbacks", "gamma_scale"):
            check(np.array_equal(getattr(full, f), getattr(res, f),
                                 equal_nan=True),
                  f"resume: {f} differs from the uninterrupted run")
        # one save of the same snapshot, from the card
        step = checkpointer.latest_step(ckdir)
        with np.load(os.path.join(ckdir, f"step_{step:08d}", "arrays.npz"),
                     allow_pickle=False) as data:
            tree = {k.replace("/", "."): torch.from_numpy(data[k]).to(dev)
                    for k in data.files}
        nbytes = sum(t.numel() * t.element_size() for t in tree.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpointer.save(os.path.join(ckdir, "timed"), step, tree)
        save_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    out = {"cells": int(full.losses[..., 0].size), "iters": RESUME_ITERS,
           "every": RESUME_EVERY, "uninterrupted_s": full_s,
           "resumed_s": resumed_s, "save_ms": save_ms,
           "snapshot_bytes": nbytes,
           "rollbacks": int(full.rollbacks.sum())}
    log(f"resume: bit for bit after a resume at round {RESUME_EVERY} of "
        f"{RESUME_ITERS}; one save {save_ms:.1f} ms for {nbytes} bytes: "
        f"{json.dumps(out)}")
    return out


def kernel_line(cases, launches):
    """``cases`` and ``launches`` map each kernel's name to its kernel-phase
    cases and to its launches on its path's run."""
    def entry(name, source, replaces, main_shape):
        # the first case of the main shape: for ring_sum the round's layout
        main = next(c for c in cases[name] if c["shape"] == list(main_shape))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "ms_from": main["ms_from"], "call_ms": main["call_ms"],
                "plain_call_ms": main["plain_call_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                # None where no single PyTorch call computes the function
                "library_ms": main.get("library_ms"),
                "shape": main["shape"], "check": "pass",
                "cases": cases[name]}
    return {"kernels": [
        entry("fused_memory_update", "src/repro_torch/csrc/fused_memory.cu",
              "src/repro/kernels/fused_memory.py:46", MAIN_FUSED),
        entry("ring_sum", "src/repro_torch/csrc/ring_sum.cu",
              "src/repro/kernels/ring_sum.py:28", MAIN_RING),
        # B2's loop on float32 rows, the Artemis round's server sums and
        # the sweep's bit meter: a helper of the ring_sum kernel, not a
        # TPU kernel of its own
        entry("worker_sum", "src/repro_torch/csrc/ring_sum.cu",
              "src/repro/kernels/ring_sum.py:28", MAIN_WSUM),
        entry("bucket_acc", "src/repro_torch/csrc/bucket_ring.cu",
              "src/repro/kernels/bucket_ring.py:36", MAIN_ACC),
        # the same function as ring_sum on the view [N, B*R, C]: it
        # launches the ring_sum kernel
        entry("bucket_ring_sum", "src/repro_torch/csrc/ring_sum.cu",
              "src/repro/kernels/bucket_ring.py:92", MAIN_BSUM),
        entry("squant_encode", "src/repro_torch/csrc/squant.cu",
              "src/repro/kernels/squant.py:60", MAIN_OPS),
        entry("squant_decode", "src/repro_torch/csrc/squant.cu",
              "src/repro/kernels/squant.py:86", MAIN_OPS),
        entry("dequant_apply", "src/repro_torch/csrc/squant.cu",
              "src/repro/kernels/squant.py:104", MAIN_OPS)]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.bucket_ring import bucket_acc, bucket_ring_sum
    from repro_torch.kernels.fused_memory import fused_memory_update
    from repro_torch.kernels.ring_sum import ring_sum, worker_sum
    from repro_torch.kernels.squant import (
        dequant_apply, squant_decode, squant_encode)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_identity()
    build_phase()
    fused, ring, wsum = kernel_phase(dev)
    fault_fused, fault_ring = fault_kernel_phase(dev)
    acc, bsum = mesh_kernel_phase(dev)
    codec_phase(dev)
    reset_launches()                    # the simulator's path starts here
    slice_res = slice_phase(dev)
    grid_res = grid_phase(dev)
    sim = {"fused_memory_update": fused_memory_update.launches,
           "ring_sum": ring_sum.launches, "worker_sum": worker_sum.launches}
    profile_clean = profile_phase(dev)
    reset_launches()                    # the fault path starts here
    t_fault = time.perf_counter()
    fault_res = fault_phase(dev)
    figures_phase(dev)
    resume_res = resume_phase(dev)
    flt = {"fused_memory_update": fused_memory_update.launches,
           "ring_sum": ring_sum.launches, "worker_sum": worker_sum.launches}
    log(f"fault path launches: {json.dumps(flt)}")
    check(min(flt.values()) > 0, f"the fault path launched a kernel 0 "
                                 f"times: {flt}")
    profile_fault = profile_phase(dev, GRID_FAULTS)
    fault_secs = time.perf_counter() - t_fault
    launches = {k: sim[k] + flt[k] for k in sim}
    by_path = {k: {"simulator": sim[k], "faults": flt[k]} for k in sim}
    reset_launches()                    # the mesh's path starts here
    t_mesh = time.perf_counter()
    mesh_res = mesh_phase(dev)
    wide_res = wide_phase(dev)
    launches.update(bucket_acc=bucket_acc.launches,
                    bucket_ring_sum=bucket_ring_sum.launches)
    mesh_secs = time.perf_counter() - t_mesh
    t_ops = time.perf_counter()
    enc, dec, app, fused_tiles = ops_kernel_phase(dev)
    reset_launches()                    # the compression API's path
    ops_res = ops_phase(dev)
    launches.update(squant_encode=squant_encode.launches,
                    squant_decode=squant_decode.launches,
                    dequant_apply=dequant_apply.launches)
    log(f"ops path launches: {launches['squant_encode']} squant_encode, "
        f"{launches['squant_decode']} squant_decode, "
        f"{launches['dequant_apply']} dequant_apply, "
        f"{fused_memory_update.launches} fused_memory_update")
    ops_secs = time.perf_counter() - t_ops
    check(min(launches.values()) > 0,
          f"a path launched a kernel 0 times: {launches}")
    for name in ("exp1", "exp2", "exp3", "exp4"):
        log(f"us per round per cell, {name}: "
            f"{slice_res[name]['us_per_round_cell']:.2f}")
    log(f"us per round per cell, grid (640 cells): "
        f"{grid_res['us_per_round_cell']:.3f}; faulted grid "
        f"{fault_res['grid']['us_per_round_cell']:.3f}")
    log(f"device ops per round, grid profile: "
        f"{profile_clean['device_ops_per_round']:.1f}; faulted "
        f"{profile_fault['device_ops_per_round']:.1f}; busy share "
        f"{_fmt_share(profile_clean['busy_share'])} and "
        f"{_fmt_share(profile_fault['busy_share'])}")
    log(f"exp5 final losses {fault_res['exp5']['final_loss']}, rollbacks "
        f"{fault_res['exp5']['rollbacks']}; one grid save "
        f"{resume_res['save_ms']:.1f} ms")
    for name, res in mesh_res.items():
        log(f"us per step, mesh {name}: {res['us_per_step']:.1f}")
    log(f"us per step, wide artemis: {wide_res['us_per_step']:.1f} "
        f"(busy share {wide_res['busy_share']})")
    log(f"us per step, ops compressed sgd: {ops_res['us_per_step']:.1f} "
        f"(busy share {ops_res['busy_share']})")
    log(f"fault phases {fault_secs:.1f} s; mesh phases {mesh_secs:.1f} s; "
        f"ops phases {ops_secs:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    line = kernel_line(
        {"fused_memory_update": fused + fused_tiles, "ring_sum": ring,
         "worker_sum": wsum,
         "bucket_acc": acc, "bucket_ring_sum": bsum, "squant_encode": enc,
         "squant_decode": dec, "dequant_apply": app}, launches)
    for entry in line["kernels"]:
        if entry["name"] in by_path:
            entry["launches_by_path"] = by_path[entry["name"]]
        entry["fault_cases"] = {"fused_memory_update": [fault_fused],
                                "ring_sum": [fault_ring]}.get(
                                    entry["name"], [])
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
