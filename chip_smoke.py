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
   and wide stacks and at the LM paths' own (lm-100m's [8, 16, 28421,
   256], timed; each reduced arch's W = 2 stack the train CLI builds),
   hops 0 and 1, and bucket_ring_sum at reduced starcoder2's W = 2 stack,
   all bit for bit; then the fused attention (``kernels/attention.py``)
   at the cells' shapes, forward and backward, against its plain version
   on one batch row and KV group, two backwards for the same bits, device
   times beside the FLOP bound, the eager route and SDPA (a yardstick);
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
15. resume: the faulted grid at 4 seeds (160 cells, 100 rounds)
   checkpointed every 50 rounds, rewound to its first snapshot and resumed, bit for bit with
   the uninterrupted run; the time of one save of its snapshot; then the
   profile of phase 6 again under ``GRID_FAULTS``.

16. fault ring kernels (after the mesh kernels): bucket_acc (out of place
   and every in-place hop) and bucket_ring_sum on corrupted payloads of
   the mesh stack [8, 16, 49, 64] (flipped bits, NaN, +-Inf, 0.0, -0.0 and
   negative scales), scrubbed and not, and bucket_acc_hop_ hops 0..W-1 on
   the leaf wire's stacks [8, 1024, 1024], [8, 1, 1024] and [8, 1024, 1],
   bit for bit with NaN placement;
17. telemetry grid (after phase 6): the 640-cell grid of phase 5 with the
   sweep's telemetry, bit for bit with phase 5 in losses, distances and
   bits, its µs per round per cell beside phase 5's, and the profile of
   phase 6 with telemetry (the device ops a round it adds);
18. mesh leaf (after phase 8): the mesh phase's configuration on the leaf
   wire, every variant, 20 steps: the loss falls (dore first descends)
   and bucket_acc launches W times a leaf a communicating step;
19. wide leaf: ToyMLP(12, 1024) (25 leaves) on the default leaf wire,
   profiled as phase 8, and its telemetry's wire bytes a worker against
   ``launch/roofline.py::leaf_wire_model`` exactly;
20. mesh faults: the reference's fault matrix (bit flips, NaN blowups,
   stragglers over a Markov chain, each with scrubbing) on both wires at
   the mesh configuration, p = 0.5, 20 steps, and the bit-flip cell on the
   bucketed psum (bucket_ring_sum under faults): losses and parameters
   finite, the telemetry's counts non-zero and within their bounds where
   the config makes them so, and FaultConfig() bit for bit with no config
   on both wires;
21. wide faulted: the wide bucketed step under bit flips and scrubbing,
   beside phase 8's clean step;
22. pg ring: whether gloo's send and receive move a CUDA tensor (two
   ranks, ``_gloo_cuda_probe``), then W = 4 ranks of ``core/dist_pg.py`` on the card (gloo,
   payloads staged through pinned host memory), ToyMLP(12, 1024), 3
   steps of each reduce_impl: rank 0 against the simulated axis over the
   same draws and the ranks' own gradients (pipelined and sequential bit
   for bit, psum to 1e-5), the bytes a rank sends against (W - 1) times
   the codec's wire bytes, µs per step;
23. obs smoke: ``python -m repro_torch.obs smoke`` on the card into
   ``build/chip_smoke_obs``, ``validate`` on its events, the directory
   removed;
24. lm reduced: every architecture's REDUCED config (all ten) on the card
   against the same model on the CPU (same parameters and tokens): the
   loss within 2e-3 and 8 decode steps' logits within 0.06; then 3 steps of ``launch.train.main``
   (artemis, W = 2) for each arch of the families the train CLI can
   train (dense, moe, ssm, hybrid), losses finite, and 3 steps of reduced
   starcoder2 through ``make_train_step`` with ``reduce_impl="psum"``;
   bucket_acc must launch W times a communicating step of the CLI's runs,
   bucket_ring_sum once a psum step;
25. lm serve: starcoder2-7b and olmoe-1b-7b at their published configs
   (random weights from a seed, f32 parameters, bf16 compute), one after
   the other, through ``launch.serve.generate`` at the CLI's defaults
   (batch 4, prompt 32, 32 new tokens): tok/s, ms per decode step, peak
   device memory, a profiled window of 4 decode steps, every token in the
   vocabulary, and the decode chain's last logits against
   ``prefill_logits`` over the same 64 tokens (the MoE at a dropless
   capacity, as the reference's ``test_decode_matches_prefill`` takes it)
   in bf16; for olmoe, whose bf16 routing flips, at f32 compute, and in
   bf16 with the decode's experts pinned to prefill's
   (``_moe_decode_checks``), and its bf16 flips counted again with
   cuBLAS's bf16 reduction of partial sums forbidden
   (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
   True by default: ROADMAP §C, C5);
26. lm train: ``lm-100m`` (examples/train_lm.py --full-100m, 116.4 M
   parameters) over the default bucketed ``DistConfig``, artemis, s = 1,
   adam(3e-3), W = 8, batch 16, seq 256: 2 warm-up steps, then
   ``LM_TRAIN_STEPS`` under ``torch.profiler``: µs per step, the
   device-busy share, device ops per step, peak memory, the wire bytes a
   worker a step (``launch/roofline.py::bucketed_wire_model``), exactly W
   bucket_acc launches a step, its stack the one phase 3 held to the
   plain hop; the loss must fall, by more than 0.5 nats (the example's
   check);
27. dry run: ``launch/dryrun.py`` on fake tensors for lm-100m's train step
   (phase 26's W, batch and optimizer) and starcoder2-7b's decode step
   against phase 25's 64-token cache, without device memory; each peak
   estimate beside phase 25's and 26's measured peak; then the multi-pod
   row (``MULTIPOD_ROW``: starcoder2-7b train_4k with artemis, one of 512
   ranks of a fake process group), run in a process of its own started
   after the build, beside the card's phases: one rank's bytes, FLOPs and
   collective bytes by mesh axis, the process never touching the card;
   its attention block a rank (``MULTIPOD_BLOCKS``: 9 heads on 32 lanes)
   and its FLOPs under ``MULTIPOD_REPLICATED_FLOPS``;
28. bench: ``python -m repro_torch.bench --fast`` in a subprocess on the
   card (every suite: the paper's figures, the kernels, the sweep engine
   and the mesh wire, the fault defenses), exit 0, every kernel row
   (``kernel/b1`` to ``b7`` and ``worker_sum``) with its device µs read
   from the CUDA trace;
29. analysis: ``python -m repro_torch.analysis --ci`` in a subprocess on
   the card (the lint, the launch audit, the wire checks and host-sync),
   exit 0, its host-sync findings listed (each in the port's baseline);
30. lm remat (after phase 26): phase 26's run with ``remat=True`` (the
   example sets False): µs per step, peak memory and the dry run's
   estimate of it beside phase 26's, the losses within 0.05 of phase
   26's, W bucket_acc launches a step; then one full-width
   falcon-mamba-7b layer (depth cut to 1) at batch 1 x 2048, its plain
   sgd step with remat off and on: ms per step, peak memory, the dry run's
   estimate (ROADMAP §B note 7);
31. pg train (after phase 30): ``launch.train.main --ranks 4`` on
   lm-100m at full width (4 gloo ranks on the card, the parent's cached
   device memory freed first), 3 steps with local_steps = 2: the losses
   finite and falling, and bucket_acc launched W times a rank a
   communicating step (the ranks' counts, summed in the event log's
   ``run_end``);
32. mesh train (after phase 31): which of the collectives a DTensor mesh
   issues (``MESH_PROBE_OPS``, in their functional form, and the c10d
   forms) gloo runs on CUDA tensors, each on 2 ranks of its own, recorded
   (ROADMAP C6: the CLI's mesh takes nccl on CUDA).  Then
   ``launch.train.main --mesh 1x1`` (nccl, one card a rank) on lm-100m
   at full width, artemis, batch 16 x 256, 3 steps: losses finite,
   falling, within rtol 1e-4 of ``--workers 1``'s in this process (the
   same worker unsharded, on the mesh's eager attention) and within rtol
   1e-3 of ``--ranks 1``'s (the shipped unsharded route, on the fused
   attention: another rounding of the scores), bucket_acc launched ranks
   x W a step and the fused attention 0 times (the ranks' counts), its
   bucketed layout the stack held to the plain bucket_acc, and the steady
   step time and largest peak on a rank of the mesh and ``--ranks 1``.

The simulator's path (phases 4 and 5), the fault path (phases 13 to 15),
the telemetry grid (17), the mesh's (phases 7 and 8), the leaf wire's
(18, 19), the mesh's fault path (20, 21) and the compression API's (phase
10) and the LM paths (24 to 26, 30) are each driven with every launch count
set to 0 just before and read just after; the ranks of the pg ring, pg
train and mesh train (22, 31, 32) count their own.  The kernels line adds the simulator's, the fault path's and the
telemetry grid's launches of B1, B2 and the worker sum, and every mesh
and LM path's of B3 and B4.

Phases 28 and 29 run after the launch counts are read and count nothing
for the kernels line (their own processes).

It prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
It imports nothing of JAX or of the JAX package.
"""
import contextlib
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
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores

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
# the leaf wire's stacks of ToyMLP(12, 1024) at W = 8: a weight, a bias (one
# row) and the head (rows of one element)
LEAF_STACKS = [(W, 1024, 1024), (W, 1, 1024), (W, 1024, 1)]

# compression-API shapes: ops._pack lays a ToyMLP(12, 1024) weight
# (1024 x 1024) out as [4096, 256] in (256, 256) tiles (the main shape);
# the probe holds 67.1 M elements
OPS_BLOCK = (256, 256)
OPS_CASES = [(4096, 256), (16384, 4096)]
MAIN_OPS = OPS_CASES[0]
# the fused attention's main case: starcoder2-7b's causal GQA, forward
MAIN_ATTENTION = [4, 4096, 4096, 36, 4, 128, True, "forward"]
# B1 and the encode on the API's tiles also at one tile, as a one-tile leaf
# (a bias) has it
ONE_TILE = (256, 256)
FUSED_TILE_CASES = [ONE_TILE] + OPS_CASES
# dequant_apply where N is not a multiple of 16: one element a thread
APPLY_NARROW = ((4096, 248), (256, 8))
OPS_STEPS, OPS_S, OPS_LR, OPS_ALPHA = 10, 1, 0.01, 0.5

# the fault path: the Fig. 4 grid again, every variant under bit flips,
# scrubbing and the sentinel; the resume phase's checkpointed faulted grid
# (100 rounds, a snapshot every 50)
GRID_FAULTS = dict(bitflip_rate=0.01, scrub=True, sentinel=1e6)
RESUME_ITERS, RESUME_EVERY = 100, 50
# the resume phase's grid at 4 of the 16 seeds (160 cells; 8 in PR 18),
# to make room for the LM phases
RESUME_SEEDS = GRID_SEEDS[:4]
# the codecs phase: (codec, kwargs, shape) on the card against the CPU;
# [128, 20, 40] is a grid variant's uplink, [20, 5000] a longer message
CODEC_CASES = [("tile_squant", {"s": 1, "tile": 1024}, (20, 5000)),
               ("tile_squant", {"s": 1, "tile": 32}, (20, 5000)),
               ("tile_squant", {"s": 1, "tile": 32}, (B, N, 40)),
               ("sparsify", {"q": 0.25}, (B, N, 40)),
               ("sparsify", {"q": 0.5}, (20, 5000)),
               ("topk", {"frac": 0.1}, (B, N, 40)),
               ("topk", {"frac": 0.1}, (20, 5000))]


# the LM stack: every arch's REDUCED config on the card against the CPU
# (batch 2, 64 tokens, 8 decode steps), the train CLI (the families whose
# batches carry tokens only) at W = 2, 3 steps of batch 4, seq 64
LM_B, LM_S, LM_T = 2, 64, 8
LM_CLI_FAMILIES = ("dense", "moe", "ssm", "hybrid")
LM_CLI_W, LM_CLI_STEPS = 2, 3
# full width: served at the serve CLI's defaults; lm-100m trained at
# examples/train_lm.py's settings
LM_SERVE_ARCHS = ("starcoder2-7b", "olmoe-1b-7b")
LM_SERVE_B, LM_SERVE_PROMPT, LM_SERVE_GEN = 4, 32, 32
LM_TRAIN_W, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 16, 256
LM_TRAIN_STEPS = 10
# one full-width falcon-mamba-7b layer with remat on and off (ROADMAP §B
# note 7): a batch whose step fits without remat
REMAT_FALCON_B, REMAT_FALCON_SEQ = 1, 2048
# the train CLI over ranks: lm-100m, W = 4 gloo ranks on the card
PG_TRAIN_RANKS, PG_TRAIN_STEPS, PG_TRAIN_LOCAL = 4, 3, 2
# the sharded mesh (A14): lm-100m on --mesh 2x2 (4 gloo ranks, W = 2
# workers of 2 model ranks) where gloo runs the mesh's collectives on CUDA
# tensors, else --mesh 1x1 over nccl; against --ranks W and --workers W,
# the same workers unsharded; the collectives DTensor issues there,
# probed one launch each
MESH_TRAIN_STEPS = 3
MESH_PROBE_OPS = ("all_gather_into_tensor", "reduce_scatter_tensor",
                  "all_reduce")
# the multi-pod dry run's row (A15), at full width, in a process of its own
MULTIPOD_ROW = ("starcoder2-7b", "train_4k", "multipod", "artemis")
# its attention block a model rank, (query heads, KV heads, head-dim lanes):
# 36 heads over 16 as the reference's compiled program splits them
# (layers.head_partition), and the row's FLOPs with every model rank on all
# 36 heads, which that split must undercut
MULTIPOD_BLOCKS = [[9, 1, 32]]
MULTIPOD_REPLICATED_FLOPS = 1.448e15


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
    profiler's CUDA trace records them (``repro_torch.bench.device_trace``,
    which pads the calls with spin kernels and retries an empty trace):
    (summed duration in ms per call, kernels per call, kernel names), or
    (None, 0, []) if the trace holds no kernel."""
    from repro_torch.bench import device_trace as trace
    us, per_call, names = trace(fn, calls, pad)
    return (None if us is None else us / 1e3), per_call, names


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


def acc_case(dev, shape, seed, timed=True):
    """B3 out of place over [rows, C].  Untimed, it only holds the kernel
    to its plain version."""
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
    if not timed:
        return dict(shape=list(shape), max_abs_err=err)
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


def hop_case(dev, shape, hop, seed, timed=True):
    """One hop of the simulated ring, in place over the [W, B, R, C] stack.
    The accumulator starts as NaN, which hop 0 must not read.  Untimed, it
    only holds the kernel to its plain version."""
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
    if not timed:
        return dict(shape=list(shape), hop=hop, max_abs_err=err)
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


def bsum_case(dev, shape, seed, timed=True):
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
    if not timed:
        return dict(shape=list(shape), max_abs_err=err)
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


def mesh_kernel_phase(dev, lm_stacks):
    """B3 and B4 on the mesh's shapes and on the LM paths' stacks
    (``lm_ring_stacks``): lm-100m's timed, the reduced archs' checked, and
    B3 out of place at lm-100m's [B * R, C], as each rank of the pg train
    phase folds its ring (``ProcessRing._ring``)."""
    acc = [acc_case(dev, sh, 20 + i) for i, sh in enumerate(ACC_CASES)]
    b, r, c = lm_stacks["train"][1:]
    acc.append(acc_case(dev, (b * r, c), 29, timed=False))
    acc += [hop_case(dev, sh, hop, 25 + i) for i, sh in enumerate(HOP_CASES)
            for hop in (0, 1)]
    acc += [hop_case(dev, lm_stacks["train"], hop, 28) for hop in (0, 1)]
    acc += [hop_case(dev, sh, hop, 40 + i, timed=False)
            for i, sh in enumerate(sorted(set(lm_stacks["cli"].values())))
            for hop in (0, 1)]
    bsum = [bsum_case(dev, sh, 30 + i) for i, sh in enumerate(BSUM_CASES)]
    bsum.append(bsum_case(dev, lm_stacks["psum"], 32, timed=False))
    for name, cases in (("bucket_acc", acc), ("bucket_ring_sum", bsum)):
        for cs in cases:
            hop = f" hop {cs['hop']}" if "hop" in cs else ""
            if "ms" not in cs:
                log(f"kernel {name} {cs['shape']}{hop}: equal to its plain "
                    f"version (an LM path's stack, not timed)")
                continue
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


def attention_case(dev, label, shape, seed):
    """The fused attention's forward and backward at one of the cells'
    shapes: against its plain version on one batch row and KV group
    (within 1e-2 of the largest entry: bf16 outputs, P and dS rounded to
    bf16 for their products), a second backward for the same bits, device
    times against the FLOP bound, the eager route (``layers.attention`` in
    chunks of 512) as ``plain_ms`` and torch's SDPA as ``library_ms`` (a
    yardstick: the port never calls it)."""
    import torch
    from repro_torch.bench.kernel_bench import (
        _attention_operands, attention_calls, attention_plain_error)
    from repro_torch.kernels import attention as FA
    args, do, flops = _attention_operands(dev, shape, seed)
    o, lse = FA._forward(*args)
    grads = FA._backward(do, *args[:5], o, lse, *args[5:])
    again = FA._backward(do, *args[:5], o, lse, *args[5:])
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"attention {label}: two backwards differ")
    del o, lse, grads, again
    err = attention_plain_error(args, do)
    check(err <= 1e-2, f"attention {label}: the kernel differs from its "
                       f"plain version by {err:.3g} of the largest entry")
    calls = attention_calls(args, do)
    out = {"label": label, "shape": list(shape), "max_abs_err": err}
    for part, ops_ in (("forward", flops), ("backward", 2.5 * flops)):
        t = {}
        for who, key in (("kernel", "ms"), ("eager", "plain_ms")):
            setup, fn = calls[part][who]
            setup()
            t[key] = device_ms(fn, calls=10 if who == "kernel" else 3)
            t["call_ms" if who == "kernel" else "plain_call_ms"] = call_ms(
                fn, runs=5 if who == "kernel" else 3,
                per_run=2 if who == "kernel" else 1)
        setup, fn = calls[part]["library"]
        setup()
        out[part] = dict(t, ms_from="profiler", library_ms=library_ms(fn),
                         bound_ms=ops_ / BF16_FLOPS_PER_S * 1e3,
                         bound_by="operations")
    calls.clear()
    return out


def attention_kernel_phase(dev):
    """The fused attention at the cells' shapes (whisper-tiny's encoder,
    decoder and cross attention at 40 rows, starcoder2-7b's causal GQA at
    4 x 4096); one case a part for the kernel table."""
    from repro_torch.bench.kernel_bench import ATTENTION
    cases = []
    for i, (label, shape) in enumerate(ATTENTION.items()):
        cs = attention_case(dev, label, shape, 30 + i)
        for part in ("forward", "backward"):
            t = cs[part]
            log(f"kernel flash_attention {part} {label} {cs['shape']}: "
                f"device {_us(t['ms'])} (eager {_us(t['plain_ms'])}, "
                f"library {_us(t['library_ms'])}), bound "
                f"{_us(t['bound_ms'])} by operations at 989 TFLOP/s, share "
                f"{100 * t['bound_ms'] / t['ms'] if t['ms'] else 0:.1f} %, "
                f"max rel err {cs['max_abs_err']:.3g}")
            cases.append(dict(t, shape=cs["shape"] + [part],
                              max_abs_err=cs["max_abs_err"]))
    return cases


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
    sweep = res.pop("sweep")
    log(f"grid: {json.dumps(res, default=float)}")
    res["sweep"] = sweep
    return res


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` with CUDA activity only
    (tracing the host's ops would slow the host, which issues the work),
    ending in a synchronize.  Returns the host wall time and the device
    time in µs, the device-busy share (None if the trace holds no device
    op), the count of device ops, and the top 10 device kernels as
    [name, µs, launches]."""
    import torch
    from repro_torch.obs import spans
    # no_phases: the step as it runs untraced, without the phases' markers
    with spans.no_phases(), torch.profiler.profile(
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


def profile_phase(dev, fault_config=None, telemetry=False):
    """Device-busy share over 20 rounds of one variant's 128 grid cells
    (under ``fault_config``, a dict of FaultConfig fields, if given; with
    the sweep's telemetry when ``telemetry``)."""
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
    kw = dict(batch=16, eval_every=5, backend="cuda", device=dev,
              telemetry=telemetry)
    sw.run_sweep(prob, [cfg], gammas, GRID_SEEDS, 10, **kw)   # warm-up
    torch.cuda.synchronize()
    wall_us, dev_us, busy, n_ops, top = profiled(
        lambda: sw.run_sweep(prob, [cfg], gammas, GRID_SEEDS, 20, **kw))
    label = "grid profile" + (" (faulted)" if fault_config else "") + (
        " (telemetry)" if telemetry else "")
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
            "device_us_per_step": dev_us / WIDE_STEPS,
            "device_ops_per_step": n_ops / WIDE_STEPS, "top": top,
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
    res.pop("sweep")
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
    """A checkpointed faulted grid (the Fig. 4 problem, 320 cells), rewound
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
        full = sw.run_sweep(prob, cfgs, gammas, RESUME_SEEDS, RESUME_ITERS,
                            **kw)
        full_s = time.perf_counter() - t0
        half = RESUME_EVERY // 5
        with open(os.path.join(ckdir, "LATEST"), "w") as f:
            f.write(str(half))
        t0 = time.perf_counter()
        res = sw.run_sweep(prob, cfgs, gammas, RESUME_SEEDS, RESUME_ITERS,
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


# ---------------------------------------------------------------------------
# the mesh wire's second half: the leaf wire, faults, telemetry, the
# process-group ring, and the obs package
# ---------------------------------------------------------------------------

def _corrupt_stack(dev, shape, seed, scrub):
    """A [W, ..., R, C] row-scale payload as the faulted wire hands it to
    the ring: levels with flipped bits over the whole int8 range, scales
    that are NaN, +-Inf, 0.0, -0.0 or negative; with ``scrub`` after the
    server's checksum (``dist.message_valid``, ``faults.scrub_payload``:
    finite scales, a failed bucket's zeroed)."""
    import torch
    from repro_torch.core import codec as wire
    from repro_torch.core import dist
    from repro_torch.core import faults
    gen, q, scales = _payload(dev, shape, seed)
    meta = wire.PayloadMeta("row_squant", tuple(shape), "torch.float32",
                            (("s", 3),))
    p = wire.WirePayload({"levels": q, "scales": scales}, meta)
    draws = [(torch.randint(0, bits, t.shape, generator=gen, device=dev,
                            dtype=torch.int32),
              torch.rand(t.shape, generator=gen, device=dev))
             for t, bits in ((q, 8), (scales, 32))]
    p = faults.corrupt_payload(draws, p, 5e-4)
    sc = p["scales"].clone()
    flat = sc.view(-1)
    flat[0], flat[1], flat[2] = float("nan"), float("inf"), -float("inf")
    flat[3], flat[4], flat[5] = 0.0, -0.0, -2.5
    p = p.replace(scales=sc)
    if scrub:
        codec = wire.make_codec("row_squant", shape[-1], s=3)
        valid = dist.message_valid(codec, p, 2)
        p = faults.scrub_payload(p, valid)
    return p["levels"].contiguous(), p["scales"].contiguous()


def fault_ring_kernel_phase(dev):
    """B3 (out of place and the ring's in-place hop) and B4 on corrupted
    payloads of the mesh stack [8, 16, 49, 64], scrubbed and not, and B3's
    hops 0..W-1 on the leaf wire's stacks [8, 1024, 1024] (a weight),
    [8, 1, 1024] (a bias, one row) and [8, 1024, 1] (the head: rows of one,
    the one-element path).  Bit for bit with the plain versions, NaN
    placement included."""
    import torch
    from repro_torch.kernels.bucket_ring import (
        bucket_acc, bucket_acc_hop_, bucket_acc_hop_plain_, bucket_acc_plain,
        bucket_ring_sum, bucket_ring_sum_plain)
    out = {"bucket_acc": [], "bucket_ring_sum": []}
    shape = BSUM_CASES[0]
    for i, scrub in enumerate((False, True)):
        q, sc = _corrupt_stack(dev, shape, 70 + i, scrub)
        tag = "scrubbed" if scrub else "unscrubbed"
        acc = torch.randn(q.shape, generator=torch.Generator(
            device=dev).manual_seed(i), device=dev)
        flat = (q.flatten(0, 1), sc.flatten(0, 1), acc.flatten(0, 1))
        got = bucket_acc(flat[2], flat[0], flat[1])
        ref = bucket_acc_plain(flat[2], flat[0], flat[1])
        torch.cuda.synchronize()
        check(_same_values(got, ref), f"fault B3 {tag}: out of place differs")
        a, r = torch.full(q.shape, float("nan"), device=dev), acc.clone()
        for hop in range(shape[0]):
            bucket_acc_hop_(a, q, sc, hop)
            bucket_acc_hop_plain_(r, q, sc, hop)
            torch.cuda.synchronize()
            check(_same_values(a, r), f"fault B3 {tag}: hop {hop} differs")
        s_got, s_ref = bucket_ring_sum(q, sc), bucket_ring_sum_plain(q, sc)
        torch.cuda.synchronize()
        check(_same_values(s_got, s_ref), f"fault B4 {tag}: differs")
        # the scrubbed scales are finite; the unscrubbed NaN reaches the sum
        check(bool(torch.isfinite(sc).all()) if scrub
              else bool(torch.isnan(s_got).any()),
              f"fault B4 {tag}: the corrupt payload is not as built")
        case = dict(shape=list(shape), payload=tag, hops=shape[0],
                    nan_out=int(torch.isnan(a).sum()), max_abs_err=0.0)
        out["bucket_acc"].append(case)
        out["bucket_ring_sum"].append(dict(case, nan_out=int(
            torch.isnan(s_got).sum())))
    for j, leaf in enumerate(LEAF_STACKS):
        gen, q, sc = _payload(dev, leaf, 75 + j)
        a = torch.full(leaf, float("nan"), device=dev)
        r = torch.full(leaf, float("nan"), device=dev)
        for hop in range(leaf[0]):
            bucket_acc_hop_(a, q, sc, hop)
            bucket_acc_hop_plain_(r, q, sc, hop)
        torch.cuda.synchronize()
        check(_same_values(a, r), f"leaf B3 {list(leaf)}: the hop chain "
                                  f"differs from its plain version")
        out["bucket_acc"].append(dict(shape=list(leaf), payload="leaf stack",
                                      hops=leaf[0], max_abs_err=0.0))
    log(f"fault ring kernels: bucket_acc (both entry points) and "
        f"bucket_ring_sum bit for bit on {shape} corrupted payloads, "
        f"scrubbed and not, and bucket_acc_hop_ hops 0..{W - 1} on the leaf "
        f"stacks {[list(x) for x in LEAF_STACKS]}")
    return out


def _mesh_obs(res):
    """Per-step telemetry of a toy_mesh_train run as floats."""
    return [{k: float(v) for k, v in o.items()} for o in res["obs"]]


def leaf_mesh_phase(dev):
    """The leaf wire at the mesh phase's configuration: every variant, 20
    steps; the loss falls (dore: first descends) and bucket_acc launches W
    times a leaf a communicating step for every compressing variant."""
    from repro_torch import experiments as ex
    from repro_torch.core import dist
    out = {}
    n_leaves = 2 * 12 + 1
    for variant in dist.VARIANTS:
        res = ex.toy_mesh_train(variant, "pipelined", steps=MESH_STEPS,
                                n_workers=W, wire="leaf", device=dev)
        first, last = res["losses"][0], res["losses"][-1]
        check(all(math.isfinite(x) for x in res["losses"]),
              f"mesh leaf {variant}: non-finite loss in {res['losses']}")
        fell = (min(res["losses"]) if variant == "dore" else last) < first
        check(fell, f"mesh leaf {variant}: loss {first} -> {last} did not "
                    f"fall")
        compresses = dist.DistConfig(variant=variant).up_compress
        want = W * n_leaves * res["comm_steps"] if compresses else 0
        got = res["launches"]
        check(got == {"bucket_acc": want, "bucket_ring_sum": 0},
              f"mesh leaf {variant}: launches {got}, expected bucket_acc "
              f"{want}")
        out[variant] = {k: v for k, v in res.items()
                        if k not in ("params", "obs")}
        log(f"mesh leaf {variant}: loss {first:.6f} -> {last:.6f}, "
            f"{res['us_per_step']:.1f} us per step, launches {got}")
    return out


def _wide_model(dev):
    import torch
    from repro_torch.models.toy import ToyMLP
    model = ToyMLP(12, 1024).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    return model, params, model.batch(gen, n=4 * W)


def _wide_run(dev, dcfg, label):
    """2 warm-up and WIDE_STEPS timed steps of ToyMLP(12, 1024) under
    ``dcfg``, artemis, sgd(0.01), W = 8, under the profiler."""
    import torch
    from repro_torch.core import dist
    from repro_torch.kernels.bucket_ring import bucket_acc
    from repro_torch.optim import sgd
    model, params, batch = _wide_model(dev)
    init_state, step_fn = dist.make_train_step(model, sgd(0.01), dcfg, W,
                                               device=dev)
    state = init_state(params)
    for _ in range(2):
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
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    out = {"us_per_step": wall_us / WIDE_STEPS, "busy_share": busy,
           "device_us_per_step": dev_us / WIDE_STEPS,
           "device_ops_per_step": n_ops / WIDE_STEPS, "top": top,
           "launches": bucket_acc.launches - a0, "peak_bytes": peak,
           "loss0": float(loss0), "losses": losses}
    log(f"{label}: {WIDE_STEPS} steps: {out['us_per_step']:.1f} us per "
        f"step, device busy {out['device_us_per_step']:.1f} us per step, "
        f"share {_fmt_share(busy)}, {out['device_ops_per_step']:.1f} device "
        f"ops per step, loss {float(loss0):.6f} -> {losses[-1]:.6f}, peak "
        f"memory {peak} bytes, bucket_acc launches {out['launches']}")
    log_top(top)
    return out


def wide_leaf_phase(dev):
    """ToyMLP(12, 1024) on the default leaf wire; its wire bytes against
    the port's leaf_wire_model exactly."""
    from repro_torch.core import dist
    from repro_torch.launch import roofline
    from repro_torch.optim import sgd
    dcfg = dist.DistConfig(variant="artemis", wire="leaf")
    out = _wide_run(dev, dcfg, "wide leaf")
    check(out["losses"][-1] < out["loss0"],
          f"wide leaf: loss {out['loss0']} -> {out['losses']} did not fall")
    check(out["launches"] == W * 25 * WIDE_STEPS,
          f"wide leaf: bucket_acc launched {out['launches']}, expected "
          f"{W * 25 * WIDE_STEPS}")
    model, params, batch = _wide_model(dev)
    tcfg = dist.DistConfig(variant="artemis", wire="leaf", telemetry=True)
    init_state, step_fn = dist.make_train_step(model, sgd(0.01), tcfg, W,
                                               device=dev)
    _, (_, metrics) = step_fn(init_state(params), batch)
    shapes = [tuple(p.shape) for p in params.values()]
    model_b = roofline.leaf_wire_model(shapes, n_workers=W,
                                       codec=tcfg.wire_codec(1024))
    per_worker = metrics["obs"]["wire_bytes"] / W
    check(per_worker == model_b["wire_bytes_per_step"],
          f"wide leaf: {per_worker} wire bytes a worker a step, the model "
          f"says {model_b['wire_bytes_per_step']}")
    bucketed = dist.DistConfig(variant="artemis").layout(shapes)
    model_bk = roofline.bucketed_wire_model(
        n_workers=W, n_buckets=bucketed.n_buckets, rows=bucketed.rows,
        row=bucketed.row)
    out.update(wire_bytes_per_worker=per_worker,
               bucketed_wire_bytes_per_worker=model_bk[
                   "wire_bytes_per_step"], leaves=len(shapes),
               params=sum(p.numel() for p in params.values()))
    log(f"wide leaf: {out['params']} parameters in {len(shapes)} leaves, "
        f"{per_worker:.0f} wire bytes a worker a step (leaf_wire_model "
        f"{model_b['wire_bytes_per_step']:.0f}; the bucketed wire "
        f"{model_bk['wire_bytes_per_step']:.0f})")
    return out


# the reference's fault matrix (tests/helpers/bucket_scenarios.py::
# scenario_fault_matrix), each with scrubbing
MESH_FAULTS = {"bitflip": dict(bitflip_rate=0.02, scrub=True),
               "nan_blowup": dict(blowup_rate=0.5, scrub=True),
               "dropout_burst": dict(straggler_rate=0.5, p_stay=0.8,
                                     scrub=True)}


def mesh_fault_phase(dev):
    """The fault matrix on both wires at the mesh configuration, p = 0.5,
    20 steps, with telemetry (and the bit-flip cell on the bucketed psum,
    B4 under faults): every loss and parameter finite, the telemetry's
    counts non-zero and below their bounds where the config makes them so,
    and FaultConfig() the same bits as faults=None on both wires."""
    import torch
    from repro_torch import experiments as ex
    from repro_torch.core import dist, faults
    out = {}
    n_buckets = 16
    runs = [(w, name, "pipelined") for w in dist.WIRES
            for name in MESH_FAULTS] + [("bucketed", "bitflip", "psum")]
    for wire, name, impl in runs:
        fc = faults.FaultConfig(**MESH_FAULTS[name])
        res = ex.toy_mesh_train("artemis", impl, steps=MESH_STEPS,
                                n_workers=W, p_participation=0.5, wire=wire,
                                faults=fc, telemetry=True, device=dev)
        label = f"mesh faults {wire}/{impl} {name}"
        check(all(math.isfinite(x) for x in res["losses"]),
              f"{label}: non-finite loss {res['losses']}")
        check(all(bool(torch.isfinite(p).all())
                  for p in res["params"].values()),
              f"{label}: non-finite parameters")
        obs = _mesh_obs(res)
        tot = {k: sum(o[k] for o in obs) for k in obs[0]}
        units = n_buckets if wire == "bucketed" else 25
        check(all(0 <= o["mesh_active"] <= W for o in obs)
              and 0 < tot["mesh_active"] < W * len(obs),
              f"{label}: mesh_active {[o['mesh_active'] for o in obs]}")
        check(all(o["mesh_blowup_hits"] <= W for o in obs)
              and (tot["mesh_blowup_hits"] > 0) == (name == "nan_blowup"),
              f"{label}: blowup hits {tot['mesh_blowup_hits']}")
        check(all(o["mesh_scrubbed"] <= W * units for o in obs)
              and (tot["mesh_scrubbed"] > 0) == (name == "bitflip"),
              f"{label}: scrubbed {tot['mesh_scrubbed']}")
        out[f"{wire}/{impl}/{name}"] = dict(
            losses=res["losses"], us_per_step=res["us_per_step"],
            launches=res["launches"], obs_totals=tot)
        log(f"{label}: loss {res['losses'][0]:.6f} -> "
            f"{res['losses'][-1]:.6f}, {res['us_per_step']:.1f} us per "
            f"step, obs totals {json.dumps(tot)}, launches "
            f"{res['launches']}")
    for wire in dist.WIRES:
        runs = [ex.toy_mesh_train("artemis", steps=MESH_STEPS, n_workers=W,
                                  p_participation=0.5, wire=wire, faults=fc,
                                  device=dev)
                for fc in (None, faults.FaultConfig())]
        check(runs[0]["losses"] == runs[1]["losses"]
              and all(torch.equal(p, runs[1]["params"][k])
                      for k, p in runs[0]["params"].items()),
              f"mesh faults {wire}: FaultConfig() differs from faults=None")
    log("mesh faults: FaultConfig() equals faults=None bit for bit on both "
        "wires")
    return out


def wide_faulted_phase(dev, clean):
    """The wide bucketed step under bit flips and scrubbing, beside the
    clean wide step of the same run."""
    from repro_torch.core import dist, faults
    dcfg = dist.DistConfig(variant="artemis", faults=faults.FaultConfig(
        bitflip_rate=0.01, scrub=True))
    out = _wide_run(dev, dcfg, "wide faulted")
    log(f"wide faulted: {out['us_per_step']:.1f} us and "
        f"{out['device_ops_per_step']:.1f} device ops per step, against the "
        f"clean wide step's {clean['us_per_step']:.1f} us and "
        f"{clean['device_ops_per_step']:.1f}")
    return out


PG_WORLD, PG_STEPS = 4, 3        # 5 steps in PR 18
PG_CASES = ("pipelined", "sequential", "psum")


def _pg_rank(rank, world, out_dir, device):
    """A rank of the process-group ring on the card: ToyMLP(12, 1024),
    artemis, default DistConfig, PG_STEPS steps of every reduce_impl on its
    rows of the batch, recording its gradients (for the simulated axis's
    replay), its bytes sent and its µs per step."""
    import torch
    from repro_torch.core import dist, dist_pg
    from repro_torch.kernels.bucket_ring import bucket_acc
    from repro_torch.optim import sgd
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    model, params, batch = _wide_model(dev)
    rows = {k: v.reshape((world, -1) + tuple(v.shape[1:]))[rank]
            for k, v in batch.items()}
    out = {}
    for case in PG_CASES:
        recorded = []
        base = dist_pg.rank_grads(model)

        def grad_fn(p, b):
            res = base(p, b)
            recorded.append({k: v.detach().clone() for k, v in
                             res[0].items()})
            return res

        dcfg = dist.DistConfig(variant="artemis", reduce_impl=case)
        init_state, step_fn = dist_pg.make_train_step(
            model, sgd(0.01), dcfg, device=dev, grad_fn=grad_fn)
        state, times = init_state(params), []
        a0 = bucket_acc.launches
        for _ in range(PG_STEPS):
            t0 = time.perf_counter()
            state, (loss, _) = step_fn(state, rows)
            float(loss)                 # the step's end: its loss on the host
            times.append(time.perf_counter() - t0)
        out[case] = {"params": {k: v.cpu() for k, v in state.params.items()},
                     "grads": [{k: v.cpu() for k, v in g.items()}
                               for g in recorded], "loss": float(loss),
                     "bytes_sent": step_fn.ring.bytes_sent,
                     "staged": step_fn.ring.staged,
                     "us_per_step": statistics.median(times) * 1e6,
                     "launches": bucket_acc.launches - a0}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _gloo_cuda_probe(rank, world, out_dir, what="send"):
    """Does gloo move a CUDA tensor?  ``what``: "send" (rank 0 sends a
    known CUDA tensor to rank 1, which receives into a CUDA tensor);
    "c10d" (``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
    ``all_reduce`` of CUDA tensors); or one of ``MESH_PROBE_OPS`` in the
    functional form that DTensor issues (``_c10d_functional.<op>``).  A
    rank that dies leaves no result file."""
    import torch
    import torch.distributed as tdist
    import torch.distributed._functional_collectives as fc
    x = torch.arange(1024, dtype=torch.float32, device="cuda") + rank
    group = tdist.group.WORLD
    res = {}
    try:
        if what == "send":
            if rank == 0:
                tdist.send(x, 1)
            else:
                y = torch.zeros_like(x)
                tdist.recv(y, 0)
                torch.cuda.synchronize()
                res["equal"] = bool(torch.equal(x, y))
        elif what == "c10d":
            y = torch.empty(world * 1024, device="cuda")
            tdist.all_gather_into_tensor(y, x)
            z = torch.empty(1024 // world, device="cuda")
            tdist.reduce_scatter_tensor(z, x)
            w = x.clone()
            tdist.all_reduce(w)
            torch.cuda.synchronize()
            res["equal"] = bool(torch.equal(w, 2 * torch.arange(
                1024, device="cuda") + world - 1))
        else:
            out = {"all_gather_into_tensor":
                   lambda: fc.all_gather_tensor(x, 0, group),
                   "reduce_scatter_tensor":
                   lambda: fc.reduce_scatter_tensor(x, "sum", 0, group),
                   "all_reduce": lambda: fc.all_reduce(x, "sum", group)}[
                what]()
            torch.cuda.synchronize()
            res["numel"] = int(out.numel())
        res["ok"] = True
    except RuntimeError as exc:
        res = {"ok": False, "error": f"{type(exc).__name__}: {exc}"[:300]}
    torch.save(res, os.path.join(out_dir, f"probe_{what}{rank}.pt"))


def _probe(whats, out_dir):
    """Each probe of ``_gloo_cuda_probe`` in ``whats`` on 2 gloo ranks of
    its own, all at once: {what: the ranks' results, {"ok": False,
    "exit": code} for a rank that died}."""
    import threading
    import torch
    from repro_torch.core import dist_pg
    codes = {}

    def run(what):
        codes[what] = dist_pg.launch(_gloo_cuda_probe, 2, (out_dir, what),
                                     timeout=60)

    threads = [threading.Thread(target=run, args=(w,)) for w in whats]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    for what in whats:
        out[what] = []
        for r, code in enumerate(codes[what]):
            path = os.path.join(out_dir, f"probe_{what}{r}.pt")
            out[what].append(torch.load(path) if code == 0
                             and os.path.exists(path)
                             else {"ok": False, "exit": code})
    return out


def pg_phase(dev):
    """W = 4 ranks of the torch.distributed ring on the one card (gloo):
    rank 0 against the simulated axis over the same draws and the ranks'
    gradients (pipelined and sequential bit for bit, psum to 1e-5), bytes
    sent per rank per step against (W - 1) times the codec's wire bytes,
    µs per step, and whether payloads were staged through the host."""
    import shutil
    import torch
    from repro_torch.core import dist, dist_pg
    from repro_torch.optim import sgd
    out_dir = os.path.join(ROOT, "build", "chip_smoke_pg")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    out = {}
    try:
        t0 = time.perf_counter()
        probe = _probe(["send"], out_dir)["send"]
        takes = all(p.get("ok") for p in probe) and probe[1].get("equal")
        out["gloo_takes_cuda"] = bool(takes)
        log(f"pg ring: gloo send/recv of a CUDA tensor: "
            f"{'moves it' if takes else 'does not move it'} ({probe}); "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rank_dev = str(torch.device(dev.type, dev.index or 0))
        codes = dist_pg.launch(_pg_rank, PG_WORLD, (out_dir, rank_dev),
                               backend="gloo", timeout=600)
        check(codes == [0] * PG_WORLD, f"pg ring: rank exit codes {codes}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
                 for r in range(PG_WORLD)]
        out["launch_s"] = time.perf_counter() - t0
        log(f"pg ring: {PG_WORLD} ranks ran and wrote their results in "
            f"{out['launch_s']:.1f} s")
        model, params, batch = _wide_model(dev)
        plist = list(params.values())
        for case in PG_CASES:
            dcfg = dist.DistConfig(variant="artemis", reduce_impl=case)
            lay = dcfg.layout(plist)
            per_hop = sum(dcfg.wire_codec(lay.row).wire_bytes(
                (lay.n_buckets * lay.rows, lay.row)).values())
            k = [0]

            def grad_fn(p, split):
                g = {name: torch.stack([r[case]["grads"][k[0]][name]
                                        for r in ranks]).to(dev)
                     for name in p}
                k[0] += 1
                z = torch.zeros(PG_WORLD, device=dev)
                return g, (z, {"nll": z, "aux": z})

            init_state, step_fn = dist.make_train_step(
                model, sgd(0.01), dcfg, PG_WORLD, device=dev,
                grad_fn=grad_fn)
            state = init_state(params)
            for _ in range(PG_STEPS):
                state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            r0 = ranks[0][case]["params"]
            diff = max(float((r0[n].to(dev) - p).abs().max())
                       for n, p in state.params.items())
            same = all(torch.equal(r0[n].to(dev), p)
                       for n, p in state.params.items())
            if case == "psum":
                check(diff <= 1e-5, f"pg ring psum: rank 0 differs from the "
                                    f"simulated axis by {diff}")
            else:
                check(same, f"pg ring {case}: rank 0 differs from the "
                            f"simulated axis (max |diff| {diff})")
            sent = [r[case]["bytes_sent"] for r in ranks]
            want = PG_STEPS * (PG_WORLD - 1) * per_hop
            if case != "psum":
                check(sent == [want] * PG_WORLD,
                      f"pg ring {case}: bytes sent {sent}, expected {want}")
            out[case] = {
                "us_per_step": [r[case]["us_per_step"] for r in ranks],
                "staged": ranks[0][case]["staged"],
                "bytes_sent_per_step": sent[0] / PG_STEPS,
                "wire_bytes_per_hop": per_hop, "max_abs_diff": diff,
                "bit_for_bit": same,
                "launches": sum(r[case]["launches"] for r in ranks)}
            log(f"pg ring {case}: rank 0 vs the simulated axis "
                f"{'bit for bit' if same else f'max |diff| {diff:.3g}'}; "
                f"{sent[0] / PG_STEPS:.0f} bytes sent per rank per step "
                f"((W - 1) x {per_hop}); us per step "
                f"{[round(x, 1) for x in out[case]['us_per_step']]}; "
                f"payloads staged through the host: "
                f"{ranks[0][case]['staged']}; bucket_acc launches "
                f"{out[case]['launches']}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out["launches"] = sum(out[c]["launches"] for c in PG_CASES)
    return out


def telemetry_grid_phase(dev, clean):
    """The clean 640-cell grid with the sweep's telemetry: losses, distances
    and bits bit for bit with ``clean`` (the grid phase's SweepResult);
    µs per round per cell with and without, and the device ops a round the
    telemetry adds (20 rounds of one variant's 128 cells, profiled)."""
    import numpy as np
    from repro_torch import experiments as ex
    t0 = time.perf_counter()
    res = ex.fig4_bits(device=dev, gamma_mults=GRID_MULTS, seeds=GRID_SEEDS,
                       telemetry=True)
    secs = time.perf_counter() - t0
    sweep = res.pop("sweep")
    for f in ("losses", "dists", "bits", "w_final", "rollbacks"):
        check(np.array_equal(getattr(sweep, f), getattr(clean["sweep"], f),
                             equal_nan=True),
              f"telemetry grid: {f} differs from the grid without it")
    tel = sweep.telemetry
    check(tel is not None and tel["avail"].shape == sweep.losses.shape,
          "telemetry grid: no telemetry of the grid's shape")
    check(np.isfinite(tel["err_up"]).all() and (tel["uplink_bits"] > 0).any(),
          "telemetry grid: the readings are not finite or empty")
    prof_on = profile_phase(dev, telemetry=True)
    out = {"us_per_round_cell": res["us_per_round_cell"],
           "clean_us_per_round_cell": clean["us_per_round_cell"],
           "seconds": secs, "profile": prof_on}
    log(f"telemetry grid: bit for bit with the clean grid; us per round "
        f"per cell {res['us_per_round_cell']:.3f} against "
        f"{clean['us_per_round_cell']:.3f} without; device ops per round "
        f"{prof_on['device_ops_per_round']:.1f}")
    return out


def obs_smoke_phase():
    """``python -m repro_torch.obs smoke`` on the card, then the CLI's
    ``validate`` (in this process) on the events it wrote; the directory is
    removed after."""
    import shutil
    out_dir = os.path.join(ROOT, "build", "chip_smoke_obs")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    try:
        t0 = time.perf_counter()
        smoke = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", "smoke", "-o",
             out_dir], capture_output=True, text=True, timeout=300, env=env,
            cwd=ROOT)
        secs = time.perf_counter() - t0
        check(smoke.returncode == 0, f"obs smoke failed: "
                                     f"{smoke.stdout[-1500:]}"
                                     f"{smoke.stderr[-1500:]}")
        from repro_torch.obs import __main__ as obs_cli
        rc = obs_cli.main(["validate", os.path.join(out_dir, "events.jsonl")])
        check(rc == 0, f"obs validate returned {rc}")
        log(f"obs smoke ({secs:.1f} s): "
            f"{' | '.join(smoke.stdout.strip().splitlines()[-3:])}; "
            f"validate returned {rc}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"seconds": secs}


# ---------------------------------------------------------------------------
# the LM stack: every family reduced, two 7B models served, lm-100m trained
# ---------------------------------------------------------------------------

def _lm_batch(cfg, b, s, seed):
    """Tokens (and the vlm's patch embeddings, the encdec's frames) drawn
    from ``seed`` with numpy, on the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    text = s - cfg.n_patches if cfg.family == "vlm" else s
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, text)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32))
    return batch


def _lm_eval(model, params, batch, enc_out, steps):
    """The loss and ``steps`` decode steps' logits [steps, B, V]."""
    import torch
    dev = params["embed"].device
    batch = {k: v.to(dev) for k, v in batch.items()}
    with torch.inference_mode():
        loss, _ = model.loss(params, batch)
        cache = model.init_cache(batch["tokens"].shape[0], steps, device=dev)
        logits = []
        for i in range(steps):
            lg, cache = model.decode_step(
                params, cache, batch["tokens"][:, i], i,
                enc_out=None if enc_out is None else enc_out.to(dev))
            logits.append(lg)
    return float(loss), torch.stack(logits).cpu()


def lm_logits_agree(out, ref):
    """Every logit within 0.06 (the bf16 bar of tests/test_torch_models.py;
    the card and the CPU run the same port, so the MoE archs take it too).
    Returns (ok, max |diff|, tokens beyond 0.06)."""
    err = (out - ref).abs()
    mx = float(err.max())
    return mx <= 6e-2, mx, int((err > 6e-2).any(-1).sum())


def _quiet(fn, *args, **kw):
    """Run ``fn`` with its stdout (an echoing event log) kept off ours."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _lm_cli_archs():
    """The archs whose reduced config the train CLI can train: their
    TokenStream batches carry tokens only."""
    from repro_torch import configs
    return [a for a in sorted(configs.ARCHS)
            if configs.get_config(a, reduced=True).family in LM_CLI_FAMILIES]


def lm_ring_stacks(dev):
    """The [W, B, R, C] stacks that the LM paths hand B3's hops and B4,
    under the default bucketed ``DistConfig`` (the one the train CLI
    builds): each reduced arch the CLI trains at W = 2 (``"cli"``),
    reduced starcoder2 on psum at W = 2 (``"psum"``) and lm-100m at W = 8
    (``"train"``)."""
    import torch
    from repro_torch import configs
    from repro_torch import experiments as ex
    from repro_torch.core import dist
    from repro_torch.models.model import build_model

    def stack(cfg, w):
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
        return (w,) + tuple(dist.DistConfig().layout(
            list(params.values())).shape)

    cli = {a: stack(configs.get_config(a, reduced=True), LM_CLI_W)
           for a in _lm_cli_archs()}
    return {"cli": cli, "psum": cli["starcoder2-7b"],
            "train": stack(ex.lm_config(full_100m=True), LM_TRAIN_W)}


def lm_reduced_phase(dev):
    """Every arch's REDUCED config on the card against the CPU; the train
    CLI for each arch it can train; reduced starcoder2 on psum."""
    import torch
    from repro_torch import configs
    from repro_torch.core import dist
    from repro_torch.data.synthetic import TokenStream, TokenStreamConfig
    from repro_torch.kernels.bucket_ring import bucket_acc, bucket_ring_sum
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.optim import adam
    out = {"archs": {}}
    t0 = time.perf_counter()
    for i, arch in enumerate(sorted(configs.ARCHS)):
        cfg = configs.get_config(arch, reduced=True)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(i))
        batch = _lm_batch(cfg, LM_B, LM_S, 100 + i)
        enc = (None if cfg.family != "encdec" else torch.randn(
            LM_B, cfg.n_frames, cfg.d_model,
            generator=torch.Generator().manual_seed(200 + i)).to(cfg.cdtype))
        loss_c, logits_c = _lm_eval(model, params, batch, enc, LM_T)
        loss_d, logits_d = _lm_eval(
            model, {k: v.to(dev) for k, v in params.items()}, batch, enc,
            LM_T)
        check(math.isfinite(loss_d) and bool(torch.isfinite(logits_d).all()),
              f"lm reduced {arch}: non-finite loss or logits on the card")
        rel = abs(loss_d - loss_c) / abs(loss_c)
        ok, mx, rows = lm_logits_agree(logits_d, logits_c)
        check(rel <= 2e-3 and ok,
              f"lm reduced {arch}: card against CPU loss rel {rel:.3g} "
              f"(bar 2e-3), decode logits max |diff| {mx:.4g}, {rows} of "
              f"{LM_T * LM_B} tokens beyond 0.06")
        out["archs"][arch] = {"loss_card": loss_d, "loss_cpu": loss_c,
                              "loss_rel": rel, "logits_max_abs": mx,
                              "tokens_beyond": rows}
        log(f"lm reduced {arch} ({cfg.family}): loss card {loss_d:.6f} cpu "
            f"{loss_c:.6f} (rel {rel:.3g}); {LM_T} decode steps max |diff| "
            f"{mx:.4g}, {rows} of {LM_T * LM_B} tokens beyond 0.06")
    a0 = bucket_acc.launches
    cli = _lm_cli_archs()
    for arch in cli:
        logs = _quiet(train.main, [
            "--arch", arch, "--reduced", "--steps", str(LM_CLI_STEPS),
            "--batch", "4", "--seq", "64", "--dist", "artemis",
            "--workers", str(LM_CLI_W), "--log-every", "1",
            "--device", str(dev)])
        losses = [r["loss"] for r in logs]
        check(len(logs) == LM_CLI_STEPS and all(map(math.isfinite, losses)),
              f"lm train cli {arch}: losses {losses}")
        out["archs"][arch]["cli_losses"] = losses
        log(f"lm train cli {arch}: artemis W = {LM_CLI_W}, losses {losses}")
    want = LM_CLI_W * LM_CLI_STEPS * len(cli)
    got = bucket_acc.launches - a0
    check(got == want, f"lm train cli: bucket_acc launched {got}, expected "
                       f"{want} (W a step)")
    # B4: reduced starcoder2 on the bucketed psum
    cfg = configs.get_config("starcoder2-7b", reduced=True)
    model = build_model(cfg)
    dcfg = dist.DistConfig(variant="artemis", reduce_impl="psum")
    init_state, step_fn = dist.make_train_step(model, adam(3e-3), dcfg,
                                               LM_CLI_W, device=dev)
    state = init_state(model.init(torch.Generator(device=dev).manual_seed(0)))
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=64,
                                           batch=4), device=dev)
    r0, a1 = bucket_ring_sum.launches, bucket_acc.launches
    losses = []
    for i in range(LM_CLI_STEPS):
        state, (loss, _) = step_fn(state, stream.batch_at(i))
        losses.append(float(loss))
    check(all(map(math.isfinite, losses)), f"lm psum: losses {losses}")
    got = (bucket_ring_sum.launches - r0, bucket_acc.launches - a1)
    check(got == (LM_CLI_STEPS, 0), f"lm psum: bucket_ring_sum and "
                                    f"bucket_acc launched {got}, expected "
                                    f"({LM_CLI_STEPS}, 0)")
    log(f"lm psum starcoder2-reduced: losses {losses}, bucket_ring_sum "
        f"launches {got[0]}")
    out["psum_losses"] = losses
    out["seconds"] = time.perf_counter() - t0
    return out


def lm_serve_case(dev, arch):
    """One arch at its published config through ``generate``."""
    import dataclasses
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    cfg = configs.get_config(arch)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (LM_SERVE_B, LM_SERVE_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    generate(model, params, prompt[:, :2], 4, 2)         # warm-up
    torch.cuda.synchronize(dev)
    total = LM_SERVE_PROMPT + LM_SERVE_GEN
    decoded = _Routing(cfg)             # records a MoE's experts, if any
    t0 = time.perf_counter()
    with decoded:
        toks, logits = generate(model, params, prompt, total, LM_SERVE_GEN,
                                return_logits=True)
    host = toks.cpu()                                   # waits for the card
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(tuple(host.shape) == (LM_SERVE_B, total)
          and bool(((host >= 0) & (host < cfg.vocab)).all())
          and bool(torch.isfinite(logits).all()),
          f"lm serve {arch}: tokens out of range or non-finite logits")
    # the decode chain's last logits against the teacher-forced forward
    # over the same tokens (the MoE at a dropless capacity: decode's groups
    # of B tokens never drop at this width)
    pcfg = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k)
            if cfg.family == "moe" else cfg)
    prefilled = _Routing(cfg)
    with prefilled, torch.inference_mode():
        pre = build_model(pcfg).prefill_logits(params, {"tokens": toks})
    chk = _decode_against_prefill(logits, pre)
    if cfg.family == "moe":
        chk = _moe_decode_checks(cfg, pcfg, model, params, toks,
                                 (logits, decoded.calls),
                                 (pre, prefilled.calls))
    bf16 = (f"; bf16: {chk['flips']} of {chk['choices']} expert choices "
            f"of the decode chain differ from prefill's (f32: "
            f"{chk['flips_f32']}; C5: bf16 reduction allowed "
            f"{chk['bf16_reduction_allowed']}, with it forbidden "
            f"{chk['flips_bf16_reduction_off']}), in rows "
            f"{chk['flipped_rows']}; unpinned "
            f"max |diff| {chk['free_max_abs']:.4g} (argmax agree "
            f"{chk['free_argmax_agree']:.3f}), rows without a flip "
            f"{chk['unflipped_max_abs']} (bf16 bar, ok "
            f"{chk['unflipped_ok']}); experts pinned to prefill's, max "
            f"|diff| {chk['pinned_max_abs']:.4g} (argmax agree "
            f"{chk['pinned_argmax_agree']:.3f}) against the bar "
            f"{chk['prefill_bf16_err']:.4g}, the bf16 prefill's max |diff| "
            f"from f32 compute with its experts" if "flips" in chk else "")
    check(chk["ok"], f"lm serve {arch}: decode against prefill max |diff| "
                     f"{chk['max_abs']:.4g} beyond the bar ({chk['bar']})"
                     f"{bf16}")
    # where a decode step's time goes: 4 steps under the profiler
    wall_us, dev_us, busy, n_ops, top = profiled(
        lambda: generate(model, params, prompt[:, :2], 4, 2))
    res = {"params": n_params, "init_s": init_s, "wall_s": wall,
           "tok_per_s": LM_SERVE_B * total / wall,
           "ms_per_decode_step": wall / total * 1e3, "peak_bytes": peak,
           "decode_vs_prefill": chk, "profile_us_per_step": wall_us / 4,
           "profile_device_us_per_step": dev_us / 4, "busy_share": busy,
           "device_ops_per_step": n_ops / 4, "top": top}
    log(f"lm serve {arch}: {n_params} parameters (init {init_s:.3f} s), "
        f"batch {LM_SERVE_B}, {total} decode steps in {wall:.3f} s: "
        f"{res['tok_per_s']:.1f} tok/s, {res['ms_per_decode_step']:.3f} ms "
        f"per decode step, peak memory {peak} bytes; decode against "
        f"prefill ({chk['bar']}) max |diff| {chk['max_abs']:.4g}, logits "
        f"rms {chk['rms']:.4g}, argmax agree {chk['argmax_agree']:.3f}"
        f"{bf16}; profiled: {wall_us / 4:.1f} us per step, device "
        f"{dev_us / 4:.1f} us, share {_fmt_share(busy)}, "
        f"{n_ops / 4:.1f} device ops per step")
    log_top(top)
    del params, toks, logits, pre
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _decode_against_prefill(logits, pre, f32=False):
    """The last decode step's logits against ``prefill_logits`` over the
    same tokens: in bf16 within 0.15 x the logits' rms + 0.05 x |logit|
    (the reference's rtol 5e-2 and atol 5e-2, the atol scaled by the rms
    over the reduced width's 0.32); at f32 compute within 0.01 x rms +
    1e-3 x |logit|."""
    err = (logits - pre).abs()
    rms = float(pre.pow(2).mean().sqrt())
    a, r = (0.01, 1e-3) if f32 else (0.15, 0.05)
    return {"ok": bool((err <= a * rms + r * pre.abs()).all()),
            "max_abs": float(err.max()), "rms": rms,
            "bar": f"{a} rms + {r} |ref|, {'f32' if f32 else 'bf16'}",
            "argmax_agree": float((logits.argmax(-1) == pre.argmax(-1))
                                  .float().mean())}


class _Routing:
    """Stands in for ``torch.topk`` while entered.  The MoE router's top-k
    (a call over ``n_experts`` with k = ``top_k``, one a layer) is recorded
    in ``calls``.  Given ``pinned``, a forward's record over [B, S] tokens,
    each call takes the recorded experts instead of its own: a forward over
    the same tokens takes layer c's at its call c, a decode chain takes at
    its call c (step c // L, layer c % L) the record's for that step.  Any
    other top-k passes through."""

    def __init__(self, cfg, pinned=None):
        self.e, self.k, self.pinned, self.calls = (
            cfg.n_experts, cfg.top_k, pinned, [])

    def __enter__(self):
        import torch
        self._topk, torch.topk = torch.topk, self._route
        return self

    def __exit__(self, *exc):
        import torch
        torch.topk = self._topk

    def _route(self, x, k, dim=-1, **kw):
        if x.shape[-1] != self.e or k != self.k:
            return self._topk(x, k, dim, **kw)
        if self.pinned is None:
            gate, idx = self._topk(x, k, dim, **kw)
        else:
            step, layer = divmod(len(self.calls), len(self.pinned))
            idx = self.pinned[layer]
            if idx.shape[:-1] != x.shape[:-1]:
                idx = idx.reshape(x.shape[-2], -1, k)[:, step][None]
            gate = x.gather(-1, idx)
        self.calls.append(idx)
        return gate, idx


def _decode_chain(model, params, toks, routing):
    """The last logits of decode steps over ``toks`` (teacher-forced)."""
    import torch
    b, total = toks.shape
    with routing, torch.inference_mode():
        cache = model.init_cache(b, total, device=toks.device)
        for i in range(total):
            logits, cache = model.decode_step(params, cache, toks[:, i], i)
    return logits


def _flips(cfg, decode_calls, prefill_calls, b):
    """(expert choices of a decode chain that differ from the forward's
    over the same tokens, of how many; the rows that hold one)."""
    import torch
    n_layers = len(prefill_calls)
    rows = torch.zeros(b, dtype=torch.bool, device=decode_calls[0].device)
    flips = 0
    for c, idx in enumerate(decode_calls):
        step, layer = divmod(c, n_layers)
        ref = prefill_calls[layer].reshape(b, -1, cfg.top_k)[:, step]
        diff = (idx[0].sort(-1).values != ref.sort(-1).values).any(-1)
        rows |= diff
        flips += int(diff.sum())
    return flips, len(decode_calls) * b, rows


def _moe_decode_checks(cfg, pcfg, model, params, toks, decoded, prefilled):
    """Decode against prefill for a MoE at its published width, from the
    bf16 decode chain's last logits and experts (``decoded``) and the bf16
    forward's over the same tokens (``prefilled``).  In bf16 the top-8 of
    64 experts flips on a rounding between the 4-token decode and the
    256-token forward, and a flipped expert moves its token's whole output;
    a near-uniform random router flips often.  The gates: at f32 compute,
    the decode chain within the f32 bar of the forward; in bf16, the chain
    with every step's experts pinned to the forward's within the forward's
    own bf16 error (its max |diff| from the same forward at f32 compute
    with the same experts), and the unpinned rows whose experts all agree
    with the forward's within the bf16 bar.  The flips and the unpinned
    gap are recorded."""
    import dataclasses
    import torch
    from repro_torch.models.model import build_model
    (lg_free, dec_calls), (pre, pre_calls) = decoded, prefilled
    b = toks.shape[0]
    lg_pin = _decode_chain(model, params, toks, _Routing(cfg, pre_calls))
    flips, choices, flipped = _flips(cfg, dec_calls, pre_calls, b)
    m32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    f32_pre = build_model(dataclasses.replace(pcfg, compute_dtype="float32"))
    with _Routing(cfg, pre_calls), torch.inference_mode():
        pre32_pin = f32_pre.prefill_logits(params, {"tokens": toks})
    rounding = float((pre - pre32_pin).abs().max())
    free32, pre32 = _Routing(cfg), _Routing(cfg)
    lg32 = _decode_chain(m32, params, toks, free32)
    with pre32, torch.inference_mode():
        lg_pre32 = f32_pre.prefill_logits(params, {"tokens": toks})
    flips32 = _flips(cfg, free32.calls, pre32.calls, b)[0]
    chk = _decode_against_prefill(lg32, lg_pre32, f32=True)
    # C5: the same bf16 chain and forward with cuBLAS's bf16 reduction of
    # partial sums forbidden (PyTorch allows it by default)
    mm = torch.backends.cuda.matmul
    allowed = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        dec_off, pre_off = _Routing(cfg), _Routing(cfg)
        _decode_chain(model, params, toks, dec_off)
        with pre_off, torch.inference_mode():
            build_model(pcfg).prefill_logits(params, {"tokens": toks})
    finally:
        mm.allow_bf16_reduced_precision_reduction = allowed
    flips_off = _flips(cfg, dec_off.calls, pre_off.calls, b)[0]
    pin_err = float((lg_pin - pre).abs().max())
    whole = _decode_against_prefill(lg_free, pre)
    keep = ~flipped
    rows = (_decode_against_prefill(lg_free[keep], pre[keep])
            if bool(keep.any()) else None)
    chk.update(
        ok=chk["ok"] and pin_err <= rounding
        and (rows is None or rows["ok"]),
        flips=flips, flips_f32=flips32, choices=choices,
        bf16_reduction_allowed=allowed, flips_bf16_reduction_off=flips_off,
        flipped_rows=flipped.nonzero().flatten().tolist(),
        free_max_abs=whole["max_abs"],
        free_argmax_agree=whole["argmax_agree"],
        unflipped_max_abs=None if rows is None else rows["max_abs"],
        unflipped_ok=None if rows is None else rows["ok"],
        pinned_max_abs=pin_err, prefill_bf16_err=rounding,
        pinned_argmax_agree=float((lg_pin.argmax(-1) == pre.argmax(-1))
                                  .float().mean()))
    return chk


def lm_serve_phase(dev):
    return {arch: lm_serve_case(dev, arch) for arch in LM_SERVE_ARCHS}


def _lm_100m_run(dev, remat):
    """lm-100m over the default bucketed wire, artemis, W = 8, with or
    without remat: 2 warm-up steps, then LM_TRAIN_STEPS profiled."""
    import dataclasses
    import torch
    from repro_torch import experiments as ex
    from repro_torch.core import dist
    from repro_torch.data.synthetic import TokenStream, TokenStreamConfig
    from repro_torch.kernels.bucket_ring import bucket_acc
    from repro_torch.launch import roofline
    from repro_torch.models.model import build_model
    from repro_torch.optim import adam
    cfg = dataclasses.replace(ex.lm_config(full_100m=True), remat=remat)
    steps = LM_TRAIN_STEPS
    name = f"lm train {cfg.name}{' remat' if remat else ''}"
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in params.values())
    dcfg = dist.DistConfig(variant="artemis")
    layout = dcfg.layout(list(params.values()))
    init_state, step_fn = dist.make_train_step(model, adam(3e-3), dcfg,
                                               LM_TRAIN_W, device=dev)
    state = init_state(params)
    stream = TokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, batch=LM_TRAIN_BATCH),
        device=dev)
    batches = [stream.batch_at(i) for i in range(2 + steps)]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for b in batches[:2]:                               # warm-up
        state, (loss, _) = step_fn(state, b)
        losses.append(loss)
    torch.cuda.synchronize(dev)
    a0 = bucket_acc.launches

    def run():
        nonlocal state
        for b in batches[2:]:
            state, (loss, _) = step_fn(state, b)
            losses.append(loss)

    wall_us, dev_us, busy, n_ops, top = profiled(run)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    launched = bucket_acc.launches - a0
    check(all(map(math.isfinite, losses)), f"{name}: losses {losses}")
    check(launched == LM_TRAIN_W * steps,
          f"{name}: bucket_acc launched {launched}, expected "
          f"{LM_TRAIN_W * steps} (W a step)")
    drop = losses[0] - losses[-1]
    check(drop > 0.5, f"{name}: the loss fell {drop:.4f} nats over "
                      f"{len(losses)} steps (the example asks > 0.5)")
    wire = roofline.bucketed_wire_model(
        n_workers=LM_TRAIN_W, n_buckets=layout.n_buckets, rows=layout.rows,
        row=layout.row)["wire_bytes_per_step"]
    res = {"params": n_params, "layout": list(layout.shape),
           # on the host, for the remat phase's comparison
           "final_params": {k: v.detach().cpu()
                            for k, v in state.params.items()},
           "us_per_step": wall_us / steps, "busy_share": busy,
           "device_us_per_step": dev_us / steps,
           "device_ops_per_step": n_ops / steps, "peak_bytes": peak,
           "wire_bytes_per_worker_per_step": wire, "losses": losses,
           "drop": drop, "launches": launched, "top": top}
    log(f"{name}: {n_params} parameters, layout "
        f"{list(layout.shape)}, W = {LM_TRAIN_W}, batch {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ}, {steps} steps after 2: {wall_us / steps:.1f} us "
        f"per step, device busy {dev_us / steps:.1f} us per step, share "
        f"{_fmt_share(busy)}, {n_ops / steps:.1f} device ops per step, "
        f"peak memory {peak} bytes, {wire:.0f} wire bytes a worker a step, "
        f"bucket_acc launches {launched}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (drop {drop:.4f})")
    log_top(top)
    return res


def lm_train_phase(dev):
    """lm-100m over the default bucketed wire, artemis, W = 8 (the
    example's remat=False)."""
    return _lm_100m_run(dev, remat=False)


def _falcon_layer(dev, remat):
    """One full-width falcon-mamba-7b layer's plain train step (sgd) at
    batch REMAT_FALCON_B x REMAT_FALCON_SEQ: ms per step (median of 3 after
    one), peak memory, and the dry run's estimate of the peak."""
    import dataclasses
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.core import dist
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.optim import sgd
    over = {"n_layers": 1, "remat": remat}
    cfg = dataclasses.replace(configs.get_config("falcon-mamba-7b"), **over)
    est = dryrun.lower_one("falcon-mamba-7b", "train_4k", "none",
                           batch=REMAT_FALCON_B, seq=REMAT_FALCON_SEQ,
                           cfg_overrides=over)
    check(est["status"] == "ok", f"remat falcon: dry run {est}")
    model = build_model(cfg)
    init_state, step_fn = dist.make_train_step(model, sgd(1e-3), None,
                                               device=dev)
    state = init_state(model.init(torch.Generator(device=dev).manual_seed(0)))
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (REMAT_FALCON_B, REMAT_FALCON_SEQ), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1),
        dtype=torch.int32)}
    state, (loss, _) = step_fn(state, batch)              # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], [float(loss)]
    for _ in range(3):
        t0 = time.perf_counter()
        state, (loss, _) = step_fn(state, batch)
        losses.append(float(loss))              # the step's end, on the host
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(map(math.isfinite, losses)),
          f"remat falcon (remat {remat}): losses {losses}")
    del state, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms_per_step": statistics.median(times), "peak_bytes": peak,
            "estimate_bytes": est["peak_bytes"], "losses": losses}


def lm_remat_phase(dev, train_res):
    """A17 on the card: lm-100m with remat beside phase 26's run without
    (ms per step, peak, the dry run's estimate of the remat peak, the
    losses), then one full-width falcon-mamba-7b layer with remat on and
    off (ROADMAP §B note 7)."""
    from repro_torch.launch import dryrun
    res = _lm_100m_run(dev, remat=True)
    est = dryrun.lower_one(
        "lm-100m", "train_4k", "artemis", workers=LM_TRAIN_W,
        batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, optimizer="adam",
        cfg_overrides={"remat": True})
    check(est["status"] == "ok", f"lm remat: dry run {est}")
    gap = max(abs(a - b) for a, b in zip(res["losses"],
                                         train_res["losses"]))
    mine, theirs = res.pop("final_params"), train_res.pop("final_params")
    param_gap = max(float((mine[k] - theirs[k]).abs().max()) for k in mine)
    # remat recomputes the same products on the same inputs: bit for bit on
    # the CPU (tests/test_torch_remat.py) and on the card (PERF.md §6)
    check(gap == 0 and param_gap == 0,
          f"lm remat: losses {res['losses']} against phase 26's "
          f"{train_res['losses']}, parameters {param_gap} apart after "
          f"{len(res['losses'])} steps")
    res.update(estimate_bytes=est["peak_bytes"], loss_gap=gap,
               param_gap=param_gap)
    log(f"lm remat lm-100m: {res['us_per_step']:.1f} us per step against "
        f"{train_res['us_per_step']:.1f} without (x"
        f"{res['us_per_step'] / train_res['us_per_step']:.4f}); peak "
        f"{res['peak_bytes']} bytes against {train_res['peak_bytes']} "
        f"(x{res['peak_bytes'] / train_res['peak_bytes']:.4f}); dry run's "
        f"estimate {est['peak_bytes']} (x"
        f"{est['peak_bytes'] / res['peak_bytes']:.4f} of the measured); "
        f"losses and parameters bit for bit with phase 26's")
    falcon = {r: _falcon_layer(dev, r) for r in (False, True)}
    for r, f in falcon.items():
        log(f"lm remat falcon-mamba-7b, 1 layer at full width, batch "
            f"{REMAT_FALCON_B} x {REMAT_FALCON_SEQ}, remat {r}: "
            f"{f['ms_per_step']:.3f} ms per step, peak {f['peak_bytes']} "
            f"bytes, the dry run's estimate {f['estimate_bytes']} (x"
            f"{f['estimate_bytes'] / f['peak_bytes']:.4f}); losses "
            f"{[round(x, 4) for x in f['losses']]}")
    res["falcon"] = falcon
    return res


def lm_pg_train_phase(dev):
    """A18 on the card: ``launch.train.main --ranks PG_TRAIN_RANKS`` on
    lm-100m at full width (gloo ranks on this card), PG_TRAIN_STEPS steps
    with local_steps = PG_TRAIN_LOCAL: the losses finite and falling, and
    bucket_acc launched W times a communicating step by every rank (the
    ranks' own counts, summed in the run's ``run_end`` event); the fused
    attention's launches by the ranks, returned as ``attention``."""
    import gc
    import shutil
    import torch
    from repro_torch import experiments as ex
    from repro_torch.launch import train
    from repro_torch.obs import events
    gc.collect()
    torch.cuda.empty_cache()            # the ranks need the card's memory
    out_dir = os.path.join(ROOT, "build", "chip_smoke_pg_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "events.jsonl")
    try:
        t0 = time.perf_counter()
        logs = _quiet(train.main, [
            "--arch", "lm-100m", "--steps", str(PG_TRAIN_STEPS), "--batch",
            str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ), "--dist",
            "artemis", "--ranks", str(PG_TRAIN_RANKS), "--local-steps",
            str(PG_TRAIN_LOCAL), "--log-every", "1", "--events", path,
            "--device", dev.type],
            config=ex.lm_config(full_100m=True))
        secs = time.perf_counter() - t0
        evs = events.read_events(path)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    check(not events.validate_events(evs), "pg train: invalid events")
    losses = [r["loss"] for r in logs]
    check(len(losses) == PG_TRAIN_STEPS and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"pg train: losses {losses}")
    launched = evs[-1]["kernel_launches"]
    comm = PG_TRAIN_STEPS // PG_TRAIN_LOCAL
    want = PG_TRAIN_RANKS * PG_TRAIN_RANKS * comm
    check(launched["bucket_acc"] == want,
          f"pg train: bucket_acc launched {launched['bucket_acc']} times by "
          f"the ranks, expected {want} (W a rank a communicating step)")
    steady = [e["dur_s"] for e in evs if e["ev"] == "span"]
    layout = evs[0]["config"]["layout"]
    log(f"pg train lm-100m: {PG_TRAIN_RANKS} ranks (gloo, one card), layout "
        f"{layout}, "
        f"{PG_TRAIN_STEPS} steps, local_steps {PG_TRAIN_LOCAL}, batch "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: losses {losses}; the ranks' "
        f"kernel launches {launched}; spans {steady} s; {secs:.1f} s with "
        f"the ranks' start")
    return {"losses": losses, "launches": launched["bucket_acc"],
            "attention": launched["flash_attention"], "layout": layout,
            "seconds": secs}


def _train_events(argv, path):
    """``launch.train.main`` on lm-100m at full width with ``argv`` and an
    event log at ``path``: (logs, events, seconds)."""
    from repro_torch import experiments as ex
    from repro_torch.launch import train
    from repro_torch.obs import events
    t0 = time.perf_counter()
    logs = _quiet(train.main, [
        "--arch", "lm-100m", "--steps", str(MESH_TRAIN_STEPS), "--batch",
        str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ), "--dist", "artemis",
        "--log-every", "1", "--events", path, "--device", "cuda", *argv],
        config=ex.lm_config(full_100m=True))
    secs = time.perf_counter() - t0
    evs = events.read_events(path)
    check(not events.validate_events(evs), f"mesh train {argv}: invalid "
                                           f"events")
    return logs, evs, secs


@contextlib.contextmanager
def _eager_attention():
    """``layers.attention`` on ``_attn_block`` everywhere while entered (in
    this process): the attention the sharded mesh runs."""
    from repro_torch.models import layers
    saved = layers.fused_route
    layers.fused_route = lambda *args, **kw: False
    try:
        yield
    finally:
        layers.fused_route = saved


def mesh_train_phase(dev):
    """A14 on the card.  First the probe, a record of gloo's fault
    (ROADMAP C6): which of the collectives a DTensor mesh issues
    (``MESH_PROBE_OPS``, functional) gloo runs on CUDA tensors, each on 2
    ranks of its own, and their c10d forms.  The CLI's mesh takes nccl on
    CUDA, one card a rank, so on this one card ``launch.train.main --mesh
    1x1`` on lm-100m at full width, artemis, adam, batch 16 x 256,
    MESH_TRAIN_STEPS steps: its losses finite and falling and within rtol
    1e-4 of the same worker unsharded (``--workers 1`` in this process)
    with the mesh's attention, the eager ``_attn_block``.  The sharded
    mesh keeps it; the shipped unsharded route (``--ranks 1``) takes the
    fused kernel, whose scores stay f32 where the eager block rounds them
    to bf16: the two paths differ, by 1.09e-4 at the third loss on the
    H100, so the mesh is held to that run within rtol 1e-3, a fault's
    size and not a rounding's.  bucket_acc launched ranks x W a step and
    the fused attention 0 times (the ranks' counts, summed in
    ``run_end``); its bucketed layout; the steady step time and the
    largest peak of the mesh and ``--ranks 1``."""
    import gc
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()            # the ranks need the card's memory
    out_dir = os.path.join(ROOT, "build", "chip_smoke_mesh_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    res = {}
    try:
        t0 = time.perf_counter()
        probe = _probe(["c10d"] + list(MESH_PROBE_OPS), out_dir)
        res["probe_s"] = time.perf_counter() - t0
        verdict = {w: all(p.get("ok") for p in probe[w])
                   and probe[w][-1].get("equal", True) for w in probe}
        refused = sorted(f"_c10d_functional.{op}" for op in MESH_PROBE_OPS
                         if not verdict[op])
        res["probe"] = {"gloo_cuda": verdict, "refused": refused,
                        "ranks": probe}
        log(f"mesh train probe: gloo on CUDA tensors: c10d collectives "
            f"{'run' if verdict['c10d'] else 'fail'}; functional "
            + ", ".join(f"{op} {'runs' if verdict[op] else 'fails'}"
                        for op in MESH_PROBE_OPS)
            + f" ({probe}); {res['probe_s']:.1f} s")
        shape, backend = "1x1", "nccl"  # nccl: one card a rank
        d, m = (int(x) for x in shape.split("x"))
        runs = {}
        for name, argv in (
                ("mesh", ["--mesh", shape]),
                ("ranks", ["--ranks", str(d)]),
                ("eager", ["--workers", str(d)])):
            gc.collect()
            torch.cuda.empty_cache()
            with (_eager_attention() if name == "eager"
                  else contextlib.nullcontext()):
                logs, evs, secs = _train_events(
                    argv, os.path.join(out_dir, f"{name}.jsonl"))
            # the steady steps' wall time, device drained, saves and
            # rollbacks left out (launch/train.py)
            steady = next(e for e in evs if e["ev"] == "span"
                          and e["name"] == "train/steady_steps")
            runs[name] = {"losses": [r["loss"] for r in logs],
                          "launches": evs[-1]["kernel_launches"][
                              "bucket_acc"],
                          "attention": evs[-1]["kernel_launches"][
                              "flash_attention"],
                          "peak_bytes": evs[-1]["device_peak_bytes"],
                          "ms_per_step": 1e3 * steady["dur_s"]
                          / steady["steps"],
                          "layout": evs[0]["config"]["layout"],
                          "seconds": secs}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    mesh, ranks, eager = runs["mesh"], runs["ranks"], runs["eager"]
    losses = mesh["losses"]
    check(len(losses) == MESH_TRAIN_STEPS and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"mesh train: losses {losses}")
    gap = {name: max(abs(a - b) / abs(b)
                     for a, b in zip(losses, runs[name]["losses"]))
           for name in ("eager", "ranks")}
    check(gap["eager"] <= 1e-4, f"mesh train: losses {losses} against the "
                                f"unsharded worker's on the eager attention, "
                                f"{eager['losses']} (rtol "
                                f"{gap['eager']:.3g})")
    check(gap["ranks"] <= 1e-3, f"mesh train: losses {losses} against "
                                f"--ranks {d}'s on the fused attention, "
                                f"{ranks['losses']} (rtol "
                                f"{gap['ranks']:.3g})")
    want = d * m * d * MESH_TRAIN_STEPS
    check(mesh["launches"] == want,
          f"mesh train: bucket_acc launched {mesh['launches']} times by the "
          f"ranks, expected {want} (ranks x W a step)")
    check(mesh["attention"] == 0 and ranks["attention"] > 0,
          f"mesh train: the fused attention launched {mesh['attention']} "
          f"times by the mesh's ranks (expected 0: the mesh keeps the eager "
          f"block) and {ranks['attention']} by --ranks {d}'s")
    log(f"mesh train lm-100m: --mesh {shape} over {backend} ({d * m} "
        f"ranks, W = {d}), {MESH_TRAIN_STEPS} steps of batch "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: losses {losses}; unsharded on "
        f"the eager attention (--workers {d}) {eager['losses']} (largest "
        f"rtol {gap['eager']:.3g}); --ranks {d} on the fused attention "
        f"{ranks['losses']} (largest rtol {gap['ranks']:.3g}); bucket_acc "
        f"{mesh['launches']} launches, fused attention {mesh['attention']} "
        f"(--ranks {d}: {ranks['attention']}); ms per steady step (wall "
        f"clock, device drained) {mesh['ms_per_step']:.1f} (--ranks {d}: "
        f"{ranks['ms_per_step']:.1f}); largest peak on a rank "
        f"{mesh['peak_bytes']} bytes (--ranks {d}: {ranks['peak_bytes']}); "
        f"{mesh['seconds']:.1f} s and {ranks['seconds']:.1f} s with the "
        f"ranks' start")
    return {**res, "mesh": shape, "backend": backend, "runs": runs,
            "launches": mesh["launches"], "attention": mesh["attention"],
            "layout": mesh["layout"], "rtol": gap["eager"],
            "rtol_fused": gap["ranks"]}


def _multipod_dry_run(out_path):
    """MULTIPOD_ROW of the dry run in a process of its own (its fake
    process group of 512 ranks is the process's default group); writes
    the record and whether the process touched the card."""
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.launch import dryrun
    arch, shape, mesh, dv = MULTIPOD_ROW
    t0 = time.perf_counter()
    rec = dryrun.lower_mesh(arch, shape, mesh, dv)
    rec["wall_s"] = time.perf_counter() - t0
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    rec["cuda_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.cuda.is_initialized() else 0)
    with open(out_path, "w") as fh:
        json.dump(rec, fh)


def start_multipod_dry_run():
    """Start ``_multipod_dry_run`` (host work only), to overlap the card's
    phases; ``dryrun_phase`` joins it."""
    import multiprocessing
    out_dir = os.path.join(ROOT, "build", "chip_smoke_multipod")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "row.json")
    if os.path.exists(path):
        os.remove(path)
    proc = multiprocessing.get_context("spawn").Process(
        target=_multipod_dry_run, args=(path,))
    proc.start()
    return proc, path


# the kernel rows of ``python -m repro_torch.bench kernel``: every kernel of
# the kernels line has one (B3 three: out of place, hops 0 and 1)
BENCH_KERNEL_ROWS = ("b1_fused_memory_update", "b2_ring_sum", "worker_sum",
                     "b3_bucket_acc", "b3_hop0", "b3_hop1",
                     "b4_bucket_ring_sum", "b5_squant_encode",
                     "b6_squant_decode", "b6_squant_decode_narrow",
                     "b7_dequant_apply")


def _module_run(args, timeout):
    """``python -m <args>`` from the checkout, on the card; (seconds, the
    completed process)."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)
    return time.perf_counter() - t0, proc


def bench_phase():
    """``python -m repro_torch.bench --fast`` on the card: every suite
    passes, and every kernel row holds a device time from the CUDA
    trace."""
    import shutil
    out_dir = os.path.join(ROOT, "build", "chip_smoke_bench")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        secs, proc = _module_run(["repro_torch.bench", "--fast",
                                  "--out-dir", out_dir], 600)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    check(proc.returncode == 0, f"bench --fast exited {proc.returncode}: "
                                f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    # derived holds commas of its own: split each line at its first two
    rows = {r[0]: r for r in (ln.split(",", 2)
                              for ln in proc.stdout.splitlines())
            if len(r) == 3}
    kernel_us = {}
    for name in BENCH_KERNEL_ROWS:
        row = rows.get(f"kernel/{name}")
        check(row is not None and "device_us=" in row[2]
              and "device_us=not_measured" not in row[2],
              f"bench: kernel/{name} has no device time: {row}")
        kernel_us[name] = float(row[1])
        log(f"bench kernel/{name}: {row[1]} us; {row[2][:300]}")
    for name, row in rows.items():
        if not name.startswith("kernel/") and name != "name":
            log(f"bench {name}: {row[1]} us per call; {row[2][:200]}")
    log(f"bench --fast: {len(rows) - 1} rows in {secs:.1f} s, exit 0")
    return {"seconds": secs, "kernel_us": kernel_us, "rows": len(rows) - 1}


def analysis_phase():
    """``python -m repro_torch.analysis --ci`` on the card: exit 0; its
    host-sync findings (each suppressed by the port's baseline) listed."""
    out = os.path.join(ROOT, "build", "chip_smoke_analysis.json")
    try:
        secs, proc = _module_run(["repro_torch.analysis", "--ci", "-q",
                                  "--json", out], 600)
        with open(out) as fh:
            rep = json.load(fh)
    finally:
        if os.path.exists(out):
            os.remove(out)
    check(proc.returncode == 0, f"analysis --ci exited {proc.returncode}: "
                                f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    syncs = [f for f in rep["findings"] if f["rule"] == "host-sync"]
    for f in syncs:
        log(f"analysis host-sync: {f['path']}:{f['line']} {f['message']} "
            f"(suppressed: {f['suppressed']})")
    log(f"analysis --ci: {rep['counts']} in {secs:.1f} s, exit 0; "
        f"{len(syncs)} host-sync findings")
    return {"seconds": secs, "counts": rep["counts"],
            "host_syncs": len(syncs)}


def dryrun_phase(dev, serve_res, train_res, multipod):
    """The dry run on fake tensors of lm-100m's train step (phase 26's W,
    batch, sequence and optimizer) and starcoder2-7b's decode step at phase
    25's batch and 64-token cache: no device memory moves, and each peak
    estimate stands beside the measured one.  Then the multi-pod row
    (``MULTIPOD_ROW``, started with ``start_multipod_dry_run``): one
    rank's bytes, FLOPs and collective bytes by axis, its process never
    touching the card."""
    import torch
    from repro_torch.launch import dryrun
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    recs = {
        "lm-100m train": (dryrun.lower_one(
            "lm-100m", "train_4k", "artemis", workers=LM_TRAIN_W,
            batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, optimizer="adam"),
            train_res["peak_bytes"]),
        "starcoder2-7b decode": (dryrun.lower_one(
            "starcoder2-7b", "decode_32k", batch=LM_SERVE_B,
            seq=LM_SERVE_PROMPT + LM_SERVE_GEN),
            serve_res["starcoder2-7b"]["peak_bytes"])}
    secs = time.perf_counter() - t0
    check(torch.cuda.memory_allocated(dev) == before,
          "dry run: device memory moved")
    out = {}
    for name, (rec, measured) in recs.items():
        check(rec["status"] == "ok" and rec["peak_bytes"] > 0,
              f"dry run {name}: {rec}")
        out[name] = {"peak_bytes": rec["peak_bytes"], "measured": measured,
                     "ratio": rec["peak_bytes"] / measured,
                     "flops": rec["flops"], "dominant": rec["dominant"]}
        log(f"dry run {name}: peak estimate {rec['peak_bytes']} bytes "
            f"against the measured {measured} "
            f"(x{rec['peak_bytes'] / measured:.4f}); "
            f"{rec['flops']:.4g} FLOPs, params {rec['param_bytes']}, "
            f"optimizer {rec['optimizer_bytes']}, artemis "
            f"{rec['artemis_bytes']} bytes; compute {rec['compute_s']:.4g} s, "
            f"memory {rec['memory_s']:.4g} s, wire {rec['wire_s']:.4g} s "
            f"({rec['dominant']}); traced in {rec['trace_s']} s")
    proc, path = multipod
    t0 = time.perf_counter()
    proc.join(900)
    if proc.is_alive():
        proc.kill()
        proc.join()
    check(proc.exitcode == 0 and os.path.exists(path),
          f"dry run {MULTIPOD_ROW}: exit code {proc.exitcode}")
    with open(path) as fh:
        rec = json.load(fh)
    check(rec["status"] == "ok" and rec["param_bytes"] > 0
          and rec["artemis_bytes"] > 0 and "pod" in rec["coll_bytes"],
          f"dry run {MULTIPOD_ROW}: {rec}")
    check(not rec["cuda_initialized"] and rec["cuda_bytes"] == 0,
          f"dry run {MULTIPOD_ROW}: its process used the card")
    check(rec["attn_blocks"] == MULTIPOD_BLOCKS
          and rec["flops"] < MULTIPOD_REPLICATED_FLOPS,
          f"dry run {MULTIPOD_ROW}: attention blocks {rec['attn_blocks']} "
          f"(expected {MULTIPOD_BLOCKS}), {rec['flops']:.4g} FLOPs "
          f"(expected under {MULTIPOD_REPLICATED_FLOPS:.4g})")
    out["multipod"] = {k: rec[k] for k in (
        "param_bytes", "optimizer_bytes", "artemis_bytes", "peak_bytes",
        "flops", "bytes_accessed", "coll_bytes", "comm_counts", "compute_s",
        "memory_s", "collective_s", "dominant", "trace_s", "wall_s",
        "attn_blocks")}
    heads, kv, lanes = rec["attn_blocks"][0]
    log(f"dry run {' x '.join(MULTIPOD_ROW)}, one of 512 ranks: attention "
        f"{heads} query heads, {kv} KV heads and {lanes} head-dim lanes a "
        f"rank, {rec['flops']:.4g} FLOPs (all 36 heads a rank: "
        f"{MULTIPOD_REPLICATED_FLOPS:.4g}); params "
        f"{rec['param_bytes']}, optimizer {rec['optimizer_bytes']}, artemis "
        f"{rec['artemis_bytes']} bytes, peak estimate {rec['peak_bytes']} "
        f"bytes; {rec['flops']:.4g} FLOPs, {rec['bytes_accessed']:.4g} bytes "
        f"accessed; collective bytes by axis {json.dumps(rec['coll_bytes'])}"
        f"; compute {rec['compute_s']:.4g} s, memory {rec['memory_s']:.4g} "
        f"s, collective {rec['collective_s']:.4g} s ({rec['dominant']}); "
        f"traced in {rec['trace_s']} s (its process {rec['wall_s']:.1f} s, "
        f"{time.perf_counter() - t0:.1f} s waited for here); the card "
        f"untouched")
    log(f"dry run: {secs:.1f} s")
    return {"seconds": secs, **out}


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
              "src/repro/kernels/squant.py:104", MAIN_OPS),
        # no TPU kernel: the reference's attention is plain JAX
        dict(entry("flash_attention", "src/repro_torch/kernels/attention.py",
                   None, MAIN_ATTENTION), route="triton")]}


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
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.bucket_ring import bucket_acc, bucket_ring_sum
    from repro_torch.kernels.fused_memory import fused_memory_update
    from repro_torch.kernels.ring_sum import ring_sum, worker_sum
    from repro_torch.kernels.squant import (
        dequant_apply, squant_decode, squant_encode)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_identity()
    build_phase()
    multipod = start_multipod_dry_run()     # host work, beside the card's
    fused, ring, wsum = kernel_phase(dev)
    attn = attention_kernel_phase(dev)
    fault_fused, fault_ring = fault_kernel_phase(dev)
    lm_stacks = lm_ring_stacks(dev)
    acc, bsum = mesh_kernel_phase(dev, lm_stacks)
    ring_faults = fault_ring_kernel_phase(dev)
    codec_phase(dev)
    reset_launches()                    # the simulator's path starts here
    slice_res = slice_phase(dev)
    grid_res = grid_phase(dev)
    sim = {"fused_memory_update": fused_memory_update.launches,
           "ring_sum": ring_sum.launches, "worker_sum": worker_sum.launches}
    profile_clean = profile_phase(dev)
    reset_launches()                    # the simulator with telemetry
    t_tel = time.perf_counter()
    tel_res = telemetry_grid_phase(dev, grid_res)
    grid_res.pop("sweep")
    tel = {"fused_memory_update": fused_memory_update.launches,
           "ring_sum": ring_sum.launches, "worker_sum": worker_sum.launches}
    log(f"telemetry path launches: {json.dumps(tel)}")
    tel_secs = time.perf_counter() - t_tel
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
    launches = {k: sim[k] + flt[k] + tel[k] for k in sim}
    by_path = {k: {"simulator": sim[k], "faults": flt[k], "telemetry": tel[k]}
               for k in sim}

    def mesh_counts():
        return {"bucket_acc": bucket_acc.launches,
                "bucket_ring_sum": bucket_ring_sum.launches}

    reset_launches()                    # the mesh's path starts here
    t_mesh = time.perf_counter()
    mesh_res = mesh_phase(dev)
    wide_res = wide_phase(dev)
    mesh_l = mesh_counts()
    mesh_secs = time.perf_counter() - t_mesh
    reset_launches()                    # the leaf wire's path
    t_leaf = time.perf_counter()
    leaf_mesh_phase(dev)
    wide_leaf = wide_leaf_phase(dev)
    leaf_l = mesh_counts()
    check(leaf_l["bucket_acc"] > 0, f"the leaf path launched {leaf_l}")
    leaf_secs = time.perf_counter() - t_leaf
    reset_launches()                    # the mesh's fault path
    t_mflt = time.perf_counter()
    mesh_fault_phase(dev)
    wide_flt = wide_faulted_phase(dev, wide_res)
    mflt_l = mesh_counts()
    check(min(mflt_l.values()) > 0, f"the mesh's fault path launched "
                                     f"{mflt_l}")
    mflt_secs = time.perf_counter() - t_mflt
    t_pg = time.perf_counter()
    pg_res = pg_phase(dev)              # the ranks count their own launches
    pg_secs = time.perf_counter() - t_pg
    check(pg_res["launches"] > 0, "the pg ring launched bucket_acc 0 times")
    for k in ("bucket_acc", "bucket_ring_sum"):
        pg_k = pg_res["launches"] if k == "bucket_acc" else 0
        launches[k] = mesh_l[k] + leaf_l[k] + mflt_l[k] + pg_k
        by_path[k] = {"mesh": mesh_l[k], "leaf": leaf_l[k],
                      "mesh_faults": mflt_l[k], "pg_ring": pg_k}
    log(f"mesh paths launches: {json.dumps(by_path['bucket_acc'])} "
        f"bucket_acc, {json.dumps(by_path['bucket_ring_sum'])} "
        f"bucket_ring_sum")
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
    log(f"us per step, wide leaf artemis: {wide_leaf['us_per_step']:.1f} "
        f"({wide_leaf['device_ops_per_step']:.1f} device ops, device "
        f"{wide_leaf['device_us_per_step']:.1f} us); wide bucketed "
        f"{wide_res['us_per_step']:.1f} ({wide_res['device_ops_per_step']:.1f}"
        f" device ops, device {wide_res['device_us_per_step']:.1f} us); "
        f"wide faulted {wide_flt['us_per_step']:.1f} "
        f"({wide_flt['device_ops_per_step']:.1f} device ops)")
    log(f"us per step, pg ring (W = {PG_WORLD}, gloo): " + ", ".join(
        f"{c} {statistics.median(pg_res[c]['us_per_step']):.1f}"
        for c in PG_CASES) + f"; staged through the host: "
        f"{pg_res['pipelined']['staged']}")
    log(f"us per round per cell, telemetry grid: "
        f"{tel_res['us_per_round_cell']:.3f} against "
        f"{tel_res['clean_us_per_round_cell']:.3f}; device ops per round "
        f"{tel_res['profile']['device_ops_per_round']:.1f} against "
        f"{profile_clean['device_ops_per_round']:.1f}")
    obs_res = obs_smoke_phase()
    lm_secs, lm_l, lm_res, fa_l = {}, {}, {}, {}
    for name, phase in (
            ("lm_reduced", lm_reduced_phase),
            ("lm_serve", lm_serve_phase),
            ("lm_train", lm_train_phase),
            ("lm_remat", lambda d: lm_remat_phase(d, lm_res["lm_train"])),
            ("lm_pg_train", lm_pg_train_phase),
            ("lm_mesh_train", mesh_train_phase)):
        reset_launches()                # each LM path on its own
        t_lm = time.perf_counter()
        lm_res[name] = phase(dev)
        lm_secs[name] = time.perf_counter() - t_lm
        lm_l[name] = mesh_counts()
        fa_l[name] = flash_attention.launches
    # the ranks count their own launches
    for name in ("lm_pg_train", "lm_mesh_train"):
        lm_l[name]["bucket_acc"] = lm_res[name]["launches"]
        fa_l[name] = lm_res[name]["attention"]
    serve_res, train_res = lm_res["lm_serve"], lm_res["lm_train"]
    tool_res = {"dryrun": dryrun_phase(dev, serve_res, train_res, multipod),
                "bench": bench_phase(), "analysis": analysis_phase()}
    check(tuple([LM_TRAIN_W] + train_res["layout"]) == lm_stacks["train"],
          f"lm train: its stack {train_res['layout']} at W = {LM_TRAIN_W} "
          f"is not the one held to the plain hop, {lm_stacks['train']}")
    for name in ("lm_pg_train", "lm_mesh_train"):
        ranks_layout = lm_res[name]["layout"]
        check(tuple(ranks_layout) == lm_stacks["train"][1:],
              f"{name}: its ranks' stack {ranks_layout} is not the one "
              f"held to the plain out-of-place bucket_acc, "
              f"{lm_stacks['train'][1:]}")
    check(lm_l["lm_reduced"]["bucket_acc"] > 0
          and lm_l["lm_reduced"]["bucket_ring_sum"] > 0
          and min(lm_l[k]["bucket_acc"] for k in ("lm_train", "lm_remat",
                                                  "lm_pg_train",
                                                  "lm_mesh_train")) > 0,
          f"an LM path launched B3 or B4 0 times: {lm_l}")
    for k in ("bucket_acc", "bucket_ring_sum"):
        for name in lm_l:
            launches[k] += lm_l[name][k]
            by_path[k][name] = lm_l[name][k]
    log(f"lm paths launches: {json.dumps(lm_l)}")
    log(f"lm paths flash_attention launches: {json.dumps(fa_l)}")
    check(min(fa_l[k] for k in ("lm_train", "lm_remat", "lm_pg_train")) > 0,
          f"an LM train path launched the fused attention 0 times: {fa_l}")
    launches["flash_attention"] = sum(fa_l.values())
    by_path["flash_attention"] = fa_l
    for arch, res in serve_res.items():
        log(f"tok/s, lm serve {arch}: {res['tok_per_s']:.1f} "
            f"({res['ms_per_decode_step']:.3f} ms per decode step, peak "
            f"{res['peak_bytes']} bytes)")
    log(f"us per step, lm train lm-100m: {train_res['us_per_step']:.1f} "
        f"(busy share {_fmt_share(train_res['busy_share'])}, "
        f"{train_res['device_ops_per_step']:.1f} device ops, peak "
        f"{train_res['peak_bytes']} bytes)")
    remat_res = lm_res["lm_remat"]
    log(f"us per step, lm train lm-100m with remat: "
        f"{remat_res['us_per_step']:.1f} (peak {remat_res['peak_bytes']} "
        f"bytes, estimate {remat_res['estimate_bytes']}); falcon-mamba-7b "
        f"layer ms per step / peak bytes without and with remat: " + ", ".join(
            f"{f['ms_per_step']:.3f} / {f['peak_bytes']}"
            for f in remat_res["falcon"].values()))
    for arch, res in serve_res.items():
        chk = res["decode_vs_prefill"]
        if "flips" in chk:
            log(f"C5, lm serve {arch}: bf16 expert flips against prefill "
                f"{chk['flips']} of {chk['choices']} with cuBLAS's bf16 "
                f"reduction allowed ({chk['bf16_reduction_allowed']}), "
                f"{chk['flips_bf16_reduction_off']} with it forbidden, "
                f"{chk['flips_f32']} at f32 compute")
    log(f"fault phases {fault_secs:.1f} s; telemetry grid {tel_secs:.1f} s; "
        f"mesh phases {mesh_secs:.1f} s; leaf phases {leaf_secs:.1f} s; "
        f"mesh fault phases {mflt_secs:.1f} s; pg ring {pg_secs:.1f} s; "
        f"ops phases {ops_secs:.1f} s; obs smoke {obs_res['seconds']:.1f} s; "
        + "; ".join(f"{k.replace('_', ' ')} {v:.1f} s"
                    for k, v in lm_secs.items())
        + "; " + "; ".join(f"{k} {v['seconds']:.1f} s"
                           for k, v in tool_res.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")
    line = kernel_line(
        {"fused_memory_update": fused + fused_tiles, "ring_sum": ring,
         "worker_sum": wsum,
         "bucket_acc": acc, "bucket_ring_sum": bsum, "squant_encode": enc,
         "squant_decode": dec, "dequant_apply": app,
         "flash_attention": attn}, launches)
    for entry in line["kernels"]:
        if entry["name"] in by_path:
            entry["launches_by_path"] = by_path[entry["name"]]
        entry["fault_cases"] = {"fused_memory_update": [fault_fused],
                                "ring_sum": [fault_ring],
                                **ring_faults}.get(entry["name"], [])
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
