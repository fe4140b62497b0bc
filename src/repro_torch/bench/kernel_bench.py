"""The hand-written kernels at the main path's shapes (port of
``benchmarks/kernel_bench.py``).

On the card each row is one kernel of ``PERF.md``'s table: B1
``fused_memory_update`` on the round's rows, B2 ``ring_sum`` on the round's
strided view, ``worker_sum``, B3 ``bucket_acc`` (out of place, and the
ring's in-place hops 0 and 1), B4 ``bucket_ring_sum``, B5
``squant_encode``, B6 ``squant_decode`` (whole (256, 256) tiles and (256,
8) blocks, which take one element a thread) and B7 ``dequant_apply``; and,
in the ``kernel/attention_*`` rows, the fused attention's forward and
backward at the cells' shapes against their FLOP bound (989 TFLOP/s bf16), the eager route
they replace and torch's SDPA as a yardstick the port never calls.  The
row's value is the kernel's device µs per launch read from the
``torch.profiler`` CUDA trace (never host-inclusive); ``derived`` holds the
bound (the bytes the function must move, each input read once and each
output written once, at ``launch/roofline.HBM_BW``, 3.35 TB/s), the plain
version's device µs, and, where one PyTorch call computing the same
function runs as one kernel, that call's device µs.  Every kernel is first
held to its plain version on the same inputs.  Each row also says where
the calls find their inputs, as the main path finds them: B1, B2, B4 and
``worker_sum`` warm (one set of a few MB, L2-resident, as the simulator's
round calls them on the same buffers), B3 cold by size (hundreds of MB a
call); of the ops step's (``ops.compress``, ``ops.memory_update``,
``experiments.compressed_sgd_step``), which passes 25 leaves through each
call, B5's x and B7's w cold (each call takes the next of enough copies
to pass the 50 MB L2 four times over), and what the step wrote just
before warm: B5's uniforms and B7's levels and scales, drawn and encoded
before each call (``Case.prep``, whose kernels the row leaves out), and
B6's levels and scales, one set read by every call.  The three hold each
output for as many calls, as the step holds its leaves' outputs, so each
call writes to fresh addresses.  The reference's traffic rows
follow: B1 against the unfused encode, decode and update it replaces, and
the compression API's wire ratio.  ``b1_probe`` times B1 and B5 at the
probe [16384, 4096] (ROADMAP §B item 3).

On the CPU no kernel runs: each row times the plain version on the host
clock and says so; its value is never a kernel's.  At ``fast`` on the CPU
the shapes are cut to toy sizes; on the card they stay the main path's,
with fewer calls a trace.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.bench import Context, Row, device_trace, fmt, host_us
from repro_torch.kernels import ops
from repro_torch.kernels.bucket_ring import (
    bucket_acc, bucket_acc_hop_, bucket_acc_hop_plain_, bucket_acc_plain,
    bucket_ring_sum, bucket_ring_sum_plain)
from repro_torch.kernels.fused_memory import (
    fused_memory_update, fused_memory_update_plain)
from repro_torch.kernels.ring_sum import (
    ring_sum, ring_sum_plain, worker_sum, worker_sum_plain)
from repro_torch.kernels.squant import (
    dequant_apply, dequant_apply_plain, squant_decode, squant_decode_plain,
    squant_encode, squant_encode_plain)
from repro_torch.launch.roofline import HBM_BW

TILE = (256, 256)
# the main path's shapes (PERF.md's table): the grid's 128 cells of N = 20
# workers at d = 40, the mesh's W = 8 stacks, a ToyMLP(12, 1024) weight as
# the compression API packs it; and the probe
MAIN = {"b1": (2560, 40), "b2": (20, 128, 40), "wsum": (128, 20, 40),
        "b3": (128, 3076, 256), "hop": (8, 16, 3076, 256),
        "b4": (8, 16, 49, 64), "ops": (4096, 256), "narrow": (256, 8),
        "probe": (16384, 4096)}
# the CPU's smoke shapes (plain versions only)
TOY = {"b1": (64, 40), "b2": (4, 8, 40), "wsum": (8, 4, 40),
       "b3": (16, 12, 64), "hop": (4, 2, 12, 64), "b4": (4, 2, 7, 64),
       "ops": (512, 256), "narrow": (256, 8), "probe": (512, 512)}


L2_BYTES = 50e6            # the H100 SXM's L2
COLD_BYTES = 4 * L2_BYTES  # a cold input's copies together


@dataclasses.dataclass
class Case:
    name: str
    kernel: Callable
    plain: Callable
    bytes: float                    # each input read once, each output once
    library: Optional[Callable] = None
    library_name: str = ""
    # run before every call of kernel, plain version and library call: it
    # writes the inputs that the main path writes just before the call
    # (their kernels are left out of the row) and moves the cold ones on
    prep: Optional[Callable] = None
    keep: int = 0                   # calls an output is held for
    where: str = ""                 # where the calls find their inputs

    @property
    def inputs(self) -> str:
        """Where the calls find their inputs, for the row."""
        if self.where:
            return self.where
        if self.bytes > L2_BYTES:
            return (f"inputs cold: {self.bytes / 1e6:.0f} MB a call > the "
                    f"{L2_BYTES / 1e6:.0f} MB L2")
        return ("inputs warm: one set, L2-resident, as the simulator's "
                "round finds them")


def copies(ctx: Context, nbytes: float) -> int:
    """How many copies of a cold input of ``nbytes`` the calls rotate
    through: on the card enough to pass the L2 (``COLD_BYTES``), so a copy
    is evicted before its turn comes again; one on the CPU, which times
    the plain version alone."""
    return max(2, math.ceil(COLD_BYTES / nbytes)) if ctx.cuda else 1


def _cold(name: str, items: list) -> str:
    mb = sum(t.numel() * t.element_size() for t in items) / 1e6
    return (f"{name} cold: {len(items)} copies rotated, {mb:.0f} MB > the "
            f"{L2_BYTES / 1e6:.0f} MB L2; each output held for "
            f"{len(items)} calls, as the step holds its leaves'")


def _shapes(ctx: Context) -> Dict[str, tuple]:
    return TOY if ctx.fast and not ctx.cuda else MAIN


def _gen(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _payload(dev, shape, seed: int):
    g = _gen(dev, seed)
    q = torch.randint(-4, 5, shape, generator=g, device=dev,
                      dtype=torch.int8)
    return g, q, torch.rand(tuple(shape[:-1]) + (1,), generator=g,
                            device=dev)


def _tiles(shape, block) -> int:
    return (shape[0] // block[0]) * (shape[1] // block[1])


def _tile_views(shape, block):
    (m, n), (bm, bn) = shape, block
    return (m // bm, bm, n // bn, bn), (m // bm, 1, n // bn, 1)


def b1_case(dev, shape, seed: int, block=None) -> Case:
    rows, d = shape
    block = (1, d) if block is None else block
    g = _gen(dev, seed)
    gg, h = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    u = torch.rand(shape, generator=g, device=dev)
    n = gg.numel()
    # reads g, h, u, writes q (1 B) and h_new per element, a 4 B scale a tile
    return Case(f"fused_memory_update {list(shape)} in {tuple(block)}",
                lambda: fused_memory_update(gg, h, u, 0.25, s=1, block=block),
                lambda: fused_memory_update_plain(gg, h, u, 0.25, s=1,
                                                  block=block),
                17.0 * n + 4.0 * _tiles(shape, block))


def b2_case(dev, shape, seed: int) -> Case:
    n, m, c = shape
    g = _gen(dev, seed)
    # made [M, N, C] and passed transposed, as the Artemis round passes it
    q = torch.randint(-2, 3, (m, n, c), generator=g, device=dev,
                      dtype=torch.int8).transpose(0, 1)
    sc = torch.rand(m, n, 1, generator=g, device=dev).transpose(0, 1)
    return Case(f"ring_sum {list(shape)} strided",
                lambda: ring_sum(q, sc), lambda: ring_sum_plain(q, sc),
                n * m * c + 4.0 * n * m + 4.0 * m * c)


def wsum_case(dev, shape, seed: int) -> Case:
    x = torch.randn(shape, generator=_gen(dev, seed), device=dev)
    out = shape[0] * shape[2]
    return Case(f"worker_sum {list(shape)}", lambda: worker_sum(x),
                lambda: worker_sum_plain(x), 4.0 * x.numel() + 4.0 * out,
                lambda: torch.sum(x, dim=-2), "torch.sum")


def b3_case(dev, shape, seed: int) -> Case:
    g, q, sc = _payload(dev, shape, seed)
    acc = torch.randn(shape, generator=g, device=dev)
    n = q.numel()
    return Case(f"bucket_acc {list(shape)}",
                lambda: bucket_acc(acc, q, sc),
                lambda: bucket_acc_plain(acc, q, sc),
                9.0 * n + 4.0 * (n // shape[-1]),
                lambda: torch.addcmul(acc, q, sc), "torch.addcmul")


def hop_case(dev, shape, seed: int, hop: int) -> Case:
    _, q, sc = _payload(dev, shape, seed)
    acc = torch.zeros(shape, device=dev)
    ref = torch.zeros(shape, device=dev)
    n = q.numel()
    # hop 0 writes acc without reading it
    return Case(f"bucket_acc_hop_ {list(shape)} hop {hop}",
                lambda: bucket_acc_hop_(acc, q, sc, hop),
                lambda: bucket_acc_hop_plain_(ref, q, sc, hop),
                (9.0 if hop else 5.0) * n + 4.0 * (n // shape[-1]),
                lambda: ref.addcmul_(q, sc),
                "Tensor.addcmul_ (no worker offset)")


def b4_case(dev, shape, seed: int) -> Case:
    _, q, sc = _payload(dev, shape, seed)
    n = q.numel()
    return Case(f"bucket_ring_sum {list(shape)}",
                lambda: bucket_ring_sum(q, sc),
                lambda: bucket_ring_sum_plain(q, sc),
                n + 4.0 * (n // shape[-1]) + 4.0 * (n // shape[0]))


def b5_case(dev, shape, seed: int, n: int = 1) -> Case:
    """B5 on ``n`` copies of x, taken in turn; before each call the
    uniforms are drawn anew from a generator, as ``ops.encode`` draws
    them."""
    g = _gen(dev, seed)
    xs = [torch.randn(shape, generator=g, device=dev) for _ in range(n)]
    u = torch.empty(shape, device=dev)
    turn, at = itertools.count(), {}

    def prep():
        at["x"] = xs[next(turn) % n]
        u.uniform_(generator=g)

    return Case(f"squant_encode {list(shape)} in {TILE}",
                lambda: squant_encode(at["x"], u, s=1, block=TILE),
                lambda: squant_encode_plain(at["x"], u, s=1, block=TILE),
                9.0 * u.numel() + 4.0 * _tiles(shape, TILE), prep=prep,
                keep=n, where=(f"{_cold('x', xs)}; u warm, drawn before each call"
                       if n > 1 else ""))


def _encoded(dev, shape, seed: int, block):
    g = _gen(dev, seed)
    x = torch.randn(shape, generator=g, device=dev)
    u = torch.rand(shape, generator=g, device=dev)
    w = torch.randn(shape, generator=g, device=dev)
    q, sc = squant_encode_plain(x, u, s=1, block=block)
    return w, q, sc


def b6_case(dev, shape, seed: int, block=TILE, n: int = 1) -> Case:
    """B6 on one set of levels and scales, each output held for ``n``
    calls."""
    _, q, sc = _encoded(dev, shape, seed, block)
    qv, sv = _tile_views(shape, block)
    return Case(f"squant_decode {list(shape)} in {tuple(block)}",
                lambda: squant_decode(q, sc, block=block),
                lambda: squant_decode_plain(q, sc, block=block),
                5.0 * q.numel() + 4.0 * _tiles(shape, block),
                lambda: torch.mul(q.view(qv), sc.view(sv)), "torch.mul",
                keep=n, where=(
                    f"q and scales warm: one set, L2-resident, as the "
                    f"encode just before leaves them in ops.compress and "
                    f"ops.memory_update; each output held for {n} calls, "
                    f"as those hold their leaves'" if n > 1 else ""))


def b7_case(dev, shape, seed: int, n: int = 1) -> Case:
    """B7 on ``n`` copies of w, taken in turn; before each call the levels
    and scales are encoded anew (B5 on one x and u), as
    ``experiments.compressed_sgd_step`` encodes each leaf's gradient just
    before its apply."""
    g = _gen(dev, seed)
    x, u = torch.randn(shape, generator=g, device=dev), \
        torch.rand(shape, generator=g, device=dev)
    ws = [torch.randn(shape, generator=g, device=dev) for _ in range(n)]
    qv, sv = _tile_views(shape, TILE)
    turn, at = itertools.count(), {}

    def prep():
        at["w"] = ws[next(turn) % n]
        at["q"], at["sc"] = squant_encode(x, u, s=1, block=TILE)

    return Case(f"dequant_apply {list(shape)} in {TILE}",
                lambda: dequant_apply(at["w"], at["q"], at["sc"], 0.01,
                                      block=TILE),
                lambda: dequant_apply_plain(at["w"], at["q"], at["sc"], 0.01,
                                            block=TILE),
                9.0 * x.numel() + 4.0 * _tiles(shape, TILE),
                lambda: torch.addcmul(at["w"].view(qv), at["q"].view(qv),
                                      at["sc"].view(sv), value=-0.01),
                "torch.addcmul", prep=prep, keep=n,
                where=(f"{_cold('w', ws)}; q and scales warm, encoded "
                       f"before each call" if n > 1 else ""))


def _agrees(out, ref) -> Tuple[bool, float]:
    """(agree, max abs difference of the float outputs): int8 levels off by
    at most one on fewer than 1e-4 of the entries (the fused quantizers'
    norm order), floats to rtol 1e-5 / atol 1e-6; bit for bit where the
    kernels are (every other kernel gives the plain version's bits)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    ok, err = True, 0.0
    for a, b in zip(outs, refs):
        if a.dtype == torch.int8:
            d = (a.to(torch.int32) - b.to(torch.int32)).abs()
            ok &= bool(d.max() <= 1) and float((d != 0).float().mean()) < 1e-4
        else:
            err = max(err, float((a.float() - b.float()).abs().max()))
            ok &= torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-6)
    return ok, err


def _one_kernel_us(fn: Callable, calls: int,
                   skip=frozenset()) -> Optional[float]:
    """Device µs of one PyTorch call, where it runs as one kernel (the
    kernels named in ``skip`` left out)."""
    us, per_call, names = device_trace(fn, calls, skip=skip)
    return us if per_call == 1 and len(names) == 1 else None


def measure(case: Case, ctx: Context) -> Tuple[float, str]:
    """(row value, derived) of one case."""
    bound_us = case.bytes / HBM_BW * 1e6
    if case.prep is not None:
        case.prep()
    if not ctx.cuda:
        plain = host_us(case.plain, ctx.device, reps=1 if ctx.fast else 5)
        return plain, (f"device=cpu: plain version only, no kernel runs on "
                       f"the CPU; plain_host_us={plain:.1f} "
                       f"h100_bound_us={bound_us:.3f}")
    ok, err = _agrees(case.kernel(), case.plain())
    if not ok:
        raise AssertionError(f"{case.name}: the kernel differs from its "
                             f"plain version by {err}")
    calls = 5 if ctx.fast else 25
    skip, left_out = frozenset(), ""
    if case.prep is not None:
        skip = frozenset(device_trace(case.prep, calls)[2])
        left_out = f"; left out, the inputs' kernels {sorted(skip)}"

    def timed(fn):
        if case.prep is None and not case.keep:
            return fn
        held = collections.deque(maxlen=max(case.keep, 1))

        def call():
            if case.prep is not None:
                case.prep()
            held.append(fn())
        return call

    us, per_call, names = device_trace(timed(case.kernel), calls, skip=skip)
    plain_us = device_trace(timed(case.plain), calls, skip=skip)[0]
    lib_us = (None if case.library is None
              else _one_kernel_us(timed(case.library), calls, skip))
    lib = (f" library_us={fmt(lib_us)} ({case.library_name})"
           if case.library is not None else " library_us=none")
    derived = (f"device_us={fmt(us)} (torch.profiler CUDA trace, "
               f"{per_call:g} kernels a call {names}) bound_us="
               f"{bound_us:.3f} (bytes at {HBM_BW / 1e12:.2f} TB/s) "
               f"plain_us={fmt(plain_us)}{lib} max_abs_err={err:.3g}; "
               f"{case.inputs}{left_out}")
    return (float("nan") if us is None else us), derived


def _rows(cases: List[Tuple[str, Case]], ctx: Context) -> List[Row]:
    out = []
    for label, case in cases:
        value, derived = measure(case, ctx)
        out.append((f"kernel/{label}", value, f"{case.name}: {derived}"))
    return out


def kernel_suite(ctx: Context) -> List[Row]:
    dev, sh = ctx.device, _shapes(ctx)
    n = copies(ctx, 4.0 * math.prod(sh["ops"]))     # an f32 leaf's copies
    cases = [("b1_fused_memory_update", b1_case(dev, sh["b1"], 0)),
             ("b2_ring_sum", b2_case(dev, sh["b2"], 1)),
             ("worker_sum", wsum_case(dev, sh["wsum"], 2)),
             ("b3_bucket_acc", b3_case(dev, sh["b3"], 3)),
             ("b3_hop0", hop_case(dev, sh["hop"], 4, 0)),
             ("b3_hop1", hop_case(dev, sh["hop"], 4, 1)),
             ("b4_bucket_ring_sum", b4_case(dev, sh["b4"], 5)),
             ("b5_squant_encode", b5_case(dev, sh["ops"], 6, n=n)),
             ("b6_squant_decode", b6_case(dev, sh["ops"], 7, n=n)),
             ("b6_squant_decode_narrow",
              b6_case(dev, sh["ops"], 8, block=sh["narrow"], n=n)),
             ("b7_dequant_apply", b7_case(dev, sh["ops"], 9, n=n))]
    rows = _rows(cases, ctx)
    rows += traffic_rows(ctx, sh["ops"])
    return rows + attention_rows(ctx)


def traffic_rows(ctx: Context, shape) -> List[Row]:
    """B1 on (256, 256) tiles against the pipeline it fuses (encode g - h,
    decode, h + alpha * decoded), and the compression API's wire ratio."""
    dev = ctx.device
    g0 = _gen(dev, 10)
    g, h = (torch.randn(shape, generator=g0, device=dev) for _ in range(2))
    u = torch.rand(shape, generator=g0, device=dev)

    def fused():
        return fused_memory_update(g, h, u, 0.25, s=1, block=TILE)

    def unfused():
        q, sc = squant_encode(g - h, u, s=1, block=TILE)
        return h + 0.25 * squant_decode(q, sc, block=TILE)

    calls = 5 if ctx.fast else 25
    if ctx.cuda:
        f_us, u_us = (device_trace(fn, calls)[0] for fn in (fused, unfused))
        where = "device_us from the torch.profiler CUDA trace"
    else:
        f_us, u_us = (host_us(fn, dev, reps=1) for fn in (fused, unfused))
        where = "device=cpu: plain versions only, host clock"
    c, _ = ops.encode(g, u, s=1)
    ratio = 4.0 * g.numel() / c.wire_bytes
    share = None if not (f_us and u_us) else f_us / u_us
    return [
        ("kernel/fused_memory", float("nan") if f_us is None else f_us,
         f"{list(shape)} in {TILE}: {where}; hbm_passes fused=3r2w vs "
         f"unfused=7r3w (1.67x less traffic)"),
        ("kernel/unfused_memory", float("nan") if u_us is None else u_us,
         f"encode(g - h) + decode + h update, the reference pipeline: "
         f"{where}; fused/unfused={fmt(share)}"),
        ("kernel/wire_ratio", 0.0, f"fp32_bytes/wire_bytes={ratio:.2f}")]


def b1_probe(ctx: Context) -> List[Row]:
    """B1 and B5 at the probe [16384, 4096] on (256, 256) tiles."""
    dev, shape = ctx.device, _shapes(ctx)["probe"]
    return _rows([("b1_probe", b1_case(dev, shape, 11, block=TILE)),
                  ("b5_probe", b5_case(dev, shape, 12))], ctx)


# the fused attention at the cells' shapes: name -> (b, sq, sk, heads, kv
# heads, head dim, causal); the CPU's toy shapes keep the ragged edges
ATTENTION = {
    "whisper_encoder": (40, 1500, 1500, 6, 6, 64, False),
    "whisper_decoder": (40, 448, 448, 6, 6, 64, True),
    "whisper_cross": (40, 448, 1500, 6, 6, 64, False),
    "starcoder2_causal_gqa": (4, 4096, 4096, 36, 4, 128, True)}
ATTENTION_TOY = {
    "whisper_encoder": (2, 150, 150, 2, 2, 64, False),
    "whisper_decoder": (2, 45, 45, 2, 2, 64, True),
    "whisper_cross": (2, 45, 150, 2, 2, 64, False),
    "starcoder2_causal_gqa": (1, 130, 130, 4, 2, 128, True)}
PEAK_BF16 = 989e12         # the H100 SXM's dense bf16 tensor cores


def _attention_operands(dev, shape, seed: int):
    """(the kernel's arguments, dO, forward FLOPs over the unmasked
    pairs)."""
    b, sq, sk, h, kv, d, causal = shape
    g = _gen(dev, seed)
    q, do = (torch.randn(b, sq, h, d, generator=g, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, sk, kv, d, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    qp = torch.arange(sq, dtype=torch.int32, device=dev)[None].expand(b, sq)
    kp = torch.arange(sk, dtype=torch.int32, device=dev)[None].expand(b, sk)
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return (q, k, v, qp, kp, d ** -0.5, 0, causal), do, \
        4.0 * b * h * d * pairs


def attention_plain_error(args, do) -> float:
    """The kernel's out, dq, dk and dv against its plain version's, the
    largest difference over each one's largest entry, on the first batch
    row and KV group (the plain version holds the dense scores: the whole
    of starcoder2's would not fit beside the rest)."""
    from repro_torch.kernels import attention as FA
    q, k, v, qp, kp, scale, window, causal = args
    rep = q.shape[2] // k.shape[2]
    one = (q[:1, :, :rep], k[:1, :, :1], v[:1, :, :1], qp[:1], kp[:1])
    rest, dgo = (scale, window, causal), do[:1, :, :rep]
    o, lse = FA._forward(*one, *rest)
    po, plse = FA.forward_plain(*one, *rest)
    mine = (o,) + FA._backward(dgo, *one, o, lse, *rest)
    ref = (po,) + FA.backward_plain(dgo, *one, po, plse, *rest)
    return max(float((a.float() - r.float()).abs().max()
                     / r.float().abs().max()) for a, r in zip(mine, ref))


def _graph(fn, leaves):
    """``fn`` run once on fresh leaves: (output, leaves), for timing the
    backward alone on the kept graph."""
    leaves = [t.detach().requires_grad_() for t in leaves]
    return fn(*leaves), leaves


def attention_calls(args, do):
    """{part: {kernel, eager, library: (set-up, call)}}: the kernel's
    forward and backward, the eager route they replace (``layers.attention``
    in query chunks of 512, as the parent step ran) and torch's SDPA as the
    yardstick (the port never calls it).  A backward's set-up builds the
    graph it pulls through (dropped when the next set-up runs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention as FA
    from repro_torch.models import layers as L
    q, k, v, qp, kp, scale, window, causal = args
    rep = q.shape[2] // k.shape[2]

    def eager(q, k, v):
        return L.attention(q, k, v, qp, kp, causal=causal, q_chunk=512)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, scale=scale, enable_gqa=rep > 1).transpose(1, 2)

    held = {}

    def graph(fn):
        def setup():
            held.clear()
            held["out"], held["leaves"] = _graph(fn, (q, k, v))
        return setup

    def pull():
        return torch.autograd.grad(held["out"], held["leaves"], do,
                                   retain_graph=True)

    def kernel_setup():
        held.clear()
        held["o"], held["lse"] = FA._forward(*args)

    def kernel_backward():
        return FA._backward(do, *args[:5], held["o"], held["lse"], *args[5:])

    none = held.clear
    return {
        "forward": {"kernel": (none, lambda: FA._forward(*args)),
                    "eager": (none, lambda: eager(q, k, v)),
                    "library": (none, lambda: sdpa(q, k, v))},
        "backward": {"kernel": (kernel_setup, kernel_backward),
                     "eager": (graph(eager), pull),
                     "library": (graph(sdpa), pull)}}


def _attention_rows(label, shape, ctx: Context, seed: int) -> List[Row]:
    """The kernel's forward and backward against their FLOP bound, the
    eager route and SDPA (``attention_calls``)."""
    dev = ctx.device
    args, do, flops = _attention_operands(dev, shape, seed)
    calls = attention_calls(args, do)
    causal = args[-1]
    err = attention_plain_error(args, do) if ctx.cuda else None
    if err is not None and err > 1e-2:
        raise AssertionError(f"attention {label}: the kernel differs from "
                             f"its plain version by {err} of the largest "
                             f"entry")
    rows = []
    for part, ops_ in (("forward", flops), ("backward", 2.5 * flops)):
        bound_us = ops_ / PEAK_BF16 * 1e6
        name = (f"attention {part} {label} [{shape[0]}, {shape[1]}x"
                f"{shape[2]}, {shape[3]}/{shape[4]} heads, {shape[5]}]"
                f"{' causal' if causal else ''}")
        if not ctx.cuda:
            setup, fn = calls[part]["eager"]
            setup()
            plain = host_us(fn, dev, reps=1 if ctx.fast else 3)
            rows.append((f"kernel/attention_{part}_{label}", plain,
                         f"{name}: device=cpu: the eager route only, no "
                         f"kernel runs on the CPU; plain_host_us={plain:.1f}"
                         f" h100_bound_us={bound_us:.3f}"))
            continue
        n = 3 if ctx.fast else 10
        times = {}
        for who, (setup, fn) in calls[part].items():
            setup()
            times[who] = device_trace(fn, n)
        us, per_call, names = times["kernel"]
        share = None if not us else 100.0 * bound_us / us
        rows.append((
            f"kernel/attention_{part}_{label}",
            float("nan") if us is None else us,
            f"{name}: device_us={fmt(us)} (torch.profiler CUDA trace, "
            f"{per_call:g} kernels a call {names}) bound_us={bound_us:.3f} "
            f"({ops_:.4g} FLOPs at {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16) "
            f"roofline_share={fmt(share, 1)}% eager_us="
            f"{fmt(times['eager'][0])} (layers.attention in chunks of 512) "
            f"library_us={fmt(times['library'][0])} (torch SDPA, yardstick "
            f"only) max_rel_err={err:.3g} (one batch row and KV group); "
            f"inputs warm"))
    calls.clear()
    return rows


def attention_rows(ctx: Context) -> List[Row]:
    shapes = ATTENTION_TOY if ctx.fast and not ctx.cuda else ATTENTION
    rows = []
    for i, (label, shape) in enumerate(shapes.items()):
        rows += _attention_rows(label, shape, ctx, 20 + i)
    return rows


SUITES = [("kernel", kernel_suite), ("kernel/b1_probe", b1_probe)]
