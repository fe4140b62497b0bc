"""Fused attention, forward and backward, for the card: the S x S scores
never reach device memory.

``flash_attention(q, k, v, q_pos, k_pos, scale=, window=, causal=)`` is the
function of ``models/layers.py::_attn_block`` (grouped-query attention
under the position mask ``mask``, the softmax in float32) on the
training route, where ``layers.attention`` takes it (``fused_route``).  It
replaces no TPU kernel: the reference's attention
(``repro/models/layers.py::attention``) is plain JAX, which XLA fuses on
the TPU; on the card the eager ops wrote the whole score matrix to device
memory several times, in f32, and remat's recompute wrote it again.

Design (FlashAttention-2, Triton, built at the first launch):

* Forward: one program per (query tile, batch x query head) loops over
  the K/V tiles with the running max and sum in f32 (the online softmax,
  in base 2: the scale times log2(e) is folded into the scores).  The
  scores come from the first product in f32, never rounded to bf16; the
  probabilities are cast to the value type for the PV product, as
  ``_attn_block`` casts its.  The output is the input type; the row
  log-sum-exp (base 2) is kept in f32 for the backward.
* Backward: one program per (query tile, batch x query head) computes
  dQ and, first, D = rowsum(dO * O) in f32 for its rows, which it writes
  out.  Then one program per (K/V tile, batch x KV head) loops over that
  KV head's ``rep`` query heads and the query tiles, so GQA's sum over
  query heads happens inside it: no atomics, the same bits on every run.
  P is recomputed from the log-sum-exp; dS stays in f32 and is cast to
  the input type for its two products.
* The mask is ``mask``'s, from ``q_pos`` and ``k_pos`` loaded with each
  tile: causal (q >= k), the window (q - k < window) and, without causal,
  the empty-slot sentinel.  Ragged edges (whisper's 1500 and 448) are
  masked in the kernel.
* Tile skipping: each program first scans the other side's tiles for the
  extremes of their positions and runs its main loop only from the first
  to the last tile in which some pair is unmasked (causal: max q >= min
  k; the window: min q - max k < window; the sentinel: min k below it).
  This is exact for any positions: a fully masked tile inside the range
  adds exactly 0 (its scores sit at -1e30, so its p is 0 and the running
  max and sum keep their values).
* The caller guarantees every query row keeps at least one key (no
  cache: the diagonal, or every frame); a row with none is undefined
  here (NaN, or an average over masked keys), where ``_attn_block``
  spreads it evenly over every key.

Bound on an H100 SXM: operations (4 * B * H * Sq * Sk * D a forward over
the unmasked pairs, 2.5 times that a backward, at 989 TFLOP/s in bf16);
the bytes are q, k, v, o and their gradients, read and written once or a
few times per tile row, far below the products' time at these shapes.  One
tile configuration for head dim 64 and one for 128 (``CONFIGS``), chosen
on the card (PERF.md) and fixed: no run-time autotuning, so set-up
compiles each kernel once a shape class.

Binding: two ``autograd.Function``s (the forward and the backward launch),
each with ``setup_context`` and a ``vmap`` rule that folds the vmapped
dim into the batch dim (a view where the input allows it), so the launch
runs under ``torch.func.vmap(grad_and_value)`` (the simulated workers)
and remat's ``torch.func.vjp`` alike.  Positions may hold fewer rows than
the batch: batch row b reads position row b mod rows.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (``forward_plain``, ``backward_plain``), which repeat the
kernels' arithmetic densely.  ``flash_attention.launches`` counts kernel
launches: 1 a forward, 2 a backward.
"""
from __future__ import annotations

import math

import torch

INVALID_POS = 2**31 // 2 - 1       # int32 max // 2: an empty cache slot
LOG2E = math.log2(math.e)
_MASKED = -1.0e30                  # a masked score, in base 2

# head dim -> {kernel: (BLOCK_M, BLOCK_N, num_warps, num_stages)}; BLOCK_M
# runs over query rows, BLOCK_N over key rows.  Each the fastest of six or
# seven candidates on the H100 (700 W) at the cells' shapes: 64 over
# whisper-tiny's encoder, decoder and cross attention at 40 rows, 128 over
# starcoder2-7b's causal GQA at 4 x 4096 (PERF.md)
CONFIGS = {
    64: {"fwd": (128, 64, 4, 3), "dkdv": (32, 128, 4, 3),
         "dq": (128, 64, 4, 3)},
    128: {"fwd": (128, 32, 4, 4), "dkdv": (32, 64, 4, 3),
          "dq": (128, 64, 8, 3)},
}

_KERNELS = {}


def mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
         causal: bool) -> torch.Tensor:
    """[B, Sq, Sk] mask from q_pos [B, Sq], k_pos [B, Sk]: causal, and
    |q - k| < window when window > 0 (``layers._attn_block``'s; the
    kernels apply the same rule a tile at a time)."""
    if causal:
        m = q_pos[:, :, None] >= k_pos[:, None, :]
    else:
        # still exclude invalid (sentinel-position) cache slots
        m = (k_pos[:, None, :] < INVALID_POS).expand(
            q_pos.shape[0], q_pos.shape[1], k_pos.shape[1])
    if window > 0:
        m = m & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    return m


def _kernels():
    """The Triton kernels, defined at the first launch (importing this
    module imports no ``triton``: the CPU has none).  The import binds
    ``triton`` and ``tl`` as module globals, where Triton resolves the
    names a kernel and the functions it calls use."""
    global triton, tl
    if _KERNELS:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _pos(ptr, idx, n, stride):
        """Positions at ``idx`` (masked past ``n``) and their extremes."""
        ok = idx < n
        p = tl.load(ptr + idx * stride, mask=ok, other=0).to(tl.int32)
        lo = tl.min(tl.where(ok, p, 2147483647), 0)
        hi = tl.max(tl.where(ok, p, -2147483647), 0)
        return p, lo, hi

    @triton.jit
    def _live(qlo, qhi, klo, khi, window, CAUSAL: tl.constexpr,
              WINDOWED: tl.constexpr):
        """Some pair of the two tiles is unmasked (exact for a tile that
        fails: every pair is masked)."""
        if CAUSAL:
            ok = qhi >= klo
        else:
            ok = klo < 1073741823
        if WINDOWED:
            ok = ok & (qlo - khi < window)
        return ok

    @triton.jit
    def _keep(qp, kp, window, CAUSAL: tl.constexpr, WINDOWED: tl.constexpr):
        """``mask`` on broadcast positions."""
        if CAUSAL:
            ok = qp >= kp
        else:
            ok = (kp < 1073741823) & (qp == qp)
        if WINDOWED:
            ok = ok & (qp - kp < window)
        return ok

    @triton.jit
    def _range(pos_ptr, n, stride, other_lo, other_hi, window,
               KEYS: tl.constexpr, CAUSAL: tl.constexpr,
               WINDOWED: tl.constexpr, BLOCK: tl.constexpr):
        """[lo, hi): the first and past the last tile of positions
        ``pos_ptr[0:n]`` (tiles of BLOCK) with an unmasked pair against the
        other side's extremes; ``KEYS``: the tiles are key tiles."""
        n_tiles = tl.cdiv(n, BLOCK)
        lo = n_tiles + 0
        hi = n_tiles * 0
        idx = tl.arange(0, BLOCK)
        for t in range(0, n_tiles):
            _, tlo, thi = _pos(pos_ptr, t * BLOCK + idx, n, stride)
            if KEYS:
                ok = _live(other_lo, other_hi, tlo, thi, window, CAUSAL,
                           WINDOWED)
            else:
                ok = _live(tlo, thi, other_lo, other_hi, window, CAUSAL,
                           WINDOWED)
            lo = tl.minimum(lo, tl.where(ok, t, n_tiles))
            hi = tl.maximum(hi, tl.where(ok, t + 1, 0))
        return lo, hi

    @triton.jit
    def fwd(Q, K, V, QP, KP, O, LSE,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            o_sb, o_ss, o_sh, qp_sb, qp_ss, qp_rows, kp_sb, kp_ss, kp_rows,
            H, REP, SQ, SK, scale2, window,
            CAUSAL: tl.constexpr, WINDOWED: tl.constexpr, D: tl.constexpr,
            BM: tl.constexpr, BN: tl.constexpr):
        pid_m = tl.program_id(0)
        bh = tl.program_id(1)
        b = bh // H
        h = bh % H
        kvh = h // REP
        rows = pid_m * BM + tl.arange(0, BM)
        cols = tl.arange(0, BN)
        dims = tl.arange(0, D)
        row_ok = rows < SQ
        qp, qlo, qhi = _pos(QP + (b % qp_rows) * qp_sb, rows, SQ, qp_ss)
        kp_ptr = KP + (b % kp_rows) * kp_sb
        lo, hi = _range(kp_ptr, SK, kp_ss, qlo, qhi, window, True, CAUSAL,
                        WINDOWED, BN)
        q = tl.load(Q + b * q_sb + h * q_sh + rows[:, None] * q_ss
                    + dims[None, :], mask=row_ok[:, None], other=0.0)
        k_ptr = K + b * k_sb + kvh * k_sh
        v_ptr = V + b * v_sb + kvh * v_sh
        m_i = tl.full([BM], float("-inf"), tl.float32)
        l_i = tl.zeros([BM], tl.float32)
        acc = tl.zeros([BM, D], tl.float32)
        for t in range(lo, hi):
            c = t * BN + cols
            c_ok = c < SK
            kp = tl.load(kp_ptr + c * kp_ss, mask=c_ok, other=0).to(tl.int32)
            k = tl.load(k_ptr + c[:, None] * k_ss + dims[None, :],
                        mask=c_ok[:, None], other=0.0)
            s = tl.dot(q, tl.trans(k)) * scale2
            keep = c_ok[None, :] & _keep(qp[:, None], kp[None, :], window,
                                         CAUSAL, WINDOWED)
            s = tl.where(keep, s, -1.0e30)
            m_new = tl.maximum(m_i, tl.max(s, 1))
            alpha = tl.exp2(m_i - m_new)
            p = tl.exp2(s - m_new[:, None])
            l_i = l_i * alpha + tl.sum(p, 1)
            v = tl.load(v_ptr + c[:, None] * v_ss + dims[None, :],
                        mask=c_ok[:, None], other=0.0)
            acc = acc * alpha[:, None] + tl.dot(p.to(v.dtype), v)
            m_i = m_new
        out = acc / l_i[:, None]
        tl.store(O + b * o_sb + h * o_sh + rows[:, None] * o_ss
                 + dims[None, :], out.to(O.dtype.element_ty),
                 mask=row_ok[:, None])
        tl.store(LSE + bh * SQ + rows, m_i + tl.log2(l_i), mask=row_ok)

    @triton.jit
    def dkdv(Q, K, V, DO, LSE, DELTA, DK, DV, QP, KP,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             do_sb, do_ss, do_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh,
             qp_sb, qp_ss, qp_rows, kp_sb, kp_ss, kp_rows,
             H, REP, SQ, SK, scale2, scale, window,
             CAUSAL: tl.constexpr, WINDOWED: tl.constexpr, D: tl.constexpr,
             BM: tl.constexpr, BN: tl.constexpr):
        pid_n = tl.program_id(0)
        bk = tl.program_id(1)
        kvs = H // REP
        b = bk // kvs
        kvh = bk % kvs
        cols = pid_n * BN + tl.arange(0, BN)
        rows0 = tl.arange(0, BM)
        dims = tl.arange(0, D)
        c_ok = cols < SK
        kp, klo, khi = _pos(KP + (b % kp_rows) * kp_sb, cols, SK, kp_ss)
        qp_ptr = QP + (b % qp_rows) * qp_sb
        lo, hi = _range(qp_ptr, SQ, qp_ss, klo, khi, window, False, CAUSAL,
                        WINDOWED, BM)
        k = tl.load(K + b * k_sb + kvh * k_sh + cols[:, None] * k_ss
                    + dims[None, :], mask=c_ok[:, None], other=0.0)
        v = tl.load(V + b * v_sb + kvh * v_sh + cols[:, None] * v_ss
                    + dims[None, :], mask=c_ok[:, None], other=0.0)
        dk = tl.zeros([BN, D], tl.float32)
        dv = tl.zeros([BN, D], tl.float32)
        for r in range(0, REP):
            h = kvh * REP + r
            q_ptr = Q + b * q_sb + h * q_sh
            do_ptr = DO + b * do_sb + h * do_sh
            stat = (b * H + h) * SQ
            for t in range(lo, hi):
                rows = t * BM + rows0
                r_ok = rows < SQ
                qp = tl.load(qp_ptr + rows * qp_ss, mask=r_ok,
                             other=0).to(tl.int32)
                q = tl.load(q_ptr + rows[:, None] * q_ss + dims[None, :],
                            mask=r_ok[:, None], other=0.0)
                do = tl.load(do_ptr + rows[:, None] * do_ss + dims[None, :],
                             mask=r_ok[:, None], other=0.0)
                lse = tl.load(LSE + stat + rows, mask=r_ok, other=0.0)
                delta = tl.load(DELTA + stat + rows, mask=r_ok, other=0.0)
                s_t = tl.dot(k, tl.trans(q)) * scale2          # [BN, BM]
                keep = (c_ok[:, None] & r_ok[None, :]
                        & _keep(qp[None, :], kp[:, None], window, CAUSAL,
                                WINDOWED))
                p_t = tl.where(keep, tl.exp2(s_t - lse[None, :]), 0.0)
                dv += tl.dot(p_t.to(do.dtype), do)
                dp_t = tl.dot(v, tl.trans(do))
                ds_t = p_t * (dp_t - delta[None, :])
                dk += tl.dot(ds_t.to(q.dtype), q)
        tl.store(DK + b * dk_sb + kvh * dk_sh + cols[:, None] * dk_ss
                 + dims[None, :], (dk * scale).to(DK.dtype.element_ty),
                 mask=c_ok[:, None])
        tl.store(DV + b * dv_sb + kvh * dv_sh + cols[:, None] * dv_ss
                 + dims[None, :], dv.to(DV.dtype.element_ty),
                 mask=c_ok[:, None])

    @triton.jit
    def dq(Q, K, V, O, DO, LSE, DELTA, DQ, QP, KP,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           do_sb, do_ss, do_sh, o_sb, o_ss, o_sh, dq_sb, dq_ss, dq_sh,
           qp_sb, qp_ss, qp_rows, kp_sb, kp_ss, kp_rows,
           H, REP, SQ, SK, scale2, scale, window,
           CAUSAL: tl.constexpr, WINDOWED: tl.constexpr, D: tl.constexpr,
           BM: tl.constexpr, BN: tl.constexpr):
        pid_m = tl.program_id(0)
        bh = tl.program_id(1)
        b = bh // H
        h = bh % H
        kvh = h // REP
        rows = pid_m * BM + tl.arange(0, BM)
        cols = tl.arange(0, BN)
        dims = tl.arange(0, D)
        row_ok = rows < SQ
        qp, qlo, qhi = _pos(QP + (b % qp_rows) * qp_sb, rows, SQ, qp_ss)
        kp_ptr = KP + (b % kp_rows) * kp_sb
        lo, hi = _range(kp_ptr, SK, kp_ss, qlo, qhi, window, True, CAUSAL,
                        WINDOWED, BN)
        q = tl.load(Q + b * q_sb + h * q_sh + rows[:, None] * q_ss
                    + dims[None, :], mask=row_ok[:, None], other=0.0)
        do = tl.load(DO + b * do_sb + h * do_sh + rows[:, None] * do_ss
                     + dims[None, :], mask=row_ok[:, None], other=0.0)
        lse = tl.load(LSE + bh * SQ + rows, mask=row_ok, other=0.0)
        o = tl.load(O + b * o_sb + h * o_sh + rows[:, None] * o_ss
                    + dims[None, :], mask=row_ok[:, None], other=0.0)
        delta = tl.sum(o.to(tl.float32) * do.to(tl.float32), 1)
        tl.store(DELTA + bh * SQ + rows, delta, mask=row_ok)
        k_ptr = K + b * k_sb + kvh * k_sh
        v_ptr = V + b * v_sb + kvh * v_sh
        acc = tl.zeros([BM, D], tl.float32)
        for t in range(lo, hi):
            c = t * BN + cols
            c_ok = c < SK
            kp = tl.load(kp_ptr + c * kp_ss, mask=c_ok, other=0).to(tl.int32)
            k = tl.load(k_ptr + c[:, None] * k_ss + dims[None, :],
                        mask=c_ok[:, None], other=0.0)
            v = tl.load(v_ptr + c[:, None] * v_ss + dims[None, :],
                        mask=c_ok[:, None], other=0.0)
            s = tl.dot(q, tl.trans(k)) * scale2
            keep = (row_ok[:, None] & c_ok[None, :]
                    & _keep(qp[:, None], kp[None, :], window, CAUSAL,
                            WINDOWED))
            p = tl.where(keep, tl.exp2(s - lse[:, None]), 0.0)
            dp = tl.dot(do, tl.trans(v))
            ds = p * (dp - delta[:, None])
            acc += tl.dot(ds.to(k.dtype), k)
        tl.store(DQ + b * dq_sb + h * dq_sh + rows[:, None] * dq_ss
                 + dims[None, :], (acc * scale).to(DQ.dtype.element_ty),
                 mask=row_ok[:, None])

    _KERNELS.update(fwd=fwd, dkdv=dkdv, dq=dq, cdiv=triton.cdiv)
    return _KERNELS


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------

def _check(q, k, v, q_pos, k_pos) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B, Sq, H, D], k and v [B, Sk, KV, D]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not serve q "
                         f"{tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v of one type: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, p, n in (("q_pos", q_pos, sq), ("k_pos", k_pos, k.shape[1])):
        if (p.dim() != 2 or p.shape[1] != n or b % p.shape[0]
                or p.is_floating_point()):
            raise ValueError(f"{name} must be integer [rows, {n}] with rows "
                             f"dividing {b}: {p.dtype} {tuple(p.shape)}")
    if not q.device == k.device == v.device == q_pos.device == k_pos.device:
        raise ValueError("q, k, v and the positions on one device")


def _cuda_operands(q, d, *tensors):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    if q.dtype != torch.bfloat16 or d not in CONFIGS:
        raise TypeError(f"the kernel takes bf16 with head dim in "
                        f"{sorted(CONFIGS)}: {q.dtype}, head dim {d}")
    if max(t.numel() for t in (q,) + tensors) >= 2**31:
        raise ValueError("the kernel's offsets are 32-bit: each operand "
                         "under 2**31 elements")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"batch x heads {q.shape[0] * q.shape[2]} is over "
                         f"the grid's second dimension, 65535")


def _last_dense(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _pos_args(p):
    return p.stride(0), p.stride(1), p.shape[0]


def _forward_cuda(q, k, v, q_pos, k_pos, scale, window, causal):
    b, sq, h, d = q.shape
    sk, kvs = k.shape[1], k.shape[2]
    _cuda_operands(q, d, k, v)
    q, k, v = (_last_dense(t) for t in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    kern = _kernels()
    bm, bn, warps, stages = CONFIGS[d]["fwd"]
    with torch.cuda.device(q.device):
        kern["fwd"][(kern["cdiv"](sq, bm), b * h)](
            q, k, v, q_pos, k_pos, o, lse, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], *_pos_args(q_pos),
            *_pos_args(k_pos), h, h // kvs, sq, sk, scale * LOG2E,
            window, CAUSAL=causal, WINDOWED=window > 0, D=d, BM=bm, BN=bn,
            num_warps=warps, num_stages=stages)
    flash_attention.launches += 1
    return o, lse


def _backward_cuda(do, q, k, v, q_pos, k_pos, o, lse, scale, window,
                   causal):
    b, sq, h, d = q.shape
    sk, kvs = k.shape[1], k.shape[2]
    _cuda_operands(q, d, k, v, do)
    do, q, k, v, o = (_last_dense(t) for t in (do, q, k, v, o))
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kvs, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, kvs, d), dtype=v.dtype, device=q.device)
    kern = _kernels()
    cfg = CONFIGS[d]
    common = (*_pos_args(q_pos), *_pos_args(k_pos), h, h // kvs, sq, sk,
              scale * LOG2E, scale, window)
    flags = dict(CAUSAL=causal, WINDOWED=window > 0, D=d)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3])
    with torch.cuda.device(q.device):
        # dQ first: its programs also write D = rowsum(dO * O), which the
        # dK/dV programs read for every query tile
        bm, bn, warps, stages = cfg["dq"]
        kern["dq"][(kern["cdiv"](sq, bm), b * h)](
            q, k, v, o, do, lse, delta, dq, q_pos, k_pos, *strides,
            *o.stride()[:3], *dq.stride()[:3], *common, **flags, BM=bm,
            BN=bn, num_warps=warps, num_stages=stages)
        bm, bn, warps, stages = cfg["dkdv"]
        kern["dkdv"][(kern["cdiv"](sk, bn), b * kvs)](
            q, k, v, do, lse, delta, dk, dv, q_pos, k_pos, *strides,
            *dk.stride()[:3], *dv.stride()[:3], *common, **flags, BM=bm,
            BN=bn, num_warps=warps, num_stages=stages)
    flash_attention.launches += 2
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the plain versions: the kernels' arithmetic, dense
# ---------------------------------------------------------------------------

def _rows(p, b):
    """Positions [rows, S] as [b, S]: batch row i reads row i mod rows."""
    return p if p.shape[0] == b else p.repeat(b // p.shape[0], 1)




def _scores(q, k, q_pos, k_pos, scale, window, causal):
    """Scores in base 2 [B, KV, rep, Sq, Sk] in f32 from the unrounded
    product, masked, and the mask."""
    b, sq, h, d = q.shape
    kvs = k.shape[2]
    qg = q.float().reshape(b, sq, kvs, h // kvs, d)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * (scale * LOG2E)
    keep = mask(_rows(q_pos, b), _rows(k_pos, b), window, causal)[
        :, None, None]
    return torch.where(keep, s, _MASKED), keep


def forward_plain(q, k, v, q_pos, k_pos, scale, window, causal):
    """(o [B, Sq, H, D] in q's type, lse [B, H, Sq] f32 in base 2)."""
    b, sq, h, d = q.shape
    s, _ = _scores(q, k, q_pos, k_pos, scale, window, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l_ = p.sum(-1, keepdim=True)
    o = torch.einsum("bkrqs,bskd->bkrqd", p.to(v.dtype).float(), v.float())
    o = (o / l_).to(q.dtype)
    lse = (m + torch.log2(l_))[..., 0].reshape(b, h, sq)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d), lse


def backward_plain(do, q, k, v, q_pos, k_pos, o, lse, scale, window, causal):
    """(dq, dk, dv) in the inputs' types, from the log-sum-exp and D."""
    b, sq, h, d = q.shape
    kvs = k.shape[2]
    rep = h // kvs
    s, keep = _scores(q, k, q_pos, k_pos, scale, window, causal)
    lse = lse.reshape(b, kvs, rep, sq)[..., None]
    p = torch.where(keep, torch.exp2(s - lse), 0.0)
    dog = do.float().reshape(b, sq, kvs, rep, d)
    delta = (o.float() * do.float()).sum(-1).reshape(b, sq, kvs, rep)
    delta = delta.permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqkrd,bskd->bkrqs", dog, v.float())
    ds = p * (dp - delta)
    dv = torch.einsum("bkrqs,bqkrd->bskd", p.to(do.dtype).float(), dog)
    dsr = ds.to(q.dtype).float()
    dk = torch.einsum("bkrqs,bqkrd->bskd", dsr,
                      q.float().reshape(b, sq, kvs, rep, d)) * scale
    dq = torch.einsum("bkrqs,bskd->bqkrd", dsr, k.float()) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _forward(q, k, v, q_pos, k_pos, scale, window, causal):
    _check(q, k, v, q_pos, k_pos)
    if q.device.type == "cpu":
        return forward_plain(q, k, v, q_pos, k_pos, scale, window, causal)
    return _forward_cuda(q, k, v, q_pos, k_pos, scale, window, causal)


def _backward(do, q, k, v, q_pos, k_pos, o, lse, scale, window, causal):
    if q.device.type == "cpu":
        return backward_plain(do, q, k, v, q_pos, k_pos, o, lse, scale,
                              window, causal)
    return _backward_cuda(do, q, k, v, q_pos, k_pos, o, lse, scale, window,
                          causal)


# ---------------------------------------------------------------------------
# the binding: autograd and vmap
# ---------------------------------------------------------------------------

def _fold(x, d, n, b):
    """``x`` vmapped at ``d`` (None: not vmapped) as the batch of n * b
    rows (a view where the layout allows)."""
    if d is None:
        x = x.expand(n, *x.shape)
    else:
        x = x.movedim(d, 0)
    return x.reshape(n * b, *x.shape[2:])


def _fold_pos(p, d, n, b):
    """Positions vmapped at ``d``: [n * b, S]; not vmapped they stay
    (batch row i reads row i mod rows)."""
    if d is None:
        return p
    p = p.movedim(d, 0)
    if p.shape[1] != b:
        p = p.repeat(1, b // p.shape[1], 1)
    return p.reshape(n * b, p.shape[2])


def _unfold(x, n):
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def _batch_of(q, d):
    """q's batch size in one example, ``d`` its vmapped dim (or None)."""
    return q.shape[0 if d is None or d > 0 else 1]


class _Forward(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, q_pos, k_pos, scale, window, causal):
        return _forward(q, k, v, q_pos, k_pos, scale, window, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_pos, k_pos, scale, window, causal = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, lse)
        ctx.args = (scale, window, causal)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        dq, dk, dv = _Backward.apply(do, q, k, v, q_pos, k_pos, o, lse,
                                     *ctx.args)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, k_pos, scale, window, causal):
        n = info.batch_size
        b = _batch_of(q, in_dims[0])
        q, k, v = (_fold(t, d, n, b) for t, d in zip((q, k, v), in_dims))
        q_pos, k_pos = (_fold_pos(p, d, n, b)
                        for p, d in zip((q_pos, k_pos), in_dims[3:5]))
        o, lse = _Forward.apply(q, k, v, q_pos, k_pos, scale, window, causal)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _Backward(torch.autograd.Function):
    @staticmethod
    def forward(do, q, k, v, q_pos, k_pos, o, lse, scale, window, causal):
        return _backward(do, q, k, v, q_pos, k_pos, o, lse, scale, window,
                         causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, do, q, k, v, q_pos, k_pos, o, lse, scale, window,
             causal):
        n = info.batch_size
        ts = (do, q, k, v, o, lse)
        ds = in_dims[:4] + in_dims[6:8]
        b = _batch_of(q, in_dims[1])
        do, q, k, v, o, lse = (_fold(t, d, n, b) for t, d in zip(ts, ds))
        q_pos, k_pos = (_fold_pos(p, d, n, b)
                        for p, d in zip((q_pos, k_pos), in_dims[4:6]))
        grads = _Backward.apply(do, q, k, v, q_pos, k_pos, o, lse, scale,
                                window, causal)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q, k, v, q_pos, k_pos, *, scale: float, window: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``q`` [B, Sq, H, D] over ``k``, ``v`` [B, Sk, KV, D]
    (H a multiple of KV) under ``mask(q_pos, k_pos, window, causal)``,
    scores times ``scale``, the softmax in f32: [B, Sq, H, D]
    in q's type.  Positions are [S] or [rows, S] with rows dividing B."""
    q_pos = q_pos if q_pos.dim() == 2 else q_pos[None]
    k_pos = k_pos if k_pos.dim() == 2 else k_pos[None]
    return _Forward.apply(q, k, v, q_pos, k_pos, float(scale), int(window),
                          bool(causal))[0]


flash_attention.launches = 0
