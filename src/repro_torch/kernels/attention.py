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
* Tile schedule: each program first finds, from the other side's
  positions, the tiles its main loop visits, [lo, hi): the first to the
  last tile in which some pair is unmasked (causal: max q >= min k; the
  window: min q - max k < window; the sentinel: min k below it).  This is
  exact for any positions: a fully masked tile inside the range adds
  exactly 0 (its scores sit at -1e30, so its p is 0 and the running max
  and sum keep their values).  The scan (``_plan``) loads SCAN positions
  a step as one [tiles, BLOCK] block and takes every tile's extremes and
  rules as vectors, folded once after the loop: 8 steps at 8192
  positions where a tile a step took 128-256 latency-bound ones, in
  every program of every layer.  No pre-pass launch and no table: the
  host-paced cells would pay for another launch.
* Unmasked interior: the same scan finds [a, b), the tiles whose every
  pair is unmasked against the program's own extremes (causal: min q >=
  max k; the window: max q - min k < window; no sentinel) with both
  tiles whole (no ragged edge on either side).  It is kept only when
  every tile between a and b is one, else empty, so it is exact for any
  positions.  The main loop runs [lo, a) and [b, hi) masked and [a, b)
  without the position loads, the mask and its ``where``: the same tiles
  in the same order, the values equal up to the compiler contracting a
  multiply and an add once the ``where`` is gone.  ``tile_plan`` gives
  both ranges densely by the same rule (the tests and ``bench kernel``
  count the tiles with it).
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

# positions a step of each program's scan for its tile schedule (``_plan``):
# 8 steps at 8192 positions
SCAN = 1024

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
    def _full(qlo, qhi, klo, khi, window, CAUSAL: tl.constexpr,
              WINDOWED: tl.constexpr):
        """Every pair of the two tiles is unmasked."""
        if CAUSAL:
            ok = qlo >= khi
        else:
            ok = khi < 1073741823
        if WINDOWED:
            ok = ok & (qhi - klo < window)
        return ok

    @triton.jit
    def _plan(pos_ptr, n, stride, own_lo, own_hi, own_full, window,
              KEYS: tl.constexpr, CAUSAL: tl.constexpr,
              WINDOWED: tl.constexpr, BLOCK: tl.constexpr,
              TILES: tl.constexpr):
        """The program's tile schedule over positions ``pos_ptr[0:n]``
        (tiles of BLOCK; ``KEYS``: key tiles) against its own extremes:
        [lo, hi), the first and past the last tile with an unmasked pair,
        and [a, b), the tiles whose every pair is unmasked, kept only when
        each tile between a and b is one (``own_full``: the program's own
        tile has no ragged edge), else empty at hi.  TILES tiles a step:
        one [TILES, BLOCK] load, the tiles' extremes and rules as
        vectors, folded once after the loop."""
        n_tiles = tl.cdiv(n, BLOCK)
        t0 = tl.arange(0, TILES)
        idx = tl.arange(0, BLOCK)
        lo = tl.zeros([TILES], tl.int32) + n_tiles
        hi = tl.zeros([TILES], tl.int32)
        a = tl.zeros([TILES], tl.int32) + n_tiles
        b = tl.zeros([TILES], tl.int32)
        count = tl.zeros([TILES], tl.int32)
        for c in range(0, tl.cdiv(n_tiles, TILES)):
            t = c * TILES + t0
            e = t[:, None] * BLOCK + idx[None, :]
            ok = e < n
            p = tl.load(pos_ptr + e * stride, mask=ok, other=0).to(tl.int32)
            tlo = tl.min(tl.where(ok, p, 2147483647), 1)
            thi = tl.max(tl.where(ok, p, -2147483647), 1)
            if KEYS:
                live = _live(own_lo, own_hi, tlo, thi, window, CAUSAL,
                             WINDOWED)
                full = _full(own_lo, own_hi, tlo, thi, window, CAUSAL,
                             WINDOWED)
            else:
                live = _live(tlo, thi, own_lo, own_hi, window, CAUSAL,
                             WINDOWED)
                full = _full(tlo, thi, own_lo, own_hi, window, CAUSAL,
                             WINDOWED)
            live = live & (t < n_tiles)
            full = full & (t * BLOCK + BLOCK <= n) & own_full
            lo = tl.minimum(lo, tl.where(live, t, n_tiles))
            hi = tl.maximum(hi, tl.where(live, t + 1, 0))
            a = tl.minimum(a, tl.where(full, t, n_tiles))
            b = tl.maximum(b, tl.where(full, t + 1, 0))
            count += full.to(tl.int32)
        lo = tl.min(lo, 0)
        hi = tl.max(hi, 0)
        a = tl.min(a, 0)
        b = tl.max(b, 0)
        whole = tl.sum(count, 0) == b - a
        return lo, hi, tl.where(whole, a, hi), tl.where(whole, b, hi)

    @triton.jit
    def _fwd_tiles(t0, t1, m_i, l_i, acc, q, qp, k_ptr, v_ptr, kp_ptr,
                   k_ss, v_ss, kp_ss, SK, scale2, window,
                   CAUSAL: tl.constexpr, WINDOWED: tl.constexpr,
                   MASKED: tl.constexpr, D: tl.constexpr,
                   BN: tl.constexpr):
        """The forward's main loop over key tiles [t0, t1); without
        ``MASKED`` every pair is unmasked and every tile whole."""
        cols = tl.arange(0, BN)
        dims = tl.arange(0, D)
        for t in range(t0, t1):
            c = t * BN + cols
            if MASKED:
                c_ok = c < SK
                kp = tl.load(kp_ptr + c * kp_ss, mask=c_ok,
                             other=0).to(tl.int32)
                k = tl.load(k_ptr + c[:, None] * k_ss + dims[None, :],
                            mask=c_ok[:, None], other=0.0)
            else:
                k = tl.load(k_ptr + c[:, None] * k_ss + dims[None, :])
            s = tl.dot(q, tl.trans(k)) * scale2
            if MASKED:
                keep = c_ok[None, :] & _keep(qp[:, None], kp[None, :],
                                             window, CAUSAL, WINDOWED)
                s = tl.where(keep, s, -1.0e30)
            m_new = tl.maximum(m_i, tl.max(s, 1))
            alpha = tl.exp2(m_i - m_new)
            p = tl.exp2(s - m_new[:, None])
            l_i = l_i * alpha + tl.sum(p, 1)
            if MASKED:
                v = tl.load(v_ptr + c[:, None] * v_ss + dims[None, :],
                            mask=c_ok[:, None], other=0.0)
            else:
                v = tl.load(v_ptr + c[:, None] * v_ss + dims[None, :])
            acc = acc * alpha[:, None] + tl.dot(p.to(v.dtype), v)
            m_i = m_new
        return m_i, l_i, acc

    @triton.jit
    def fwd(Q, K, V, QP, KP, O, LSE,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            o_sb, o_ss, o_sh, qp_sb, qp_ss, qp_rows, kp_sb, kp_ss, kp_rows,
            H, REP, SQ, SK, scale2, window,
            CAUSAL: tl.constexpr, WINDOWED: tl.constexpr, D: tl.constexpr,
            BM: tl.constexpr, BN: tl.constexpr, TILES: tl.constexpr):
        pid_m = tl.program_id(0)
        bh = tl.program_id(1)
        b = bh // H
        h = bh % H
        kvh = h // REP
        rows = pid_m * BM + tl.arange(0, BM)
        dims = tl.arange(0, D)
        row_ok = rows < SQ
        qp, qlo, qhi = _pos(QP + (b % qp_rows) * qp_sb, rows, SQ, qp_ss)
        kp_ptr = KP + (b % kp_rows) * kp_sb
        whole = pid_m * BM + BM <= SQ
        lo, hi, ua, ub = _plan(kp_ptr, SK, kp_ss, qlo, qhi, whole, window,
                               True, CAUSAL, WINDOWED, BN, TILES)
        q = tl.load(Q + b * q_sb + h * q_sh + rows[:, None] * q_ss
                    + dims[None, :], mask=row_ok[:, None], other=0.0)
        k_ptr = K + b * k_sb + kvh * k_sh
        v_ptr = V + b * v_sb + kvh * v_sh
        m_i = tl.full([BM], float("-inf"), tl.float32)
        l_i = tl.zeros([BM], tl.float32)
        acc = tl.zeros([BM, D], tl.float32)
        m_i, l_i, acc = _fwd_tiles(lo, ua, m_i, l_i, acc, q, qp, k_ptr, v_ptr,
                                   kp_ptr, k_ss, v_ss, kp_ss, SK, scale2,
                                   window, CAUSAL, WINDOWED, True, D, BN)
        m_i, l_i, acc = _fwd_tiles(ua, ub, m_i, l_i, acc, q, qp, k_ptr, v_ptr,
                                   kp_ptr, k_ss, v_ss, kp_ss, SK, scale2,
                                   window, CAUSAL, WINDOWED, False, D, BN)
        m_i, l_i, acc = _fwd_tiles(ub, hi, m_i, l_i, acc, q, qp, k_ptr, v_ptr,
                                   kp_ptr, k_ss, v_ss, kp_ss, SK, scale2,
                                   window, CAUSAL, WINDOWED, True, D, BN)
        out = acc / l_i[:, None]
        tl.store(O + b * o_sb + h * o_sh + rows[:, None] * o_ss
                 + dims[None, :], out.to(O.dtype.element_ty),
                 mask=row_ok[:, None])
        tl.store(LSE + bh * SQ + rows, m_i + tl.log2(l_i), mask=row_ok)

    @triton.jit
    def _dkdv_tiles(t0, t1, dk, dv, k, v, kp, c_ok, q_ptr, do_ptr, qp_ptr,
                    LSE, DELTA, stat, q_ss, do_ss, qp_ss, SQ, scale2, window,
                    CAUSAL: tl.constexpr, WINDOWED: tl.constexpr,
                    MASKED: tl.constexpr, D: tl.constexpr,
                    BM: tl.constexpr):
        """dK and dV's loop over query tiles [t0, t1) of one query head;
        without ``MASKED`` every pair is unmasked and every tile whole."""
        rows0 = tl.arange(0, BM)
        dims = tl.arange(0, D)
        for t in range(t0, t1):
            rows = t * BM + rows0
            if MASKED:
                r_ok = rows < SQ
                qp = tl.load(qp_ptr + rows * qp_ss, mask=r_ok,
                             other=0).to(tl.int32)
                q = tl.load(q_ptr + rows[:, None] * q_ss + dims[None, :],
                            mask=r_ok[:, None], other=0.0)
                do = tl.load(do_ptr + rows[:, None] * do_ss + dims[None, :],
                             mask=r_ok[:, None], other=0.0)
                lse = tl.load(LSE + stat + rows, mask=r_ok, other=0.0)
                delta = tl.load(DELTA + stat + rows, mask=r_ok, other=0.0)
            else:
                q = tl.load(q_ptr + rows[:, None] * q_ss + dims[None, :])
                do = tl.load(do_ptr + rows[:, None] * do_ss + dims[None, :])
                lse = tl.load(LSE + stat + rows)
                delta = tl.load(DELTA + stat + rows)
            s_t = tl.dot(k, tl.trans(q)) * scale2          # [BN, BM]
            if MASKED:
                keep = (c_ok[:, None] & r_ok[None, :]
                        & _keep(qp[None, :], kp[:, None], window, CAUSAL,
                                WINDOWED))
                p_t = tl.where(keep, tl.exp2(s_t - lse[None, :]), 0.0)
            else:
                p_t = tl.exp2(s_t - lse[None, :])
            dv += tl.dot(p_t.to(do.dtype), do)
            dp_t = tl.dot(v, tl.trans(do))
            ds_t = p_t * (dp_t - delta[None, :])
            dk += tl.dot(ds_t.to(q.dtype), q)
        return dk, dv

    @triton.jit
    def dkdv(Q, K, V, DO, LSE, DELTA, DK, DV, QP, KP,
             q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             do_sb, do_ss, do_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh,
             qp_sb, qp_ss, qp_rows, kp_sb, kp_ss, kp_rows,
             H, REP, SQ, SK, scale2, scale, window,
             CAUSAL: tl.constexpr, WINDOWED: tl.constexpr, D: tl.constexpr,
             BM: tl.constexpr, BN: tl.constexpr, TILES: tl.constexpr):
        pid_n = tl.program_id(0)
        bk = tl.program_id(1)
        kvs = H // REP
        b = bk // kvs
        kvh = bk % kvs
        cols = pid_n * BN + tl.arange(0, BN)
        dims = tl.arange(0, D)
        c_ok = cols < SK
        kp, klo, khi = _pos(KP + (b % kp_rows) * kp_sb, cols, SK, kp_ss)
        qp_ptr = QP + (b % qp_rows) * qp_sb
        whole = pid_n * BN + BN <= SK
        lo, hi, ua, ub = _plan(qp_ptr, SQ, qp_ss, klo, khi, whole, window,
                               False, CAUSAL, WINDOWED, BM, TILES)
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
            dk, dv = _dkdv_tiles(lo, ua, dk, dv, k, v, kp, c_ok, q_ptr, do_ptr,
                                 qp_ptr, LSE, DELTA, stat, q_ss, do_ss, qp_ss,
                                 SQ, scale2, window, CAUSAL, WINDOWED, True,
                                 D, BM)
            dk, dv = _dkdv_tiles(ua, ub, dk, dv, k, v, kp, c_ok, q_ptr, do_ptr,
                                 qp_ptr, LSE, DELTA, stat, q_ss, do_ss, qp_ss,
                                 SQ, scale2, window, CAUSAL, WINDOWED, False,
                                 D, BM)
            dk, dv = _dkdv_tiles(ub, hi, dk, dv, k, v, kp, c_ok, q_ptr, do_ptr,
                                 qp_ptr, LSE, DELTA, stat, q_ss, do_ss, qp_ss,
                                 SQ, scale2, window, CAUSAL, WINDOWED, True,
                                 D, BM)
        tl.store(DK + b * dk_sb + kvh * dk_sh + cols[:, None] * dk_ss
                 + dims[None, :], (dk * scale).to(DK.dtype.element_ty),
                 mask=c_ok[:, None])
        tl.store(DV + b * dv_sb + kvh * dv_sh + cols[:, None] * dv_ss
                 + dims[None, :], dv.to(DV.dtype.element_ty),
                 mask=c_ok[:, None])

    @triton.jit
    def _dq_tiles(t0, t1, acc, q, do, qp, lse, delta, row_ok, k_ptr, v_ptr,
                  kp_ptr, k_ss, v_ss, kp_ss, SK, scale2, window,
                  CAUSAL: tl.constexpr, WINDOWED: tl.constexpr,
                  MASKED: tl.constexpr, D: tl.constexpr, BN: tl.constexpr):
        """dQ's loop over key tiles [t0, t1); without ``MASKED`` every pair
        is unmasked and every tile whole."""
        cols = tl.arange(0, BN)
        dims = tl.arange(0, D)
        for t in range(t0, t1):
            c = t * BN + cols
            if MASKED:
                c_ok = c < SK
                kp = tl.load(kp_ptr + c * kp_ss, mask=c_ok,
                             other=0).to(tl.int32)
                k = tl.load(k_ptr + c[:, None] * k_ss + dims[None, :],
                            mask=c_ok[:, None], other=0.0)
                v = tl.load(v_ptr + c[:, None] * v_ss + dims[None, :],
                            mask=c_ok[:, None], other=0.0)
            else:
                k = tl.load(k_ptr + c[:, None] * k_ss + dims[None, :])
                v = tl.load(v_ptr + c[:, None] * v_ss + dims[None, :])
            s = tl.dot(q, tl.trans(k)) * scale2
            if MASKED:
                keep = (row_ok[:, None] & c_ok[None, :]
                        & _keep(qp[:, None], kp[None, :], window, CAUSAL,
                                WINDOWED))
                p = tl.where(keep, tl.exp2(s - lse[:, None]), 0.0)
            else:
                p = tl.exp2(s - lse[:, None])
            dp = tl.dot(do, tl.trans(v))
            ds = p * (dp - delta[:, None])
            acc += tl.dot(ds.to(k.dtype), k)
        return acc

    @triton.jit
    def dq(Q, K, V, O, DO, LSE, DELTA, DQ, QP, KP,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           do_sb, do_ss, do_sh, o_sb, o_ss, o_sh, dq_sb, dq_ss, dq_sh,
           qp_sb, qp_ss, qp_rows, kp_sb, kp_ss, kp_rows,
           H, REP, SQ, SK, scale2, scale, window,
           CAUSAL: tl.constexpr, WINDOWED: tl.constexpr, D: tl.constexpr,
           BM: tl.constexpr, BN: tl.constexpr, TILES: tl.constexpr):
        pid_m = tl.program_id(0)
        bh = tl.program_id(1)
        b = bh // H
        h = bh % H
        kvh = h // REP
        rows = pid_m * BM + tl.arange(0, BM)
        dims = tl.arange(0, D)
        row_ok = rows < SQ
        qp, qlo, qhi = _pos(QP + (b % qp_rows) * qp_sb, rows, SQ, qp_ss)
        kp_ptr = KP + (b % kp_rows) * kp_sb
        whole = pid_m * BM + BM <= SQ
        lo, hi, ua, ub = _plan(kp_ptr, SK, kp_ss, qlo, qhi, whole, window,
                               True, CAUSAL, WINDOWED, BN, TILES)
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
        acc = _dq_tiles(lo, ua, acc, q, do, qp, lse, delta, row_ok, k_ptr,
                        v_ptr, kp_ptr, k_ss, v_ss, kp_ss, SK, scale2, window,
                        CAUSAL, WINDOWED, True, D, BN)
        acc = _dq_tiles(ua, ub, acc, q, do, qp, lse, delta, row_ok, k_ptr,
                        v_ptr, kp_ptr, k_ss, v_ss, kp_ss, SK, scale2, window,
                        CAUSAL, WINDOWED, False, D, BN)
        acc = _dq_tiles(ub, hi, acc, q, do, qp, lse, delta, row_ok, k_ptr,
                        v_ptr, kp_ptr, k_ss, v_ss, kp_ss, SK, scale2, window,
                        CAUSAL, WINDOWED, True, D, BN)
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


def _tiles(block):
    """Tiles a step of the schedule's scan: SCAN positions."""
    return max(1, SCAN // block)


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
            TILES=_tiles(bn), num_warps=warps, num_stages=stages)
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
            BN=bn, TILES=_tiles(bn), num_warps=warps, num_stages=stages)
        bm, bn, warps, stages = cfg["dkdv"]
        kern["dkdv"][(kern["cdiv"](sk, bn), b * kvs)](
            q, k, v, do, lse, delta, dk, dv, q_pos, k_pos, *strides,
            *dk.stride()[:3], *dv.stride()[:3], *common, **flags, BM=bm,
            BN=bn, TILES=_tiles(bm), num_warps=warps, num_stages=stages)
    flash_attention.launches += 2
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the plain versions: the kernels' arithmetic, dense
# ---------------------------------------------------------------------------

def _rows(p, b):
    """Positions [rows, S] as [b, S]: batch row i reads row i mod rows."""
    return p if p.shape[0] == b else p.repeat(b // p.shape[0], 1)


def _tile_extremes(p, block):
    """Each tile's least and largest position and whether it is whole
    (no ragged edge), of positions [rows, S] in tiles of ``block``."""
    rows, n = p.shape
    pad = -n % block
    p = p.long()
    lo = torch.cat([p, p.new_full((rows, pad), 2**31 - 1)], 1)
    hi = torch.cat([p, p.new_full((rows, pad), -2**31 + 1)], 1)
    whole = torch.arange(1, (n + pad) // block + 1, device=p.device) * block
    return (lo.reshape(rows, -1, block).amin(-1),
            hi.reshape(rows, -1, block).amax(-1), whole <= n)


def tile_plan(pos, other_pos, block, other_block, window, causal, keys):
    """The kernels' tile schedule, densely: for each tile of ``other_pos``
    (a program's own positions, tiles of ``other_block``), the tiles of
    ``pos`` (tiles of ``block``; ``keys``: key positions) its main loop
    visits, [lo, hi), and among them those it runs without the mask,
    [a, b) (a = b = hi when none).  The rule is the kernels' ``_plan``:
    a tile is live when some pair of the two is unmasked by the extremes'
    test, and [a, b) spans the tiles whose every pair is unmasked, both
    tiles whole, only where no other tile lies between.  Positions [S] or
    [rows, S]; returns [rows, tiles of other_pos, 4] int64 (lo, hi, a,
    b)."""
    pos = pos if pos.dim() == 2 else pos[None]
    other_pos = other_pos if other_pos.dim() == 2 else other_pos[None]
    rows = max(pos.shape[0], other_pos.shape[0])
    t_lo, t_hi, t_whole = _tile_extremes(_rows(pos, rows), block)
    o_lo, o_hi, o_whole = _tile_extremes(_rows(other_pos, rows), other_block)
    t_side = (t_lo[:, None, :], t_hi[:, None, :])
    o_side = (o_lo[:, :, None], o_hi[:, :, None])
    (qlo, qhi), (klo, khi) = ((o_side, t_side) if keys
                              else (t_side, o_side))
    if causal:
        live, full = qhi >= klo, qlo >= khi
    else:
        live, full = klo < INVALID_POS, khi < INVALID_POS
    if window > 0:
        live = live & (qlo - khi < window)
        full = full & (qhi - klo < window)
    shape = (rows, o_lo.shape[1], t_lo.shape[1])
    live = live.expand(shape)
    full = full & t_whole[None, None, :] & o_whole[None, :, None]
    n = shape[2]
    t = torch.arange(n, device=pos.device)
    lo = torch.where(live, t, n).amin(-1)
    hi = torch.where(live, t + 1, 0).amax(-1)
    a = torch.where(full, t, n).amin(-1)
    b = torch.where(full, t + 1, 0).amax(-1)
    kept = full.sum(-1) == b - a
    return torch.stack([lo, hi, torch.where(kept, a, hi),
                        torch.where(kept, b, hi)], -1)


def launch_tiles(q_pos, k_pos, batch, heads, kv_heads, d, window, causal):
    """{kernel: (tiles visited, tiles on the unmasked path)} of one
    forward and one backward launch (``fwd``; ``dq``, ``dkdv``) at these
    positions, by ``tile_plan`` at ``CONFIGS[d]``'s tiles: a tile is one
    (query tile, key tile) product of one query head."""
    q_pos = q_pos if q_pos.dim() == 2 else q_pos[None]
    k_pos = k_pos if k_pos.dim() == 2 else k_pos[None]
    out = {}
    for name, (bm, bn, _, _) in CONFIGS[d].items():
        if name == "dkdv":      # a program per key tile, over rep heads
            plan = tile_plan(q_pos, k_pos, bm, bn, window, causal, False)
        else:
            plan = tile_plan(k_pos, q_pos, bn, bm, window, causal, True)
        times = batch // plan.shape[0] * heads
        lo, hi, a, b = plan.unbind(-1)
        out[name] = (int((hi - lo).clamp(min=0).sum()) * times,
                     int((b - a).sum()) * times)
    return out


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
