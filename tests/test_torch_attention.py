"""The fused attention (``repro_torch/kernels/attention.py``) where tier-1
runs, on the CPU.

* ``fused_route``: each of its conditions on and off, on fake CUDA tensors.
* The kernels' tiled algorithm, written out here in f32 PyTorch (the
  online softmax, the base-2 log-sum-exp, the backward from the
  log-sum-exp and D, and the tile ranges from the positions' extremes),
  against autograd of ``layers._attn_block`` in float64: causal,
  non-causal, a window, GQA, ragged lengths (1500, 448), shuffled
  positions and empty cache slots.  Tolerance 2e-5 of the largest entry:
  f32 sums of a few thousand terms against float64.
* The binding (two ``autograd.Function``s with vmap rules) through the
  plain versions: ``vmap(grad_and_value)`` over 3 workers equals the loop
  over them bit for bit, so does remat's checkpoint, and the positions
  fold as the model passes them.
* The model's ``attn_fused`` counts with the route forced onto the plain
  version: two a layer's attention (forward and recompute).
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import dist
from repro_torch.kernels import attention as FA
from repro_torch.models import layers as L
from repro_torch.models import remat as RM
from repro_torch.models.model import build_model
from repro_torch.obs import spans
from repro_torch.optim import adam

INVALID = FA.INVALID_POS


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _fake(shape, device="cuda", dtype=torch.bfloat16):
    return torch.empty(shape, device=device, dtype=dtype)


class _Lanes:
    def size(self):
        return 2


ROUTE_OFF = {
    "fusable": dict(fusable=False),
    "lanes": dict(lanes=_Lanes()),
    "softmax_bf16": dict(softmax_dtype=torch.bfloat16),
    "head_dim_32": dict(d=32),
    "head_dim_96": dict(d=96),
    "f32_operands": dict(dtype=torch.float32),
    "f16_operands": dict(dtype=torch.float16),
    "cpu": dict(device="cpu"),
    "k_on_cpu": dict(k_device="cpu"),
}


def _route(d=64, dtype=torch.bfloat16, device="cuda", k_device=None, **kw):
    with FakeTensorMode():
        q = _fake((2, 8, 4, d), device, dtype)
        k = _fake((2, 8, 2, d), k_device or device, dtype)
        v = _fake((2, 8, 2, d), device, dtype)
        args = dict(lanes=None, softmax_dtype=torch.float32, fusable=True)
        args.update(kw)
        return L.fused_route(q, k, v, **args)


@pytest.mark.parametrize("d", [64, 128])
def test_route_on(d):
    assert _route(d=d)


@pytest.mark.parametrize("name", sorted(ROUTE_OFF))
def test_route_off(name):
    assert not _route(**ROUTE_OFF[name])


def test_route_off_for_a_dtensor():
    """A DTensor (the sharded mesh's operands) keeps ``_attn_block``."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1), _init_backend=False)
        with FakeTensorMode():
            q, k, v = (_fake((2, 8, 2, 64)) for _ in range(3))
            dq = DTensor(q, DTensorSpec(mesh, (Replicate(),), TensorMeta(
                q.shape, q.stride(), q.dtype)), requires_grad=False)
            assert L.fused_route(q, k, v, fusable=True)
            assert not L.fused_route(dq, k, v, fusable=True)
    finally:
        tdist.destroy_process_group()


def _vouched(monkeypatch, arch, decode):
    """The ``fusable`` word of each attention call of a reduced arch's
    forward (``decode``: one decode step on a cache), and the attn_fused
    counts of a traced forward without a cache."""
    words = []

    def route(q, k, v, fusable=False, **kw):
        words.append(fusable)
        return False
    monkeypatch.setattr(L, "fused_route", route)
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 8), generator=g)
    frames = (torch.randn(2, cfg.n_frames, cfg.d_model, generator=g)
              if cfg.family == "encdec" else None)
    if decode:
        cache = model.init_cache(2, 16, device="cpu")
        enc = (model._encode(params, frames) if frames is not None
               else None)
        model.decode_step(params, cache, tok[:, 0], 0, enc_out=enc)
    else:
        batch = {"tokens": tok}
        if frames is not None:
            batch["frames"] = frames
        model.loss(params, batch)
    return cfg, words


@pytest.mark.parametrize("arch", ["whisper-tiny", "starcoder2-7b"])
@pytest.mark.parametrize("decode", [False, True])
def test_attn_apply_vouches_only_without_a_cache(monkeypatch, arch, decode):
    """The model's attention calls vouch (``fusable``) in the forward, and
    none does in a decode step: the self-attention holds the cache and the
    cross-attention beside it is told so (``decode``)."""
    cfg, words = _vouched(monkeypatch, arch, decode)
    if decode:
        calls = 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
        assert words[-calls:] == [False] * calls
        assert len(words) >= calls
    else:
        calls = (cfg.enc_layers + 2 * cfg.n_layers
                 if cfg.family == "encdec" else cfg.n_layers)
        assert words == [True] * calls


def test_cpu_attention_is_the_eager_block():
    """On the CPU the route is off whatever the caller vouches: the same
    bits as ``_attn_block`` in its query chunks."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 128, 4, 64, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 128, 2, 64, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 128, 2, 64, generator=g).to(torch.bfloat16)
    pos = torch.arange(128, dtype=torch.int32)[None].expand(2, 128)
    a = L.attention(q, k, v, pos, pos, q_chunk=64, fusable=True)
    chunks = [L._attn_block(q[:, i:i + 64], k, v, pos[:, i:i + 64], pos, 2,
                            64 ** -0.5, 0, True, torch.float32)
              for i in (0, 64)]
    assert torch.equal(a, torch.cat(chunks, dim=1))


# ---------------------------------------------------------------------------
# the kernels' tiled algorithm, in f32
# ---------------------------------------------------------------------------

def _extremes(p):
    return int(p.min()), int(p.max())


def _live(qlo, qhi, klo, khi, window, causal):
    ok = qhi >= klo if causal else klo < INVALID
    return ok and (window <= 0 or qlo - khi < window)


def _tile_range(pos, block, other, keys, window, causal):
    """The kernels' ``_range``: [lo, hi) of the tiles of ``pos`` with an
    unmasked pair against ``other`` = (lo, hi) of the other side."""
    n = -(-pos.shape[0] // block)
    lo, hi = n, 0
    for t in range(n):
        tlo, thi = _extremes(pos[t * block:(t + 1) * block])
        ok = (_live(*other, tlo, thi, window, causal) if keys
              else _live(tlo, thi, *other, window, causal))
        if ok:
            lo, hi = min(lo, t), max(hi, t + 1)
    return lo, hi


def _keep(qp, kp, window, causal):
    qp, kp = qp[:, None], kp[None, :]
    m = qp >= kp if causal else (kp < INVALID).expand(qp.shape[0],
                                                      kp.shape[1])
    return m & (qp - kp < window) if window > 0 else m


def tiled_forward(q, k, v, qp, kp, scale, window, causal, bm, bn):
    """Returns (o, lse in base 2, tiles computed)."""
    b, sq, h, d = q.shape
    rep = h // k.shape[2]
    o = torch.zeros(b, sq, h, d)
    lse = torch.zeros(b, h, sq)
    s2 = scale * FA.LOG2E
    done = 0
    for bi in range(b):
        for hi_ in range(h):
            kvh = hi_ // rep
            for m0 in range(0, sq, bm):
                rows = slice(m0, min(m0 + bm, sq))
                qpos = qp[bi, rows]
                lo, hi = _tile_range(kp[bi], bn, _extremes(qpos), True,
                                     window, causal)
                m_i = torch.full((qpos.shape[0],), float("-inf"))
                l_i = torch.zeros(qpos.shape[0])
                acc = torch.zeros(qpos.shape[0], d)
                for t in range(lo, hi):
                    cols = slice(t * bn, min((t + 1) * bn, k.shape[1]))
                    s = (q[bi, rows, hi_] @ k[bi, cols, kvh].T) * s2
                    s = torch.where(_keep(qpos, kp[bi, cols], window, causal),
                                    s, -1.0e30)
                    m_new = torch.maximum(m_i, s.amax(1))
                    alpha = torch.exp2(m_i - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l_i = l_i * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ v[bi, cols, kvh]
                    m_i = m_new
                    done += 1
                o[bi, rows, hi_] = acc / l_i[:, None]
                lse[bi, hi_, rows] = m_i + torch.log2(l_i)
    return o, lse, done


def tiled_backward(do, q, k, v, qp, kp, o, lse, scale, window, causal, bm,
                   bn):
    b, sq, h, d = q.shape
    sk, kvs = k.shape[1], k.shape[2]
    rep = h // kvs
    s2 = scale * FA.LOG2E
    delta = (do * o).sum(-1).permute(0, 2, 1)          # [B, H, Sq]
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for bi in range(b):
        for kvh in range(kvs):                         # dK, dV
            for n0 in range(0, sk, bn):
                cols = slice(n0, min(n0 + bn, sk))
                kpos = kp[bi, cols]
                lo, hi = _tile_range(qp[bi], bm, _extremes(kpos), False,
                                     window, causal)
                for hq in range(kvh * rep, (kvh + 1) * rep):
                    for t in range(lo, hi):
                        rows = slice(t * bm, min((t + 1) * bm, sq))
                        s_t = (k[bi, cols, kvh] @ q[bi, rows, hq].T) * s2
                        keep = _keep(qp[bi, rows], kpos, window, causal).T
                        p_t = torch.where(keep, torch.exp2(
                            s_t - lse[bi, hq, rows][None]), 0.0)
                        dv[bi, cols, kvh] += p_t @ do[bi, rows, hq]
                        dp_t = v[bi, cols, kvh] @ do[bi, rows, hq].T
                        ds_t = p_t * (dp_t - delta[bi, hq, rows][None])
                        dk[bi, cols, kvh] += ds_t @ q[bi, rows, hq]
        for hq in range(h):                            # dQ
            kvh = hq // rep
            for m0 in range(0, sq, bm):
                rows = slice(m0, min(m0 + bm, sq))
                qpos = qp[bi, rows]
                lo, hi = _tile_range(kp[bi], bn, _extremes(qpos), True,
                                     window, causal)
                for t in range(lo, hi):
                    cols = slice(t * bn, min((t + 1) * bn, sk))
                    s = (q[bi, rows, hq] @ k[bi, cols, kvh].T) * s2
                    keep = _keep(qpos, kp[bi, cols], window, causal)
                    p = torch.where(keep, torch.exp2(
                        s - lse[bi, hq, rows][:, None]), 0.0)
                    dp = do[bi, rows, hq] @ v[bi, cols, kvh].T
                    ds = p * (dp - delta[bi, hq, rows][:, None])
                    dq[bi, rows, hq] += ds @ k[bi, cols, kvh]
    return dq * scale, dk * scale, dv


def _ref(q, k, v, qp, kp, window, causal):
    """``_attn_block`` in float64 and its autograd."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    out = L._attn_block(q, k, v, qp, kp, q.shape[2] // k.shape[2],
                        q.shape[-1] ** -0.5, window, causal, torch.float64)
    return out, (q, k, v)


def _close(a, r, tol=2e-5):
    a, r = a.detach().double(), r.detach().double()
    assert float((a - r).abs().max()) <= tol * float(r.abs().max()), \
        float((a - r).abs().max())


# name: b, sq, sk, h, kv, d, causal, window, positions
TILED = {
    "encoder_1500": (1, 1500, 1500, 2, 2, 8, False, 0, "arange"),
    "decoder_448": (2, 448, 448, 2, 2, 8, True, 0, "arange"),
    "cross_448x1500": (1, 448, 1500, 2, 2, 8, False, 0, "arange"),
    "gqa_causal": (1, 520, 520, 6, 2, 16, True, 0, "arange"),
    "window": (2, 300, 300, 4, 1, 8, True, 37, "arange"),
    "window_not_causal": (1, 260, 260, 2, 1, 8, False, 50, "arange"),
    "shuffled_causal": (2, 200, 200, 2, 1, 8, True, 0, "shuffled"),
    "empty_slots": (2, 100, 300, 2, 2, 8, False, 0, "slots"),
}


def _positions(kind, b, sq, sk, g):
    if kind == "arange":
        return (torch.arange(sq, dtype=torch.int32)[None].expand(b, sq),
                torch.arange(sk, dtype=torch.int32)[None].expand(b, sk))
    if kind == "shuffled":      # the same positions on both sides
        p = torch.stack([torch.randperm(sq, generator=g) for _ in range(b)])
        return p.int(), p.int()
    kp = torch.arange(sk, dtype=torch.int32)[None].repeat(b, 1)
    kp[:, 170:] = INVALID       # a cache whose tail slots are empty
    return torch.arange(sq, dtype=torch.int32)[None].expand(b, sq), kp


def _inputs(spec, seed=0):
    b, sq, sk, h, kv, d, causal, window, kind = spec
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, sq, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, sk, kv, d, generator=g) for _ in range(2))
    qp, kp = _positions(kind, b, sq, sk, g)
    return q, k, v, do, qp, kp, causal, window


@pytest.mark.parametrize("name", sorted(TILED))
def test_tiled_algorithm_matches_attn_block(name):
    q, k, v, do, qp, kp, causal, window = _inputs(TILED[name])
    scale = q.shape[-1] ** -0.5
    bm, bn = 128, 64
    o, lse, done = tiled_forward(q, k, v, qp, kp, scale, window, causal,
                                 bm, bn)
    ref, leaves = _ref(q, k, v, qp, kp, window, causal)
    _close(o, ref)
    grads = tiled_backward(do, q, k, v, qp, kp, o, lse, scale, window,
                           causal, bm, bn)
    for a, r in zip(grads, torch.autograd.grad(ref, leaves, do.double())):
        _close(a, r)
    # the plain version beside the kernel does the same arithmetic densely
    po, plse = FA.forward_plain(q, k, v, qp, kp, scale, window, causal)
    _close(po, ref)
    assert float((plse - lse).abs().max()) < 1e-4
    tiles = (q.shape[0] * q.shape[2] * -(-q.shape[1] // bm)
             * -(-k.shape[1] // bn))
    if TILED[name][-1] == "arange" and causal and not window:
        assert done < 0.7 * tiles     # the upper triangle is skipped
    if TILED[name][-1] == "slots":
        assert done < tiles           # the empty tail is skipped
    if not causal and not window and TILED[name][-1] == "arange":
        assert done == tiles


def test_skipping_a_masked_tile_is_exact():
    """A fully masked tile inside the live range adds exactly 0: the same
    bits with the range widened to every tile."""
    q, k, v, _, qp, kp, causal, window = _inputs(TILED["window"])
    scale = q.shape[-1] ** -0.5
    o, lse, _ = tiled_forward(q, k, v, qp, kp, scale, window, causal, 64, 32)
    saved = _tile_range.__code__
    try:
        _tile_range.__code__ = (lambda pos, block, other, keys, window,
                                causal: (0, -(-pos.shape[0] // block))
                                ).__code__
        o2, lse2, _ = tiled_forward(q, k, v, qp, kp, scale, window, causal,
                                    64, 32)
    finally:
        _tile_range.__code__ = saved
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


# ---------------------------------------------------------------------------
# the binding, through the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["decoder_448", "gqa_causal", "window",
                                  "empty_slots", "shuffled_causal"])
def test_flash_attention_matches_attn_block(name):
    b, sq, sk, h, kv, d, causal, window, kind = TILED[name]
    q, k, v, do, qp, kp, causal, window = _inputs(
        (b, min(sq, 200), min(sk, 300), h, kv, d, causal, window, kind))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves, qp, kp, scale=d ** -0.5, window=window,
                             causal=causal)
    ref, rleaves = _ref(q, k, v, qp, kp, window, causal)
    _close(out, ref)
    for a, r in zip(torch.autograd.grad(out, leaves, do),
                    torch.autograd.grad(ref, rleaves, do.double())):
        _close(a, r)


def _loss(q, k, v, qp, kp, causal=True):
    out = FA.flash_attention(q, k, v, qp, kp, scale=0.25, causal=causal)
    return (out.float() ** 2).sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmap_grad_equals_the_loop_over_workers(dtype):
    g = torch.Generator().manual_seed(3)
    w, b, s, h, kv, d = 3, 2, 40, 4, 2, 16
    qs = torch.randn(w, b, s, h, d, generator=g).to(dtype)
    ks, vs = (torch.randn(w, b, s, kv, d, generator=g).to(dtype)
              for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    fn = torch.func.grad_and_value(_loss, argnums=(0, 1, 2))
    grads, vals = torch.func.vmap(fn, in_dims=(0, 0, 0, None, None))(
        qs, ks, vs, pos, pos)
    for i in range(w):
        gi, vi = fn(qs[i], ks[i], vs[i], pos, pos)
        assert torch.equal(vals[i], vi)
        for a, r in zip(grads, gi):
            assert torch.equal(a[i], r)


@pytest.mark.parametrize("kv_dim", [0, None])
@pytest.mark.parametrize("pos_dims", [(0, 0), (None, 0), (0, None)])
def test_vmapped_positions_fold_as_the_loop(pos_dims, kv_dim):
    """Positions vmapped or not, one row or the batch's, k and v vmapped
    or shared: batch row b reads position row b mod rows, as the loop over
    workers does."""
    g = torch.Generator().manual_seed(4)
    w, b, s, h, d = 2, 3, 24, 2, 8
    qs, ks, vs = (torch.randn(w, b, s, h, d, generator=g) for _ in range(3))
    if kv_dim is None:
        ks, vs = ks[0], vs[0]
    perm = torch.stack([torch.randperm(s, generator=g) for _ in range(w)])
    qp = perm[:, None].expand(w, b, s) if pos_dims[0] == 0 else perm[0]
    kp = perm[:, None, :] if pos_dims[1] == 0 else perm[0][None]
    fn = torch.func.grad(_loss, argnums=(0, 1, 2))
    grads = torch.func.vmap(fn, in_dims=(0, kv_dim, kv_dim) + pos_dims)(
        qs, ks, vs, qp, kp)
    for i in range(w):
        qi = qp[i] if pos_dims[0] == 0 else qp
        ki = kp[i] if pos_dims[1] == 0 else kp
        kvi = (ks[i], vs[i]) if kv_dim == 0 else (ks, vs)
        for a, r in zip(grads, fn(qs[i], *kvi, qi, ki)):
            assert torch.equal(a[i], r)


def test_remat_checkpoint_changes_no_bit():
    """Under ``vmap(grad_and_value)`` through remat's checkpoint (the
    recompute under ``torch.func.vjp``), the gradients of the run without
    it, bit for bit."""
    g = torch.Generator().manual_seed(5)
    w, b, s, h, d = 2, 2, 32, 4, 16
    x = torch.randn(w, b, s, h * d, generator=g)
    wq = torch.randn(h * d, h * d, generator=g) * 0.1
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)

    def body(x, pos, wq):
        q = (x @ wq).reshape(b, s, h, d)
        return (FA.flash_attention(q, q, q, pos, pos, scale=0.25)
                .reshape(b, s, h * d),)

    def loss(wq, x, remat):
        if remat:
            y, = RM.checkpoint(body, RM.saved_products(None), x, pos, wq)
        else:
            y, = body(x, pos, wq)
        return (y ** 2).sum()

    outs = [torch.func.vmap(torch.func.grad_and_value(loss),
                            in_dims=(None, 0, None))(wq, x, remat)
            for remat in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_second_derivative_refused():
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    pos = torch.arange(8)
    out = FA.flash_attention(q, q, q, pos, pos, scale=0.3)
    g, = torch.autograd.grad(out.sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="second derivative"):
        torch.autograd.grad(g.sum(), q)


@pytest.mark.parametrize("bad", ["rows", "float_pos", "kv_heads"])
def test_operands_checked(bad):
    q = torch.randn(4, 8, 4, 8)
    k = torch.randn(4, 8, 3 if bad == "kv_heads" else 2, 8)
    pos = torch.arange(8)
    qp = pos[None].expand(3, 8) if bad == "rows" else pos
    qp = qp.float() if bad == "float_pos" else qp
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, k, qp, pos, scale=0.3)


# ---------------------------------------------------------------------------
# the model's counts
# ---------------------------------------------------------------------------

def _fused_counts(arch, monkeypatch, force):
    """attn_fused of each attention record of one traced Artemis step
    (W = 2, remat on), the route forced onto the plain version where
    ``force``."""
    if force:
        monkeypatch.setattr(L, "fused_route",
                            lambda q, k, v, fusable=False, **kw: fusable)
    cfg = dataclasses.replace(get_config(arch, reduced=True), remat=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(4, cfg.n_frames, cfg.d_model,
                                      generator=g)
    dcfg = dist.DistConfig(seed=5, bucket_bytes=4096, max_buckets=16,
                           bucket_row=64)
    init, step = dist.make_train_step(model, adam(1e-3), dcfg, 2,
                                      torch.device("cpu"))
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, (loss, _) = step(init(params), batch)
    recs = [r for r in spans.phases() if r.name == "grads/attention"]
    return cfg, loss, [r.counts.get("attn_fused") for r in recs
                       if r.pass_ != spans.BACKWARD]


@pytest.mark.parametrize("arch", ["whisper-tiny", "starcoder2-7b"])
def test_attn_fused_counts_each_attention_twice(arch, monkeypatch):
    cfg, loss, plain = _fused_counts(arch, monkeypatch, force=False)
    calls = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
             else cfg.n_layers)
    assert plain == [0] * (2 * calls)           # the CPU: the eager ops
    _, fused_loss, fused = _fused_counts(arch, monkeypatch, force=True)
    assert fused == [1] * (2 * calls)           # forward and recompute
    assert torch.allclose(fused_loss, loss, rtol=1e-5)
