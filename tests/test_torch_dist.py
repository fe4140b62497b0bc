"""The port's bucketed mesh wire against the JAX package's.

Inputs are made from numpy seeds (or by the reference's own initializers)
and carried across with ``repro_torch.convert``; the port's steps take a
noise source that replays the reference's ``_round_keys`` chain (uplink
``fold_in(fold_in(base, wid + 1), bucket)``, participation
``fold_in(fold_in(base, 999), wid)``, downlink ``fold_in(fold_in(base, 0),
bucket)``, with ``base = fold_in(PRNGKey(seed), step)``).

Tolerances:
  * layouts and bucket contents: exact;
  * ``bucket_acc``: the plain version against the interpreted Pallas kernel
    to atol 1e-6 (the interpreted body may fuse to an FMA; ROADMAP §C);
    ``bucket_ring_sum`` against the hop chain bit for bit, against
    ``bucket_ring_sum_ref`` to 1e-5;
  * one aggregate: rtol 1e-5, atol 1e-6 on the aggregate and the new state,
    on all but at most 1e-4 of the entries (the f32 row norms may differ by
    an ulp, which can move a level by one: the bar of ROADMAP B5);
  * whole steps: losses to rtol 1e-4; parameters, h and hbar to rtol 1e-4,
    atol 1e-6 on all but 1e-3 of the parameters, 1e-4 of the h entries and
    W * 1e-4 of the hbar entries (each sums W workers' levels), and every
    parameter to atol 1e-4.  The gradients differ in
    the last bits (another matmul order; and each of the reference's
    workers keeps its own copy of the replicated parameters, updated with
    its own ring sum, where the port keeps worker 0's).  Once h tracks the
    gradient, g - h cancels those bits up, and a level may move by one: it
    moves one entry of h by alpha times the row's scale, and the row's
    downlink scale a little, which moves the row's parameters by ~1e-5.

The whole-step reference needs 4 CPU devices, fixed when JAX starts, so it
runs once per module in a subprocess: this file re-invokes itself with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and reads the
``.npz`` it writes.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.prop import given, settings, st

from repro.core import bucketing as jb
from repro.core import dist as jdist
from repro.core import faults as jflt
from repro.kernels import bucket_ring as jbk
from repro.models.toy import ToyMLP as JToyMLP
from repro.optim import optimizers as jopt
from repro_torch import convert, experiments
from repro_torch.core import bucketing as tb
from repro_torch.core import codec as tcodec
from repro_torch.core import dist as tdist
from repro_torch.core import faults as tfaults
from repro_torch.core import noise as tnoise
from repro_torch.kernels import bucket_ring as tbk
from repro_torch.models.toy import ToyMLP
from repro_torch.optim import optimizers as topt
from test_torch_faults import leaf_draws

W = 4
WIRE = dict(s=3, bucket_bytes=4096, max_buckets=8, bucket_row=64)
STEP_CASES = {"artemis": dict(variant="artemis"),
              "dore": dict(variant="dore"),
              "sgd": dict(variant="sgd"),
              "artemis_p05": dict(variant="artemis", p_participation=0.5),
              "leaf_artemis": dict(variant="artemis", wire="leaf"),
              "leaf_dore_p05": dict(variant="dore", wire="leaf",
                                    p_participation=0.5),
              # stragglers over a Markov chain, NaN blowups, scrubbing
              "faulted": dict(variant="artemis", p_participation=0.5,
                              faults=dict(straggler_rate=0.25, p_stay=0.8,
                                          blowup_rate=0.3, scrub=True))}


def _case_kw(case, flt):
    """STEP_CASES[case] with its faults as ``flt.FaultConfig``."""
    kw = dict(STEP_CASES[case])
    if "faults" in kw:
        kw["faults"] = flt.FaultConfig(**kw["faults"])
    return kw


def _state_leaves(x):
    """The mesh state's field as a list of arrays (the leaf wire's per-leaf
    lists or trees; the bucketed wire's one stack)."""
    if isinstance(x, (list, tuple, dict)):
        return [np.asarray(a) for a in jax.tree.leaves(x)]
    return [np.asarray(x)]


def _jax_params(n_layers=4, d=64):
    return JToyMLP(n_layers, d).init(jax.random.PRNGKey(0))


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


class JaxMeshReplay:
    """Replays the reference mesh step's draws for ``seed`` (DistConfig's):
    the uplink and downlink uniforms of every bucket (``shape`` [B, R, C])
    or of every parameter leaf (``shape`` a list of leaf shapes), the
    participation uniform of every worker, and, when asked, the fault
    draws of ``_round_keys``: the straggler and blowup uniforms and the bit
    flips of every wire message, ``fold_in(flt_key, 3)`` for the bucket
    stack and ``fold_in(flt_key, 10 + i)`` for leaf i."""

    def __init__(self, seed, n_workers, shape):
        self.seed, self.n = seed, n_workers
        self.bucketed = all(isinstance(d, int) for d in shape)
        self.shapes = ([tuple(shape)] if self.bucketed
                       else [tuple(x) for x in shape])

    def _uniforms(self, key):
        if self.bucketed:
            b, r, c = self.shapes[0]
            return [jax.vmap(lambda i: jax.random.uniform(
                jax.random.fold_in(key, i), (r, c), jnp.float32))(
                    jnp.arange(b))]
        return [jax.random.uniform(jax.random.fold_in(key, i), s)
                for i, s in enumerate(self.shapes)]

    def step(self, k, *, faults=False, leaves=()):
        base = jax.random.fold_in(jax.random.PRNGKey(self.seed), k)
        ups = [self._uniforms(jax.random.fold_in(base, w + 1))
               for w in range(self.n)]
        u_up = [_t(jnp.stack([u[i] for u in ups]))
                for i in range(len(self.shapes))]
        u_act = _t(jnp.stack([jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(base, 999), w), ()) for w in range(self.n)]))
        u_dwn = [_t(u) for u in self._uniforms(jax.random.fold_in(base, 0))]
        if self.bucketed:
            u_up, u_dwn = u_up[0], u_dwn[0]
        draws = tnoise.MeshDraws(u_up=u_up, u_act=u_act, u_dwn=u_dwn)
        if not faults:
            return draws
        flt = [jax.random.fold_in(jax.random.fold_in(base, jflt.FAULT_SALT),
                                  w) for w in range(self.n)]
        draws.u_strag, draws.u_blow = (
            _t(jnp.stack([jax.random.uniform(jax.random.fold_in(f, j), ())
                          for f in flt])) for j in (1, 2))
        if leaves:
            salts = [3] if self.bucketed else [10 + i
                                               for i in range(len(leaves))]
            draws.flips = []
            for salt, spec in zip(salts, leaves):
                per_w = [leaf_draws(jax.random.fold_in(f, salt), spec)
                         for f in flt]
                draws.flips.append([
                    (_t(jnp.stack([d[j][0] for d in per_w])),
                     _t(jnp.stack([d[j][1] for d in per_w])))
                    for j in range(len(spec))])
        return draws


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_mostly_close(out, ref, rtol=1e-5, atol=1e-6, frac=1e-4,
                        equal_nan=False):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    bad = ~np.isclose(out, ref, rtol=rtol, atol=atol, equal_nan=equal_nan)
    assert bad.mean() <= frac, (bad.sum(), bad.size,
                                np.abs(out - ref).max())


# ---------------------------------------------------------------------------
# layout and bucketing
# ---------------------------------------------------------------------------

SHAPE_SETS = [[(37, 11), (5,), (301,), (2, 3, 7)], [(1,), ()], [(17, 13)],
              [(256,), (31, 9), (4, 4), (5,)]]


def _same_layout(shapes, **kw):
    ref = jb.make_layout([jax.ShapeDtypeStruct(s, jnp.float32)
                          for s in shapes], **kw)
    lay = tb.make_layout(shapes, **kw)
    assert (lay.shape, lay.pad, lay.offsets, lay.sizes, lay.shapes) == (
        ref.shape, ref.pad, ref.offsets, ref.sizes, ref.shapes)
    return lay


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 8192), st.integers(1, 20), st.sampled_from([1, 8, 64,
                                                                  256]),
       st.integers(0, 3))
def test_make_layout_matches_reference(bucket_bytes, max_buckets, row, which):
    _same_layout(SHAPE_SETS[which], bucket_bytes=bucket_bytes,
                 max_buckets=max_buckets, row=row)


@pytest.mark.parametrize("n_layers,d,kw,shape,pad", [
    (12, 64, dict(bucket_bytes=4096, max_buckets=16, row=64), (16, 49, 64),
     192),
    (12, 1024, {}, (16, 3076, 256), 3072),
    (4, 64, dict(bucket_bytes=4096, max_buckets=8, row=64), (8, 33, 64),
     192)])
def test_toy_layouts(n_layers, d, kw, shape, pad):
    model = ToyMLP(n_layers, d)
    shapes = [tuple(p.shape) for p in model.leaves().values()]
    lay = _same_layout(shapes, **kw)
    assert (lay.shape, lay.pad) == (shape, pad)


def test_toy_leaf_order_is_the_references():
    jp = _jax_params()
    ref = [tuple(l.shape) for l in jax.tree.leaves(jp)]
    params = convert.toy_params(_as_numpy(jp), device="cpu")
    assert list(params) == list(ToyMLP(4, 64).names())
    assert [tuple(p.shape) for p in params.values()] == ref


@pytest.mark.parametrize("which", range(len(SHAPE_SETS)))
@pytest.mark.parametrize("lead", [(), (3,)])
def test_bucketize_roundtrip(which, lead):
    shapes = SHAPE_SETS[which]
    rng = np.random.default_rng(which)
    leaves = [torch.from_numpy(rng.standard_normal(lead + s).astype(
        np.float32)) for s in shapes]
    lay = tb.make_layout(shapes, bucket_bytes=256, max_buckets=4, row=16)
    buckets = tb.bucketize(lay, leaves)
    assert tuple(buckets.shape) == lead + lay.shape
    flat = buckets.reshape(lead + (-1,))
    assert (flat[..., lay.total:] == 0).all()
    for a, b in zip(leaves, tb.unbucketize(lay, buckets, like=leaves)):
        assert torch.equal(a, b)


def test_bucket_contents_match_reference():
    jp = _jax_params()
    kw = dict(bucket_bytes=4096, max_buckets=8, row=64)
    ref = np.asarray(jb.bucketize(jb.make_layout(jp, **kw), jp))
    params = list(convert.toy_params(_as_numpy(jp), device="cpu").values())
    out = tb.bucketize(tb.make_layout(params, **kw), params)
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

def _payload(seed, n, b, r, c):
    rng = np.random.default_rng(seed)
    q = rng.integers(-4, 5, (n, b, r, c)).astype(np.int8)
    sc = rng.random((n, b, r, 1), dtype=np.float32)
    return q, sc


@pytest.mark.parametrize("b,r,c", [(3, 8, 16), (16, 49, 64), (2, 33, 1)])
def test_bucket_acc_plain_matches_pallas(b, r, c):
    q, sc = _payload(b + r + c, 1, b, r, c)
    acc = np.random.default_rng(1).standard_normal((b, r, c)).astype(
        np.float32)
    ref = jbk.bucket_acc(jnp.asarray(acc), jnp.asarray(q[0]),
                         jnp.asarray(sc[0]), interpret=True)
    before = tbk.bucket_acc.launches
    out = tbk.bucket_acc(torch.from_numpy(acc), torch.from_numpy(q[0]),
                         torch.from_numpy(sc[0]))
    assert tbk.bucket_acc.launches == before      # the plain version ran
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jbk.bucket_acc_ref(acc, q[0], sc[0])))


def test_bucket_acc_takes_leading_axes():
    q, sc = _payload(3, W, 2, 8, 16)
    acc = torch.randn(W, 2, 8, 16, generator=torch.Generator().manual_seed(0))
    out = tbk.bucket_acc(acc, torch.from_numpy(q), torch.from_numpy(sc))
    for w in range(W):
        assert torch.equal(out[w], tbk.bucket_acc(acc[w], torch.from_numpy(
            q[w]), torch.from_numpy(sc[w])))


@pytest.mark.parametrize("hop", range(W))
@pytest.mark.parametrize("b,r,c", [(3, 8, 64), (2, 33, 5)])
def test_bucket_acc_hop_plain_matches_reference(b, r, c, hop):
    """Hop ``hop`` of the ring in place equals the reference's fold of the
    rolled payload; at hop 0 it starts from 0.0 whatever ``acc`` held."""
    q, sc = _payload(10 * hop + r + c, W, b, r, c)
    acc = np.random.default_rng(hop).standard_normal((W, b, r, c)).astype(
        np.float32)
    ref = jbk.bucket_acc_ref(np.zeros_like(acc) if hop == 0 else acc,
                             jnp.roll(q, hop, 0), jnp.roll(sc, hop, 0))
    tacc = torch.full(acc.shape, float("nan")) if hop == 0 \
        else torch.from_numpy(acc.copy())
    ptr, before = tacc.data_ptr(), tbk.bucket_acc.launches
    out = tbk.bucket_acc_hop_(tacc, torch.from_numpy(q), torch.from_numpy(sc),
                              hop)
    assert tbk.bucket_acc.launches == before      # the plain version ran
    assert out is tacc and out.data_ptr() == ptr
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bucket_acc_hop_rules():
    q, sc = _payload(1, W, 2, 8, 16)
    tq, tsc = torch.from_numpy(q), torch.from_numpy(sc)
    for hop in (-1, W):
        with pytest.raises(ValueError, match="0 <= hop < W"):
            tbk.bucket_acc_hop_(torch.zeros(tq.shape), tq, tsc, hop)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbk.bucket_acc_hop_(torch.zeros(tq.shape, device="meta"),
                            tq.to("meta"), tsc.to("meta"), 0)


def test_pipelined_ring_hops_in_place_without_rolls(monkeypatch):
    """The pipelined ring of the row-scale payload makes one accumulator and
    W in-place hops 0 .. W-1 on the untouched payload, with no roll."""
    codec = tdist.DistConfig(**WIRE).wire_codec(64)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((W, 2, 8, 64)).astype(
        np.float32))
    u = torch.from_numpy(rng.random((W, 2, 8, 64), dtype=np.float32))
    enc = tb.encode_buckets(codec, x, u)
    calls = []
    real = tdist.bucket_acc_hop_

    def hop_(acc, q, scales, hop):
        calls.append((acc.data_ptr(), q is enc["levels"],
                      scales is enc["scales"], hop))
        return real(acc, q, scales, hop)

    def no_roll(_):
        raise AssertionError("the pipelined ring rolled its payload")

    monkeypatch.setattr(tdist, "bucket_acc_hop_", hop_)
    monkeypatch.setattr(tdist, "_roll", no_roll)
    out = tdist.bucket_ring_reduce(codec, enc, W)
    assert [c[3] for c in calls] == list(range(W))
    assert all(c[1] and c[2] for c in calls)
    assert {c[0] for c in calls} == {out.data_ptr()}
    monkeypatch.undo()
    assert torch.equal(out, tdist.bucket_ring_reduce_sequential(codec, enc,
                                                                W))


@pytest.mark.parametrize("n,b,r,c", [(5, 4, 8, 16), (8, 16, 49, 64),
                                     (3, 2, 33, 1)])
def test_bucket_ring_sum_plain_matches_chain_and_reference(n, b, r, c):
    q, sc = _payload(n + b + r + c, n, b, r, c)
    tq, tsc = torch.from_numpy(q), torch.from_numpy(sc)
    out = tbk.bucket_ring_sum(tq, tsc)
    acc = torch.zeros(b, r, c)
    for i in range(n):
        acc = tbk.bucket_acc(acc, tq[i], tsc[i])
    assert torch.equal(out, acc)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jbk.bucket_ring_sum_ref(jnp.asarray(q), jnp.asarray(sc))), atol=1e-5)


# ---------------------------------------------------------------------------
# one aggregate, against the reference's aggregate under a named vmap
# ---------------------------------------------------------------------------

def _aggregate_inputs(dcfg_kw, step=3):
    """Random gradients and state for ToyMLP(4, 64)'s [8, 33, 64] layout."""
    jcfg = jdist.DistConfig(worker_axes=("pod",), **WIRE, **dcfg_kw)
    lay = jcfg.layout(_jax_params())
    rng = np.random.default_rng(7)
    full = (W,) + lay.shape
    g = rng.standard_normal(full).astype(np.float32)
    st0 = jdist.init_dist_state(jcfg, _jax_params(), W)
    h = (0.5 * rng.standard_normal(full)).astype(np.float32) \
        if jcfg.memory else np.asarray(st0.h)
    hbar = (0.5 * rng.standard_normal(lay.shape)).astype(np.float32) \
        if jcfg.memory else np.asarray(st0.hbar)
    e = (0.1 * rng.standard_normal(full)).astype(np.float32) \
        if jcfg.use_ef else np.asarray(st0.e)
    return jcfg, lay, g, dict(h=h, hbar=hbar, e=e, acc=np.asarray(st0.acc),
                              prev_active=np.zeros(W, np.float32), step=step)


def _reference_aggregate(jcfg, lay, g, s):
    """The reference's ``artemis_aggregate_bucketed`` for every worker, under
    ``jax.vmap`` with the worker axis named: its ppermute ring and its
    ``bucket_acc`` chain (interpreted) run as in the mesh."""
    def one(gb, h, e, acc, prev):
        wid = jax.lax.axis_index("pod")
        state = jdist.ArtemisDistState(h[None], jnp.asarray(s["hbar"]),
                                       e[None], acc[None], prev[None],
                                       jnp.int32(s["step"]))
        ghat, new = jdist.artemis_aggregate_bucketed(jcfg, state, gb, lay, W,
                                                     wid)
        return ghat, new.h[0], new.hbar, new.e[0], new.prev_active[0]

    out = jax.vmap(one, axis_name="pod")(
        jnp.asarray(g), jnp.asarray(s["h"]), jnp.asarray(s["e"]),
        jnp.asarray(s["acc"]), jnp.asarray(s["prev_active"]))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("variant", tdist.VARIANTS)
def test_aggregate_matches_reference(variant, p):
    kw = dict(variant=variant, p_participation=p)
    jcfg, lay, g, s = _aggregate_inputs(kw)
    ghat_r, h_r, hbar_r, e_r, part_r = _reference_aggregate(jcfg, lay, g, s)
    tcfg = tdist.DistConfig(**WIRE, **kw)
    state = convert.dist_state(**s, device="cpu")
    draws = JaxMeshReplay(tcfg.seed, W, lay.shape).step(s["step"])
    ghat, new = tdist.artemis_aggregate_bucketed(
        tcfg, state, torch.from_numpy(g),
        tb.make_layout(lay.shapes, bucket_bytes=4096, max_buckets=8, row=64),
        W, draws)
    assert new.step == s["step"] + 1
    np.testing.assert_array_equal(new.prev_active.numpy(), part_r)
    assert_mostly_close(ghat.numpy(), ghat_r[0])
    if tcfg.memory:
        assert_mostly_close(new.h.numpy(), h_r)
        assert_mostly_close(new.hbar.numpy(), hbar_r[0])
    if tcfg.use_ef:
        assert_mostly_close(new.e.numpy(), e_r)


@pytest.mark.parametrize("variant", tdist.VARIANTS)
def test_reduce_impls_agree_on_cpu(variant):
    """pipelined == sequential bit for bit; psum to 1e-5 (DESIGN.md §7)."""
    _, lay, g, s = _aggregate_inputs(dict(variant=variant))
    draws = JaxMeshReplay(17, W, lay.shape).step(s["step"])
    layout = tb.make_layout(lay.shapes, bucket_bytes=4096, max_buckets=8,
                            row=64)
    out = {}
    for impl in tdist.REDUCE_IMPLS:
        cfg = tdist.DistConfig(**WIRE, variant=variant, reduce_impl=impl)
        ghat, new = tdist.artemis_aggregate_bucketed(
            cfg, convert.dist_state(**s, device="cpu"), torch.from_numpy(g),
            layout, W, draws)
        out[impl] = (ghat, new.hbar)
    for a, b in zip(out["pipelined"], out["sequential"]):
        assert torch.equal(a, b)
    for a, b in zip(out["pipelined"], out["psum"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("row,s", [(64, 3), (256, 1), (1, 2)])
def test_default_alpha_matches_reference(row, s):
    a = tdist.default_alpha_bucketed(row, s)
    assert a == jdist.default_alpha_bucketed(row, s)
    assert a == tdist._codec_alpha(tdist.DistConfig(s=s), [row])


def test_zero_fault_helpers_match_reference():
    from repro.core import codec as jcodec
    from repro.core import faults as jfaults
    rng = np.random.default_rng(2)
    u = rng.random(W, dtype=np.float32)
    part = tfaults.participation(tfaults.of(None), 0.5, torch.from_numpy(u))
    np.testing.assert_array_equal(part.numpy(), np.asarray(
        jfaults.participation(jfaults.of(None), 0.5, jnp.asarray(u), None,
                              None)))
    x = rng.standard_normal((W, 2, 3, 8)).astype(np.float32)
    ux = rng.random(x.shape, dtype=np.float32)
    enc = tfaults.mask_payload(tcodec.make_codec("row_squant", 8, s=2).encode(
        torch.from_numpy(x), torch.from_numpy(ux)), part)
    jenc = jcodec.make_codec("row_squant", 8, s=2).encode(
        jax.random.PRNGKey(0), jnp.asarray(x))
    jenc = jfaults.mask_payload(jenc.replace(levels=jnp.asarray(
        enc["levels"].numpy())), jnp.asarray(part.numpy()).reshape(W, 1, 1,
                                                                     1))
    np.testing.assert_array_equal(enc["levels"].numpy(),
                                  np.asarray(jenc["levels"]))
    np.testing.assert_allclose(enc["scales"].numpy(),
                               np.asarray(jenc["scales"]), rtol=1e-6)
    assert (enc["scales"].numpy()[part.numpy() == 0] == 0).all()


# ---------------------------------------------------------------------------
# the model and the optimizers
# ---------------------------------------------------------------------------

def test_toy_loss_and_grads_match_reference():
    jp = _jax_params()
    jbatch = JToyMLP(4, 64).batch(jax.random.PRNGKey(1), n=16)
    (jloss, _), jgrads = jax.value_and_grad(JToyMLP(4, 64).loss,
                                            has_aux=True)(jp, jbatch)
    params = convert.toy_params(_as_numpy(jp), device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    fn = torch.func.grad_and_value(ToyMLP(4, 64).loss, has_aux=True)
    grads, (loss, metrics) = fn(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    for g, jg in zip(grads.values(), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.05)), ("sgd", dict(lr=0.1, momentum=0.9)),
    ("sgd", dict(lr=0.1, weight_decay=0.01)),
    ("adam", dict(lr=1e-2)), ("adam", dict(lr=1e-2, weight_decay=0.1))])
def test_optimizers_match_reference(name, kw):
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jst, tst = jo.init([jnp.asarray(p) for p in params]), \
        to.init([torch.from_numpy(p) for p in params])
    for step in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ju, jst = jo.update([jnp.asarray(g) for g in grads], jst,
                            jnp.int32(step), [jnp.asarray(p) for p in params])
        tu, tst = to.update([torch.from_numpy(g) for g in grads], tst, step,
                            [torch.from_numpy(p) for p in params])
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# whole steps against repro.core.dist.make_train_step on 4 CPU devices
# ---------------------------------------------------------------------------

def _reference_steps(out_path):
    """Three steps of ToyMLP(4, 64) on a 4-worker mesh per case; run in the
    subprocess with 4 CPU devices."""
    from repro.optim import sgd as jsgd
    assert jax.device_count() == W, jax.devices()
    mesh = jdist.make_worker_mesh((W,), ("pod",))
    model = JToyMLP(4, 64)
    params = _jax_params()
    batch = model.batch(jax.random.PRNGKey(1), n=4 * W)
    out = {}
    for case in STEP_CASES:
        dcfg = jdist.DistConfig(worker_axes=("pod",), **WIRE,
                                **_case_kw(case, jflt))
        init_state, step_fn = jdist.make_train_step(model, jsgd(0.05), dcfg,
                                                    mesh)
        state, jstep, losses = init_state(params), jax.jit(step_fn), []
        for _ in range(3):
            state, (loss, _) = jstep(state, batch)
            losses.append(float(loss))
        out[f"{case}/loss"] = np.asarray(losses)
        for i, leaf in enumerate(jax.tree.leaves(state.params)):
            out[f"{case}/param{i}"] = np.asarray(leaf)
        for name in ("h", "hbar"):
            for i, a in enumerate(_state_leaves(getattr(state.artemis,
                                                        name))):
                out[f"{case}/{name}{i}"] = a
        out[f"{case}/prev_active"] = np.asarray(state.artemis.prev_active)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference_steps(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "steps.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(path)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_reference(reference_steps, case):
    jp = _jax_params()
    jbatch = JToyMLP(4, 64).batch(jax.random.PRNGKey(1), n=4 * W)
    model = ToyMLP(4, 64)
    dcfg = tdist.DistConfig(**WIRE, **_case_kw(case, tfaults))
    params = convert.toy_params(_as_numpy(jp), device="cpu")
    shape = (dcfg.layout(list(params.values())).shape if dcfg.bucketed
             else [tuple(p.shape) for p in params.values()])
    init_state, step_fn = tdist.make_train_step(
        model, topt.sgd(0.05), dcfg, W, device="cpu",
        noise=JaxMeshReplay(dcfg.seed, W, shape))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    state, losses = init_state(params), []
    for _ in range(3):
        state, (loss, _) = step_fn(state, batch)
        losses.append(float(loss))
    ref = reference_steps
    np.testing.assert_allclose(losses, ref[f"{case}/loss"], rtol=1e-4)
    flat = np.concatenate([p.numpy().ravel()
                           for p in state.params.values()])
    flat_ref = np.concatenate([ref[f"{case}/param{i}"].ravel()
                               for i in range(len(state.params))])
    assert_mostly_close(flat, flat_ref, rtol=1e-4, atol=1e-6, frac=1e-3)
    np.testing.assert_allclose(flat, flat_ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(state.artemis.prev_active.numpy(),
                                  ref[f"{case}/prev_active"])
    if dcfg.memory:
        def flat(name):
            x = getattr(state.artemis, name)
            x = x if isinstance(x, list) else [x]
            return (np.concatenate([a.numpy().ravel() for a in x]),
                    np.concatenate([ref[f"{case}/{name}{i}"].ravel()
                                    for i in range(len(x))]))
        assert_mostly_close(*flat("h"), rtol=1e-4, atol=1e-6)
        # an entry of hbar sums W workers' levels
        assert_mostly_close(*flat("hbar"), rtol=1e-4, atol=1e-6,
                            frac=W * 1e-4)


# ---------------------------------------------------------------------------
# the port's own rules on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", tdist.VARIANTS)
def test_pipelined_equals_sequential_training(variant):
    runs = [experiments.toy_mesh_train(variant, impl, n_layers=2, d=16,
                                       steps=3, n_workers=W, device="cpu")
            for impl in ("pipelined", "sequential")]
    assert runs[0]["losses"] == runs[1]["losses"]
    for k, p in runs[0]["params"].items():
        assert torch.equal(p, runs[1]["params"][k])


def test_local_steps_accumulate_between_syncs():
    res = experiments.toy_mesh_train("artemis", n_layers=2, d=16, steps=4,
                                     n_workers=W, local_steps=2,
                                     device="cpu")
    assert res["comm_steps"] == 2
    assert np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]


def test_mesh_noise_depends_on_seed_and_step_only():
    src = tnoise.MeshNoise(5, W, (2, 3, 4), "cpu")
    a, b = src.step(3), src.step(1)
    again = tnoise.MeshNoise(5, W, (2, 3, 4), "cpu").step(3)
    assert tuple(a.u_up.shape) == (W, 2, 3, 4)
    assert tuple(a.u_act.shape) == (W,) and tuple(a.u_dwn.shape) == (2, 3, 4)
    assert torch.equal(a.u_up, again.u_up) and torch.equal(a.u_dwn,
                                                           again.u_dwn)
    assert not torch.equal(a.u_up, b.u_up)


def _without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["toy_mesh_train", "make_train_step",
                                   "init_dist_state", "toy_params"])
def test_entry_points_need_cuda_unless_cpu(monkeypatch, entry):
    _without_cuda(monkeypatch)
    params = convert.toy_params(_as_numpy(_jax_params(1, 8)), device="cpu")
    calls = {
        "toy_mesh_train": lambda **kw: experiments.toy_mesh_train(
            n_layers=1, d=8, steps=1, n_workers=2, **kw),
        "make_train_step": lambda **kw: tdist.make_train_step(
            ToyMLP(1, 8), topt.sgd(0.1), tdist.DistConfig(), 2, **kw),
        "init_dist_state": lambda **kw: tdist.init_dist_state(
            tdist.DistConfig(), list(params.values()), 2, **kw),
        "toy_params": lambda **kw: convert.toy_params(
            _as_numpy(_jax_params(1, 8)), **kw)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    calls[entry](device="cpu")


@pytest.mark.parametrize("kw", [
    dict(wire="leaf"), dict(telemetry=True),
    dict(faults=tfaults.FaultConfig(straggler_rate=0.1)),
    dict(faults=tfaults.FaultConfig(p_stay=0.9)),
    dict(faults=tfaults.FaultConfig(scrub=True))])
def test_unported_options_raise(kw):
    """These options did not run before the leaf wire, the mesh faults and
    the mesh telemetry were ported; now each trains a step, finite, and
    nothing raises."""
    model = ToyMLP(1, 8)
    params = model.init(torch.Generator().manual_seed(0))
    init_state, step_fn = tdist.make_train_step(
        model, topt.sgd(0.1), tdist.DistConfig(**kw), 2, device="cpu")
    state, (loss, metrics) = step_fn(init_state(params),
                                     model.batch(torch.Generator(), n=4))
    assert torch.isfinite(loss) and state.artemis.step == 1
    assert ("obs" in metrics) == bool(kw.get("telemetry"))


def test_zero_fault_config_runs_and_other_helpers_raise():
    tdist.make_train_step(ToyMLP(1, 8), topt.sgd(0.1),
                          tdist.DistConfig(faults=tfaults.FaultConfig()), 2,
                          device="cpu")
    for helper in (tdist.shard_map_compat, tdist.make_worker_mesh,
                   tdist.state_specs, tdist.state_shardings):
        with pytest.raises(NotImplementedError, match="dist_pg"):
            helper()
    # every codec of the registry is ported: the wire builds any of them
    assert tdist.DistConfig(codec="sparsify").wire_codec(64).name == \
        "sparsify(q=0.25)"
    with pytest.raises(ValueError):
        tdist.DistConfig(codec="nope")
    assert "row_squant" in tcodec.available()


if __name__ == "__main__":
    _reference_steps(sys.argv[1])
