"""The port's fault model against the JAX package's.

The reference's fault draws are replayed and handed to the port as tensors:
a primitive's flipped bit from ``randint(kb, shape, 0, 8 or 32)`` and its
hit uniform from ``uniform(km, shape)`` (the reference's Bernoulli draw is
that uniform below the rate), a payload's keys split per leaf in
sorted-key order; a round's wire key is ``fold_in(fold_in(key, step),
FAULT_SALT)``; a sweep's straggler and blowup uniforms come from
``fold_in(k_flt, 1)`` and ``fold_in(k_flt, 2)`` with ``k_flt =
fold_in(fold_in(key, k), FAULT_SALT)`` (``FaultReplayNoise``, which also
replays the codec draws of a cell whose step a rollback moved off the
round).  Tolerances: the primitives, Markov participation and the dense
faulted round bit for bit; the ``cuda`` round (its kernels' plain versions
on the CPU) to 1e-5 against the reference's interpreted Pallas path
(DESIGN.md §9); faulted sweeps' losses and distances to rtol 1e-4, bits,
rollbacks and step-size scales exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artemis as jart
from repro.core import codec as jwire
from repro.core import faults as jflt
from repro.core import federated as jfed
from repro.core import sweep as jsw
from repro_torch import convert
from repro_torch.core import artemis as tart
from repro_torch.core import codec as twire
from repro_torch.core import faults as tflt
from repro_torch.core import sweep as tsw
from test_torch_sweep import JaxReplayNoise

KEY = jax.random.PRNGKey(17)
N, D = 8, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def leaf_draws(key, leaves):
    """The reference's corrupt_payload draws for ``leaves`` ((shape, bit
    range), ...): split per leaf, then (bit, hit uniform) per leaf."""
    out = []
    for k, (shape, bits) in zip(jax.random.split(key, len(leaves)), leaves):
        kb, km = jax.random.split(k)
        out.append((jax.random.randint(kb, shape, 0, bits, dtype=jnp.int32),
                    jax.random.uniform(km, shape)))
    return out


class FaultReplayNoise(JaxReplayNoise):
    """JaxReplayNoise plus the reference sweep's fault draws, and its codec
    and wire draws for cells whose step fell behind the round."""

    def __init__(self, seeds, iters, n, d, batch, n_per):
        super().__init__(seeds, iters, n, d, batch, n_per)
        self.keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
        salt = jflt.FAULT_SALT

        def sweep_faults(key, k):
            k_flt = jax.random.fold_in(jax.random.fold_in(key, k), salt)
            return (jax.random.uniform(jax.random.fold_in(k_flt, 1), (n,)),
                    jax.random.uniform(jax.random.fold_in(k_flt, 2), (n,)))

        both = jax.vmap(jax.vmap(sweep_faults, (None, 0)), (0, None))(
            self.keys, jnp.arange(iters))
        self.u_strag, self.u_blow = (_t(np.asarray(x).swapaxes(0, 1))
                                     for x in both)

        def cell(key, k, step, leaves):
            k_art = jax.random.split(jax.random.fold_in(key, k), 3)[2]
            up_key, dwn_key = jax.random.split(
                jax.random.fold_in(k_art, step))
            u_up = jax.vmap(lambda kx: jax.random.uniform(kx, (d,)))(
                jax.random.split(up_key, n))
            flt = jax.random.fold_in(jax.random.fold_in(k_art, step), salt)
            return (u_up, jax.random.uniform(dwn_key, (d,)),
                    leaf_draws(flt, leaves))

        self._cells = jax.jit(
            lambda keys, k, steps, leaves: jax.vmap(
                lambda key, st: cell(key, k, st, leaves))(keys, steps),
            static_argnums=3)

    def round(self, k, *, steps=None, faults=False, leaves=()):
        nz = super().round(k)
        S = self.keys.shape[0]
        moved = steps is not None and bool((steps != k).any())
        if moved or leaves:
            if moved:
                keys = self.keys[np.arange(steps.shape[0]) % S]
                st = jnp.asarray(steps.numpy())
            else:
                keys, st = self.keys, jnp.full((S,), k, jnp.int32)
            leaves = tuple((tuple(s), b) for s, b in leaves)
            u_up, u_dwn, flips = self._cells(keys, k, st, leaves)
            if moved:
                nz.u_up, nz.u_dwn = _t(u_up), _t(u_dwn)
            if leaves:
                nz.flips = [(_t(b), _t(u)) for b, u in flips]
        if faults:
            nz.u_strag, nz.u_blow = self.u_strag[k], self.u_blow[k]
        return nz


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "f32", "i32"])
@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_corrupt_primitives_match_reference(kind, rate):
    rng = np.random.default_rng(3)
    shape = (6, 33)
    if kind == "int8":
        x = rng.integers(-128, 128, shape).astype(np.int8)
        ref = jflt.corrupt_int8(KEY, jnp.asarray(x), rate)
        port, bits = tflt.corrupt_int8, 8
    elif kind == "f32":
        x = rng.standard_normal(shape).astype(np.float32)
        x[0, :4] = [0.0, -0.0, np.inf, np.nan]
        ref = jflt.corrupt_f32(KEY, jnp.asarray(x), rate)
        port, bits = tflt.corrupt_f32, 32
    else:
        x = rng.integers(-2**31, 2**31, shape).astype(np.int32)
        ref = jflt.corrupt_i32(KEY, jnp.asarray(x), rate)
        port, bits = tflt.corrupt_i32, 32
    kb, km = jax.random.split(KEY)
    bit = jax.random.randint(kb, shape, 0, bits, dtype=jnp.int32)
    u = jax.random.uniform(km, shape)
    out = port(_t(x), _t(bit), _t(u), rate).numpy()
    ref = np.asarray(ref)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out.view(np.int8 if kind == "int8"
                                           else np.int32),
                                  ref.view(out.view(np.int8 if kind == "int8"
                                                    else np.int32).dtype))
    if rate == 1.0 and kind != "int8":
        # a flip of bit 31 (the sign) happened and came out right
        assert (np.asarray(bit) == 31).any()


@pytest.mark.parametrize("codec,kw", [("squant", {"s": 1}),
                                      ("row_squant", {"s": 2}),
                                      ("sparsify", {"q": 0.5}),
                                      ("identity", {})])
@pytest.mark.parametrize("only", [False, True])
def test_corrupt_payload_matches_reference(codec, kw, only):
    """Leaves in sorted-key order, keys split per leaf, ``only`` masking
    the workers that did not send."""
    x = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    jc, tc = jwire.make_codec(codec, D, **kw), twire.make_codec(codec, D,
                                                                **kw)
    keys = jax.random.split(KEY, N)
    jp = jax.vmap(jc.encode)(keys, jnp.asarray(x))
    u = jax.vmap(lambda k: jax.random.uniform(k, (D,)))(keys)
    tp = tc.encode(_t(x), _t(u))
    mask = (np.arange(N) % 3 != 0).astype(np.float32)
    ref = jflt.corrupt_payload(KEY, jp, 0.2,
                               only=jnp.asarray(mask) if only else None)
    leaves = tuple((tuple(t.shape), tflt.flip_bits(t.dtype))
                   for t in tp.leaves())
    draws = [(_t(b), _t(v)) for b, v in leaf_draws(KEY, leaves)]
    out = tflt.corrupt_payload(draws, tp, 0.2, only=_t(mask) if only
                               else None)
    for k in out.keys():
        a, r = out[k].numpy(), np.asarray(ref[k])
        np.testing.assert_array_equal(a.reshape(r.shape).view(np.uint8),
                                      r.view(np.uint8), err_msg=k)
    with pytest.raises(ValueError):
        tflt.corrupt_payload(draws + draws[:1], tp, 0.2)


def test_scrub_mask_and_validity_match_reference():
    rng = np.random.default_rng(6)
    q = rng.integers(-4, 5, (N, D)).astype(np.int8)
    sc = rng.random((N, 1)).astype(np.float32)
    sc[1, 0], sc[2, 0], sc[3, 0] = np.nan, -np.inf, -0.5
    q[4, 3] = -128
    jp = jwire.WirePayload({"levels": jnp.asarray(q),
                            "scales": jnp.asarray(sc)},
                           jwire.PayloadMeta("row_squant", (N, D), "float32",
                                             (("s", 2),)))
    tp = twire.WirePayload({"levels": _t(q), "scales": _t(sc)},
                           twire.PayloadMeta("row_squant", (N, D),
                                             "torch.float32", (("s", 2),)))
    jv = jflt.payload_valid(jnp.asarray(q), jnp.asarray(sc), 3, -1)
    tv = tflt.payload_valid(_t(q), _t(sc), 3, -1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    valid = tv[:, 0]
    for jop, top in ((jflt.scrub_payload, tflt.scrub_payload),
                     (jflt.mask_payload, tflt.mask_payload)):
        jo, to = jop(jp, jnp.asarray(valid.numpy())), top(tp, valid)
        for k in ("levels", "scales"):
            np.testing.assert_array_equal(
                to[k].numpy().view(np.uint8),
                np.asarray(jo[k]).view(np.uint8), err_msg=k)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x[2, 5], x[6, 0] = np.nan, np.inf
    np.testing.assert_array_equal(tflt.nan_to_zero(_t(x)).numpy(),
                                  np.asarray(jflt.nan_to_zero(x)))
    for axes in (-1, (0, 1)):
        np.testing.assert_array_equal(
            tflt.finite_mask(_t(x), axes).numpy(),
            np.asarray(jflt.finite_mask(jnp.asarray(x), axes)))


@pytest.mark.parametrize("value", [float("nan"), 1e15])
def test_blowup_matches_reference(value):
    fc_t = tflt.FaultConfig(blowup_rate=0.4, blowup_value=value)
    fc_j = jflt.FaultConfig(blowup_rate=0.4, blowup_value=value)
    g = np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)
    u = jax.random.uniform(KEY, (N,))
    ref = jflt.inject_blowup(fc_j, KEY, jnp.asarray(g))
    out = tflt.inject_blowup(fc_t, _t(u), _t(g))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tflt.blowup_mask(fc_t, _t(u)).numpy(),
        np.asarray(jflt.blowup_mask(fc_j, KEY, N)))


@pytest.mark.parametrize("p,p_stay", [(0.5, 0.9), (0.7, 0.7), (0.3, 0.1),
                                      (1.0, 0.6)])
def test_markov_participation_matches_reference(p, p_stay):
    fc_t, fc_j = tflt.FaultConfig(p_stay=p_stay), jflt.FaultConfig(
        p_stay=p_stay)
    u = np.asarray(jax.random.uniform(KEY, (50, 64)))
    prev_t, prev_j = torch.zeros(64), jnp.zeros(64)
    for k in range(50):
        prev_t = tflt.participation(fc_t, p, _t(u[k]), prev_t, k)
        prev_j = jflt.participation(fc_j, p, jnp.asarray(u[k]), prev_j,
                                    jnp.int32(k))
        np.testing.assert_array_equal(prev_t.numpy(), np.asarray(prev_j))
    assert tflt.markov_rates(fc_t, p) == jflt.markov_rates(fc_j, p)
    assert tflt.markov_autocorr(fc_t, p) == jflt.markov_autocorr(fc_j, p)


def test_markov_infeasible_chain_raises(tprob):
    fc = tflt.FaultConfig(p_stay=0.1)
    with pytest.raises(ValueError, match="infeasible"):
        tflt.markov_rates(fc, 0.9)
    with pytest.raises(ValueError, match="infeasible"):
        jflt.markov_rates(jflt.FaultConfig(p_stay=0.1), 0.9)
    cfg = dataclasses.replace(tart.variant_config("artemis", D, N, p=0.9),
                              faults=fc)
    with pytest.raises(ValueError, match="infeasible"):
        tsw.run_sweep(tprob, [cfg], [0.02], [0], 2, device="cpu")


def test_fault_config_validation_and_gates():
    for bad in (dict(bitflip_rate=1.5), dict(p_stay=-0.1),
                dict(backoff=0.0)):
        with pytest.raises(ValueError):
            tflt.FaultConfig(**bad)
    fcs = [dict(), dict(scrub=True), dict(bitflip_rate=0.1),
           dict(sentinel=3.0), dict(p_stay=0.5), dict(straggler_rate=0.2)]
    for kw in fcs:
        t, j = tflt.FaultConfig(**kw), jflt.FaultConfig(**kw)
        assert (t.enabled, t.markov, t.rollback, t.wire_faults) == (
            j.enabled, j.markov, j.rollback, j.wire_faults), kw
    assert tflt.FAULT_SALT == jflt.FAULT_SALT


# ---------------------------------------------------------------------------
# one faulted round
# ---------------------------------------------------------------------------

FAULTS = {"flips": dict(bitflip_rate=0.08),
          "scrub": dict(scrub=True),
          "flips+scrub": dict(bitflip_rate=0.08, scrub=True)}


@pytest.mark.parametrize("variant", ["artemis", "dore", "qsgd"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("jax_backend,port_backend",
                         [("dense", "dense"), ("pallas", "cuda")])
def test_faulted_round_matches_reference(variant, fault, jax_backend,
                                         port_backend):
    rng = np.random.default_rng(len(variant) + len(fault))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    grads, h, hbar, e = f(N, D), f(N, D), f(D), f(N, D)
    grads[3] = np.nan                     # reaches the wire unscrubbed
    active = (rng.random(N) < 0.7).astype(np.float32)
    active[3] = 1.0
    step = 4
    jcfg = dataclasses.replace(jart.variant_config(variant, D, N, p=0.7),
                               faults=jflt.FaultConfig(**FAULTS[fault]))
    tcfg = dataclasses.replace(tart.variant_config(variant, D, N, p=0.7),
                               faults=tflt.FaultConfig(**FAULTS[fault]))
    jst = jart.ArtemisState(jnp.asarray(h), jnp.asarray(hbar),
                            jnp.asarray(e), jnp.int32(step))
    om, nst, stats = jart.artemis_round(jcfg, jst, jnp.asarray(grads), KEY,
                                        jnp.asarray(active),
                                        backend=jax_backend)
    up_key, dwn_key = jax.random.split(jax.random.fold_in(KEY, step))
    u_up = jax.vmap(lambda k: jax.random.uniform(k, (D,)))(
        jax.random.split(up_key, N))
    u_dwn = jax.random.uniform(dwn_key, (D,))
    flt = jax.random.fold_in(jax.random.fold_in(KEY, step),
                             jflt.FAULT_SALT)
    leaves = tart.uplink_leaves(tcfg, port_backend)
    flips = [(_t(b), _t(u)) for b, u in leaf_draws(flt, leaves)]
    tst = tart.ArtemisState(_t(h), _t(hbar), _t(e),
                            torch.tensor(step, dtype=torch.int32))
    tom, tnst, tstats = tart.artemis_round(
        tcfg, tst, _t(grads), _t(u_up), _t(u_dwn), _t(active),
        backend=port_backend, flips=flips)
    pairs = [(tom, om)] + [(getattr(tnst, k), getattr(nst, k))
                           for k in ("h", "hbar", "e")]
    for out, ref in pairs:
        if port_backend == "dense":
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)
    for k in ("uplink_bits", "dwnlink_bits", "wire_scrubbed"):
        assert float(tstats[k]) == float(stats[k]), k
    if "scrub" in fault:
        # the NaN worker's squant payload fails its checksum; B1 clamps a
        # non-finite norm to a zero scale, which passes it
        assert torch.isfinite(tom).all()
        assert float(tstats["wire_scrubbed"]) >= (port_backend == "dense")


def test_flips_are_required_when_bits_flip():
    cfg = dataclasses.replace(tart.variant_config("artemis", D, N),
                              faults=tflt.FaultConfig(bitflip_rate=0.1))
    st = tart.init_state(cfg, device="cpu")
    z = torch.zeros(N, D)
    with pytest.raises(ValueError, match="flips"):
        tart.artemis_round(cfg, st, z, z, torch.zeros(D))


# ---------------------------------------------------------------------------
# faulted sweeps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jprob():
    prob, _ = jfed.make_lsr_problem(jax.random.PRNGKey(9), n_workers=N,
                                    n_per=50, d=D, noise=0.4)
    return prob


@pytest.fixture(scope="module")
def tprob(jprob):
    return convert.problem(np.asarray(jprob.X), np.asarray(jprob.Y),
                           jprob.kind, jprob.reg, device="cpu")


def _both(mod, fc_kw, p=0.5):
    base = mod.variant_config("artemis", D, N, p=p)
    flt = jflt if mod is jart else tflt
    return [dataclasses.replace(base, faults=None if kw is None
                                else flt.FaultConfig(**kw))
            for kw in fc_kw]


def _sweeps_agree(jprob, tprob, fc_kw, iters, gammas, seeds, batch,
                  eval_every, jax_backend=None, port_backend=None, p=0.5):
    ref = jsw.run_sweep(jprob, _both(jart, fc_kw, p), gammas, seeds, iters,
                        batch=batch, eval_every=eval_every,
                        backend=jax_backend)
    noise = FaultReplayNoise(seeds, iters, N, D, batch, tprob.X.shape[1])
    out = tsw.run_sweep(tprob, _both(tart, fc_kw, p), gammas, seeds, iters,
                        batch=batch, eval_every=eval_every,
                        backend=port_backend, device="cpu", noise=noise)
    assert np.array_equal(out.bits, ref.bits)
    assert np.array_equal(out.rollbacks, ref.rollbacks)
    assert np.array_equal(out.gamma_scale, ref.gamma_scale)
    for f in ("losses", "dists", "w_final", "w_avg", "w_tail_avg"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    return out


# the example's exp5 cells (examples/federated_artemis.py::exp5_faults)
EXP5 = [None, dict(p_stay=0.9), dict(blowup_rate=0.2, scrub=True),
        dict(bitflip_rate=0.005, scrub=True, sentinel=20.0, backoff=0.8)]
# benchmarks/fault_bench.py::run_matrix's faulted cells
MATRIX = [dict(blowup_rate=0.25, scrub=True),
          dict(blowup_rate=0.1, blowup_value=1e15, scrub=True,
               sentinel=1e3),
          dict(bitflip_rate=0.05, scrub=True, sentinel=1e4)]


def test_exp5_cells_match_reference(jprob, tprob):
    out = _sweeps_agree(jprob, tprob, EXP5, 40, [0.001, 0.004], [0, 1], 1, 10)
    assert np.isfinite(out.losses).all()


def test_fault_matrix_cells_match_reference(jprob, tprob):
    out = _sweeps_agree(jprob, tprob, MATRIX[:2], 40, [0.02], [0, 3], 4, 1,
                        p=0.7)
    assert out.rollbacks[1].min() >= 1 and out.gamma_scale[1].max() < 1
    np.testing.assert_array_equal(out.gamma_scale[1],
                                  0.5 ** out.rollbacks[1])


def test_bitflip_matrix_cell_on_the_fused_path(jprob, tprob):
    out = _sweeps_agree(jprob, tprob, MATRIX[2:], 40, [0.02], [0], 4, 1,
                        jax_backend="pallas", port_backend="cuda", p=0.7)
    assert np.isfinite(out.losses).all()


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_zero_fault_and_iid_markov_are_bitwise_no_config(tprob, backend):
    cfgs = _both(tart, [None, dict(), dict(p_stay=0.7)], p=0.7)
    res = tsw.run_sweep(tprob, cfgs, [0.02], [0, 1], 30, batch=4,
                        backend=backend, device="cpu")
    for f in ("losses", "bits", "dists", "w_final", "w_avg"):
        x = getattr(res, f)
        assert np.array_equal(x[0], x[1]) and np.array_equal(x[0], x[2]), f
    assert not res.rollbacks.any() and (res.gamma_scale == 1).all()


def test_torch_noise_fault_draws_are_per_seed_and_leave_base_draws():
    from repro_torch.core import noise as tnoise
    a = tnoise.TorchNoise([3, 5], N, D, 2, 10, "cpu")
    b = tnoise.TorchNoise([5], N, D, 2, 10, "cpu")
    leaves = ((( N, D), 8), ((N, 1), 32))
    plain = a.round(70)
    full = a.round(70, faults=True, leaves=leaves)
    assert torch.equal(plain.u_up, full.u_up)
    assert plain.u_strag is None and plain.flips is None
    other = b.round(70, faults=True, leaves=leaves)
    assert torch.equal(full.u_blow[1], other.u_blow[0])
    assert torch.equal(full.flips[0][0][1], other.flips[0][0][0])
    assert full.flips[0][0].dtype == torch.int32
    assert int(full.flips[0][0].max()) < 8 <= int(full.flips[1][0].max())
    assert full.flips[1][1].shape == (2, N, 1)


@pytest.mark.parametrize("kernel", ["fused_memory_update", "squant_encode"])
def test_levels_saturate_as_the_reference_on_a_nan_norm_tile(kernel):
    """A NaN beside blown-up entries: the norm is NaN, so ``safe`` is 1 and
    the levels leave the int8 range; XLA saturates them (NaN to 0), and so
    do the plain versions (and the CUDA kernels, on the card)."""
    from repro.kernels import fused_memory as jfm
    from repro.kernels import squant as jsq
    from repro_torch.kernels import fused_memory as tfm
    from repro_torch.kernels import squant as tsq
    rng = np.random.default_rng(12)
    g, h = rng.standard_normal((2, 4, 20)).astype(np.float32)
    u = rng.random((4, 20), dtype=np.float32)
    g[1] *= 1e15
    h[1, 0] = np.nan
    if kernel == "fused_memory_update":
        ref = jfm.fused_memory_update(jnp.asarray(g), jnp.asarray(h),
                                      jnp.asarray(u), 0.5, s=2,
                                      block=(1, 20), interpret=True)
        out = tfm.fused_memory_update(_t(g), _t(h), _t(u), 0.5, s=2,
                                      block=(1, 20))
    else:
        x = g - h
        ref = jsq.squant_encode(jnp.asarray(x), jnp.asarray(u), s=2,
                                block=(1, 20), interpret=True)
        out = tsq.squant_encode(_t(x), _t(u), s=2, block=(1, 20))
    q, qr = out[0].numpy(), np.asarray(ref[0])
    np.testing.assert_array_equal(q[1], qr[1])
    assert set(np.unique(q[1])) == {-128, 0, 127}    # saturated; NaN 0
    assert q[1, 0] == 0
