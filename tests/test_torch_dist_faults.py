"""The port's leaf wire, mesh faults and mesh telemetry against the JAX
package's ``repro/core/dist.py``.

One aggregate at a time: the reference's ``artemis_aggregate`` (leaf wire)
and ``artemis_aggregate_bucketed`` run for every worker under ``jax.vmap``
with the worker axis named, so their ``ppermute`` rings run as in the
mesh; the port's aggregates take the reference's draws, replayed by
``test_torch_dist.JaxMeshReplay`` (the ``_round_keys`` chain, fault draws
included).

Tolerances:
  * the participation (``prev_active``), the telemetry's counts and wire
    bytes, and the checksum masks (which worker's bucket or leaf the server
    accepted, read off the memory that moved) bit for bit;
  * ghat, h, hbar and e at the bucketed aggregate's bars (rtol 1e-5, atol
    1e-6 on all but 1e-4 of the entries: a row norm over more than 32
    elements may differ by an ulp and move a level by one), NaN where the
    reference has NaN;
  * the sparsify codec, which has no norm: bit for bit;
  * the mesh encoder's levels on a NaN row: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import dist as jdist
from repro.core import faults as jflt
from repro.launch import roofline as jroof
from repro_torch import convert, experiments
from repro_torch.core import bucketing as tb
from repro_torch.core import codec as tcodec
from repro_torch.core import dist as tdist
from repro_torch.core import faults as tfaults
from repro_torch.launch import roofline as troof
from repro_torch.models.toy import ToyMLP
from repro_torch.optim import optimizers as topt
from test_torch_dist import (W, WIRE, JaxMeshReplay, _jax_params, _t,
                             assert_mostly_close)

FAULTS = {"flips": dict(bitflip_rate=0.02),
          "flips+scrub": dict(bitflip_rate=0.02, scrub=True),
          "blowup": dict(blowup_rate=0.5),
          "blowup+scrub": dict(blowup_rate=0.5, scrub=True),
          "stragglers+markov": dict(straggler_rate=0.5, p_stay=0.8,
                                    scrub=True)}
STEP = 3


def _cfgs(wire, variant, p=1.0, faults=None, telemetry=False, **kw):
    common = dict(variant=variant, p_participation=p, wire=wire,
                  telemetry=telemetry, **WIRE, **kw)
    return (jdist.DistConfig(worker_axes=("pod",), faults=None if faults
                             is None else jflt.FaultConfig(**faults),
                             **common),
            tdist.DistConfig(faults=None if faults is None
                             else tfaults.FaultConfig(**faults), **common))


def _inputs(jcfg, seed=7):
    """Random gradients and state for ToyMLP(4, 64) on ``jcfg``'s wire:
    lists of per-leaf arrays on the leaf wire, one stack on the bucketed
    wire, as numpy; ``prev`` a random last availability."""
    params = _jax_params()
    rng = np.random.default_rng(seed)
    st0 = jdist.init_dist_state(jcfg, params, W)
    if jcfg.bucketed:
        shapes = [jcfg.layout(params).shape]
    else:
        shapes = [tuple(l.shape) for l in jax.tree.leaves(params)]

    def field(name, scale, on, lead):
        if not on:
            return [np.asarray(x) for x in jax.tree.leaves(
                getattr(st0, name))]
        return [(scale * rng.standard_normal(lead + s)).astype(np.float32)
                for s in shapes]

    s = dict(h=field("h", 0.5, jcfg.memory, (W,)),
             hbar=field("hbar", 0.5, jcfg.memory, ()),
             e=field("e", 0.1, jcfg.use_ef, (W,)),
             acc=[np.asarray(x) for x in jax.tree.leaves(st0.acc)],
             prev_active=(rng.random(W) < 0.5).astype(np.float32),
             step=STEP)
    g = [rng.standard_normal((W,) + sh).astype(np.float32) for sh in shapes]
    return params, shapes, g, s


def _reference(jcfg, params, g, s):
    """The reference's aggregate of every worker under a named vmap:
    (worker 0's aggregate leaves, h leaves, worker 0's hbar leaves, e leaves,
    prev_active, obs summed over the workers or None)."""
    treedef = jax.tree.structure(params)

    def tree(xs):
        return xs[0] if jcfg.bucketed else jax.tree.unflatten(treedef, xs)

    def leaves(x):
        return [x] if jcfg.bucketed else jax.tree.leaves(x)

    def one(gl, hl, el, al, prev):
        wid = jax.lax.axis_index("pod")
        state = jdist.ArtemisDistState(
            tree([x[None] for x in hl]), tree([jnp.asarray(x)
                                               for x in s["hbar"]]),
            tree([x[None] for x in el]), tree([x[None] for x in al]),
            prev[None], jnp.int32(s["step"]))
        if jcfg.bucketed:
            lay = jcfg.layout(params)
            out = jdist.artemis_aggregate_bucketed(jcfg, state, gl[0], lay,
                                                   W, wid)
        else:
            out = jdist.artemis_aggregate(jcfg, state, tree(gl), W, wid)
        agg, new = out[0], out[1]
        obs = out[2] if jcfg.telemetry else {}
        return (leaves(agg), [x[0] for x in leaves(new.h)],
                leaves(new.hbar), [x[0] for x in leaves(new.e)],
                new.prev_active[0], obs)

    out = jax.vmap(one, axis_name="pod")(
        [jnp.asarray(x) for x in g], [jnp.asarray(x) for x in s["h"]],
        [jnp.asarray(x) for x in s["e"]], [jnp.asarray(x) for x in s["acc"]],
        jnp.asarray(s["prev_active"]))
    agg, h, hbar, e, prev, obs = jax.tree.map(np.asarray, out)
    return ([x[0] for x in agg], h, [x[0] for x in hbar], e, prev,
            {k: float(v.sum()) for k, v in obs.items()} or None)


def _port(tcfg, shapes, g, s):
    state = convert.dist_state(**{k: (v if k not in ("h", "hbar", "e",
                                                     "acc")
                                      or not tcfg.bucketed else v[0])
                                  for k, v in s.items()}, device="cpu")
    replay = JaxMeshReplay(tcfg.seed, W, shapes[0] if tcfg.bucketed
                           else shapes)
    fc = tfaults.of(tcfg.faults)
    draws = replay.step(s["step"], faults=fc.enabled,
                        leaves=tdist.wire_leaves(
                            tcfg, shapes[0] if tcfg.bucketed else shapes))
    if tcfg.bucketed:
        layout = tb.make_layout(
            [tuple(l.shape) for l in jax.tree.leaves(_jax_params())],
            bucket_bytes=WIRE["bucket_bytes"],
            max_buckets=WIRE["max_buckets"], row=WIRE["bucket_row"])
        out = tdist.artemis_aggregate_bucketed(tcfg, state, _t(g[0]),
                                               layout, W, draws)
    else:
        out = tdist.artemis_aggregate(tcfg, state, [_t(x) for x in g], W,
                                      draws)
    agg, new = out[0], out[1]

    def lst(x):
        return [a.numpy() for a in (x if isinstance(x, list) else [x])]

    obs = None
    if tcfg.telemetry:
        obs = {k: float(v) for k, v in out[2].items()}
    return (lst(agg), lst(new.h), lst(new.hbar), lst(new.e),
            new.prev_active.numpy(), obs, new)


def _moved(new, old, lead):
    """1 where a worker's bucket (leaf) of the memory changed: the
    server accepted its payload."""
    new, old = np.asarray(new), np.asarray(old)
    diff = ~(new == old)
    return diff.reshape(diff.shape[:lead] + (-1,)).any(-1)


def _compare(jcfg, tcfg, params, shapes, g, s, exact=False):
    ref = _reference(jcfg, params, g, s)
    out = _port(tcfg, shapes, g, s)
    np.testing.assert_array_equal(out[4], ref[4])           # prev_active
    if tcfg.telemetry:
        assert out[5] == ref[5], (out[5], ref[5])
    close = (np.testing.assert_array_equal if exact else
             lambda a, b: assert_mostly_close(a, b, equal_nan=True))
    for a, b in zip(out[0], ref[0]):                          # ghat
        close(a, b)
    if tcfg.memory:
        lead = 2 if tcfg.bucketed else 1
        for a, b, h0 in zip(out[1], ref[1], s["h"]):
            close(a, b)
            np.testing.assert_array_equal(_moved(a, h0, lead),
                                          _moved(b, h0, lead))
        for a, b in zip(out[2], ref[2]):
            close(a, b)
    if tcfg.use_ef:
        for a, b in zip(out[3], ref[3]):
            close(a, b)
    return out, ref


# ---------------------------------------------------------------------------
# the two repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", tdist.WIRES)
@pytest.mark.parametrize("p", [0.5, 1.0])
def test_markov_participation_matches_reference(wire, p):
    """A p_stay chain over 3 steps: the availability follows the chain
    (from the last step's availability and the step), at p < 1 and at
    p = 1, bit for bit with the reference's ``_round_keys``."""
    jcfg, tcfg = _cfgs(wire, "artemis", p, dict(p_stay=0.8))
    params, shapes, g, s = _inputs(jcfg)
    s = dict(s, step=0, prev_active=np.zeros(W, np.float32))
    seen = []
    for step in range(3):
        ref = _reference(jcfg, params, g, s)
        out = _port(tcfg, shapes, g, s)
        np.testing.assert_array_equal(out[4], ref[4])
        seen.append(out[4])
        s = dict(s, step=step + 1, prev_active=ref[4],
                 h=ref[1], e=ref[3], hbar=ref[2])
    # the chain moved off "everyone" at p = 1, and is not i.i.d. draws
    assert min(x.sum() for x in seen) < W


def test_mesh_encoder_levels_saturate_as_the_reference():
    """A row holding NaN beside entries whose levels pass 127: the norm is
    NaN, so ``safe`` is 1; XLA's int8 conversion saturates and sends NaN
    to 0, and so does the mesh's encoder."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    x[1, :6] = [np.nan, 300.0, -500.0, 90.0, 1e9, -1e30]
    x[2, 0] = np.inf
    key = jax.random.PRNGKey(5)
    q_ref, sc_ref = jcodec.row_squant_encode(key, jnp.asarray(x), 2)
    u = jax.random.uniform(key, x.shape, jnp.float32)
    q, sc = tcodec.row_squant_encode(_t(x), _t(u), 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(sc.numpy()[1:], np.asarray(sc_ref)[1:])
    assert q[1, 0] == 0 and q[1, 1] == 127 and q[1, 2] == -128


# ---------------------------------------------------------------------------
# the leaf wire and the faulted aggregates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("variant", tdist.VARIANTS)
def test_leaf_aggregate_matches_reference(variant, p):
    jcfg, tcfg = _cfgs("leaf", variant, p, telemetry=True)
    params, shapes, g, s = _inputs(jcfg)
    out, _ = _compare(jcfg, tcfg, params, shapes, g, s)
    assert out[6].step == STEP + 1 and len(out[0]) == len(shapes) == 9


@pytest.mark.parametrize("variant", ["artemis", "dore"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("wire", tdist.WIRES)
def test_faulted_aggregate_matches_reference(wire, fault, variant):
    p = 0.5 if fault == "stragglers+markov" else 1.0
    jcfg, tcfg = _cfgs(wire, variant, p, FAULTS[fault], telemetry=True)
    params, shapes, g, s = _inputs(jcfg, seed=len(fault))
    out, ref = _compare(jcfg, tcfg, params, shapes, g, s)
    obs = out[5]
    fc = FAULTS[fault]
    if "blowup" in fault:
        assert 0 < obs["mesh_blowup_hits"] <= W
    if fault == "flips+scrub":           # dropped by the wire's checksum
        assert obs["mesh_scrubbed"] > 0
    if fault == "stragglers+markov" or (fault == "blowup+scrub"
                                        and wire == "bucketed"):
        # missed the deadline, or masked at entry by a NaN gradient (the
        # leaf wire masks per leaf, which mesh_active does not count)
        assert obs["mesh_active"] < W
    if not fc.get("scrub"):
        return
    for a in out[0]:                        # scrubbing keeps ghat finite
        assert np.isfinite(a).all()


@pytest.mark.parametrize("wire", tdist.WIRES)
@pytest.mark.parametrize("variant", ["artemis", "dore"])
def test_sparsify_aggregate_matches_reference_bit_for_bit(wire, variant):
    jcfg, tcfg = _cfgs(wire, variant, 0.5, codec="sparsify",
                       codec_kwargs=(("q", 0.5),))
    params, shapes, g, s = _inputs(jcfg, seed=11)
    _compare(jcfg, tcfg, params, shapes, g, s, exact=True)


def test_sparsify_rides_the_ring_as_the_reference_scenario():
    """``scenario_codec_sparsify``: the pipelined ring equals psum of the
    decoded payloads to 1e-5 over 3 steps, artemis converges, and dore's
    error feedback engages."""
    kw = dict(codec="sparsify", codec_kwargs=(("q", 0.5),))
    runs = {impl: _train("artemis", 3, reduce_impl=impl, **kw)
            for impl in ("pipelined", "psum")}
    for k, p in runs["pipelined"][0].params.items():
        torch.testing.assert_close(p, runs["psum"][0].params[k], rtol=0,
                                   atol=1e-5)
    _, losses = _train("artemis", 10, **kw)
    assert losses[-1] < losses[0]
    state, losses = _train("dore", 4, **kw)
    assert np.isfinite(losses).all()
    assert float((state.artemis.e ** 2).sum()) > 0


def _train(variant, steps, *, wire="bucketed", p=1.0, faults=None,
           n_layers=4, d=64, **kw):
    """The reference scenarios' run on the port: ToyMLP(4, 64), W = 4, s =
    3, sgd(0.05), 32 rows, the default noise."""
    model = ToyMLP(n_layers, d)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=32)
    dcfg = tdist.DistConfig(variant=variant, wire=wire, p_participation=p,
                            faults=faults, **WIRE, **kw)
    init_state, step_fn = tdist.make_train_step(model, topt.sgd(0.05), dcfg,
                                                W, device="cpu")
    state, losses = init_state(params), []
    for _ in range(steps):
        state, (loss, metrics) = step_fn(state, batch)
        losses.append(float(loss))
    return state, losses


# ---------------------------------------------------------------------------
# the port's own rules on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", tdist.WIRES)
def test_zero_fault_config_is_no_config_bit_for_bit(wire):
    """``scenario_fault_zero_bitwise``: FaultConfig() trains the same bits
    as faults=None."""
    a, la = _train("artemis", 3, wire=wire, p=0.5)
    b, lb = _train("artemis", 3, wire=wire, p=0.5,
                   faults=tfaults.FaultConfig())
    assert la == lb
    for k, x in a.params.items():
        assert torch.equal(x, b.params[k])


@pytest.mark.parametrize("wire", tdist.WIRES)
@pytest.mark.parametrize("name", sorted(
    {"bitflip": dict(bitflip_rate=0.02, scrub=True),
     "nan_blowup": dict(blowup_rate=0.5, scrub=True),
     "dropout_burst": dict(straggler_rate=0.5, p_stay=0.8, scrub=True)}))
def test_fault_matrix_trains_finite(wire, name):
    """``scenario_fault_matrix``: each fault with scrubbing keeps training
    finite on both wires."""
    fc = {"bitflip": dict(bitflip_rate=0.02, scrub=True),
          "nan_blowup": dict(blowup_rate=0.5, scrub=True),
          "dropout_burst": dict(straggler_rate=0.5, p_stay=0.8,
                                scrub=True)}[name]
    state, losses = _train("artemis", 4, wire=wire, p=0.5,
                           faults=tfaults.FaultConfig(**fc))
    assert np.isfinite(losses).all()
    for p in state.params.values():
        assert torch.isfinite(p).all()


@pytest.mark.parametrize("wire,impl", [("bucketed", "pipelined"),
                                       ("bucketed", "sequential"),
                                       ("bucketed", "psum"),
                                       ("leaf", "sequential")])
def test_wire_bytes_match_the_wire_models(wire, impl):
    """``scenario_obs_wire_telemetry``: a worker's wire bytes equal the
    port's and the reference's wire models exactly on both ring wires (the
    psum all-reduce reports its larger dense proxy); every worker active;
    telemetry moves no number and is absent when off."""
    model = ToyMLP(4, 64)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=32)
    out = {}
    for telemetry in (True, False):
        dcfg = tdist.DistConfig(wire=wire, reduce_impl=impl,
                                telemetry=telemetry, **WIRE)
        init_state, step_fn = tdist.make_train_step(
            model, topt.sgd(0.05), dcfg, W, device="cpu")
        out[telemetry] = step_fn(init_state(params), batch)
    (st, (loss, m)), (st0, (loss0, m0)) = out[True], out[False]
    assert "obs" not in m0 and torch.equal(loss, loss0)
    for k, x in st.params.items():
        assert torch.equal(x, st0.params[k])
    obs = m["obs"]
    assert set(obs) == set(jdist.obs_tel.MESH_METRICS)
    assert float(obs["mesh_active"]) == W
    assert float(obs["mesh_scrubbed"]) == float(obs["mesh_blowup_hits"]) == 0
    shapes = [tuple(p.shape) for p in params.values()]
    if wire == "bucketed":
        lay = dcfg.layout(shapes)
        geo = dict(n_workers=W, n_buckets=lay.n_buckets, rows=lay.rows,
                   row=lay.row)
        model_b = troof.bucketed_wire_model(codec=dcfg.wire_codec(lay.row),
                                            **geo)
        ref_b = jroof.bucketed_wire_model(
            codec=jdist.DistConfig(**WIRE).wire_codec(lay.row), **geo)
    else:
        model_b = troof.leaf_wire_model(shapes, n_workers=W,
                                        codec=dcfg.wire_codec(64))
        ref_b = jroof.leaf_wire_model(
            shapes, n_workers=W, codec=jdist.DistConfig(**WIRE).wire_codec(
                64))
    per_worker = obs["wire_bytes"] / W
    assert model_b["wire_bytes_per_step"] == ref_b["wire_bytes_per_step"]
    if impl == "psum":
        assert per_worker > model_b["wire_bytes_per_step"]
    else:
        assert per_worker == model_b["wire_bytes_per_step"]


def test_leaf_ring_folds_every_hop_with_bucket_acc(monkeypatch):
    """Each row-scale leaf ring makes W in-place ``bucket_acc_hop_`` hops
    over the leaf's [W, rows, C] stack; the uncompressed variant none."""
    calls = []
    real = tdist.bucket_acc_hop_

    def hop_(acc, q, scales, hop):
        calls.append((tuple(q.shape), hop))
        return real(acc, q, scales, hop)

    monkeypatch.setattr(tdist, "bucket_acc_hop_", hop_)
    _train("artemis", 2, wire="leaf", n_layers=2, d=16)
    n_leaves = 5
    assert len(calls) == 2 * n_leaves * W
    assert [h for _, h in calls[:W]] == list(range(W))
    assert {s for s, _ in calls} == {(W, 16, 1), (W, 1, 16), (W, 16, 16)}
    calls.clear()
    _train("sgd", 2, wire="leaf", n_layers=2, d=16)
    assert calls == []


def test_leaf_wire_local_steps_and_convert():
    """local_steps = 2 on the leaf wire accumulates per leaf between syncs;
    ``convert.dist_state`` carries the per-leaf state lists."""
    res = experiments.toy_mesh_train("artemis", n_layers=2, d=16, steps=4,
                                     n_workers=W, local_steps=2, wire="leaf",
                                     device="cpu")
    assert res["comm_steps"] == 2 and np.isfinite(res["losses"]).all()
    jcfg = jdist.DistConfig(worker_axes=("pod",), wire="leaf", **WIRE)
    st0 = jdist.init_dist_state(jcfg, _jax_params(), W)
    st = convert.dist_state(
        *(list(map(np.asarray, jax.tree.leaves(getattr(st0, f))))
          for f in ("h", "hbar", "e", "acc")), np.asarray(st0.prev_active),
        np.asarray(st0.step), device="cpu")
    ref = tdist.init_dist_state(tdist.DistConfig(wire="leaf", **WIRE),
                                [tuple(l.shape) for l in jax.tree.leaves(
                                    _jax_params())], W, device="cpu")
    for f in ("h", "hbar", "e", "acc"):
        assert [tuple(x.shape) for x in getattr(st, f)] == \
            [tuple(x.shape) for x in getattr(ref, f)], f


def test_leaf_noise_and_fault_draws():
    """MeshNoise on the leaf wire: per-leaf uniforms; fault draws only when
    asked, from their own seeds, leaving the base draws as they were."""
    from repro_torch.core import noise as tnoise
    shapes = [(16, 1), (16,), (16, 16)]
    src = tnoise.MeshNoise(3, W, shapes, "cpu")
    plain = src.step(2)
    assert [tuple(u.shape) for u in plain.u_up] == [(W,) + s for s in shapes]
    assert [tuple(u.shape) for u in plain.u_dwn] == shapes
    assert plain.u_strag is None and plain.flips is None
    cfg = tdist.DistConfig(wire="leaf", faults=tfaults.FaultConfig(
        bitflip_rate=0.1))
    leaves = tdist.wire_leaves(cfg, shapes)
    full = src.step(2, faults=True, leaves=leaves)
    for a, b in zip(plain.u_up, full.u_up):
        assert torch.equal(a, b)
    assert len(full.flips) == 3
    assert [tuple(b.shape) for b, _ in full.flips[1]] == [(W, 16), (W, 1)]
    assert full.flips[0][0][0].dtype == torch.int32
    assert int(full.flips[2][0][0].max()) < 8
    assert tdist.wire_leaves(tdist.DistConfig(wire="leaf"), shapes) == ()
