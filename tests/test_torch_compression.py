"""The port's tile_squant, sparsify and topk codecs and its ``Compressor``
view against the JAX package's.

The uniforms are the ones the reference's key gives, drawn with
``jax.random.uniform`` and handed to the port: sparsify's Bernoulli draw is
``uniform < q``, and tile_squant's draw over the zero-padded tiles agrees
with a draw of the message's own shape on its first d entries (threefry
in partitionable mode).  Tolerances: sparsify and topk bit for bit;
tile_squant bit for bit for tiles of at most 32 elements, whose norms the
port adds in the reference's order on the CPU; 1024-element tiles: levels
equal where the two norms agree and scales to rtol 1e-6 (XLA's order for a
longer norm is not repeated, ROADMAP.md C).  Assumption 5 (unbiasedness and
the omega bound) on statistics, with the slack of tests/test_compression.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jwire
from repro.core import compression as jcomp
from repro_torch.core import artemis as tart
from repro_torch.core import codec as twire
from repro_torch.core import compression as tcomp

KEY = jax.random.PRNGKey(5)

CODECS = [("tile_squant", {"s": 1, "tile": 8}),
          ("tile_squant", {"s": 2, "tile": 32}),
          ("sparsify", {"q": 0.25}), ("sparsify", {"q": 0.5}),
          ("sparsify", {"q": 1.0}),
          ("topk", {"frac": 0.1}), ("topk", {"frac": 0.25})]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _encode_both(name, kw, x):
    """(reference codec, port codec, reference payload, port payload)."""
    d = x.shape[-1]
    jc, tc = jwire.make_codec(name, d, **kw), twire.make_codec(name, d, **kw)
    if x.ndim == 1:
        jp = jc.encode(KEY, jnp.asarray(x))
        u = jax.random.uniform(KEY, x.shape)
    else:
        keys = jax.random.split(KEY, x.shape[0])
        jp = jax.vmap(jc.encode)(keys, jnp.asarray(x))
        u = jax.vmap(lambda k: jax.random.uniform(k, (d,)))(keys)
    tp = tc.encode(torch.from_numpy(x), torch.tensor(np.asarray(u)))
    return jc, tc, jp, tp, torch.tensor(np.asarray(u))


def _decode(jc, jp, x):
    return np.asarray(jax.vmap(jc.decode)(jp) if x.ndim == 2
                      else jc.decode(jp))


@pytest.mark.parametrize("name,kw", CODECS)
@pytest.mark.parametrize("shape", [(20,), (40,), (6, 40)])
def test_payload_and_round_trip_match_reference(name, kw, shape):
    x = _x(shape, seed=shape[-1] + len(shape))
    jc, tc, jp, tp, u = _encode_both(name, kw, x)
    assert tp.keys() == tuple(sorted(jp.data))
    for k in tp.keys():
        ref, out = np.asarray(jp[k]), tp[k].numpy()
        assert out.dtype == ref.dtype, k
        np.testing.assert_array_equal(out, ref, err_msg=k)
    ref = (jax.vmap(jc)(jax.random.split(KEY, x.shape[0]), jnp.asarray(x))
           if x.ndim == 2 else jc(KEY, jnp.asarray(x)))
    np.testing.assert_array_equal(tc(torch.from_numpy(x), u).numpy(),
                                  np.asarray(ref))
    np.testing.assert_array_equal(tc.decode(tp).numpy(), _decode(jc, jp, x))


@pytest.mark.parametrize("shape", [(40,), (6, 1500)])
def test_tile_squant_long_tiles_match_reference(shape):
    """1024-element tiles: the norm's order is torch's, not XLA's."""
    x = _x(shape, seed=9)
    jc, tc, jp, tp, _ = _encode_both("tile_squant", {"s": 1, "tile": 1024}, x)
    sc, jsc = tp["scales"].numpy(), np.asarray(jp["scales"])
    np.testing.assert_allclose(sc, jsc, rtol=1e-6)
    same = np.broadcast_to(sc == jsc, sc.shape[:-1] + (1024,))
    q, jq = tp["levels"].numpy(), np.asarray(jp["levels"])
    np.testing.assert_array_equal(q[same], jq[same])
    assert same.any()
    np.testing.assert_allclose(tc.decode(tp).numpy(), _decode(jc, jp, x),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,kw", CODECS + [
    ("tile_squant", {"s": 1, "tile": 1024}), ("squant", {"s": 1}),
    ("identity", {}), ("row_squant", {"s": 1})])
@pytest.mark.parametrize("d", [1, 20, 40, 2000])
def test_static_metadata_matches_reference(name, kw, d):
    jc, tc = jwire.make_codec(name, d, **kw), twire.make_codec(name, d, **kw)
    assert (tc.name, tc.omega, tc.unbiased, tc.fused_uplink, tc.fused_acc) \
        == (jc.name, jc.omega, jc.unbiased, jc.fused_uplink, jc.fused_acc)
    for n in (1, d, 3 * d):
        assert tc.bits(n) == jc.bits(n)
    assert tc.wire_bytes((d,)) == jc.wire_bytes((d,))


@pytest.mark.parametrize("name,kw", CODECS + [
    ("tile_squant", {"s": 1, "tile": 1024}), ("squant", {"s": 3}),
    ("identity", {}), ("row_squant", {"s": 1})])
@pytest.mark.parametrize("shape", [(40,), (7, 40), (2, 3, 1500)])
def test_wire_bytes_is_what_the_codec_emits(name, kw, shape):
    tc = twire.make_codec(name, shape[-1], **kw)
    x = torch.from_numpy(_x(shape, seed=3))
    p = tc.encode(x, torch.rand(shape, generator=torch.Generator()
                                .manual_seed(0)))
    emitted = {}
    for t in p.leaves():
        key = {torch.int8: "s8", torch.int32: "s32",
               torch.float32: "f32"}[t.dtype]
        emitted[key] = emitted.get(key, 0) + t.numel() * t.element_size()
    assert emitted == tc.wire_bytes(shape)


def test_topk_keeps_exactly_k_on_ties():
    """jax.lax.top_k gives the lower index first on tied magnitudes; the
    port's stable sort keeps exactly k with the same indices."""
    x = np.array([3, -1, -3, 2, 3, 1], np.float32)
    jc, tc, jp, tp, _ = _encode_both("topk", {"frac": 1 / 3}, x)
    assert tp["indices"].tolist() == [0, 2] == np.asarray(
        jp["indices"]).tolist()
    flat = np.ones((4, 12), np.float32)          # every magnitude tied
    flat[1] *= -1
    jc, tc, jp, tp, _ = _encode_both("topk", {"frac": 0.25}, flat)
    assert tp["indices"].tolist() == [[0, 1, 2]] * 4
    np.testing.assert_array_equal(tp["indices"].numpy(),
                                  np.asarray(jp["indices"]))
    assert int((tc.decode(tp) != 0).sum()) == 4 * 3


def test_sparsify_sentinel_and_drop_on_decode():
    """Dropped slots carry the sentinel index n, after the kept indices in
    ascending order; decode drops them, wraps an index in [-n, 0) and drops
    any other out-of-range index, as the reference's scatter does."""
    x = _x((20,), seed=4)
    jc, tc, jp, tp, _ = _encode_both("sparsify", {"q": 0.25}, x)
    idx = tp["indices"].numpy()
    kept = int((idx < 20).sum())
    assert 0 < kept < 20 and (idx[kept:] == 20).all()
    assert (np.diff(idx[:kept]) > 0).all()
    bad = idx.copy()
    bad[0], bad[1] = -3, 1 << 20                  # wraps; dropped
    tbad = tp.replace(indices=torch.from_numpy(bad))
    jbad = jp.replace(indices=jnp.asarray(bad))
    np.testing.assert_array_equal(tc.decode(tbad).numpy(),
                                  np.asarray(jc.decode(jbad)))
    assert tc.validate(tbad).item() == 0.0 == float(jc.validate(jbad))
    assert tc.validate(tp).item() == 1.0 == float(jc.validate(jp))


@pytest.mark.parametrize("name,kw", CODECS + [("squant", {"s": 3})])
def test_validate_matches_reference_on_corrupted_payloads(name, kw):
    x = _x((6, 20), seed=8)
    jc, tc, jp, tp, _ = _encode_both(name, kw, x)
    rng = np.random.default_rng(1)
    tdata, jdata = {}, {}
    for k in tp.keys():
        a = tp[k].numpy().copy()
        flat = a.reshape(-1)
        if a.dtype == np.float32:
            flat[rng.integers(0, flat.size, 3)] = [np.nan, np.inf, -1.0]
        else:
            flat[rng.integers(0, flat.size, 2)] = [-128, 99]
        tdata[k] = torch.from_numpy(a)
        jdata[k] = jnp.asarray(a.reshape(np.asarray(jp[k]).shape))
    tv = tc.validate(tp.replace(**tdata)).numpy()
    jv = np.asarray(jax.vmap(jc.validate)(jp.replace(**jdata)))
    np.testing.assert_array_equal(tv, jv)
    assert (tv == 0).any()


def test_registry_holds_every_reference_codec():
    assert twire.available() == jwire.available()
    for name in jwire.available():
        twire.make_codec(name, 16)
    with pytest.raises(ValueError):
        twire.make_codec("sparsify", 4, q=0.0)
    with pytest.raises(ValueError):
        twire.make_codec("tile_squant", 4, s=0)


# ---------------------------------------------------------------------------
# the Compressor view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda m: m.identity(), lambda m: m.squant(20, s=2),
    lambda m: m.tile_squant(8, s=1), lambda m: m.sparsify(0.5),
    lambda m: m.topk(0.25),
    lambda m: m.make_compressor("tile_squant", 32, s=3, tile=16)])
def test_compressors_match_reference(build):
    tc, jc = build(tcomp), build(jcomp)
    assert (tc.name, tc.omega, tc.unbiased) == (jc.name, jc.omega,
                                                jc.unbiased)
    assert [tc.bits(n) for n in (1, 20, 77)] == [jc.bits(n)
                                                 for n in (1, 20, 77)]
    x = _x((20,), seed=2)
    u = np.array(jax.random.uniform(KEY, (20,)))
    np.testing.assert_array_equal(
        tc(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
        np.asarray(jc(KEY, jnp.asarray(x))))


def test_config_compressors_are_its_codecs():
    cfg = tart.ArtemisConfig(dim=20, n_workers=4, up="sparsify",
                             dwn="topk", up_kwargs={"q": 0.5},
                             dwn_kwargs={"frac": 0.2})
    up, dwn = cfg.compressors()
    c_up, c_dwn = cfg.codecs()
    assert (up.name, up.omega, dwn.name, dwn.unbiased) == (
        c_up.name, c_up.omega, c_dwn.name, False)


@pytest.mark.parametrize("name,kw", [
    ("squant", {"s": 1}), ("squant", {"s": 4}),
    ("tile_squant", {"s": 1, "tile": 8}), ("sparsify", {"q": 0.5}),
    ("sparsify", {"q": 0.25}), ("identity", {})])
def test_assumption5(name, kw, n_samples=2000, tol=0.08):
    """E[C(x)] = x and E||C(x) - x||^2 <= omega ||x||^2, by Monte Carlo
    over a [samples, d] stack of messages."""
    d = 32
    x = torch.from_numpy(_x((d,), seed=7))
    c = tcomp.make_compressor(name, d, **kw)
    xs = x.expand(n_samples, d)
    outs = c(xs, generator=torch.Generator().manual_seed(0))
    mean = outs.mean(0)
    err = float(((outs - xs) ** 2).sum(-1).mean())
    nx2 = float((x ** 2).sum())
    np.testing.assert_allclose(mean.numpy(), x.numpy(),
                               atol=tol * np.sqrt(nx2 / d) * 3 + 1e-6)
    assert err <= c.omega * nx2 * (1 + tol) + 1e-6, (err, c.omega * nx2)
