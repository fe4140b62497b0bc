"""The port's codecs against the JAX package's, under the same uniforms.

The uniforms are the ones the reference's key gives, drawn in the test with
``jax.random.uniform`` and handed to the port.  A message is the last axis;
a [N, d] stack is compared with ``jax.vmap`` of the reference codec.
Messages of at most 32 elements bit for bit: on the CPU the port adds the
norm's squares in the reference's order (``core/codec.py``).  Longer ones
(d = 40): int8 levels may differ on fewer than 1e-4 of the entries, each by
at most 1 (XLA vectorises that reduce in an order the port does not
repeat); scales and decoded values to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jwire
from repro_torch.core import codec as twire

KEY = jax.random.PRNGKey(11)

CODECS = [("identity", {}), ("squant", {"s": 1}), ("squant", {"s": 3}),
          ("row_squant", {"s": 1}), ("row_squant", {"s": 2})]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _encode_both(name, kw, x):
    """(reference payload, port payload) for one message or a stack."""
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
    return jc, tc, jp, tp


@pytest.mark.parametrize("name,kw", CODECS)
@pytest.mark.parametrize("shape", [(2,), (40,), (6, 20)])
def test_encode_decode_match_reference(name, kw, shape):
    x = _x(shape, seed=len(shape) + shape[-1])
    jc, tc, jp, tp = _encode_both(name, kw, x)
    assert tp.keys() == tuple(sorted(jp.data))
    # leaves in the reference's pytree order (a squant scale keeps its
    # message axis in the port: [..., 1] where the reference has [...])
    assert [str(t.dtype).removeprefix("torch.") for t in tp.leaves()] == \
        [str(a.dtype) for a in jax.tree_util.tree_leaves(jp)]
    bitwise = shape[-1] <= twire.SEQUENTIAL_NORM_MAX
    for k in tp.keys():
        ref, out = np.asarray(jp[k]), tp[k].numpy()
        if bitwise:
            np.testing.assert_array_equal(out.reshape(ref.shape), ref)
        elif k == "levels":
            q, qr = out.astype(np.int32), ref.astype(np.int32)
            assert (q != qr).mean() < 1e-4
            assert np.abs(q - qr).max(initial=0) <= 1
        else:
            np.testing.assert_allclose(out.reshape(ref.shape), ref,
                                       rtol=1e-6)
    dec = jax.vmap(jc.decode)(jp) if x.ndim == 2 else jc.decode(jp)
    if bitwise:
        np.testing.assert_array_equal(tc.decode(tp).numpy(), np.asarray(dec))
    else:
        np.testing.assert_allclose(tc.decode(tp).numpy(), np.asarray(dec),
                                   rtol=1e-6)


@pytest.mark.parametrize("d", [2, 10, 20])
@pytest.mark.parametrize("rows", [1, 6, 20])
def test_norm_matches_reference_bitwise(d, rows):
    """The port's CPU norms equal the reference's bit for bit: squant's
    ``jnp.linalg.norm`` (a sequential FMA chain, vmapped over rows) and
    row_squant's square-then-sum scale (sequential, a rounding each)."""
    x = _x((rows, d), seed=100 * d + rows)
    jn = np.asarray(jax.vmap(jnp.linalg.norm)(jnp.asarray(x)))
    np.testing.assert_array_equal(
        twire.l2_norm(torch.from_numpy(x)).numpy(), jn)
    keys = jax.random.split(KEY, rows)
    _, jsc = jax.vmap(lambda k, r: jwire.row_squant_encode(k, r, 1))(
        keys, jnp.asarray(x))
    _, tsc = twire.row_squant_encode(torch.from_numpy(x),
                                     torch.zeros(rows, d), 1)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_fma32_rounds_once():
    """a * b + c rounded once, also where float64 then float32 would round
    twice: a * b = 2^-24 - 2^-70 and c = 1 + 2^-23 put the float64 sum on a
    float32 tie that the exact sum is below (naive: 1 + 2^-22)."""
    a = torch.tensor([2.0 ** -12 * (1 + 2.0 ** -23), 3.0])
    b = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -23), 0.5])
    c = torch.tensor([1 + 2.0 ** -23, -1.0])
    out = twire.fma32(a, b, c)
    assert out.tolist() == [1 + 2.0 ** -23, 0.5]
    naive = (a.double() * b.double() + c.double()).float()
    assert float(naive[0]) == 1 + 2.0 ** -22


@pytest.mark.parametrize("name,kw", CODECS)
@pytest.mark.parametrize("d", [2, 20, 40])
def test_static_metadata_matches_reference(name, kw, d):
    jc, tc = jwire.make_codec(name, d, **kw), twire.make_codec(name, d, **kw)
    assert (tc.name, tc.omega, tc.unbiased, tc.fused_uplink, tc.fused_acc) \
        == (jc.name, jc.omega, jc.unbiased, jc.fused_uplink, jc.fused_acc)
    for n in (1, d, 3 * d):
        assert tc.bits(n) == jc.bits(n)
    assert tc.wire_bytes((d,)) == jc.wire_bytes((d,))


def test_row_squant_clamps_nonfinite_row():
    x = _x((3, 8), seed=4)
    x[1, 2] = np.nan
    _, tc, jp, tp = _encode_both("row_squant", {"s": 1}, x)
    assert float(tp["scales"][1, 0]) == 0.0 == float(jp["scales"][1, 0])
    assert torch.isfinite(tc.decode(tp)).all()
    assert tc.validate(tp).tolist() == [1.0, 1.0, 1.0]


def test_validate_flags_bad_levels():
    tc = twire.make_codec("squant", 4, s=1)
    p = tc.encode(torch.ones(2, 4), torch.zeros(2, 4))
    bad = p.replace(levels=torch.tensor([[0, 0, 0, 0], [9, 0, 0, 0]],
                                        dtype=torch.int8))
    assert tc.validate(bad).tolist() == [1.0, 0.0]


def test_generator_draws_when_no_uniforms():
    tc = twire.make_codec("squant", 16, s=2)
    x = torch.from_numpy(_x((16,)))
    a = tc(x, generator=torch.Generator().manual_seed(0))
    b = tc(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tc.encode(x)


def test_registry_errors():
    with pytest.raises(ValueError):
        twire.make_codec("nope", 4)
    with pytest.raises(ValueError):
        twire.make_codec("squant", 4, s=127)
    for name in ("tile_squant", "sparsify", "topk"):
        assert name in twire.available()
        twire.make_codec(name, 4)
