"""The port's shape-agnostic compression API (``repro_torch.kernels.ops``)
against the JAX package's (``repro.kernels.ops``).

The reference draws its uniforms inside each call from a key, over the
packed shape, with ``jax.random.uniform(key, packed_shape, dtype)`` (per
leaf from ``jax.random.split`` in the tree helpers); the tests replay those
draws and hand them to the port as ``u``.  On the CPU the reference runs its
Pallas kernels in interpret mode and the port its plain versions.

Bars: int8 levels may differ on fewer than 1e-4 of the entries, each by at
most 1; scales to rtol 1e-6; decoded values and memories to rtol 1e-5,
atol 1e-6 where the levels agree (the reference's own, tests/
test_kernels.py); wire bytes exactly.  Then the port's own statistics and
properties, as tests/test_kernels.py and tests/test_faults.py state them,
and three steps of compressed SGD on ToyMLP(2, 64) through both packages.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.prop import given, settings, st

from repro.kernels import ops as jops
from repro.models.toy import ToyMLP as JaxToyMLP
from repro_torch import convert
from repro_torch.experiments import compressed_sgd_step
from repro_torch.kernels import ops as tops
from repro_torch.models.toy import ToyMLP

BLOCK = (256, 256)
SHAPES = [(7,), (100,), (33, 65), (3, 5, 129), (300000,)]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _replay(key, shape, dtype=jnp.float32) -> torch.Tensor:
    """The uniforms the reference draws for a leaf of ``shape``."""
    packed, _ = jops._pack(jnp.zeros(shape, dtype), BLOCK)
    return _t(jax.random.uniform(key, packed.shape, dtype=dtype))


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def assert_wire_close(ct, cj):
    q, qr = ct.q.numpy().astype(np.int32), np.asarray(cj.q, np.int32)
    assert q.shape == qr.shape
    mismatch = q != qr
    assert mismatch.mean() < 1e-4, mismatch.mean()
    assert np.abs(q - qr)[mismatch].max(initial=0) <= 1
    np.testing.assert_allclose(ct.scales.numpy(), np.asarray(cj.scales),
                               rtol=1e-6)
    return ~mismatch


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_decode_compress_match_reference(shape):
    x = _normal(shape, seed=len(shape) + shape[-1])
    key = jax.random.PRNGKey(shape[-1])
    cj, shj = jops.encode(key, jnp.asarray(x), s=1)
    dj = jops.decode(cj, shj)
    u = _replay(key, shape)
    ct, sht = tops.encode(_t(x), u, s=1)
    assert sht == shj == shape
    agree = assert_wire_close(ct, cj).reshape(-1)[:x.size].reshape(shape)
    dt = tops.decode(ct, sht)
    assert dt.shape == shape and dt.dtype == torch.float32
    np.testing.assert_allclose(dt.numpy()[agree], np.asarray(dj)[agree],
                               rtol=1e-5, atol=1e-6)
    out = tops.compress(_t(x), u, s=1)
    assert torch.equal(out, dt)
    np.testing.assert_allclose(out.numpy()[agree],
                               np.asarray(jops.compress(key, jnp.asarray(x),
                                                        s=1))[agree],
                               rtol=1e-5, atol=1e-6)
    # decoded values share x's sign or are zero
    on = out.numpy()
    assert not ((np.sign(on) != 0) & (np.sign(on) != np.sign(x))).any()


@pytest.mark.parametrize("shape", [(7,), (33, 65), (300000,), (256, 256)])
def test_wire_bytes_match_reference(shape):
    key = jax.random.PRNGKey(0)
    cj, _ = jops.encode(key, jnp.zeros(shape), s=1)
    ct, _ = tops.encode(torch.zeros(shape), _replay(key, shape), s=1)
    assert ct.wire_bytes == cj.wire_bytes
    assert ct.q.dtype == torch.int8 and ct.scales.dtype == torch.float32


def test_memory_update_matches_reference():
    g, h = _normal((500, 300), 1), _normal((500, 300), 2, 0.5)
    key = jax.random.PRNGKey(4)
    dj, hj, cj = jops.memory_update(key, jnp.asarray(g), jnp.asarray(h), 0.5,
                                    s=1)
    dt, ht, ct = tops.memory_update(_t(g), _t(h), 0.5,
                                    _replay(key, (500, 300)), s=1)
    agree = assert_wire_close(ct, cj).reshape(-1)[:g.size].reshape(g.shape)
    np.testing.assert_allclose(dt.numpy()[agree], np.asarray(dj)[agree],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ht.numpy()[agree], np.asarray(hj)[agree],
                               rtol=1e-5, atol=1e-6)
    # h_new = h + alpha * delta_hat (tests/test_kernels.py's consistency)
    np.testing.assert_allclose(ht.numpy(), (_t(h) + 0.5 * dt).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_apply_update_matches_reference():
    w, g = _normal((100, 100), 3), _normal((100, 100), 9)
    key = jax.random.PRNGKey(10)
    cj, shape = jops.encode(key, jnp.asarray(g), s=1)
    wj = jops.apply_update(jnp.asarray(w), cj, 0.01, shape)
    ct, shape_t = tops.encode(_t(g), _replay(key, (100, 100)), s=1)
    wt = tops.apply_update(_t(w), ct, 0.01, shape_t)
    agree = assert_wire_close(ct, cj).reshape(-1)[:g.size].reshape(g.shape)
    np.testing.assert_allclose(wt.numpy()[agree], np.asarray(wj)[agree],
                               rtol=1e-5, atol=1e-6)
    expect = _t(w) - 0.01 * tops.decode(ct, shape_t)
    np.testing.assert_allclose(wt.numpy(), expect.numpy(), rtol=1e-5,
                               atol=1e-7)


def _tree(seed):
    return {"w": _normal((64, 32), seed), "b": np.ones((17,), np.float32)}


def _tree_uniforms(key, tree):
    """Per-leaf uniforms in flatten order, as the reference splits its key."""
    leaves = [tree[k] for k in sorted(tree)]
    keys = jax.random.split(key, len(leaves))
    return [_replay(k, leaf.shape) for k, leaf in zip(keys, leaves)]


def test_tree_compress_matches_reference():
    tree, key = _tree(5), jax.random.PRNGKey(6)
    out_j = jops.tree_compress(key, jax.tree.map(jnp.asarray, tree), s=1)
    out_t = tops.tree_compress({k: _t(v) for k, v in tree.items()},
                               _tree_uniforms(key, tree), s=1)
    assert sorted(out_t) == sorted(out_j)
    for k in tree:
        assert out_t[k].shape == tree[k].shape
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-5, atol=1e-6)


def test_tree_memory_update_matches_reference():
    tree, key = _tree(7), jax.random.PRNGKey(8)
    zeros = {k: np.zeros_like(v) for k, v in tree.items()}
    dj, hj = jops.tree_memory_update(key, jax.tree.map(jnp.asarray, tree),
                                     jax.tree.map(jnp.asarray, zeros), 0.5,
                                     s=1)
    dt, ht = tops.tree_memory_update({k: _t(v) for k, v in tree.items()},
                                     {k: _t(v) for k, v in zeros.items()},
                                     0.5, _tree_uniforms(key, tree), s=1)
    for k in tree:
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ht[k].numpy(), np.asarray(hj[k]),
                                   rtol=1e-5, atol=1e-6)
        # from h = 0, h_new = alpha * delta_hat
        np.testing.assert_allclose(ht[k].numpy(), 0.5 * dt[k].numpy(),
                                   rtol=1e-6)


def _to_bf16(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor (exact, through f32)."""
    return torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(
        torch.bfloat16)


def _bf16_pair(a: np.ndarray):
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _to_bf16(j)


def assert_bf16_update_close(dt, ht, h, dj, hj, agree):
    """bf16 bars of the fused uplink against the interpreted reference (see
    tests/test_torch_kernels.py): where the levels agree, delta_hat to two
    bf16 ulps (the scales agree to rtol 3e-3, and the bf16 rounding of the
    scale can move by an ulp) and h_new within two bf16 ulps of its terms
    |h| + |alpha * delta_hat|."""
    dj = np.asarray(dj.astype(jnp.float32))
    hj = np.asarray(hj.astype(jnp.float32))
    d, hn = dt.float().numpy(), ht.float().numpy()
    np.testing.assert_allclose(d[agree], dj[agree], rtol=2.0 ** -6, atol=0)
    bound = 2.0 ** -6 * (np.abs(h.float().numpy()) + np.abs(0.5 * dj))
    assert (np.abs(hn - hj) <= bound)[agree].all()


@pytest.mark.parametrize("shape", [(500, 300), (7,), (33, 65)])
def test_memory_update_bf16_matches_reference(shape):
    """C1: the fused uplink on bf16 g and h, u drawn in bf16 as the
    reference draws it (replayed), against ``repro.kernels.ops.
    memory_update`` run interpreted: delta_hat and h_new in bf16, scales
    f32 to rtol 3e-3, levels off by at most 1 on fewer than 1e-3 of the
    entries (the interpreted kernel keeps g - h in f32)."""
    (gj, gt), (hj, ht) = (_bf16_pair(_normal(shape, 11)),
                          _bf16_pair(_normal(shape, 12, 0.5)))
    key = jax.random.PRNGKey(14)
    dj, hnj, cj = jops.memory_update(key, gj, hj, 0.5, s=1)
    packed, _ = jops._pack(jnp.zeros(shape, jnp.bfloat16), BLOCK)
    u = _to_bf16(jax.random.uniform(key, packed.shape, dtype=jnp.bfloat16))
    dt, hnt, ct = tops.memory_update(gt, ht, 0.5, u, s=1)
    assert dt.dtype == hnt.dtype == torch.bfloat16 and dt.shape == shape
    q, qr = ct.q.numpy().astype(np.int32), np.asarray(cj.q, np.int32)
    mismatch = q != qr
    assert mismatch.mean() < 1e-3 and np.abs(q - qr).max() <= 1
    np.testing.assert_allclose(ct.scales.numpy(), np.asarray(cj.scales),
                               rtol=3e-3)
    agree = ~mismatch.reshape(-1)[:math.prod(shape)].reshape(shape)
    assert_bf16_update_close(dt, hnt, ht, dj, hnj, agree)


def test_tree_memory_update_bf16_matches_reference():
    """tree_memory_update over a bf16 gradient tree and memory, per-leaf
    bf16 uniforms replayed from the reference's key split."""
    tree, key = _tree(15), jax.random.PRNGKey(16)
    mem = {k: 0.5 * _normal(v.shape, 17 + i)
           for i, (k, v) in enumerate(sorted(tree.items()))}
    jt = {k: _bf16_pair(v) for k, v in tree.items()}
    jm = {k: _bf16_pair(v) for k, v in mem.items()}
    dj, hj = jops.tree_memory_update(key, {k: v[0] for k, v in jt.items()},
                                     {k: v[0] for k, v in jm.items()}, 0.5,
                                     s=1)
    keys = jax.random.split(key, len(tree))
    u = []
    for k, name in zip(keys, sorted(tree)):
        packed, _ = jops._pack(jnp.zeros(tree[name].shape, jnp.bfloat16),
                               BLOCK)
        u.append(_to_bf16(jax.random.uniform(k, packed.shape,
                                             dtype=jnp.bfloat16)))
    dt, ht = tops.tree_memory_update({k: v[1] for k, v in jt.items()},
                                     {k: v[1] for k, v in jm.items()}, 0.5,
                                     u, s=1)
    for k in tree:
        assert dt[k].dtype == ht[k].dtype == torch.bfloat16
        assert_bf16_update_close(dt[k], ht[k], jm[k][1], dj[k], hj[k],
                                 np.ones(tree[k].shape, bool))


def test_tree_flatten_follows_jax_order():
    """A flat dict keyed "layer_00/w" flattens like the reference's nested
    dict; the rebuilt tree has the input's structure."""
    nested = {"layer_01": {"w": 1, "b": 2}, "head": 3,
              "layer_00": {"w": 4, "b": 5}}
    flat = {"layer_01/w": 1, "layer_01/b": 2, "head": 3, "layer_00/w": 4,
            "layer_00/b": 5}
    order = jax.tree.leaves(nested)
    leaves, unflatten = tops.tree_flatten(nested)
    assert leaves == order == tops.tree_flatten(flat)[0]
    assert unflatten([10 * x for x in leaves]) == jax.tree.map(
        lambda x: 10 * x, nested)


# ---------------------------------------------------------------------------
# the port's own statistics and properties
# ---------------------------------------------------------------------------

def test_compress_unbiased():
    """E[C(x)] = x: the projection t_k = <C_k(x), x> / ||x||^2 has mean 1
    over 150 draws from one generator."""
    n_samp = 150
    x = torch.from_numpy(_normal((768,), 0))
    gen = torch.Generator().manual_seed(1)
    t = torch.stack([tops.compress(x, generator=gen, s=1) @ x
                     for _ in range(n_samp)]) / (x @ x)
    z = (float(t.mean()) - 1.0) / (float(t.std()) / math.sqrt(n_samp))
    assert abs(z) < 5.0, (float(t.mean()), z)


def test_compress_variance_bound():
    """Per-tile squant satisfies Assumption 5 with omega = sqrt(tile) / s."""
    d = 256 * 256
    x = torch.from_numpy(_normal((d,), 2))
    gen = torch.Generator().manual_seed(2)
    errs = [float(torch.sum((tops.compress(x, generator=gen, s=1) - x) ** 2))
            for _ in range(50)]
    omega = math.sqrt(d) / 1.0
    assert np.mean(errs) <= omega * float(torch.sum(x * x)) * 1.1


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 4000), st.integers(1, 126), st.integers(0, 10**6))
def test_property_levels_and_decode(n, s, seed):
    """Levels stay within s + 1 and decode is exactly q * scale per tile."""
    x = torch.from_numpy(_normal((n,), seed))
    gen = torch.Generator().manual_seed(seed + 1)
    c, shape = tops.encode(x, generator=gen, s=s)
    assert int(c.q.to(torch.int32).abs().max()) <= s + 1
    full = tops.decode(c, (c.q.numel(),))
    expect = (c.q.to(torch.float32).view(-1, 256, 1, 256)
              * c.scales.view(-1, 1, 1, 1)).reshape(-1)
    assert torch.equal(full, expect)
    assert tops.decode(c, shape).shape == (n,)


def test_nan_leaf_compresses_to_finite_zero():
    """An all-NaN array ships a zero scale and decodes to exact zeros
    (tests/test_faults.py's regression, through the port)."""
    gen = torch.Generator().manual_seed(0)
    out = tops.compress(torch.full((64,), float("nan")), generator=gen, s=1)
    assert torch.equal(out, torch.zeros(64))
    tree = {"a": torch.full((3, 5), float("nan")), "b": torch.ones(4)}
    out = tops.tree_compress(tree, generator=gen, s=1)
    assert torch.isfinite(out["a"]).all() and torch.isfinite(out["b"]).all()


def test_ops_device_and_dtype_rules():
    x = torch.ones(10)
    with pytest.raises(ValueError):              # no uniforms, no generator
        tops.encode(x)
    with pytest.raises(ValueError):              # any device but cuda, cpu
        tops.encode(x.to("meta"), torch.zeros(256, 256, device="meta"))
    with pytest.raises(ValueError):              # u over the wrong shape
        tops.encode(x, torch.zeros(10))
    with pytest.raises(TypeError):               # g and h share a dtype
        tops.memory_update(x.bfloat16(), x, 0.5, generator=torch.Generator())
    dh, hn, _ = tops.memory_update(x.bfloat16(), x.bfloat16(), 0.5,
                                   generator=torch.Generator(), s=2)
    assert dh.dtype == hn.dtype == torch.bfloat16 and hn.shape == x.shape
    c, shape = tops.encode(x.bfloat16(), generator=torch.Generator(), s=2)
    assert tops.decode(c, shape, dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    assert tops.apply_update(x.bfloat16(), c, 0.1).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the slice as a whole: compressed SGD through encode -> apply_update
# ---------------------------------------------------------------------------

def test_compressed_sgd_matches_reference():
    """Three steps of ``w = apply_update(w, encode(grad))`` over every leaf
    of ToyMLP(2, 64) (s = 1, lr = 0.01), the reference's ops composition
    against ``experiments.compressed_sgd_step`` with the same batch and
    replayed per-leaf uniforms.  Parameters agree to rtol 1e-5, atol 1e-6,
    the bar where no level differs: a flipped level would move its entry by
    lr * scale, far past it, and none flips at these seeds."""
    s, lr = 1, 0.01
    jmodel, tmodel = JaxToyMLP(2, 64), ToyMLP(2, 64)
    jp = jmodel.init(jax.random.PRNGKey(0))
    jbatch = jmodel.batch(jax.random.PRNGKey(1), 32)
    tp = convert.toy_params(jax.tree.map(np.asarray, jp), device="cpu")
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    grad = jax.jit(jax.grad(lambda p: jmodel.loss(p, jbatch)[0]))
    for step in range(3):
        leaves, treedef = jax.tree.flatten(jp)
        keys = jax.random.split(jax.random.PRNGKey(100 + step), len(leaves))
        gl = treedef.flatten_up_to(grad(jp))
        new, u = [], []
        for k, w, g in zip(keys, leaves, gl):
            c, shape = jops.encode(k, g, s=s)
            new.append(jops.apply_update(w, c, lr, shape))
            u.append(_replay(k, g.shape))
        jp = jax.tree.unflatten(treedef, new)
        tp, loss = compressed_sgd_step(tmodel, tp, tbatch, lr, s=s,
                                       uniforms=u)
        assert math.isfinite(float(loss))
        for name, w in zip(sorted(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
