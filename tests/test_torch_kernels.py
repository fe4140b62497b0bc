"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; those are
held against the Pallas kernels run in interpret mode, on the same inputs
made from numpy seeds.  Tolerances (the reference's own, tests/
test_kernels.py): int8 levels may differ on fewer than 1e-4 of the entries,
each by at most 1, because the norm is reduced in another order; scales to
rtol 1e-6; h_new to rtol 1e-5, atol 1e-6 where the levels agree; ring_sum to
rtol 1e-6 (see its test for the atol).  The CUDA kernels against these plain
versions: tests/test_torch_on_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_memory as jfm
from repro.kernels import ref as jref
from repro.kernels import ring_sum as jrs
from repro_torch.kernels import fused_memory as tfm
from repro_torch.kernels import ring_sum as trs

# (shape, block): the Artemis round's single-row tiles for d = 2, 20, 40
# (d = 40 with a ragged NaN-free tail), and the reference's 2-D tiles; then
# the edges of the CUDA kernel's regimes: rows of d = 1, 31, 32, 33 and 1024
# (a group of 4 to 32 lanes, up to 32 elements a lane), d = 4096 (a tile
# split across a cluster), and (256, 256) tiles on one tile and on 6
FUSED_CASES = [((8, 2), (1, 2)), ((8, 20), (1, 20)), ((8, 40), (1, 40)),
               ((256, 512), (256, 256)),
               ((4, 1), (1, 1)), ((4, 31), (1, 31)), ((4, 32), (1, 32)),
               ((4, 33), (1, 33)), ((4, 1024), (1, 1024)),
               ((4, 4096), (1, 4096)), ((256, 256), (256, 256)),
               ((768, 512), (256, 256))]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    h = rng.standard_normal(shape).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    return g, h, u


def assert_levels_close(q, qr):
    q, qr = np.asarray(q, np.int32), np.asarray(qr, np.int32)
    mismatch = q != qr
    assert mismatch.mean() < 1e-4, mismatch.mean()
    assert np.abs(q - qr)[mismatch].max(initial=0) <= 1
    return ~mismatch


def assert_fused_close(out, ref):
    (q, sc, hn), (qr, scr, hnr) = ([np.asarray(x) for x in o]
                                   for o in (out, ref))
    agree = assert_levels_close(q, qr)
    np.testing.assert_allclose(sc, scr, rtol=1e-6)
    np.testing.assert_allclose(hn[agree], hnr[agree], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,block", FUSED_CASES)
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("alpha", [0.25, 0.5])
def test_fused_memory_plain_matches_pallas(shape, block, s, alpha):
    g, h, u = _inputs(shape, seed=sum(shape) + s)
    ref = jfm.fused_memory_update(jnp.asarray(g), jnp.asarray(h),
                                  jnp.asarray(u), alpha, s=s, block=block,
                                  interpret=True)
    out = tfm.fused_memory_update(torch.from_numpy(g), torch.from_numpy(h),
                                  torch.from_numpy(u), alpha, s=s,
                                  block=block)
    assert out[0].dtype == torch.int8 and out[1].shape == ref[1].shape
    assert_fused_close([x.numpy() for x in out], ref)


@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_fused_memory_nonfinite_row(bad):
    """A non-finite row ships a 0 scale and leaves its memory untouched."""
    d = 20
    g, h, u = _inputs((4, d), seed=7)
    g[2, 5] = np.nan if bad == "nan" else np.inf
    q, sc, hn = tfm.fused_memory_update(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(u), 0.5,
        s=1, block=(1, d))
    _, scr, hnr = jfm.fused_memory_update(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(u), 0.5, s=1,
        block=(1, d), interpret=True)
    assert float(sc[2, 0]) == 0.0 == float(scr[2, 0])
    assert np.array_equal(hn[2].numpy(), h[2])
    assert int(q[2, 5]) == 0             # a non-finite entry ships level 0
    keep = [0, 1, 3]
    np.testing.assert_allclose(sc.numpy()[keep], np.asarray(scr)[keep],
                               rtol=1e-6)
    np.testing.assert_allclose(hn.numpy()[keep], np.asarray(hnr)[keep],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["nan", "inf"])
@pytest.mark.parametrize("shape,block,row", [
    ((4, 40), (1, 40), 2),                  # a group of lanes a tile
    ((512, 256), (256, 256), 1),            # a tile in a cluster's registers
    ((3, 2**17), (1, 2**17), 1)])           # a tile streamed by a cluster
def test_fused_memory_nonfinite_tile(shape, block, row, bad):
    """At the size of each regime of the CUDA kernel: a tile holding a
    non-finite entry ships a 0 scale, level 0 there and h_new == h; the
    other tiles agree with the Pallas kernel."""
    g, h, u = _inputs(shape, seed=11)
    bm, bn = block
    g[row * bm + bm - 1, bn - 1] = np.nan if bad == "nan" else np.inf
    q, sc, hn = (x.numpy() for x in tfm.fused_memory_update(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(u), 0.5,
        s=2, block=block))
    qr, scr, hnr = (np.asarray(x) for x in jfm.fused_memory_update(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(u), 0.5, s=2,
        block=block, interpret=True))
    tile = slice(row * bm, (row + 1) * bm)
    assert sc[row, 0] == 0.0 == scr[row, 0]
    assert np.array_equal(hn[tile], h[tile])
    assert q[row * bm + bm - 1, bn - 1] == 0
    keep = np.ones(shape[0], bool)
    keep[tile] = False
    assert_fused_close((q[keep], np.delete(sc, row, 0), hn[keep]),
                       (qr[keep], np.delete(scr, row, 0), hnr[keep]))


def test_fused_memory_rejects_bad_input():
    g, h, u = (torch.from_numpy(x) for x in _inputs((4, 6), seed=1))
    with pytest.raises(ValueError):
        tfm.fused_memory_update(g, h, u, 0.5, s=127, block=(1, 6))
    with pytest.raises(ValueError):
        tfm.fused_memory_update(g, h, u, 0.5, s=1, block=(3, 6))
    with pytest.raises(TypeError):
        tfm.fused_memory_update(g.double(), h, u, 0.5, s=1, block=(1, 6))


# (N, M, C, block): the round's M=1, C=d aggregate and a multi-row case;
# then the edges of the CUDA kernel's paths: N = 1, 8, 20 and 33 workers
# (one batch of 8 loads and more), C = 16 and 256 (16 levels a thread) and
# C = 17 (cells staged in shared memory)
RING_CASES = [(10, 1, 40, (1, 40)), (5, 1, 2, (1, 2)),
              (4, 8, 256, (8, 256))] + [
    (n, 3, c, (3, c)) for n in (1, 8, 20, 33) for c in (16, 17, 256)]


def _ring_inputs(n, m, c):
    rng = np.random.default_rng(n * m + c)
    q = rng.integers(-3, 4, (n, m, c)).astype(np.int8)
    scales = rng.random((n, m, 1), dtype=np.float32)
    scales[0] = 0.0                      # a masked (inactive) worker
    return q, scales


def _assert_ring_matches(out, q, scales, block):
    ref = jrs.ring_sum(jnp.asarray(q), jnp.asarray(scales), block=block,
                       interpret=True)
    oracle = np.asarray(jrs.ring_sum_ref(jnp.asarray(q), jnp.asarray(scales)))
    in_order = np.zeros(q.shape[1:], np.float32)
    for i in range(q.shape[0]):          # f32, each operation rounded
        in_order = in_order + q[i].astype(np.float32) * scales[i]
    assert np.array_equal(out.numpy(), in_order)
    if q.shape[0] <= 32:
        # XLA's CPU reduce adds up to 32 terms in order; beyond that it
        # reassociates, and the oracle is held to the Pallas tolerance
        assert np.array_equal(out.numpy(), oracle)
    np.testing.assert_allclose(out.numpy(), oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n,m,c,block", RING_CASES)
def test_ring_sum_plain_matches_pallas(n, m, c, block):
    """Bit for bit against a numpy loop in worker order and, up to 32
    workers, against the reference's oracle ``ring_sum_ref`` (the same
    multiply-then-add in worker order); against the interpreted Pallas
    kernel, whose XLA lowering fuses each multiply-add into one FMA, to
    rtol 1e-6 with an atol of 1e-6 for sums that cancel to near 0."""
    q, scales = _ring_inputs(n, m, c)
    out = trs.ring_sum(torch.from_numpy(q), torch.from_numpy(scales))
    _assert_ring_matches(out, q, scales, block)


@pytest.mark.parametrize("n,m,c,block", RING_CASES)
def test_ring_sum_plain_matches_pallas_strided(n, m, c, block):
    """The same, with q and scales handed over as the Artemis round does:
    [N, M] views of [M, N] tensors, the worker axis strided."""
    q, scales = _ring_inputs(n, m, c)
    qt = torch.from_numpy(np.ascontiguousarray(q.transpose(1, 0, 2)))
    st = torch.from_numpy(np.ascontiguousarray(scales.transpose(1, 0, 2)))
    out = trs.ring_sum(qt.transpose(0, 1), st.transpose(0, 1))
    _assert_ring_matches(out, q, scales, block)


def test_ring_sum_takes_strided_worker_axis():
    """The round hands ring_sum a [N, M] view of its [M, N] layout."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-3, 4, (6, 5, 16)).astype(np.int8))
    sc = torch.from_numpy(rng.random((6, 5, 1), dtype=np.float32))
    out = trs.ring_sum(q.transpose(0, 1), sc.transpose(0, 1))
    ref = trs.ring_sum(q.transpose(0, 1).contiguous(),
                       sc.transpose(0, 1).contiguous())
    assert torch.equal(out, ref)


@pytest.mark.parametrize("n", [6, 20, 32])
@pytest.mark.parametrize("lead,d", [((), 10), ((), 40), ((3,), 10)])
def test_worker_sum_plain_matches_jnp_sum(n, lead, d):
    """worker_sum adds the workers' rows in worker order from 0.0: bit for
    bit what ``jnp.sum(x, axis=-2)`` gives on the CPU (the reference
    round's server sums) up to 32 workers."""
    x = np.random.default_rng(n + d).standard_normal(
        lead + (n, d)).astype(np.float32)
    ref = np.asarray(jnp.sum(jnp.asarray(x), axis=-2))
    out = trs.worker_sum(torch.from_numpy(x))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    # a strided worker axis gives the same bits
    xt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, -1, -2)))
    assert torch.equal(trs.worker_sum(xt.transpose(-1, -2)), out)


def test_worker_sum_rejects_bad_input():
    with pytest.raises(TypeError):
        trs.worker_sum(torch.zeros(4, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        trs.worker_sum(torch.zeros(4))
    with pytest.raises(ValueError):
        trs.worker_sum(torch.zeros(4, 3, device="meta"))


# bf16 B1: the Artemis round's rows and the compression API's (256, 256)
# tiles, one tile and two
BF16_FUSED_CASES = [((8, 2), (1, 2)), ((8, 20), (1, 20)),
                    ((64, 40), (1, 40)), ((256, 256), (256, 256)),
                    ((256, 512), (256, 256))]


def assert_fused_bf16_close(out, ref, alpha, block):
    """bf16 bars against the interpreted Pallas kernel, whose XLA lowering
    keeps g - h in f32 (it may skip bf16 roundings inside a fusion): levels
    off by at most 1 on fewer than 1e-3 of the entries; scales to rtol
    3e-3 (the port's bf16 encode bar); h_new, where the levels agree,
    within two bf16 ulps of its terms, |h| + |alpha * q * scale|: the
    scale's 3e-3 can move its bf16 rounding by an ulp, and the update
    rounds after it."""
    (q, sc, hn), (qr, scr, hnr) = out, ref
    q, qr = q.numpy().astype(np.int32), np.asarray(qr, np.int32)
    mismatch = q != qr
    assert mismatch.mean() < 1e-3 and np.abs(q - qr).max() <= 1
    np.testing.assert_allclose(sc.numpy(), np.asarray(scr), rtol=3e-3)
    bm, bn = block
    scr = np.repeat(np.repeat(np.asarray(scr), bm, 0), bn, 1)
    hnr = np.asarray(hnr.astype(jnp.float32))
    terms = np.abs(hn.float().numpy() - hnr)
    bound = 2.0 ** -6 * (np.abs(hnr) + np.abs(alpha * qr * scr))
    assert (terms <= bound)[~mismatch].all()


@pytest.mark.parametrize("shape,block", BF16_FUSED_CASES)
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("alpha", [0.25, 0.5])
def test_fused_memory_plain_bf16_matches_pallas(shape, block, s, alpha):
    """g, h, u in bf16 (C1): h_new comes back in bf16 and scales in f32.
    Against the reference's own oracle ``ref.fused_memory_ref`` (each step
    rounded to bf16 as written): levels at the f32 bar and scales at the
    port's bf16 one, rtol 3e-3 (both for the norm's order); h_new bit for
    bit where the levels agree (rounding the scale to bf16 absorbs the
    order's last f32 bits).  Against the interpreted Pallas kernel at the
    bf16 bars above."""
    g, h, u = _inputs(shape, seed=sum(shape) + s)
    gj, hj, uj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (g, h, u))
    gt, ht, ut = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (gj, hj, uj))
    out = tfm.fused_memory_update(gt, ht, ut, alpha, s=s, block=block)
    assert out[0].dtype == torch.int8 and out[1].dtype == torch.float32
    assert out[2].dtype == torch.bfloat16
    oracle = jref.fused_memory_ref(gj, hj, uj, alpha, s, *block)
    agree = assert_levels_close(out[0].numpy(), oracle[0])
    np.testing.assert_allclose(out[1].numpy(), np.asarray(oracle[1]),
                               rtol=3e-3)
    np.testing.assert_array_equal(
        out[2].float().numpy()[agree],
        np.asarray(oracle[2].astype(jnp.float32))[agree])
    ref = jfm.fused_memory_update(gj, hj, uj, alpha, s=s, block=block,
                                  interpret=True)
    assert_fused_bf16_close(out, ref, alpha, block)
