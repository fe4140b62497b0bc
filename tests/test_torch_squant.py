"""The port's squant kernels (``repro_torch.kernels.squant``) and oracles
(``repro_torch.kernels.ref``) against the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions; those are
held against the Pallas kernels of ``repro/kernels/squant.py`` run in
interpret mode, and the port's ``ref.py`` against the reference's, on the
same inputs made from numpy seeds.  bf16 inputs cross as f32 numpy arrays
and are cast back to bf16 on each side, which is exact.

Bars (the reference's own, tests/test_kernels.py): int8 levels may differ
on fewer than 1e-4 of the entries, each by at most 1 (the tile norm is
reduced in another order); scales to rtol 1e-6 in f32 and 3e-3 in bf16;
decode to rtol 1e-5; dequant_apply to rtol 1e-5, atol 1e-6 in f32 and to
one bf16 ulp in bf16.  The interpreted Pallas ``dequant_apply`` rounds
``w - gamma * (q * scale)`` with an FMA on the CPU (XLA fuses it), while the
port and the CUDA kernel round the multiply and the subtraction apart, so
the f32 results differ in the last bit on some entries.  The CUDA kernels
against these plain versions: tests/test_torch_on_card.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_memory as jfm
from repro.kernels import ref as jref
from repro.kernels import squant as jsq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import squant as tsq

SHAPES = [(256, 256), (512, 256), (256, 512)]
BLOCKS = [(256, 256), (128, 256)]
DTYPES = ["float32", "bfloat16"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's oracles, jitted (op by op, each new shape recompiles
# every jnp op)
JREF_ENCODE = jax.jit(jref.squant_encode_ref, static_argnums=(2, 3, 4))
JREF_DECODE = jax.jit(jref.squant_decode_ref, static_argnums=(2, 3, 4))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(JNP[dtype])
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(TORCH[dtype])
    return j, t


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    return _pair(x, dtype), _pair(u, dtype)


def assert_levels_close(q, qr):
    q, qr = np.asarray(q, np.int32), np.asarray(qr, np.int32)
    mismatch = q != qr
    assert mismatch.mean() < 1e-4, mismatch.mean()
    assert np.abs(q - qr)[mismatch].max(initial=0) <= 1
    return ~mismatch


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t.astype(jnp.float32))


def _encoded(shape, block, s, seed):
    """Levels and scales from the Pallas encode, as numpy and as tensors."""
    (xj, _), (uj, _) = _inputs(shape, "float32", seed)
    q, sc = jsq.squant_encode(xj, uj, s=s, block=block, interpret=True)
    q, sc = np.array(q), np.array(sc)
    return (q, sc), (torch.from_numpy(q), torch.from_numpy(sc))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 4])
def test_encode_plain_matches_pallas(shape, block, dtype, s):
    (xj, xt), (uj, ut) = _inputs(shape, dtype, seed=sum(shape) + s)
    q, sc = jsq.squant_encode(xj, uj, s=s, block=block, interpret=True)
    qt, sct = tsq.squant_encode(xt, ut, s=s, block=block)
    assert qt.dtype == torch.int8 and sct.dtype == torch.float32
    assert tuple(sct.shape) == sc.shape
    assert_levels_close(qt.numpy(), q)
    np.testing.assert_allclose(sct.numpy(), np.asarray(sc),
                               rtol=3e-3 if dtype == "bfloat16" else 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 4])
def test_encode_ref_matches_reference_ref(shape, block, dtype, s):
    (xj, xt), (uj, ut) = _inputs(shape, dtype, seed=sum(shape) + s)
    q, sc = JREF_ENCODE(xj, uj, s, *block)
    qt, sct = tref.squant_encode_ref(xt, ut, s, *block)
    assert_levels_close(qt.numpy(), q)
    np.testing.assert_allclose(sct.numpy(), np.asarray(sc),
                               rtol=3e-3 if dtype == "bfloat16" else 1e-6)


@pytest.mark.parametrize("xdt,udt", [("float32", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_encode_mixed_dtypes(xdt, udt):
    """x and u may each be f32 or bf16 on its own; the math is in f32."""
    (xj, xt), _ = _inputs((256, 256), xdt, seed=11)
    _, (uj, ut) = _inputs((256, 256), udt, seed=12)
    q, sc = jsq.squant_encode(xj, uj, s=2, interpret=True)
    qt, sct = tsq.squant_encode(xt, ut, s=2)
    assert_levels_close(qt.numpy(), q)
    np.testing.assert_allclose(sct.numpy(), np.asarray(sc), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_matches_pallas(shape, dtype):
    block = (256, 256)
    (q, sc), (qt, sct) = _encoded(shape, block, 2, seed=3)
    out = jsq.squant_decode(jnp.asarray(q), jnp.asarray(sc), block=block,
                            dtype=JNP[dtype], interpret=True)
    outt = tsq.squant_decode(qt, sct, block=block, dtype=TORCH[dtype])
    assert outt.dtype == TORCH[dtype]
    np.testing.assert_allclose(_f32(outt), _f32(out), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_ref_matches_reference_ref(shape, dtype):
    block = (256, 256)
    (q, sc), (qt, sct) = _encoded(shape, block, 2, seed=4)
    out = JREF_DECODE(jnp.asarray(q), jnp.asarray(sc), *block,
                      JNP[dtype])
    outt = tref.squant_decode_ref(qt, sct, *block, dtype=TORCH[dtype])
    np.testing.assert_allclose(_f32(outt), _f32(out), rtol=1e-5)


def _apply_inputs(dtype, seed):
    block = (256, 256)
    (q, sc), (qt, sct) = _encoded((512, 256), block, 1, seed=seed)
    w = np.random.default_rng(seed + 1).standard_normal(
        (512, 256)).astype(np.float32)
    wj, wt = _pair(w, dtype)
    return block, (wj, jnp.asarray(q), jnp.asarray(sc)), (wt, qt, sct)


def _assert_apply_close(out, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    else:                                   # one bf16 ulp: 2^-7 relative
        np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dequant_apply_plain_matches_pallas(dtype):
    block, (wj, qj, scj), (wt, qt, sct) = _apply_inputs(dtype, seed=7)
    out = jsq.dequant_apply(wj, qj, scj, 0.1, block=block, interpret=True)
    outt = tsq.dequant_apply(wt, qt, sct, 0.1, block=block)
    assert outt.dtype == TORCH[dtype] and outt.shape == wt.shape
    _assert_apply_close(_f32(outt), _f32(out), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dequant_apply_ref_matches_reference_ref(dtype):
    block, (wj, qj, scj), (wt, qt, sct) = _apply_inputs(dtype, seed=9)
    out = jref.dequant_apply_ref(wj, qj, scj, 0.1, *block)
    outt = tref.dequant_apply_ref(wt, qt, sct, 0.1, *block)
    _assert_apply_close(_f32(outt), _f32(out), dtype)


def test_dequant_apply_rounds_each_operation():
    """In f32 the port rounds q * scale, gamma * (...) and w - (...) one by
    one (no FMA): the CUDA kernel's arithmetic."""
    block, _, (wt, qt, sct) = _apply_inputs("float32", seed=13)
    dq = (qt.to(torch.float32).view(2, 256, 1, 256)
          * sct.view(2, 1, 1, 1)).view(512, 256)
    step = torch.tensor(0.1, dtype=torch.float32) * dq
    assert torch.equal(tsq.dequant_apply(wt, qt, sct, 0.1, block=block),
                       wt - step)


@pytest.mark.parametrize("shape", [(256, 256), (512, 256)])
@pytest.mark.parametrize("s", [1, 3])
def test_fused_memory_ref_matches_reference_ref(shape, s):
    """B1 on the ops API's (256, 256) tiles: the port's oracle against the
    reference's and against the interpreted Pallas kernel."""
    rng = np.random.default_rng(sum(shape) + s)
    g, h = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    u = rng.random(shape, dtype=np.float32)
    args = [jnp.asarray(a) for a in (g, h, u)]
    tens = [torch.from_numpy(a) for a in (g, h, u)]
    out = tref.fused_memory_ref(*tens, 0.5, s, 256, 256)
    for ref in (jref.fused_memory_ref(*args, 0.5, s, 256, 256),
                jfm.fused_memory_update(*args, 0.5, s=s, block=(256, 256),
                                        interpret=True)):
        agree = assert_levels_close(out[0].numpy(), ref[0])
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-6)
        np.testing.assert_allclose(out[2].numpy()[agree],
                                   np.asarray(ref[2])[agree], rtol=1e-5,
                                   atol=1e-6)


def test_nan_tile_gets_zero_scale():
    """An all-NaN tile ships a zero scale and level 0 in the port's kernels
    and in its ref.py, as in the Pallas kernel.  The reference's ref.py
    ships a NaN scale there (it lacks the clamp); the port does not copy
    that."""
    x = np.random.default_rng(5).standard_normal((512, 256)).astype(
        np.float32)
    x[256:] = np.nan                       # the second tile
    u = np.random.default_rng(6).random((512, 256), dtype=np.float32)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    for q, sc in (tsq.squant_encode(xt, ut, s=1),
                  tref.squant_encode_ref(xt, ut, 1, 256, 256)):
        assert float(sc[1, 0]) == 0.0 and np.isfinite(float(sc[0, 0]))
        assert not q[256:].any()
        dec = tsq.squant_decode(q, sc)
        assert torch.equal(dec[256:], torch.zeros(256, 256))
        w = torch.ones(512, 256)
        assert torch.equal(tsq.dequant_apply(w, q, sc, 0.5)[256:],
                           torch.ones(256, 256))
    _, scj = jsq.squant_encode(jnp.asarray(x), jnp.asarray(u), s=1,
                               interpret=True)
    assert float(scj[1, 0]) == 0.0
    _, scr = jref.squant_encode_ref(jnp.asarray(x), jnp.asarray(u), 1, 256,
                                    256)
    assert np.isnan(float(scr[1, 0]))


def test_squant_rejects_bad_input():
    x = torch.zeros(256, 256)
    with pytest.raises(ValueError):
        tsq.squant_encode(x, x, s=127)
    with pytest.raises(ValueError):
        tsq.squant_encode(x, x, s=1, block=(100, 256))
    with pytest.raises(TypeError):
        tsq.squant_encode(x.double(), x, s=1)
    with pytest.raises(TypeError):
        tsq.squant_decode(torch.zeros(256, 256, dtype=torch.int8),
                          torch.zeros(1, 1), dtype=torch.float16)
    with pytest.raises(ValueError):
        tsq.dequant_apply(x, torch.zeros(256, 256, dtype=torch.int8),
                          torch.zeros(2, 1), 0.1)
    with pytest.raises(ValueError):
        tsq.squant_encode(x.to("meta"), x.to("meta"), s=1)
