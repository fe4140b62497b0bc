"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor the JAX package, so they also run where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_on_card.py

Tolerances: int8 levels may differ on fewer than 1e-4 of the entries, each
by at most 1 (the kernel reduces the norm in another order); scales to
rtol 1e-6; h_new to rtol 1e-5, atol 1e-6 where the levels agree in f32,
and bit for bit where the levels and the bf16-rounded scales agree in bf16;
a second launch of fused_memory_update, squant_encode, dequant_apply,
worker_sum or ring_sum gives the same bits; worker_sum, ring_sum,
bucket_acc, every in-place hop of bucket_acc_hop_ and bucket_ring_sum bit
for bit (the same multiply-then-add, in worker order), and so the pipelined
mesh ring equals the sequential one;
squant_decode and dequant_apply bit for bit, in f32 and in bf16 (the same
operations, each rounded to the output type).
"""
import pytest
import torch

from repro_torch import experiments
from repro_torch.core import artemis as tart
from repro_torch.kernels import bucket_ring as tbr
from repro_torch.kernels import fused_memory as tfm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ring_sum as trs
from repro_torch.kernels import squant as tsq
from repro_torch.models.toy import ToyMLP


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _rand(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev),
            torch.rand(shape, generator=gen, device=dev))


# [4096, 256]: one ToyMLP(12, 1024) weight as the ops API packs it;
# [1024, 2048]: a probe of 32 tiles in two tile columns
OPS_SHAPES = [(4096, 256), (1024, 2048)]
BF16 = torch.bfloat16


def assert_levels_close(q, qr):
    diff = (q.int() - qr.int()).abs()
    assert float((diff != 0).float().mean()) < 1e-4
    assert int(diff.max()) <= 1
    return diff == 0


def _per_element(sc, block):
    """Per-tile values [M/bm, N/bn] spread over the tiles' elements."""
    bm, bn = block
    return sc.repeat_interleave(bm, 0).repeat_interleave(bn, 1)


def _fused_agrees(g, h, u, block, alpha=0.25, s=2):
    """One launch of B1 against its plain version at today's tolerances, and
    a second launch giving the same bits.  In bf16 h_new is held bit for bit
    where the levels and the scales rounded to bf16 (the memory update's
    factor) agree."""
    before = tfm.fused_memory_update.launches
    q, sc, hn = tfm.fused_memory_update(g, h, u, alpha, s=s, block=block)
    torch.cuda.synchronize()
    assert tfm.fused_memory_update.launches == before + 1
    assert hn.dtype == g.dtype and sc.dtype == torch.float32
    qr, scr, hnr = tfm.fused_memory_update_plain(g, h, u, alpha, s=s,
                                                 block=block)
    agree = assert_levels_close(q, qr)
    torch.testing.assert_close(sc, scr, rtol=1e-6, atol=0)
    if g.dtype == BF16:
        agree &= _per_element(sc.to(BF16) == scr.to(BF16), block)
        assert torch.equal(hn[agree], hnr[agree])
    else:
        torch.testing.assert_close(hn[agree], hnr[agree], rtol=1e-5,
                                   atol=1e-6)
    again = tfm.fused_memory_update(g, h, u, alpha, s=s, block=block)
    for x, y in zip((q, sc, hn), again):
        assert torch.equal(x, y)


# rows of d: 2 and 40 (the round), 1, 31, 32, 33 and 1024 (a group of 4 to
# 32 lanes a tile, 1 to 32 elements a lane), 4096 and 4097 (a cluster's
# registers, float4 and one element at a time), 2^20 (streamed by a cluster)
@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(2560, 2), (2560, 40), (20, 4096),
                                    (300, 1), (300, 31), (300, 32),
                                    (300, 33), (300, 1024), (6, 4097),
                                    (4, 2**20)])
def test_fused_memory_kernel_matches_plain(cuda_device, rows, d):
    g, h, u = _rand((rows, d), rows + d, cuda_device)
    _fused_agrees(g, h, u, (1, d))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [((2560, 40), (1, 40)),
                                         ((300, 1024), (1, 1024)),
                                         ((256, 256), (256, 256)),
                                         ((4096, 256), (256, 256)),
                                         ((512, 510), (256, 255)),
                                         ((4, 2**20), (1, 2**20))])
def test_fused_memory_kernel_bf16(cuda_device, shape, block):
    """C1: B1 on bf16 g, h, u in each of its regimes (lane groups, a
    cluster's registers with 4-element and 1-element vectors, a cluster
    streaming its share), h_new in bf16."""
    g, h, u = (t.to(BF16) for t in _rand(shape, 7 * sum(shape),
                                         cuda_device))
    _fused_agrees(g, h, u, block, alpha=0.5, s=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [((4, 20), (1, 20)),
                                         ((512, 256), (256, 256)),
                                         ((4, 2**20), (1, 2**20))])
@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_fused_memory_kernel_nonfinite_row(cuda_device, shape, block, bad):
    """In each of B1's three regimes: a tile with a non-finite entry ships a
    0 scale, level 0 there and h_new == h."""
    g, h, u = _rand(shape, 3, cuda_device)
    bm, bn = block
    g[bm, 3] = float(bad)                   # in the second tile
    q, sc, hn = tfm.fused_memory_update(g, h, u, 0.5, s=1, block=block)
    assert float(sc[1, 0]) == 0.0 and int(q[bm, 3]) == 0
    assert torch.equal(hn[bm:2 * bm], h[bm:2 * bm])
    keep = torch.ones(shape[0], dtype=torch.bool, device=cuda_device)
    keep[bm:2 * bm] = False
    qr, scr, hnr = tfm.fused_memory_update_plain(g, h, u, 0.5, s=1,
                                                 block=block)
    agree = assert_levels_close(q[keep], qr[keep])
    torch.testing.assert_close(hn[keep][agree], hnr[keep][agree], rtol=1e-5,
                               atol=1e-6)


def _levels(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(-3, 4, shape, generator=gen, device=dev,
                          dtype=torch.int8),
            torch.rand(shape[:-1] + (1,), generator=gen, device=dev))


# N = 1, 8, 20, 33 workers x (M, C): the round's (128, 40), (3, 256) and
# (7, 16) (cells staged in shared memory, 16 bytes a load), (5, 17)
# (staged, byte loads), a row of 4096 (staged up to N = 8, 16 levels a
# thread beyond), (2, 4097) (staged up to N = 8, one thread an output
# beyond), a row of 2^20 + 16 (16 levels a thread, the last warp partial)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 1, 8, 33])
@pytest.mark.parametrize("m,c", [(128, 40), (1, 4096), (3, 256), (7, 16),
                                 (5, 17), (2, 4097), (1, 2**20 + 16)])
def test_ring_sum_kernel_matches_plain(cuda_device, n, m, c):
    q, sc = _levels((n, m, c), n + m + c, cuda_device)
    before = trs.ring_sum.launches
    out = trs.ring_sum(q, sc)
    torch.cuda.synchronize()
    assert trs.ring_sum.launches == before + 1
    assert torch.equal(out, trs.ring_sum_plain(q, sc))
    assert torch.equal(trs.ring_sum(q, sc), out)            # deterministic
    # the round's transposed [M, N] layout, as a strided view
    qt, st = q.transpose(0, 1).contiguous(), sc.transpose(0, 1).contiguous()
    out_t = trs.ring_sum(qt.transpose(0, 1), st.transpose(0, 1))
    assert torch.equal(out_t, out)
    assert torch.equal(trs.ring_sum(qt.transpose(0, 1), st.transpose(0, 1)),
                       out_t)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,c", [(8, 16 * 49, 64), (20, 128, 40),
                                   (20, 1, 4096)])
def test_ring_sum_kernels_on_misaligned_levels(cuda_device, n, m, c):
    """q one byte into its buffer is not 16-byte aligned: ring_sum and
    bucket_ring_sum take the byte-wise path, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(n * c)
    buf = torch.randint(-3, 4, (n * m * c + 1,), generator=gen,
                        device=cuda_device, dtype=torch.int8)
    q = buf[1:].view(n, m, c)
    sc = torch.rand(n, m, 1, generator=gen, device=cuda_device)
    out = trs.ring_sum(q, sc)
    assert torch.equal(out, trs.ring_sum_plain(q, sc))
    assert torch.equal(trs.ring_sum(q, sc), out)
    q4, sc4 = q.view(n, 1, m, c), sc.view(n, 1, m, 1)
    before = tbr.bucket_ring_sum.launches
    out4 = tbr.bucket_ring_sum(q4, sc4)
    torch.cuda.synchronize()
    assert tbr.bucket_ring_sum.launches == before + 1
    assert torch.equal(out4, tbr.bucket_ring_sum_plain(q4, sc4))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["artemis", "dore", "qsgd"])
def test_cuda_round_matches_dense_round(cuda_device, variant):
    """The fused uplink agrees with the dense one to 1e-5 (the fused scale
    folds the division by s in first, as in the reference)."""
    cells, n, d = 4, 20, 40
    cfg = tart.variant_config(variant, d, n, p=0.5)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    grads = torch.randn(cells, n, d, generator=gen, device=cuda_device)
    u_up = torch.rand(cells, n, d, generator=gen, device=cuda_device)
    u_dwn = torch.rand(cells, d, generator=gen, device=cuda_device)
    active = (torch.rand(cells, n, generator=gen, device=cuda_device)
              < 0.5).float()
    st = tart.init_state(cfg, (cells,), device=cuda_device)
    outs = [tart.artemis_round(cfg, st, grads, u_up, u_dwn, active,
                               backend=b) for b in ("dense", "cuda")]
    (om_d, st_d, _), (om_c, st_c, _) = outs
    torch.testing.assert_close(om_c, om_d, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st_c.h, st_d.h, rtol=1e-5, atol=1e-5)


def _payload(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-4, 5, shape, generator=gen, device=dev,
                      dtype=torch.int8)
    sc = torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
    return q, sc


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 49, 64), (8, 16, 49, 64),
                                   (3, 45, 1)])
def test_bucket_acc_kernel_matches_plain(cuda_device, shape):
    q, sc = _payload(shape, sum(shape), cuda_device)
    acc = torch.randn(shape, device=cuda_device)
    before = tbr.bucket_acc.launches
    out = tbr.bucket_acc(acc, q, sc)
    torch.cuda.synchronize()
    assert tbr.bucket_acc.launches == before + 1
    assert torch.equal(out, tbr.bucket_acc_plain(acc, q, sc))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 49, 64),     # 16 levels a thread
                                   (5, 3, 45, 1),       # one a thread
                                   (4, 2, 7, 5)])
def test_bucket_acc_hop_kernel_matches_plain(cuda_device, shape):
    """Every hop of the ring, in place, equals the plain rolled hop; hop 0
    does not read the accumulator (NaN there would show)."""
    q, sc = _payload(shape, 2 * sum(shape), cuda_device)
    acc = torch.full(shape, float("nan"), device=cuda_device)
    ref = acc.clone()
    for hop in range(shape[0]):
        before, ptr = tbr.bucket_acc.launches, acc.data_ptr()
        out = tbr.bucket_acc_hop_(acc, q, sc, hop)
        torch.cuda.synchronize()
        assert tbr.bucket_acc.launches == before + 1
        assert out is acc and acc.data_ptr() == ptr
        tbr.bucket_acc_hop_plain_(ref, q, sc, hop)
        assert torch.equal(acc, ref), hop


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,r,c", [(8, 16, 49, 64), (5, 3, 45, 1),
                                     (8, 16, 3076, 256), (33, 2, 5, 16)])
def test_bucket_ring_sum_kernel_matches_chain(cuda_device, n, b, r, c):
    q, sc = _payload((n, b, r, c), n + r, cuda_device)
    before = tbr.bucket_ring_sum.launches
    out = tbr.bucket_ring_sum(q, sc)
    torch.cuda.synchronize()
    assert tbr.bucket_ring_sum.launches == before + 1
    acc = torch.zeros(b, r, c, device=cuda_device)
    for i in range(n):
        acc = tbr.bucket_acc(acc, q[i], sc[i])
    assert torch.equal(out, acc)
    assert torch.equal(out, tbr.bucket_ring_sum_plain(q, sc))
    assert torch.equal(tbr.bucket_ring_sum(q, sc), out)     # deterministic


@pytest.mark.cuda
def test_mesh_pipelined_equals_sequential(cuda_device):
    runs = [experiments.toy_mesh_train("artemis", impl, n_layers=2, d=32,
                                       steps=3, n_workers=4,
                                       device=cuda_device)
            for impl in ("pipelined", "sequential")]
    assert runs[0]["launches"]["bucket_acc"] == 3 * 4
    for k, p in runs[0]["params"].items():
        assert torch.equal(p, runs[1]["params"][k])


# ---------------------------------------------------------------------------
# the ops API's kernels: squant encode, decode, dequant_apply and B1 on
# (256, 256) tiles
# ---------------------------------------------------------------------------

ENCODE_DTYPES = [(torch.float32, torch.float32), (BF16, BF16),
                 (torch.float32, BF16), (BF16, torch.float32)]


def _encode_agrees(x, u, s, block):
    before = tsq.squant_encode.launches
    q, sc = tsq.squant_encode(x, u, s=s, block=block)
    torch.cuda.synchronize()
    assert tsq.squant_encode.launches == before + 1
    qr, scr = tsq.squant_encode_plain(x, u, s=s, block=block)
    assert_levels_close(q, qr)
    torch.testing.assert_close(sc, scr, rtol=1e-6, atol=0)
    # deterministic: the same inputs give the same bits
    q2, sc2 = tsq.squant_encode(x, u, s=s, block=block)
    assert torch.equal(q2, q) and torch.equal(sc2, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OPS_SHAPES)
@pytest.mark.parametrize("xdt,udt", ENCODE_DTYPES)
def test_squant_encode_kernel_matches_plain(cuda_device, shape, xdt, udt):
    x, _, u = _rand(shape, sum(shape), cuda_device)
    _encode_agrees(x.to(xdt), u.to(udt), 4, (256, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [
    ((2560, 40), (1, 40)),                  # a group of lanes a tile
    ((256, 256), (256, 256)),               # one tile across a cluster
    ((768, 512), (256, 256)),               # six tiles
    ((512, 510), (256, 255)),               # one element a vector
    ((4, 2**20), (1, 2**20))])              # a cluster streaming its share
@pytest.mark.parametrize("xdt,udt", ENCODE_DTYPES)
def test_squant_encode_kernel_regimes(cuda_device, shape, block, xdt, udt):
    """The encode's three regimes (tile_quant.cuh without a memory) against
    its plain version, for the four (x, u) dtype pairs."""
    x, _, u = _rand(shape, 3 * sum(shape), cuda_device)
    _encode_agrees(x.to(xdt), u.to(udt), 2, block)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OPS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_squant_decode_and_apply_kernels_match_plain(cuda_device, shape,
                                                     dtype):
    x, w, u = _rand(shape, 2 * sum(shape), cuda_device)
    q, sc = tsq.squant_encode(x, u, s=1)
    d0, a0 = tsq.squant_decode.launches, tsq.dequant_apply.launches
    out = tsq.squant_decode(q, sc, dtype=dtype)
    w = w.to(dtype)
    new = tsq.dequant_apply(w, q, sc, 0.01)
    torch.cuda.synchronize()
    assert (tsq.squant_decode.launches, tsq.dequant_apply.launches) == \
        (d0 + 1, a0 + 1)
    assert out.dtype == dtype and new.dtype == dtype
    assert torch.equal(out, tsq.squant_decode_plain(q, sc, dtype=dtype))
    assert torch.equal(new, tsq.dequant_apply_plain(w, q, sc, 0.01))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block,offset", [
    ((4096, 256), (256, 256), 0),           # 16 levels a thread
    ((4104, 16), (8, 16), 0),               # 16 levels, the last warp partial
    ((256, 24), (256, 8), 0),               # a block 8 wide: one a thread
    ((6, 10), (3, 5), 0),
    ((512, 256), (256, 256), 1)])           # w one element into its buffer
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_dequant_apply_kernel_paths(cuda_device, shape, block, offset, dtype):
    """dequant_apply's vector path and its one-element path (a block width
    or N not a multiple of 16, or a w not 16-byte aligned), bit for bit
    against its plain version and over two launches."""
    x, _, u = _rand(shape, 11 * sum(shape), cuda_device)
    q, sc = tsq.squant_encode(x, u, s=3, block=block)
    n = shape[0] * shape[1]
    buf = torch.randn(n + offset, device=cuda_device).to(dtype)
    w = buf[offset:].view(shape)
    before = tsq.dequant_apply.launches
    out = tsq.dequant_apply(w, q, sc, 0.01, block=block)
    torch.cuda.synchronize()
    assert tsq.dequant_apply.launches == before + 1
    assert out.dtype == dtype
    assert torch.equal(out, tsq.dequant_apply_plain(w, q, sc, 0.01,
                                                    block=block))
    assert torch.equal(tsq.dequant_apply(w, q, sc, 0.01, block=block), out)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,d,strided", [
    ((128,), 20, 40, True),                 # the round's server sum
    ((128,), 20, 1, False),                 # the sweep's bit meter
    ((3,), 33, 256, False), ((), 6, 10, False),
    ((2,), 8, 5000, True)])                 # one thread an output
def test_worker_sum_kernel_matches_plain(cuda_device, lead, n, d, strided):
    """The worker sum (ring_sum.cu's loop on float32 rows) bit for bit
    against its plain loop, on the round's [M, N, d] layout (handed to the
    kernel as its [N, M, d] view) and on a view whose last axis is strided
    (the wrapper makes it contiguous), over two launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    x = torch.randn(lead + (n, d), generator=gen, device=cuda_device)
    if strided:
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    before = trs.worker_sum.launches
    out = trs.worker_sum(x)
    torch.cuda.synchronize()
    assert trs.worker_sum.launches == before + 1
    assert out.shape == lead + (d,)
    assert torch.equal(out, trs.worker_sum_plain(x))
    assert torch.equal(trs.worker_sum(x), out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [((6, 10), (3, 5)),
                                         ((256, 24), (256, 8)),
                                         ((512, 48), (256, 16))])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_squant_decode_kernel_on_other_blocks(cuda_device, shape, block,
                                              dtype):
    """Blocks whose width is not a multiple of 16 take one element a
    thread, (256, 16) the 16-element chunks; both bit for bit."""
    x, _, u = _rand(shape, 5 * sum(shape), cuda_device)
    q, sc = tsq.squant_encode(x, u, s=3, block=block)
    before = tsq.squant_decode.launches
    out = tsq.squant_decode(q, sc, block=block, dtype=dtype)
    torch.cuda.synchronize()
    assert tsq.squant_decode.launches == before + 1
    assert torch.equal(out, tsq.squant_decode_plain(q, sc, block=block,
                                                    dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [
    (sh, (256, 256)) for sh in OPS_SHAPES + [(256, 256), (768, 512)]] + [
    ((512, 510), (256, 255)),                 # one element a vector
    ((64, 64), (8, 64)), ((96, 60), (32, 30))])  # 2-D tiles of lane groups
def test_fused_memory_kernel_on_2d_tiles(cuda_device, shape, block):
    """B1 on the ops API's (256, 256) tiles (a cluster's registers; one
    tile, 16 and 32 of them) and on other 2-D tiles."""
    g, h, u = _rand(shape, 3 * sum(shape), cuda_device)
    _fused_agrees(g, h, u, block, alpha=0.5, s=1)


@pytest.mark.cuda
def test_squant_kernels_nan_tile(cuda_device):
    """An all-NaN tile ships a zero scale; decode and apply give exact
    zeros and an unchanged w there."""
    x, w, u = _rand((512, 256), 5, cuda_device)
    x[256:] = float("nan")
    q, sc = tsq.squant_encode(x, u, s=1)
    assert float(sc[1, 0]) == 0.0 and not q[256:].any()
    assert torch.equal(tsq.squant_decode(q, sc)[256:],
                       torch.zeros(256, 256, device=cuda_device))
    assert torch.equal(tsq.dequant_apply(w, q, sc, 0.5)[256:], w[256:])


@pytest.mark.cuda
def test_tree_memory_update_on_card(cuda_device):
    """One tree_memory_update over a ToyMLP(2, 64) gradient tree through B1
    and B6, against the same call on the CPU's plain versions."""
    model = ToyMLP(2, 64).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = model.init(gen)
    batch = model.batch(gen, n=32)
    grads = torch.func.grad(lambda p: model.loss(p, batch)[0])(params)
    h = {k: 0.1 * torch.randn(v.shape, generator=gen, device=cuda_device)
         for k, v in grads.items()}
    u = [torch.rand(256, 256, generator=gen, device=cuda_device)
         for _ in grads]
    f0, d0 = tfm.fused_memory_update.launches, tsq.squant_decode.launches
    dh, hn = tops.tree_memory_update(grads, h, 0.5, u, s=1)
    torch.cuda.synchronize()
    assert tfm.fused_memory_update.launches == f0 + len(grads)
    assert tsq.squant_decode.launches == d0 + len(grads)
    cpu = lambda t: {k: v.cpu() for k, v in t.items()}   # noqa: E731
    dh_c, hn_c = tops.tree_memory_update(cpu(grads), cpu(h), 0.5,
                                         [x.cpu() for x in u], s=1)
    for k in grads:
        assert dh[k].shape == grads[k].shape
        torch.testing.assert_close(hn[k], h[k] + 0.5 * dh[k], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(hn[k].cpu(), hn_c[k], rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the fault model on the card
# ---------------------------------------------------------------------------

def _same_values(a, b):
    """Bit for bit, NaN placement included."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(
        a, dtype=torch.bool)
    assert torch.equal(nan, torch.isnan(b) if b.is_floating_point()
                       else nan)
    ints = {torch.float32: torch.int32, torch.int8: torch.int8,
            torch.int32: torch.int32}
    assert torch.equal(a.view(ints[a.dtype])[~nan],
                       b.view(ints[b.dtype])[~nan])


@pytest.mark.cuda
def test_fault_primitives_on_card_match_cpu(cuda_device):
    """Bit flips, scrubbing, validity and the Markov chain give the same
    bits on the card as on the CPU."""
    from repro_torch.core import codec as tcodec
    from repro_torch.core import faults as tflt
    gen = torch.Generator().manual_seed(0)
    shape = (64, 20, 40)
    q = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)
    x = torch.randn(shape, generator=gen)
    i = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                      dtype=torch.int32)
    bit8 = torch.randint(0, 8, shape, generator=gen, dtype=torch.int32)
    bit32 = torch.randint(0, 32, shape, generator=gen, dtype=torch.int32)
    u = torch.rand(shape, generator=gen)
    dev = cuda_device
    for fn, a, b in ((tflt.corrupt_int8, q, bit8), (tflt.corrupt_f32, x,
                                                    bit32),
                     (tflt.corrupt_i32, i, bit32)):
        _same_values(fn(a.to(dev), b.to(dev), u.to(dev), 0.3),
                     fn(a, b, u, 0.3))
    codec = tcodec.make_codec("row_squant", 40, s=1)
    p = codec.encode(x, u)
    draws = [(bit8, u), (bit32[..., :1], u[..., :1])]
    only = (u[..., 0] < 0.7).float()
    cpu = tflt.corrupt_payload(draws, p, 0.2, only=only)
    card = tflt.corrupt_payload(
        [(b.to(dev), v.to(dev)) for b, v in draws],
        p.replace(**{k: v.to(dev) for k, v in p.data.items()}), 0.2,
        only=only.to(dev))
    for k in cpu.keys():
        _same_values(card[k], cpu[k])
    valid = codec.validate(card)
    torch.testing.assert_close(valid.cpu(), codec.validate(cpu))
    scrubbed = tflt.scrub_payload(card, valid)
    for k, v in tflt.scrub_payload(cpu, codec.validate(cpu)).data.items():
        _same_values(scrubbed[k], v)
    fc = tflt.FaultConfig(p_stay=0.9)
    prev_c, prev_d = torch.zeros(64), torch.zeros(64, device=dev)
    for k in range(20):
        uk = torch.rand(64, generator=gen)
        prev_c = tflt.participation(fc, 0.5, uk, prev_c, k)
        prev_d = tflt.participation(fc, 0.5, uk.to(dev), prev_d, k)
        _same_values(prev_d, prev_c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [((2560, 40), (1, 40)),
                                         ((2048, 256), (256, 256)),
                                         ((8, 2**17), (1, 2**17))])
def test_fused_memory_kernel_on_fault_inputs(cuda_device, shape, block):
    """Tiles a fault can hand B1 (all NaN, one NaN, +-Inf, all -0.0, an
    overflowing norm, a NaN norm beside blown-up entries whose levels
    saturate): bit for bit with the plain version there, NaN placement
    included everywhere."""
    g, h, u = _rand(shape, 41, cuda_device)
    bm, bn = block
    t = [slice(j * bm, (j + 1) * bm) for j in range(6)]
    g[t[0]] = float("nan")
    g[t[1]][-1, 3] = float("inf")
    g[t[2]][0, 0] = -float("inf")
    g[t[3]], h[t[3]] = -0.0, -0.0
    g[t[4]][0, :2] = 3e38
    g[t[5]] *= 1e15
    h[t[5]][0, 1] = float("nan")
    out = tfm.fused_memory_update(g, h, u, 0.5, s=2, block=block)
    ref = tfm.fused_memory_update_plain(g, h, u, 0.5, s=2, block=block)
    rows = 6 * bm
    for a, b in zip(out, ref):
        _same_values(a[:rows] if a.shape[0] == g.shape[0] else a[:6],
                     b[:rows] if b.shape[0] == g.shape[0] else b[:6])
    assert torch.equal(torch.isnan(out[2]), torch.isnan(ref[2]))
    assert set(out[0][t[5]].unique().tolist()) <= {-128, 0, 127}


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,c,strided", [(20, 128, 40, True),
                                           (8, 16, 64, False),
                                           (20, 1, 4096, False),
                                           (5, 7, 33, True)])
def test_ring_sum_kernel_on_corrupted_payloads(cuda_device, n, m, c,
                                               strided):
    """Levels over the whole int8 range and scales that are NaN, +-Inf,
    -0.0, negative or overflowing: every path of B2 bit for bit with its
    plain version, NaN placement included."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(n + m + c)
    q = torch.randint(-128, 128, (m, n, c), generator=gen, device=dev,
                      dtype=torch.int8)
    sc = torch.rand(m, n, 1, generator=gen, device=dev)
    flat = sc.view(-1)
    bad = [float("nan"), float("inf"), -0.0, -float("inf"), -2.5, 3e38]
    flat[:len(bad)] = torch.tensor(bad, device=dev)
    q.view(-1)[:c] = -128
    if strided:
        q, sc = q.transpose(0, 1), sc.transpose(0, 1)
    else:
        q, sc = q.reshape(n, m, c), sc.reshape(n, m, 1)
    _same_values(trs.ring_sum(q, sc), trs.ring_sum_plain(q, sc))


@pytest.mark.cuda
def test_faulted_sweep_resumes_bitwise_on_card(cuda_device, tmp_path):
    import dataclasses

    import numpy as np

    from repro_torch.core import faults as tflt
    from repro_torch.core import federated as tfed
    from repro_torch.core import sweep as tsw
    prob, _ = tfed.make_lsr_problem(3, n_workers=8, n_per=50, d=16,
                                    noise=0.3, device=cuda_device)
    cfgs = [dataclasses.replace(tart.variant_config(v, 16, 8, p=0.7),
                                faults=tflt.FaultConfig(
                                    bitflip_rate=0.05, scrub=True,
                                    sentinel=1e4))
            for v in ("sgd", "artemis")]
    kw = dict(batch=4, eval_every=2, backend="cuda", device=cuda_device,
              checkpoint_dir=str(tmp_path), checkpoint_every=10)
    full = tsw.run_sweep(prob, cfgs, [0.02, 0.05], [0, 1], 40, **kw)
    (tmp_path / "LATEST").write_text("5")
    res = tsw.run_sweep(prob, cfgs, [0.02, 0.05], [0, 1], 40, resume=True,
                        **kw)
    for f in ("losses", "bits", "w_final", "rollbacks", "gamma_scale"):
        assert np.array_equal(getattr(full, f), getattr(res, f)), f
