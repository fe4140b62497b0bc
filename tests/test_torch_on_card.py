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
operations, each rounded to the output type); bucket_acc (both entry
points) and bucket_ring_sum bit for bit, NaN placement included, on
corrupted mesh payloads and on the leaf wire's stacks.
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


# ---------------------------------------------------------------------------
# the mesh wire's second half: B3 and B4 on faulted payloads and the leaf
# wire's stacks
# ---------------------------------------------------------------------------

def _corrupt_payload(shape, seed, dev, scrub):
    """A [W, B, R, C] row-scale payload as the faulted wire hands it to the
    ring: bits flipped over the levels and the scales, and scales set to
    NaN, +-Inf, 0.0, -0.0 and -2.5; with ``scrub`` after the server's
    checksum and scrub (finite scales, a failed bucket's zeroed)."""
    from repro_torch.core import codec as wire
    from repro_torch.core import dist as tdist
    from repro_torch.core import faults as tflt
    q, sc = _payload(shape, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    meta = wire.PayloadMeta("row_squant", tuple(shape), "torch.float32",
                            (("s", 3),))
    p = wire.WirePayload({"levels": q, "scales": sc}, meta)
    draws = [(torch.randint(0, bits, t.shape, generator=gen, device=dev,
                            dtype=torch.int32),
              torch.rand(t.shape, generator=gen, device=dev))
             for t, bits in ((q, 8), (sc, 32))]
    p = tflt.corrupt_payload(draws, p, 5e-4)
    sc = p["scales"].clone()
    sc.view(-1)[:6] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), 0.0, -0.0, -2.5])
    p = p.replace(scales=sc)
    if scrub:
        codec = wire.make_codec("row_squant", shape[-1], s=3)
        p = tflt.scrub_payload(p, tdist.message_valid(codec, p, 2))
    return p["levels"].contiguous(), p["scales"].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("scrub", [False, True])
def test_ring_kernels_on_corrupt_payloads(cuda_device, scrub):
    """B3 (out of place and every in-place hop) and B4 bit for bit with
    their plain versions, NaN placement included, on corrupted payloads,
    scrubbed and not."""
    shape = (8, 16, 49, 64)
    q, sc = _corrupt_payload(shape, 40 + scrub, cuda_device, scrub)
    acc = torch.randn(shape, device=cuda_device)
    flat = (q.flatten(0, 1), sc.flatten(0, 1), acc.flatten(0, 1))
    _same_values(tbr.bucket_acc(flat[2], flat[0], flat[1]),
                 tbr.bucket_acc_plain(flat[2], flat[0], flat[1]))
    a, r = torch.full(shape, float("nan"), device=cuda_device), acc.clone()
    for hop in range(shape[0]):
        tbr.bucket_acc_hop_(a, q, sc, hop)
        tbr.bucket_acc_hop_plain_(r, q, sc, hop)
        _same_values(a, r)
    out = tbr.bucket_ring_sum(q, sc)
    _same_values(out, tbr.bucket_ring_sum_plain(q, sc))
    if scrub:
        assert bool(torch.isfinite(sc).all())
    else:
        assert bool(torch.isnan(out).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024, 1024), (8, 1, 1024),
                                   (8, 1024, 1)])
def test_bucket_acc_hop_on_leaf_stacks(cuda_device, shape):
    """The leaf wire's stacks of ToyMLP(12, 1024) at W = 8 (a weight, a
    bias as one row, the head's rows of one): every hop bit for bit."""
    q, sc = _payload(shape, sum(shape), cuda_device)
    a = torch.full(shape, float("nan"), device=cuda_device)
    r = a.clone()
    for hop in range(shape[0]):
        tbr.bucket_acc_hop_(a, q, sc, hop)
        tbr.bucket_acc_hop_plain_(r, q, sc, hop)
        torch.cuda.synchronize()
        assert torch.equal(a, r), hop


@pytest.mark.cuda
def test_leaf_and_faulted_mesh_on_card(cuda_device):
    """The leaf wire and a faulted bucketed wire train finite on the card,
    the leaf ring launching W bucket_acc hops a leaf a step."""
    from repro_torch.core import faults as tflt
    leaf = experiments.toy_mesh_train("artemis", n_layers=2, d=32, steps=3,
                                      n_workers=4, wire="leaf",
                                      device=cuda_device)
    assert leaf["launches"]["bucket_acc"] == 3 * 4 * 5
    flt = experiments.toy_mesh_train(
        "artemis", n_layers=2, d=32, steps=3, n_workers=4,
        p_participation=0.5, telemetry=True, device=cuda_device,
        faults=tflt.FaultConfig(bitflip_rate=0.02, blowup_rate=0.3,
                                scrub=True))
    for res in (leaf, flt):
        assert all(torch.isfinite(p).all() for p in res["params"].values())
    assert len(flt["obs"]) == 3


# ---------------------------------------------------------------------------
# the LM stack on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-7b", "falcon-mamba-7b",
                                  "recurrentgemma-2b", "whisper-tiny"])
def test_lm_on_card_matches_cpu(cuda_device, arch):
    """A reduced arch's loss and decode logits on the card against the same
    model on the CPU, at f32 compute: loss to rtol 1e-5, logits to atol
    1e-4 (the card's matmuls sum in another order)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                                     dtype=torch.int32)}
    enc = None
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, cfg.n_frames, cfg.d_model,
                                      generator=gen)
        enc = torch.randn(2, cfg.n_frames, cfg.d_model, generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            loss, _ = model.loss(p, b)
            cache = model.init_cache(2, 8, device=dev)
            logits = []
            for i in range(8):
                lg, cache = model.decode_step(
                    p, cache, b["tokens"][:, i], i,
                    enc_out=None if enc is None else enc.to(dev))
                logits.append(lg.cpu())
        out[str(dev)] = (float(loss), torch.stack(logits))
    (lc, gc), (ld, gd) = out["cpu"], out[str(cuda_device)]
    assert abs(ld - lc) <= 1e-5 * abs(lc)
    torch.testing.assert_close(gd, gc, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_lm_train_cli_on_card(cuda_device, tmp_path):
    """The train CLI on the card (artemis, W = 2): the loss falls, the ring
    launches bucket_acc W times a step, and a resumed run ends on the same
    bits as the one that did not stop."""
    import numpy as np
    from repro_torch.launch import train
    base = ["--arch", "starcoder2-7b", "--reduced", "--batch", "4", "--seq",
            "64", "--dist", "artemis", "--workers", "2", "--log-every", "1"]
    a0 = tbr.bucket_acc.launches
    logs = train.main(base + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert tbr.bucket_acc.launches - a0 == 2 * 6
    assert logs[-1]["loss"] < logs[0]["loss"]
    train.main(base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    train.main(base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                       "--resume"])
    a, b = (np.load(tmp_path / d / "step_00000006" / "arrays.npz")
            for d in ("a", "b"))
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _FixedNoise:
    """The same draws on any device: numpy's, moved to ``device``."""

    def __init__(self, iters, n, d, batch, n_per, device):
        import numpy as np
        from repro_torch.core import noise
        rng = np.random.default_rng(0)
        self.rounds = [noise.RoundNoise(
            idx=torch.from_numpy(rng.integers(0, n_per, (1, n, batch))).to(
                device),
            u_act=torch.from_numpy(rng.random((1, n), np.float32)).to(device),
            u_up=torch.from_numpy(rng.random((1, n, d), np.float32)).to(
                device),
            u_dwn=torch.from_numpy(rng.random((1, d), np.float32)).to(device))
            for _ in range(iters)]

    def round(self, k, **_):
        return self.rounds[k]


@pytest.mark.cuda
def test_run_percell_on_card(cuda_device):
    """The legacy loop on the card through the fused kernels against the
    same loop on the CPU with the same draws: bits exactly (counts of who
    was active), losses to rtol 1e-4 (the fused uplink's norm order)."""
    import numpy as np
    from repro_torch.core import federated as tfed
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        prob, w_star = tfed.make_lsr_problem(4, n_workers=8, n_per=50, d=16,
                                             device="cpu")
        prob = tfed.Problem(prob.X.to(dev), prob.Y.to(dev), prob.kind)
        cfg = tart.variant_config("artemis", 16, 8, p=0.6)
        out[dev.type] = tfed.run_percell(
            prob, cfg, 0.02, 20, 0, batch=4, w_star=w_star.to(dev),
            backend="cuda", noise=_FixedNoise(20, 8, 16, 4, 50, dev))
    np.testing.assert_array_equal(out["cuda"].bits, out["cpu"].bits)
    np.testing.assert_allclose(out["cuda"].losses, out["cpu"].losses,
                               rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_kernel_bench_reads_every_kernel_from_the_trace(cuda_device):
    from repro_torch.bench import Context, kernel_bench
    rows = kernel_bench.kernel_suite(Context(True, cuda_device, "build"))
    kernels = [r for r in rows if r[0].startswith("kernel/b")
               or r[0] == "kernel/worker_sum"]
    assert len(kernels) == 11
    for name, us, derived in kernels:
        assert us > 0 and "device_us=" in derived, (name, derived)
        assert "not_measured" not in derived.split("bound_us")[0], derived


@pytest.mark.cuda
def test_analysis_audits_on_card(cuda_device):
    """The launch audit and the wire checks on the card, and every
    host-sync finding suppressed by the port's baseline."""
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis import findings, launch_audit
    from repro_torch.analysis import wire_checks as wc
    assert launch_audit.audit_entry_points(cuda_device) == []
    assert wc.audit_codec_wires(cuda_device) == []
    assert wc.audit_donation(cuda_device) == []
    syncs = wc.audit_host_sync(cuda_device)
    findings.apply_baseline(syncs, findings.load_baseline(cli.BASELINE))
    assert not findings.active(syncs), [f.format() for f in syncs]


@pytest.mark.cuda
def test_dry_run_moves_no_device_memory(cuda_device):
    from repro_torch.launch import dryrun
    before = torch.cuda.memory_allocated(cuda_device)
    rec = dryrun.lower_one("starcoder2-7b", "decode_32k", batch=4, seq=64)
    assert rec["status"] == "ok" and rec["peak_bytes"] > rec["param_bytes"]
    assert torch.cuda.memory_allocated(cuda_device) == before


# ---------------------------------------------------------------------------
# the fused attention (kernels/attention.py)
# ---------------------------------------------------------------------------

# b, sq, sk, h, kv, d, causal, window: the cells' own shapes (whisper-tiny's
# encoder, decoder and cross attention at 2 rows, one row of starcoder2-7b's
# causal GQA at 4096) and a window
ATTN_CASES = {
    "encoder": (2, 1500, 1500, 6, 6, 64, False, 0),
    "decoder": (2, 448, 448, 6, 6, 64, True, 0),
    "cross": (2, 448, 1500, 6, 6, 64, False, 0),
    "gqa_4096": (1, 4096, 4096, 36, 4, 128, True, 0),
    "window": (2, 1000, 1000, 8, 2, 128, True, 256),
}


def _attn_inputs(spec, dev, seed=0):
    b, sq, sk, h, kv, d, causal, window = spec
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device=dev).to(BF16)
             for _ in range(2))
    k, v = (torch.randn(b, sk, kv, d, generator=gen, device=dev).to(BF16)
            for _ in range(2))
    qp = torch.arange(sq, dtype=torch.int32, device=dev)[None].expand(b, sq)
    kp = torch.arange(sk, device=dev)           # int64 and 1-D, as cross's
    return q, k, v, do, qp, kp, causal, window


def _block_grads(q, k, v, do, qp, kp, causal, window, dtype):
    """``_attn_block`` (the eager route) with its operands in ``dtype``:
    out and (dq, dk, dv)."""
    from repro_torch.models import layers as L
    leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    b, sk = k.shape[:2]
    out = L._attn_block(*leaves, qp, kp[None].expand(b, sk),
                        q.shape[2] // k.shape[2], q.shape[-1] ** -0.5, window,
                        causal, torch.float32)
    return out, torch.autograd.grad(out, leaves, do.to(dtype))


def _rel(a, r):
    r = r.detach().float()
    return float((a.detach().float() - r).abs().max() / r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_attention_kernel_matches_attn_block(cuda_device, name):
    """out, dq, dk and dv of the kernel against ``_attn_block`` run in f32
    and in bf16.  Against f32, within 1e-2 of the largest entry: the kernel
    rounds P and dS to bf16 for their products and its outputs to bf16
    (2**-8 relative each), over sums of up to 4096 terms.  Against the bf16
    block, within 3e-2: that block also rounds its scores to bf16 before the
    softmax (about 0.01 absolute on scores of unit size).  And the kernel
    stays at least as close to f32 as the bf16 block is, within 1e-3: its
    scores are f32 from the product.  One launch a forward, two a backward,
    and a second backward gives the same bits (no atomics)."""
    from repro_torch.kernels import attention as FA
    q, k, v, do, qp, kp, causal, window = _attn_inputs(ATTN_CASES[name],
                                                       cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = FA.flash_attention.launches
    out = FA.flash_attention(*leaves, qp, kp, scale=q.shape[-1] ** -0.5,
                             window=window, causal=causal)
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    again = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 5
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    o32, g32 = _block_grads(q, k, v, do, qp, kp, causal, window,
                            torch.float32)
    o16, g16 = _block_grads(q, k, v, do, qp, kp, causal, window, BF16)
    for mine, r32, r16 in zip((out, *grads), (o32, *g32), (o16, *g16)):
        assert torch.isfinite(mine).all()
        assert _rel(mine, r32) <= 1e-2, (name, _rel(mine, r32))
        assert _rel(mine, r16) <= 3e-2, (name, _rel(mine, r16))
        assert _rel(mine, r32) <= _rel(r16, r32) + 1e-3, (
            name, _rel(mine, r32), _rel(r16, r32))


def _attn_loss(q, k, v, pos):
    from repro_torch.kernels import attention as FA
    out = FA.flash_attention(q, k, v, pos, pos, scale=0.125, causal=True)
    return out.float().square().mean()


@pytest.mark.cuda
def test_flash_attention_vmap_grad_equals_the_loop(cuda_device):
    """``vmap(grad_and_value)`` over 3 workers, the batch folded into the
    launch, equals the loop over the workers: the gradients bit for bit
    (each row's programs compute the same tiles in the same order), the
    loss to rtol 1e-6 (its mean is torch's reduction, which sums a
    vmapped batch in another order on the card)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    w, b, s, h, kv, d = 3, 2, 448, 6, 6, 64
    qs = torch.randn(w, b, s, h, d, generator=gen, device=cuda_device)
    ks, vs = (torch.randn(w, b, s, kv, d, generator=gen, device=cuda_device)
              for _ in range(2))
    qs, ks, vs = (t.to(BF16) for t in (qs, ks, vs))
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None]
    fn = torch.func.grad_and_value(_attn_loss, argnums=(0, 1, 2))
    grads, vals = torch.func.vmap(fn, in_dims=(0, 0, 0, None))(qs, ks, vs,
                                                               pos)
    for i in range(w):
        gi, vi = fn(qs[i], ks[i], vs[i], pos)
        torch.testing.assert_close(vals[i], vi, rtol=1e-6, atol=0)
        assert all(torch.equal(a[i], r) for a, r in zip(grads, gi))


@pytest.mark.cuda
def test_flash_attention_under_remat_changes_no_bit(cuda_device):
    """Through remat's checkpoint (the recompute under ``torch.func.vjp``)
    under ``vmap(grad_and_value)``: the gradients without it, bit for
    bit."""
    from repro_torch.kernels import attention as FA
    from repro_torch.models import remat as RM
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w, b, s, h, d = 2, 2, 448, 6, 64
    x = torch.randn(w, b, s, h * d, generator=gen, device=cuda_device)
    wq = torch.randn(h * d, h * d, generator=gen, device=cuda_device) * 0.05
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None]

    def body(x, pos, wq):
        q = (x @ wq).to(BF16).reshape(b, s, h, d)
        return (FA.flash_attention(q, q, q, pos, pos, scale=0.125)
                .reshape(b, s, h * d),)

    def loss(wq, x, remat):
        y, = (RM.checkpoint(body, RM.saved_products(None), x, pos, wq)
              if remat else body(x, pos, wq))
        return y.float().square().mean()

    outs = [torch.func.vmap(torch.func.grad_and_value(loss),
                            in_dims=(None, 0, None))(wq, x, remat)
            for remat in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,heads,kv", [("whisper-tiny", 2, 2),
                                           ("starcoder2-7b", 4, 2)])
def test_fused_attention_counts_of_one_step(cuda_device, arch, heads, kv):
    """One traced Artemis step (W = 2, remat on) of a reduced arch at head
    dim 64: each attention call launches the forward twice (the forward
    and remat's recompute) and the backward once (two kernels), and its
    forward records count ``attn_fused`` 1 each."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import dist
    from repro_torch.kernels import attention as FA
    from repro_torch.models.model import build_model
    from repro_torch.obs import spans
    from repro_torch.optim import adam
    cfg = dataclasses.replace(get_config(arch, reduced=True), remat=True,
                              n_heads=heads, n_kv=kv)
    assert cfg.hd == 64
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                                     device=cuda_device)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(4, cfg.n_frames, cfg.d_model,
                                      generator=gen, device=cuda_device)
    calls = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
             else cfg.n_layers)
    dcfg = dist.DistConfig(seed=5, bucket_bytes=4096, max_buckets=16,
                           bucket_row=64)
    init, step = dist.make_train_step(model, adam(1e-3), dcfg, 2, cuda_device)
    state = init(params)
    state, _ = step(state, batch)                    # builds the kernels
    spans.reset()
    before = FA.flash_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state, (loss, _) = step(state, batch)
        torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert FA.flash_attention.launches - before == 4 * calls
    counts = [r.counts.get("attn_fused") for r in spans.phases()
              if r.name == "grads/attention" and r.pass_ != spans.BACKWARD]
    assert counts == [1] * (2 * calls)


@pytest.mark.cuda
def test_decode_keeps_the_eager_attention_on_card(cuda_device):
    """A decode step of reduced whisper-tiny at head dim 64 on bf16 CUDA
    tensors launches the fused attention 0 times: its self-attention holds
    the cache and its cross-attention is told so; the encoder before it
    (no cache) launches it, once a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as FA
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("whisper-tiny", reduced=True),
                              n_heads=2, n_kv=2)
    assert cfg.hd == 64
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    frames = torch.randn(2, cfg.n_frames, cfg.d_model, generator=gen,
                         device=cuda_device)
    tok = torch.randint(0, cfg.vocab, (2,), generator=gen,
                        device=cuda_device)
    with torch.no_grad():
        before = FA.flash_attention.launches
        enc = model._encode(params, frames)
        encoded = FA.flash_attention.launches - before
        cache = model.init_cache(2, 16, device=cuda_device)
        before = FA.flash_attention.launches
        for pos in range(3):
            logits, cache = model.decode_step(params, cache, tok, pos,
                                              enc_out=enc)
        torch.cuda.synchronize()
    assert encoded == cfg.enc_layers
    assert FA.flash_attention.launches - before == 0
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("theta,half", [(10000.0, 32), (1e6, 64)])
def test_rope_scalar_base_same_bits_on_card(cuda_device, theta, half):
    """``layers.rope`` raises theta to the exponents with theta as the
    power's scalar base (no host-to-device copy): the same bits as theta
    as a 0-d device tensor, on the card as on the CPU."""
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=cuda_device) / half
    ref = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=cuda_device), expo)
    assert torch.equal(torch.pow(float(torch.tensor(
        theta, dtype=torch.float32)), expo), ref)
