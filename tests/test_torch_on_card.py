"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor the JAX package, so they also run where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_on_card.py

Tolerances: int8 levels may differ on fewer than 1e-4 of the entries, each
by at most 1 (the kernel reduces the norm in another order); scales to
rtol 1e-6; h_new to rtol 1e-5, atol 1e-6 where the levels agree; ring_sum,
bucket_acc and bucket_ring_sum bit for bit (the same multiply-then-add, in
worker order), and so the pipelined mesh ring equals the sequential one.
"""
import pytest
import torch

from repro_torch import experiments
from repro_torch.core import artemis as tart
from repro_torch.kernels import bucket_ring as tbr
from repro_torch.kernels import fused_memory as tfm
from repro_torch.kernels import ring_sum as trs


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(2560, 2), (2560, 40), (20, 4096)])
def test_fused_memory_kernel_matches_plain(cuda_device, rows, d):
    g, h, u = _rand((rows, d), rows + d, cuda_device)
    before = tfm.fused_memory_update.launches
    q, sc, hn = tfm.fused_memory_update(g, h, u, 0.25, s=2, block=(1, d))
    torch.cuda.synchronize()
    assert tfm.fused_memory_update.launches == before + 1
    qr, scr, hnr = tfm.fused_memory_update_plain(g, h, u, 0.25, s=2,
                                                 block=(1, d))
    diff = (q.int() - qr.int()).abs()
    assert float((diff != 0).float().mean()) < 1e-4
    assert int(diff.max()) <= 1
    torch.testing.assert_close(sc, scr, rtol=1e-6, atol=0)
    agree = diff == 0
    torch.testing.assert_close(hn[agree], hnr[agree], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_fused_memory_kernel_nonfinite_row(cuda_device):
    g, h, u = _rand((4, 20), 3, cuda_device)
    g[1, 3] = float("nan")
    q, sc, hn = tfm.fused_memory_update(g, h, u, 0.5, s=1, block=(1, 20))
    assert float(sc[1, 0]) == 0.0 and int(q[1, 3]) == 0
    assert torch.equal(hn[1], h[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,c", [(20, 128, 40), (20, 1, 4096)])
def test_ring_sum_kernel_matches_plain(cuda_device, n, m, c):
    gen = torch.Generator(device=cuda_device).manual_seed(m + c)
    q = torch.randint(-3, 4, (n, m, c), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    sc = torch.rand(n, m, 1, generator=gen, device=cuda_device)
    before = trs.ring_sum.launches
    out = trs.ring_sum(q, sc)
    torch.cuda.synchronize()
    assert trs.ring_sum.launches == before + 1
    assert torch.equal(out, trs.ring_sum_plain(q, sc))
    # the round's transposed [M, N] layout, as a strided view
    qt, st = q.transpose(0, 1).contiguous(), sc.transpose(0, 1).contiguous()
    assert torch.equal(trs.ring_sum(qt.transpose(0, 1), st.transpose(0, 1)),
                       out)


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
@pytest.mark.parametrize("n,b,r,c", [(8, 16, 49, 64), (5, 3, 45, 1)])
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


@pytest.mark.cuda
def test_mesh_pipelined_equals_sequential(cuda_device):
    runs = [experiments.toy_mesh_train("artemis", impl, n_layers=2, d=32,
                                       steps=3, n_workers=4,
                                       device=cuda_device)
            for impl in ("pipelined", "sequential")]
    assert runs[0]["launches"]["bucket_acc"] == 3 * 4
    for k, p in runs[0]["params"].items():
        assert torch.equal(p, runs[1]["params"][k])
