"""The benchmark's own counts against hand counts: a step's model FLOPs
(``portbench/flops.py``) and B3's bytes (``portbench/rooflines``)."""
import pytest

from portbench import flops
from portbench.rooflines import bucket_acc_hop_kernel as B3

TINY = dict(family="dense", n_layers=1, d_model=4, n_heads=2, n_kv=1,
            d_ff=8, vocab=10, activation="gelu")


def test_dense_step_flops_by_hand():
    # a token's multiply-adds: wq 16, wk 8, wv 8, wo 16, w_up 32, w_down 32,
    # unembed 40 = 152; x2 forward, x3 with the backward, 3 tokens: 2736.
    # causal pairs 1 + 2 + 3 = 6, each 2 products of H * hd = 4
    # multiply-adds: 6 * 8 * 2 * 3 = 288
    assert flops.step_flops(TINY, rows=1, seq=3) == 2736 + 288


def test_encdec_step_flops_by_hand():
    cfg = dict(TINY, family="encdec", enc_layers=1)
    # tokens: 152 + the cross q and o (16 + 16) = 184 a token, 3 tokens;
    # frames: the encoder layer 112, the cross k and v 16, the front end
    # 16 = 144 a frame, 2 frames; 6 * (552 + 288) = 5040.
    # pairs: causal 6, cross 3 x 2, encoder 2 x 2 = 16; 16 * 48 = 768
    assert flops.step_flops(cfg, rows=1, seq=3, frames=2) == 5040 + 768


def test_b3_bound_reproduces_the_kernel_table():
    # bench/kernel_bench.py's out-of-place bucket_acc at [128, 3076, 256]:
    # 271.261 us at 3.35 TB/s (PERF.md's kernel table)
    nbytes = B3.launch_bytes((128, 3076, 256), hop=1)
    assert B3.bound_us(nbytes) == pytest.approx(271.261, abs=5e-4)


def test_b3_step_bytes_count_every_hop():
    stack = (20, 16, 13795, 256)
    n = 20 * 16 * 13795 * 256
    rows = n // 256
    assert B3.step_bytes(20, stack[1:]) == (5 * n + 4 * rows) \
        + 19 * (9 * n + 4 * rows)
