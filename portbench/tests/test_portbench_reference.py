"""The plain reference against the port on the CPU, at each cell's CPU size
(``tests/sizes/``): the parameters' names, shapes and order, the noise, one
step of the wire, and three training steps of every cell (Artemis at W = 2
and the plain step)."""
import math

import pytest
import torch

from portbench import bench, check
from portbench.reference import for_config
from portbench.reference import train as RT
from portbench.tests.conftest import SIZED_CELLS, reduced_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", [c for c in ("whisper-tiny.fed20",
                                                "starcoder2-7b-1layer.plain")
                                  if c in SIZED_CELLS])
def test_param_spec_is_the_ports_flatten_order(cell):
    from repro_torch.models.model import build_model
    c = reduced_cell(cell)
    run = bench.runner(c.traffic["runner"], c.root)
    model = build_model(run.program_config(c.config))
    params = model.init(torch.Generator().manual_seed(0))
    spec = for_config(c.config, c.root).param_spec(c.config)
    assert [(k, tuple(v.shape)) for k, v in params.items()] == \
        [(k, s) for k, s, _ in spec]
    # the port's init: a norm's scale at zero, a matrix at 1/sqrt(fan-in)
    for k, _, std in spec:
        if std == 0:
            assert not params[k].any()
        else:
            assert params[k].std().item() == pytest.approx(std, rel=0.25)


def test_uniforms_are_the_ports_mesh_noise():
    from repro_torch.core.noise import MeshNoise
    shape, seed = (3, 2, 8), 2**31 + 7
    noise = MeshNoise(seed, 4, shape, CPU)
    for k in (0, 1, 5):
        u_up, u_dwn = RT.uniforms(seed, k, 4, shape, CPU)
        d = noise.step(k)
        assert torch.equal(u_up, d.u_up) and torch.equal(u_dwn, d.u_dwn)


def test_one_wire_step_matches_the_ports_aggregate():
    from repro_torch.core import bucketing, dist
    from repro_torch.core.noise import MeshNoise
    w, shape = 3, (1, 8, 256)
    gen = torch.Generator().manual_seed(3)
    g = torch.randn((w,) + shape, generator=gen)
    h0 = 0.1 * torch.randn((w,) + shape, generator=gen)
    hb0 = 0.1 * torch.randn(shape, generator=gen)
    cfg = dist.DistConfig(seed=5)
    layout = bucketing.make_layout([(math.prod(shape),)])
    assert layout.shape == shape
    state = dist.init_dist_state(cfg, [(math.prod(shape),)], w, device=CPU)
    state.h, state.hbar = h0.clone(), hb0.clone()
    draws = MeshNoise(5, w, shape, CPU).step(0)
    ghat, new = dist.artemis_aggregate_bucketed(cfg, state, g.clone(),
                                                layout, w, draws)
    alpha = 1.0 / (2.0 * (16.0 + 1.0))
    ref, h, hbar = RT.aggregate(g.clone(), h0, hb0, draws.u_up, draws.u_dwn,
                                s=1, alpha=alpha, p=1.0)
    # the two round a row's norm apart; a level flips only where a uniform
    # lies within that rounding of its threshold
    for a, b in ((ghat, ref), (new.h, h), (new.hbar, hbar)):
        close = torch.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert close.float().mean() > 0.999


@pytest.mark.parametrize("cell", SIZED_CELLS)
def test_reference_follows_the_port(cell):
    """Three steps of the port (bf16 products) against the float32
    reference: the gaps stay within the bf16 rounding's reach (about 8
    ulps of bf16 on the norms, 1e-3 on the losses), where a fault of the
    semantics reads 0.1 or more.  Through the wire the first gradient is
    the quantized broadcast: a level that flips on the rounding moves a
    leaf of a few rows by several percent, so it is held to 0.1."""
    c = reduced_cell(cell)
    run = bench.runner(c.traffic["runner"], c.root)
    seed = 2**31 + 11
    gaps = check.gaps(run.program_readings(c, seed, CPU),
                      run.reference_readings(c, seed, CPU))
    assert gaps["loss_gap"] < 1e-3
    assert gaps["grad_gap"] < (0.1 if c.traffic["wire"] else 0.03), gaps
    for name in ("change_gap", "h_gap", "hbar_gap"):
        assert gaps.get(name, 0.0) < 0.03, (name, gaps)
