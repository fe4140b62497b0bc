"""The port's problems and sweep against the JAX package's.

The reference's problem and ``w_star`` are carried across with
``repro_torch.convert``; the port's sweep takes a noise source that replays
the reference's draws (its per-round sample indices, participation and codec
uniforms, derived from the cell keys as ``core/sweep.py`` and
``core/artemis.py`` derive them).  Tolerances: losses and distances to
rtol 1e-4, atol 1e-6 (the reference's own cross-grid tolerance,
tests/test_sweep.py); metered bits exactly.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artemis as jart
from repro.core import federated as jfed
from repro.core import sweep as jsw
from repro_torch import convert, default_device
from repro_torch.core import artemis as tart
from repro_torch.core import federated as tfed
from repro_torch.core import noise as tnoise
from repro_torch.core import sweep as tsw

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D = 8, 16
VARIANTS = ["sgd", "qsgd", "artemis"]
GAMMAS = [0.01, 0.02]
SEEDS = [0, 1]


class JaxReplayNoise:
    """Replays the reference sweep's per-round draws for integer seeds."""

    def __init__(self, seeds, iters, n, d, batch, n_per):
        def one_round(key, k):
            kk = jax.random.fold_in(key, k)
            k_idx, k_act, k_art = jax.random.split(kk, 3)
            idx = jax.random.randint(k_idx, (n, batch), 0, n_per)
            u_act = jax.random.uniform(k_act, (n,))
            # the round's state.step equals k
            up_key, dwn_key = jax.random.split(jax.random.fold_in(k_art, k))
            u_up = jax.vmap(lambda kx: jax.random.uniform(kx, (d,)))(
                jax.random.split(up_key, n))
            return idx, u_act, u_up, jax.random.uniform(dwn_key, (d,))

        keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
        ks = jnp.arange(iters)
        per_seed = jax.vmap(jax.vmap(one_round, (None, 0)), (0, None))
        # [S, K, ...] -> [K, S, ...]
        self.draws = [torch.from_numpy(np.asarray(x).swapaxes(0, 1).copy())
                      for x in per_seed(keys, ks)]

    def round(self, k):
        idx, u_act, u_up, u_dwn = (x[k] for x in self.draws)
        return tnoise.RoundNoise(idx=idx.long(), u_act=u_act, u_up=u_up,
                                 u_dwn=u_dwn)


@pytest.fixture(scope="module")
def jprob():
    prob, _ = jfed.make_lsr_problem(jax.random.PRNGKey(42), n_workers=N,
                                    n_per=50, d=D, noise=0.3)
    return prob


@pytest.fixture(scope="module")
def tprob(jprob):
    return convert.problem(np.asarray(jprob.X), np.asarray(jprob.Y),
                           jprob.kind, jprob.reg, device="cpu")


@pytest.fixture(scope="module")
def w_star(jprob):
    return np.asarray(jprob.solve_opt())


@pytest.mark.parametrize("jax_backend,port_backend",
                         [("dense", "dense"), ("pallas", "cuda")])
def test_sweep_matches_reference(jprob, tprob, w_star, jax_backend,
                                 port_backend):
    iters, batch = 40, 4
    jcfgs = [jart.variant_config(v, D, N, p=0.7) for v in VARIANTS]
    ref = jsw.run_sweep(jprob, jcfgs, GAMMAS, SEEDS, iters, batch=batch,
                        eval_every=5, w_star=jnp.asarray(w_star),
                        backend=jax_backend)
    tcfgs = [tart.variant_config(v, D, N, p=0.7) for v in VARIANTS]
    noise = JaxReplayNoise(SEEDS, iters, N, D, batch, tprob.X.shape[1])
    out = tsw.run_sweep(tprob, tcfgs, GAMMAS, SEEDS, iters, batch=batch,
                        eval_every=5, w_star=convert.vector(w_star,
                                                            device="cpu"),
                        backend=port_backend, device="cpu", noise=noise)
    assert out.losses.shape == ref.losses.shape == (3, 2, 2, 8)
    assert np.array_equal(out.eval_iters, ref.eval_iters)
    assert np.array_equal(out.bits, ref.bits)
    for f in ("losses", "dists", "w_final", "w_avg", "w_tail_avg"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    assert not out.rollbacks.any() and (out.gamma_scale == 1).all()


def test_full_batch_logistic_pp1_matches_reference():
    """Full gradients of the logistic loss, PP1 at p = 0.5, decaying step."""
    jprob = jfed.make_logistic_problem(jax.random.PRNGKey(3), n_workers=6,
                                       n_per=40, d=2)
    tprob = convert.problem(np.asarray(jprob.X), np.asarray(jprob.Y),
                            jprob.kind, jprob.reg, device="cpu")
    kw = dict(iters=30, eval_every=3, full_batch=True, gamma_decay=True)
    jc = [jart.variant_config("artemis", 2, 6, p=0.5, pp_mode="pp1")]
    ref = jsw.run_sweep(jprob, jc, [0.5], [7], **kw)
    tc = [tart.variant_config("artemis", 2, 6, p=0.5, pp_mode="pp1")]
    noise = JaxReplayNoise([7], 30, 6, 2, 1, 40)
    out = tsw.run_sweep(tprob, tc, [0.5], [7], device="cpu", noise=noise,
                        **kw)
    assert np.array_equal(out.bits, ref.bits)
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["lsr", "logistic"])
def test_problem_maths_match_reference(kind):
    if kind == "lsr":
        jprob, _ = jfed.make_lsr_problem(jax.random.PRNGKey(1), n_workers=5,
                                         n_per=30, d=6, noise=0.2)
    else:
        jprob = jfed.make_logistic_problem(jax.random.PRNGKey(2),
                                           n_workers=5, n_per=30, d=6)
    tprob = convert.problem(np.asarray(jprob.X), np.asarray(jprob.Y),
                            jprob.kind, jprob.reg, device="cpu")
    w = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, 30, (3, 5, 4))
    tw = torch.from_numpy(w)
    np.testing.assert_allclose(
        tprob.global_loss(tw).numpy(),
        np.asarray(jax.vmap(jprob.global_loss)(jnp.asarray(w))), rtol=1e-5)
    np.testing.assert_allclose(
        tprob.full_grad(tw).numpy(),
        np.asarray(jax.vmap(jprob.full_grad)(jnp.asarray(w))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        tprob.worker_grad(tw, torch.from_numpy(idx)).numpy(),
        np.asarray(jax.vmap(jprob.worker_grad)(jnp.asarray(w),
                                               jnp.asarray(idx))),
        rtol=1e-5, atol=1e-6)
    assert tprob.smoothness() == pytest.approx(jprob.smoothness(), rel=1e-5)
    np.testing.assert_allclose(tprob.solve_opt(300).numpy(),
                               np.asarray(jprob.solve_opt(300)), rtol=1e-4,
                               atol=1e-5)
    for v in ("sgd", "artemis"):
        assert tfed.gamma_max(tprob, tart.variant_config(v, 6, 5)) == \
            pytest.approx(jfed.gamma_max(jprob, jart.variant_config(v, 6, 5)),
                          rel=1e-5)


def test_convert_carries_state_and_vectors():
    rng = np.random.default_rng(0)
    h, e = rng.standard_normal((2, 4, 3)).astype(np.float32)
    hbar = rng.standard_normal(3).astype(np.float32)
    st = convert.state(h, hbar, e, np.int32(5), device="cpu")
    assert np.array_equal(st.h.numpy(), h) and np.array_equal(st.e.numpy(), e)
    assert np.array_equal(st.hbar.numpy(), hbar) and int(st.step) == 5
    assert np.array_equal(convert.vector(hbar, device="cpu").numpy(), hbar)


def test_run_is_one_cell_sweep(tprob):
    cfg = tart.variant_config("artemis", D, N, p=0.7)
    r = tfed.run(tprob, cfg, gamma=0.02, iters=20, seed=3, batch=4)
    res = tsw.run_sweep(tprob, [cfg], [0.02], [3], 20, batch=4, device="cpu")
    assert np.array_equal(r.losses, res.losses[0, 0, 0])
    assert np.array_equal(r.bits, res.bits[0, 0, 0])


def test_default_noise_is_per_seed_and_replayable():
    a = tnoise.TorchNoise([3, 5], 4, 6, 2, 10, "cpu")
    b = tnoise.TorchNoise([5], 4, 6, 2, 10, "cpu")
    late = a.round(70)                      # a second chunk
    early = a.round(1)
    assert torch.equal(early.u_up[1], b.round(1).u_up[0])
    assert torch.equal(late.u_dwn, a.round(70).u_dwn)
    assert early.idx.shape == (2, 4, 2) and int(early.idx.max()) < 10
    assert tnoise.TorchNoise([0], 4, 6, None, 10, "cpu").round(0).idx is None


def test_grid_cells_share_their_seed_draws(tprob):
    """Cells that differ only in gamma see the same draws: at gamma 0 the
    metered bits of a seed match across the gamma axis."""
    cfg = tart.variant_config("qsgd", D, N, p=0.5)
    res = tsw.run_sweep(tprob, [cfg], [0.01, 0.03], [0, 1], 10, batch=2,
                        device="cpu")
    assert np.array_equal(res.bits[0, 0], res.bits[0, 1])
    assert not np.array_equal(res.bits[0, 0, 0], res.bits[0, 0, 1])


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tprob):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tart.variant_config("artemis", D, N)
    for call in (lambda: default_device(),
                 lambda: tart.init_state(cfg),
                 lambda: tfed.make_lsr_problem(0, n_workers=2, n_per=4, d=3),
                 lambda: convert.vector(np.zeros(3)),
                 lambda: tsw.run_sweep(tprob, [cfg], [0.1], [0], 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert default_device("cpu") == torch.device("cpu")


def test_sweep_rejects_unported_options(tprob):
    cfg = tart.variant_config("artemis", D, N)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        tsw.run_sweep(tprob, [cfg], [0.1], [0], 2, device="cpu",
                      telemetry=True)
    # as in the reference: telemetry cannot ride a checkpointed sweep
    with pytest.raises(ValueError, match="telemetry"):
        tsw.run_sweep(tprob, [cfg], [0.1], [0], 2, device="cpu",
                      telemetry=True, checkpoint_dir="ckpt")
    with pytest.raises(ValueError):
        tsw.run_sweep(tprob, [cfg], [0.1], [0], 5, eval_every=2,
                      device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)
