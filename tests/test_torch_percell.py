"""The port's ``federated.run_percell`` against the JAX package's.

The reference's per-round draws (``fold_in(key, k)``, split 3,
``randint``, ``uniform``, the round keys of ``artemis_round``) are replayed
with ``tests/test_torch_sweep.py::JaxReplayNoise``: its draws are
``run_percell``'s as they are ``run_sweep``'s.  Tolerances: losses and
distances to rtol 1e-4, atol 1e-6 (the reference's cross-grid tolerance);
metered bits exactly.  Against the port's own ``run``, the reference's
bars for its own pair (``tests/test_sweep.py:63-70``): losses rtol 1e-4,
atol 1e-6, bits rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artemis as jart
from repro.core import federated as jfed
from repro_torch import convert
from repro_torch.core import artemis as tart
from repro_torch.core import faults as tfaults
from repro_torch.core import federated as tfed
from test_torch_sweep import JaxReplayNoise

N, D = 8, 16


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


CASES = [("sgd", 1.0, "dense"), ("qsgd", 0.7, "dense"),
         ("artemis", 0.7, "dense"), ("artemis", 0.5, "cuda"),
         ("diana", 1.0, "cuda"), ("dore", 0.8, "dense")]


@pytest.mark.parametrize("variant,p,backend", CASES)
def test_percell_matches_reference(jprob, tprob, w_star, variant, p,
                                   backend):
    iters, batch, seed, gamma = 30, 4, 5, 0.02
    jcfg = jart.variant_config(variant, D, N, p=p)
    ref = jfed.run_percell(jprob, jcfg, gamma, iters, jax.random.PRNGKey(seed),
                           batch=batch, w_star=jnp.asarray(w_star))
    noise = JaxReplayNoise([seed], iters, N, D, batch, tprob.X.shape[1])
    out = tfed.run_percell(
        tprob, tart.variant_config(variant, D, N, p=p), gamma, iters, seed,
        batch=batch, w_star=convert.vector(w_star, device="cpu"),
        backend=backend, noise=noise)
    assert out.losses.shape == ref.losses.shape == (iters,)
    assert np.array_equal(out.bits, ref.bits)
    for f in ("losses", "dist_to_opt", "w_final", "w_avg", "w_tail_avg"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)


def test_full_batch_logistic_pp1_decay_matches_reference():
    """Full gradients of the logistic loss, PP1 at p = 0.5, decaying step."""
    jprob = jfed.make_logistic_problem(jax.random.PRNGKey(3), n_workers=6,
                                       n_per=40, d=2)
    tprob = convert.problem(np.asarray(jprob.X), np.asarray(jprob.Y),
                            jprob.kind, jprob.reg, device="cpu")
    jc = jart.variant_config("artemis", 2, 6, p=0.5, pp_mode="pp1")
    ref = jfed.run_percell(jprob, jc, 0.5, 25, jax.random.PRNGKey(7),
                           full_batch=True, gamma_decay=True)
    tc = tart.variant_config("artemis", 2, 6, p=0.5, pp_mode="pp1")
    out = tfed.run_percell(tprob, tc, 0.5, 25, 7, full_batch=True,
                           gamma_decay=True,
                           noise=JaxReplayNoise([7], 25, 6, 2, 1, 40))
    assert np.array_equal(out.bits, ref.bits)
    assert out.dist_to_opt is None and ref.dist_to_opt is None
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4, atol=1e-6)


def test_percell_matches_run(tprob):
    """The reference's own pair (tests/test_sweep.py:63-70) on the port:
    the legacy loop against the sweep engine's one-cell ``run``, the same
    default draws, partial participation engaged."""
    cfg = tart.variant_config("qsgd", D, N, p=0.4)
    r_old = tfed.run_percell(tprob, cfg, gamma=0.02, iters=50, seed=3,
                             batch=4)
    r_new = tfed.run(tprob, cfg, gamma=0.02, iters=50, seed=3, batch=4)
    np.testing.assert_allclose(r_new.losses, r_old.losses, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(r_new.bits, r_old.bits, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 30, 200, 257, 1000])
def test_block_cumsum_is_the_reference_order(n):
    x = (np.random.default_rng(n).standard_normal(n) * 1e3).astype(
        np.float32)
    assert np.array_equal(tfed.block_cumsum(torch.from_numpy(x)).numpy(),
                          np.asarray(jnp.cumsum(jnp.asarray(x))))


def test_percell_rules(tprob, monkeypatch):
    cfg = tart.variant_config("artemis", D, N)
    faulted = tart.variant_config("artemis", D, N)
    faulted = type(faulted)(**{**faulted.__dict__,
                               "faults": tfaults.FaultConfig(scrub=True)})
    with pytest.raises(ValueError, match="faults"):
        tfed.run_percell(tprob, faulted, 0.02, 4, 0)
    res = tfed.run_percell(tprob, cfg, 0.02, 4, 0, batch=2)
    assert res.losses.shape == res.bits.shape == (4,)
    assert np.all(np.diff(res.bits) > 0)
    # the problem's device is the run's: a CPU problem never asks for CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tfed.run_percell(tprob, cfg, 0.02, 2, 0).w_final.shape == (D,)
