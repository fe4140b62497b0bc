"""One Artemis round of the port against ``repro.core.artemis.artemis_round``.

Both get the same gradients, state, participation mask and uniforms: the
test draws the reference's round uniforms from its key (``fold_in(key,
step)``, split into the uplink and downlink keys) and hands them to the
port.  The port's dense path is held against the reference's dense path and
its ``cuda`` path (on the CPU: the kernels' plain versions) against the
reference's ``pallas`` path, every variant under PP1 and PP2, with full and
partial participation.  The dense path bit for bit: its worker sums add in
worker order (``worker_sum``), its mean multiplies by float32(1 / N), and
its norms repeat the reference's order on the CPU (``core/codec.py``).  The
fused path to rtol 1e-5 with an atol of 1e-6 for entries that cancel to
near 0 (the reference's own bar between its dense and Pallas paths,
DESIGN.md §9); the bit meters exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artemis as jart
from repro_torch.core import artemis as tart
from repro_torch.core import faults as tfaults

N, D = 6, 10
KEY = jax.random.PRNGKey(3)
VARIANTS = ["sgd", "qsgd", "diana", "biqsgd", "artemis", "sgd-mem", "dore"]
BACKENDS = [("dense", "dense"), ("pallas", "cuda")]


def round_uniforms(key, step, n, d):
    """The uniforms the reference's round draws from ``key`` at ``step``."""
    up_key, dwn_key = jax.random.split(jax.random.fold_in(key, step))
    u_up = jax.vmap(lambda k: jax.random.uniform(k, (d,)))(
        jax.random.split(up_key, n))
    return np.asarray(u_up), np.asarray(jax.random.uniform(dwn_key, (d,)))


def _case(p, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    grads, h, hbar, e = f(N, D), f(N, D), f(D), f(N, D)
    active = ((rng.random(N) < p).astype(np.float32) if p < 1
              else np.ones(N, np.float32))
    return grads, (h, hbar, e), active


def _close(out, ref, bitwise=False):
    if bitwise:
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    else:
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pp_mode", ["pp1", "pp2"])
@pytest.mark.parametrize("jax_backend,port_backend", BACKENDS)
@pytest.mark.parametrize("p", [1.0, 0.5])
def test_round_matches_reference(variant, pp_mode, jax_backend, port_backend,
                                 p):
    grads, (h, hbar, e), active = _case(p, seed=VARIANTS.index(variant))
    step = 2
    jcfg = jart.variant_config(variant, D, N, p=p, pp_mode=pp_mode)
    jst = jart.ArtemisState(jnp.asarray(h), jnp.asarray(hbar), jnp.asarray(e),
                            jnp.int32(step))
    om, nst, stats = jart.artemis_round(jcfg, jst, jnp.asarray(grads), KEY,
                                        jnp.asarray(active),
                                        backend=jax_backend)
    u_up, u_dwn = round_uniforms(KEY, step, N, D)
    tcfg = tart.variant_config(variant, D, N, p=p, pp_mode=pp_mode)
    tst = tart.ArtemisState(*(torch.tensor(x) for x in (h, hbar, e)),
                            step=torch.tensor(step, dtype=torch.int32))
    tom, tnst, tstats = tart.artemis_round(
        tcfg, tst, torch.tensor(grads), torch.tensor(u_up),
        torch.tensor(u_dwn), torch.tensor(active), backend=port_backend)
    bitwise = port_backend == "dense"
    _close(tom, om, bitwise)
    for f in ("h", "hbar", "e"):
        _close(getattr(tnst, f), getattr(nst, f), bitwise)
    assert int(tnst.step) == int(nst.step)
    for k in ("uplink_bits", "dwnlink_bits", "wire_scrubbed"):
        assert float(tstats[k]) == float(stats[k]), k
    for k in ("compress_err_up", "compress_err_dwn", "ghat_norm"):
        _close(tstats[k], stats[k], bitwise)


@pytest.mark.parametrize("variant", ["artemis", "dore", "sgd"])
@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_batched_cells_match_one_cell_rounds(variant, backend):
    """Cells on the leading axis give what each cell gives alone: the fused
    path's [cells x workers] rows and its strided ring sum keep cells
    apart."""
    cells = 3
    cfg = tart.variant_config(variant, D, N, p=0.5, pp_mode="pp1")
    gen = torch.Generator().manual_seed(0)
    grads = torch.randn(cells, N, D, generator=gen)
    u_up = torch.rand(cells, N, D, generator=gen)
    u_dwn = torch.rand(cells, D, generator=gen)
    active = (torch.rand(cells, N, generator=gen) < 0.5).float()
    st = tart.init_state(cfg, (cells,), device="cpu")
    st = dataclasses.replace(st, h=torch.randn(cells, N, D, generator=gen),
                             e=torch.randn(cells, N, D, generator=gen))
    om, nst, stats = tart.artemis_round(cfg, st, grads, u_up, u_dwn, active,
                                        backend=backend)
    for c in range(cells):
        one = tart.ArtemisState(st.h[c], st.hbar[c], st.e[c], st.step[c])
        om1, nst1, stats1 = tart.artemis_round(
            cfg, one, grads[c], u_up[c], u_dwn[c], active[c],
            backend=backend)
        torch.testing.assert_close(om[c], om1, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(nst.h[c], nst1.h, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(nst.hbar[c], nst1.hbar, rtol=1e-6,
                                   atol=1e-7)
        assert float(stats["uplink_bits"][c]) == float(stats1["uplink_bits"])


def test_init_state_shapes_and_device():
    cfg = tart.variant_config("artemis", D, N)
    st = tart.init_state(cfg, (4, 2), device="cpu")
    assert st.h.shape == (4, 2, N, D) and st.hbar.shape == (4, 2, D)
    assert st.e.shape == (4, 2, N, D) and st.step.dtype == torch.int32
    assert all(float(x.abs().sum()) == 0 for x in (st.h, st.hbar, st.e))


def test_resolved_alpha_matches_reference():
    for v in VARIANTS:
        assert (tart.variant_config(v, D, N).resolved_alpha()
                == jart.variant_config(v, D, N).resolved_alpha()), v


def test_unported_parts_raise():
    """Nothing of the round is left unported: a faulted config runs (the
    faults' own tests are tests/test_torch_faults.py); a backend the port
    does not have raises."""
    cfg = dataclasses.replace(tart.variant_config("artemis", D, N),
                              faults=tfaults.FaultConfig(scrub=True))
    st = tart.init_state(cfg, device="cpu")
    z = torch.zeros(N, D)
    _, _, stats = tart.artemis_round(cfg, st, z, z, torch.zeros(D))
    assert float(stats["wire_scrubbed"]) == 0.0
    with pytest.raises(ValueError):
        tart.artemis_round(tart.variant_config("artemis", D, N), st, z, z,
                           torch.zeros(D), backend="pallas")
