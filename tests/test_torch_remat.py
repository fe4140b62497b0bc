"""Rematerialisation (``repro_torch.models.remat``, ``cfg.remat``) on the
CPU.

For one reduced config of each family (dense, moe, ssm, hybrid, enc-dec,
vlm) and each supported ``remat_policy``, the loss and every gradient with
remat equal those without it bit for bit, under ``grad_and_value`` and
under the simulated workers' ``vmap_grads``: the recompute repeats the same
eager ops on the same inputs, and the dots policies hand back the very
products the forward computed.  The port with ``remat=True`` matches the
JAX package's ``remat=True`` at f32 compute to ``test_torch_models.py``'s
bars (losses to rtol 1e-5, gradients per leaf to atol 2e-5 x the leaf's
largest |entry|).  An unsupported policy name raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models.model import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import dist
from repro_torch.models import remat
from repro_torch.models.model import build_model, flatten_params

FAMILIES = {"dense": "starcoder2-7b", "moe": "olmoe-1b-7b",
            "ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b",
            "encdec": "whisper-tiny", "vlm": "llava-next-mistral-7b"}
POLICIES = [None, "nothing_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims"]
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    s = S - cfg.n_patches if cfg.family == "vlm" else S
    out = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _with(cfg, policy):
    return dataclasses.replace(cfg, remat=True, remat_policy=policy)


@pytest.fixture(scope="module")
def no_remat():
    """``no_remat(family)``: the config, parameters, and loss and gradients
    without remat both ways, computed once per family."""
    done = {}

    def get(family):
        if family not in done:
            cfg = tconfigs.get_config(FAMILIES[family], reduced=True)
            assert not cfg.remat
            params = build_model(cfg).init(torch.Generator().manual_seed(0))
            done[family] = (cfg, params, _run(build_model(cfg), params,
                                              _torch(_batch(cfg))))
        return done[family]
    return get


def _run(model, params, batch):
    g, (loss, met) = torch.func.grad_and_value(model.loss, has_aux=True)(
        params, batch)
    vg, (vloss, vmet) = dist.vmap_grads(model)(params, dist._split(batch, 2))
    return {"grads": g, "loss": loss, "metrics": met, "vgrads": vg,
            "vloss": vloss, "vmetrics": vmet}


def _same(a, b):
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_changes_no_bit(family, policy, no_remat):
    cfg, params, ref = no_remat(family)
    got = _run(build_model(_with(cfg, policy)), params, _torch(_batch(cfg)))
    for k in ref:
        assert _same(got[k], ref[k]), k


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched while entered."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in remat._DOTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", ["dense", "hybrid", "encdec"])
def test_policies_recompute_what_they_do_not_keep(family, no_remat):
    """Full remat runs every layer's products twice; the dots policies run
    them once (their outputs come back from the forward); without batch
    dims, the batched products run twice."""
    cfg, params, _ = no_remat(family)
    batch = _torch(_batch(cfg))
    counts = {}
    for policy in ("off", None, "dots_saveable",
                   "dots_with_no_batch_dims_saveable"):
        c = cfg if policy == "off" else _with(cfg, policy)
        with _Products() as n:
            torch.func.grad_and_value(build_model(c).loss, has_aux=True)(
                params, batch)
        counts[policy] = n.n
    assert counts[None] > counts["off"], counts
    assert counts["dots_saveable"] == counts["off"], counts
    assert counts["off"] <= counts["dots_with_no_batch_dims_saveable"] \
        < counts[None], counts


def test_prefill_and_decode_run_as_they_are():
    """With a cache or without a gradient, no layer is wrapped: the same
    logits, and no backward state kept."""
    cfg = tconfigs.get_config("starcoder2-7b", reduced=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = _torch(_batch(cfg))
    on = build_model(_with(cfg, None))
    with torch.inference_mode():
        assert torch.equal(on.prefill_logits(params, batch),
                           build_model(cfg).prefill_logits(params, batch))
        cache = on.init_cache(B, 4, device="cpu")
        logits, _ = on.decode_step(params, cache, batch["tokens"][:, 0], 0)
        assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", ["save_only_these_names", "offload_dot",
                                  "nope"])
def test_unsupported_policies_raise(name):
    cfg = tconfigs.get_config("starcoder2-7b", reduced=True)
    with pytest.raises(ValueError, match="supported: None, "
                                         "'nothing_saveable'"):
        build_model(_with(cfg, name))
    # without remat the policy is never read, as in the reference
    build_model(dataclasses.replace(cfg, remat_policy=name))


def test_everything_saveable_is_no_remat():
    assert remat.saved_products("everything_saveable") is None
    assert remat.saved_products(None) == frozenset()
    cfg = tconfigs.get_config("starcoder2-7b", reduced=True)
    assert build_model(_with(cfg, "everything_saveable")).remat_keeps is None


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_matches_the_references_remat(family):
    arch = FAMILIES[family]
    jcfg, tcfg = (dataclasses.replace(m.get_config(arch, reduced=True),
                                      remat=True, compute_dtype="float32")
                  for m in (jconfigs, tconfigs))
    jm = jbuild(jcfg)
    jp = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    batch = _batch(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jax.numpy.asarray, jp),
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    params = convert.lm_params(jp, device="cpu")
    grads, (loss, _) = torch.func.grad_and_value(
        build_model(tcfg).loss, has_aux=True)(params, _torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-7)
    ref = {k: np.asarray(v) for k, v in flatten_params(jgrads).items()}
    assert list(grads) == list(ref)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=0,
                                   atol=2e-5 * np.abs(ref[k]).max(),
                                   err_msg=k)
