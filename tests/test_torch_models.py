"""The port's LM stack (``repro_torch.models``, ``configs``) against the JAX
package's, on the CPU.

Inputs are drawn from numpy seeds; the reference's own ``init`` makes the
parameters, which ``convert.lm_params`` carries across, so both packages run
the same model on the same tokens.  Each reference is built once per module
(``reference``) and serves every test of its architecture.

Tolerances, at f32 compute (``compute_dtype="float32"``):
  * losses (and nll, aux) to rtol 1e-5 (measured: at most 1.5e-7);
  * gradients per leaf to atol 2e-5 x the leaf's largest |entry| (measured:
    at most 3.7e-6 x);
  * prefill and decode logits to atol 2e-5 (the logits are ~0.3 in
    scale; measured: at most 2.0e-6);
  * the layer functions to rtol 1e-5, atol 1e-6 (the scans 1e-5, 1e-5: the
    reference's associative scan combines in another tree order).
At the default bf16 compute, where XLA's CPU matmuls and fused elementwise
ops round otherwise than torch's (XLA keeps f32 inside a fusion), and no
bit of rounding order is shared:
  * losses to rtol 2e-3 (measured: at most 4.5e-4, mixtral);
  * gradients per leaf to a relative L2 error of 0.08 (measured: at most
    0.037);
  * prefill and decode logits to atol 0.06 (measured: at most 0.023).
The MoE families at bf16 are held to the same bars on all but a few
tokens.  Their router init (scale 0.02) gives near-uniform probabilities,
and top-k routing flips wherever the two packages' bf16 inputs differ by a
rounding: a flipped token moves its whole contribution (one decode logit
measured 0.61 off).  Given the same bf16 input, one MoE layer agrees to
0.3 % in relative L2 error and routes every token alike
(``test_moe_layer_in_bf16_routes_as_the_reference``).  So for them: at most
one token in six with a logit beyond atol 0.06 (measured: 1 of 24 decode
rows), all within 1.0; gradients to a relative L2 error of 0.3 (measured
0.066-0.15).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import moe as jMOE
from repro.models import rglru as jRG
from repro.models import ssm as jSSM
from repro.models.model import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tL
from repro_torch.models import moe as tMOE
from repro_torch.models import rglru as tRG
from repro_torch.models import ssm as tSSM
from repro_torch.models.model import build_model, flatten_params

ARCHS = sorted(jconfigs.ARCHS)
DTYPES = ("float32", "bfloat16")
B, S, T = 2, 128, 12            # batch, train/prefill length, decode steps
MOE_ARCHS = {a for a in ARCHS
             if jconfigs.get_config(a, reduced=True).family == "moe"}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if hasattr(
        x, "dtype") and x.dtype == jnp.bfloat16 else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    s = S - cfg.n_patches if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _enc_out(cfg, seed=3):
    """The decode's stub encoder output [B, F, d], f32 (cast by the caller)."""
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _cfgs(arch, dtype):
    return tuple(dataclasses.replace(m.get_config(arch, reduced=True),
                                     compute_dtype=dtype)
                 for m in (jconfigs, tconfigs))


class Reference:
    """The reference's numbers per (arch, dtype), computed on first use."""

    def __init__(self):
        self._params, self._out = {}, {}

    def params(self, arch):
        """The reference's init, as numpy."""
        if arch not in self._params:
            cfg = jconfigs.get_config(arch, reduced=True)
            jp = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(0))
            self._params[arch] = jax.tree.map(np.asarray, jp)
        return self._params[arch]

    def __call__(self, arch, dtype):
        key = (arch, dtype)
        if key not in self._out:
            self._out[key] = self._compute(arch, dtype)
        return self._out[key]

    def _compute(self, arch, dtype):
        jcfg, _ = _cfgs(arch, dtype)
        m = jbuild(jcfg)
        jp = jax.tree.map(jnp.asarray, self.params(arch))
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
        (loss, met), grads = jax.jit(jax.value_and_grad(
            m.loss, has_aux=True))(jp, batch)
        prefill = jax.jit(m.prefill_logits)(jp, batch)
        enc = _enc_out(jcfg)
        enc = None if enc is None else jnp.asarray(enc).astype(jcfg.cdtype)
        step = jax.jit(lambda p, c, t, pos: m.decode_step(p, c, t, pos,
                                                          enc_out=enc))
        cache, logits = m.init_cache(B, T), []
        for i in range(T):
            lg, cache = step(jp, cache, batch["tokens"][:, i], jnp.int32(i))
            logits.append(np.asarray(lg))
        return {"loss": float(loss), "nll": float(met["nll"]),
                "aux": float(met["aux"]),
                "grads": {k: _np(v) for k, v in flatten_params(grads).items()},
                "prefill": np.asarray(prefill), "decode": np.stack(logits)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and each of torch's default pool (one thread a
    core) spins against the others' (this module took 20x its serial time
    that way).  The previous count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    return Reference()


def _port(arch, dtype, params_np):
    _, tcfg = _cfgs(arch, dtype)
    model = build_model(tcfg)
    params = convert.lm_params(params_np, device="cpu")
    return tcfg, model, params


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False])
def test_configs_are_the_references(reduced):
    """Every field the reference's ModelConfig has holds the reference's
    value; a field only the port has (an option off by default) holds its
    default in every configuration of the registry."""
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    from repro_torch.models.config import ModelConfig
    port_only = {f.name: f.default for f in dataclasses.fields(ModelConfig)
                 if f.name not in {g.name for g in dataclasses.fields(
                     jconfigs.get_config(ARCHS[0], reduced))}}
    assert port_only        # the port's options beside the reference's
    for arch in ARCHS:
        j = dataclasses.asdict(jconfigs.get_config(arch, reduced))
        t = dataclasses.asdict(tconfigs.get_config(arch, reduced))
        assert {k: t[k] for k in j} == j, arch
        assert set(t) == set(j) | set(port_only), arch
        assert {k: t[k] for k in port_only} == port_only, arch
        jc, tc = (m.get_config(arch, reduced) for m in (jconfigs, tconfigs))
        assert (jc.hd, jc.sub_quadratic, jc.layer_kinds()) == (
            tc.hd, tc.sub_quadratic, tc.layer_kinds())
        for shape in jconfigs.SHAPES.values():
            assert jconfigs.applicable(jc, shape) == tconfigs.applicable(
                tc, tconfigs.SHAPES[shape.name])
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("nope")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_references_leaves(arch, reference):
    """The same leaf paths in the same (flatten) order, shapes and dtypes;
    so the bucket layout equals the reference's."""
    ref = flatten_params(reference.params(arch))
    cfg = tconfigs.get_config(arch, reduced=True)
    mine = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert list(mine) == list(ref)
    for k, a in ref.items():
        assert tuple(mine[k].shape) == a.shape, k
        assert str(mine[k].dtype) == f"torch.{a.dtype}", k
        assert torch.isfinite(mine[k]).all(), k
    carried = convert.lm_params(reference.params(arch), device="cpu")
    assert list(carried) == list(ref)


# ---------------------------------------------------------------------------
# every family against the reference
# ---------------------------------------------------------------------------

def _torch_batch(cfg):
    return {k: _t(v) for k, v in _batch(cfg).items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype, reference):
    ref = reference(arch, dtype)
    cfg, model, params = _port(arch, dtype, reference.params(arch))
    grads, (loss, met) = torch.func.grad_and_value(model.loss, has_aux=True)(
        params, _torch_batch(cfg))
    rtol = 1e-5 if dtype == "float32" else 2e-3
    for name, val in (("loss", loss), ("nll", met["nll"]),
                      ("aux", met["aux"])):
        np.testing.assert_allclose(float(val), ref[name], rtol=rtol,
                                   atol=1e-7, err_msg=name)
    assert list(grads) == list(ref["grads"])
    for k, g in grads.items():
        g, r = g.float().numpy(), ref["grads"][k]
        assert np.isfinite(g).all(), k
        if dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=2e-5 * np.abs(r).max(),
                                       err_msg=k)
        else:
            bar = 0.3 if arch in MOE_ARCHS else 0.08
            err = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert err <= bar, (k, err)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, reference):
    ref = reference(arch, dtype)
    cfg, model, params = _port(arch, dtype, reference.params(arch))
    batch = _torch_batch(cfg)
    prefill = model.prefill_logits(params, batch)
    assert prefill.dtype == torch.float32
    enc = _enc_out(cfg)
    enc = None if enc is None else _t(enc).to(cfg.cdtype)
    cache = model.init_cache(B, T, device="cpu")
    decode = []
    for i in range(T):
        logits, cache = model.decode_step(params, cache,
                                          batch["tokens"][:, i], i,
                                          enc_out=enc)
        decode.append(logits.numpy())
    for name, out in (("prefill", prefill.numpy()),
                      ("decode", np.stack(decode))):
        err = np.abs(out - ref[name])
        if dtype == "float32":
            assert err.max() <= 2e-5, (name, err.max())
        elif arch in MOE_ARCHS:
            rows = (err > 6e-2).any(-1)         # a token's logits
            assert rows.mean() <= 1 / 6 and err.max() <= 1.0, (
                name, rows.sum(), rows.size, err.max())
        else:
            assert err.max() <= 6e-2, (name, err.max())


@pytest.mark.parametrize("arch", [a for a in ARCHS if jconfigs.get_config(
    a, reduced=True).family != "vlm"])
def test_decode_chain_matches_prefill(arch):
    """The port's decode steps against its own teacher-forced forward (the
    reference's ``test_decode_matches_prefill``), at f32 to atol 1e-4; the
    MoE archs at a dropless capacity, as the reference's test takes them
    (prefill and decode group their tokens differently)."""
    cfg = dataclasses.replace(tconfigs.get_config(arch, reduced=True),
                              compute_dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(cfg)
    toks = batch["tokens"][:, :16]
    enc = None
    if cfg.family == "encdec":
        enc = model._encode(params, batch["frames"])
    x, _, _ = model._forward(params, {**batch, "tokens": toks})
    full = (x @ params["unembed"]).numpy()
    cache = model.init_cache(B, 16, device="cpu")
    for i in range(16):
        logits, cache = model.decode_step(params, cache, toks[:, i], i,
                                          enc_out=enc)
        np.testing.assert_allclose(logits.numpy(), full[:, i], rtol=0,
                                   atol=1e-4, err_msg=f"step {i}")


def test_sliding_window_cache_wraps_as_the_reference():
    """mixtral at a window of 8: 12 decode steps wrap the ring buffer; the
    cache stays [B, 8, ...] and the logits follow the reference's (f32)."""
    jcfg, tcfg = (dataclasses.replace(c, window=8)
                  for c in _cfgs("mixtral-8x22b", "float32"))
    jm, model = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _batch(jcfg)["tokens"][:, :T]
    jcache, cache = jm.init_cache(B, 64), model.init_cache(B, 64,
                                                           device="cpu")
    assert tuple(cache["layers"]["k"].shape) == jcache["layers"]["k"].shape
    step = jax.jit(jm.decode_step)
    for i in range(T):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i]), jnp.int32(i))
        tl, cache = model.decode_step(params, cache, _t(toks[:, i]), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=2e-5, err_msg=f"step {i}")
    np.testing.assert_array_equal(cache["layers"]["pos"].numpy(),
                                  np.asarray(jcache["layers"]["pos"]))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    x, g = _rand(0, 2, 16, 4, 32), _rand(1, 32)
    pos = np.arange(16, dtype=np.int32)[None].repeat(2, 0) * 7
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        tL.rms_norm(tx, _t(g)).float().numpy(),
        _np(jL.rms_norm(jx, jnp.asarray(g))), **tol)
    np.testing.assert_allclose(
        tL.rope(tx, _t(pos), 500.0).float().numpy(),
        _np(jL.rope(jx, jnp.asarray(pos), 500.0)), **tol)


@pytest.mark.parametrize("window,q_chunk,causal", [
    (0, 16, True), (0, 64, True), (8, 16, True), (0, 16, False),
    (0, 24, True)])
def test_attention_matches_reference(window, q_chunk, causal):
    q, k, v = _rand(0, 2, 64, 4, 16), _rand(1, 2, 64, 2, 16), _rand(
        2, 2, 64, 2, 16)
    pos = np.arange(64, dtype=np.int32)[None].repeat(2, 0)
    kw = dict(window=window, q_chunk=q_chunk, causal=causal)
    out = tL.attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), **kw)
    ref = jL.attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_mlp_matches_reference(activation):
    x = _rand(0, 2, 8, 16)
    jp = jL.init_mlp(jax.random.PRNGKey(0), 16, 32, activation)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    np.testing.assert_allclose(
        tL.mlp_apply(tp, _t(x), activation).numpy(),
        np.asarray(jL.mlp_apply(jp, jnp.asarray(x), activation)),
        rtol=1e-5, atol=1e-6)


def test_gelu_and_softplus_are_jaxs():
    """jax.nn.gelu is the tanh form (torch's default is erf, ~1e-3 off);
    jax.nn.softplus is logaddexp(x, 0) (torch's returns x above 20)."""
    x = np.linspace(-30, 30, 2001).astype(np.float32)
    np.testing.assert_allclose(tL.gelu(_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tL.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("s,chunk", [(64, 64), (64, 16), (50, 16)])
def test_chunked_xent_matches_reference(s, chunk):
    x, w = _rand(0, 2, s, 16), _rand(1, 16, 40)
    labels = np.random.default_rng(2).integers(-1, 40, (2, s)).astype(
        np.int32)
    out = tL.chunked_xent(_t(x), _t(w), _t(labels), chunk=chunk)
    ref = jL.chunked_xent(jnp.asarray(x), jnp.asarray(w),
                          jnp.asarray(labels), chunk=chunk)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_cached_attention_matches_reference():
    """attn_apply on the ring-buffer cache (window 4, cache of 4 slots) for
    9 steps: the cache's slots and positions, and the outputs."""
    jp = jL.init_attn(jax.random.PRNGKey(0), 16, 4, 2, 8)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    kw = dict(n_heads=4, n_kv=2, head_dim=8, window=4, q_chunk=8,
              softmax_dtype=jnp.float32)
    jc = jL.init_attn_cache(2, 4, 2, 8, dtype=jnp.float32)
    tc = tL.init_attn_cache(2, 4, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(9):
        x = _rand(i, 2, 1, 16)
        pos = np.full((2, 1), i, np.int32)
        jy, jc = jL.attn_apply(jp, jnp.asarray(x), jnp.asarray(pos), cache=jc,
                               pos=jnp.int32(i), **kw)
        ty, tc = tL.attn_apply(tp, _t(x), _t(pos), cache=tc, pos=i,
                               **{**kw, "softmax_dtype": torch.float32})
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(activation, seed=0, d=8, f=12, e=4):
    jp = jMOE.init_moe(jax.random.PRNGKey(seed), d, f, e, activation)
    # a larger router spread, so routing is far from ties
    jp = {**jp, "router": jp["router"] * 50}
    return jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("activation,cf,shape,group", [
    ("silu", 1.25, (2, 16, 8), 4096),     # one group, some tokens dropped
    ("silu", 16.0, (2, 16, 8), 4096),     # dropless
    ("gelu", 1.0, (4, 16, 8), 16),        # a group per row
    ("relu2", 0.5, (2, 32, 8), 8)])       # heavy dropping
def test_moe_forward_and_grads_match_reference(activation, cf, shape, group):
    jp, tp = _moe_case(activation)
    x = _rand(1, *shape)
    kw = dict(top_k=2, capacity_factor=cf, activation=activation,
              group_size=group)

    def jloss(p, xx):
        out, aux = jMOE.moe_apply(p, xx, **kw)
        return jnp.sum(out * jnp.sin(xx)) + aux, (out, aux)

    def tloss(p, xx):
        out, aux = tMOE.moe_apply(p, xx, **kw)
        return torch.sum(out * torch.sin(xx)) + aux, (out, aux)

    (jg, jgx), (jout, jaux) = jax.jit(jax.grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    (tg, tgx), (tout, taux) = torch.func.grad(
        tloss, argnums=(0, 1), has_aux=True)(tp, _t(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_moe_layer_in_bf16_routes_as_the_reference(arch):
    """One MoE layer of the arch's reduced config, cast to bf16 as the
    model casts it, on the same bf16 input: the same top-k experts for
    every token, the output to 1 % in relative L2 error (measured: 0.3 %;
    the outputs reach ~1e3, where a bf16 ulp is 4-8)."""
    cfg = jconfigs.get_config(arch, reduced=True)
    jp = jax.tree.map(lambda a: a[0], jbuild(cfg).init(
        jax.random.PRNGKey(0))["layers"]["moe"])
    jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp = {k: _t(_np(v)).to(torch.bfloat16) for k, v in jp.items()}
    x = _rand(0, 2, 128, cfg.d_model)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), _t(x).to(torch.bfloat16)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              activation=cfg.activation, group_size=cfg.moe_group)
    jout, jaux = jMOE.moe_apply(jp, jx, **kw)
    tout, taux = tMOE.moe_apply(tp, tx, **kw)
    jidx = jax.lax.top_k(jax.nn.softmax(
        jx.astype(jnp.float32) @ jp["router"].astype(jnp.float32)),
        cfg.top_k)[1]
    tidx = torch.topk(torch.softmax(tx.float() @ tp["router"].float(), -1),
                      cfg.top_k)[1]
    np.testing.assert_array_equal(np.sort(tidx.numpy(), -1),
                                  np.sort(np.asarray(jidx), -1))
    jo, to = _np(jout), tout.float().numpy()
    assert np.linalg.norm(to - jo) / np.linalg.norm(jo) <= 1e-2
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_drops_tokens_beyond_capacity():
    """At capacity factor 0.5 some tokens reach fewer than top_k experts,
    and a token that reaches none passes only the residual (zero out)."""
    _, tp = _moe_case("silu")
    x = _t(_rand(1, 1, 32, 8))
    out, _ = tMOE.moe_apply(tp, x, top_k=2, capacity_factor=0.25)
    full, _ = tMOE.moe_apply(tp, x, top_k=2, capacity_factor=16.0)
    assert (out.abs().sum(-1) == 0).any()
    assert not torch.allclose(out, full)


def test_moe_vmaps_over_workers():
    """``torch.func.vmap`` of the MoE's gradient over a worker axis equals
    the per-worker loop."""
    _, tp = _moe_case("silu")
    xs = _t(_rand(1, 3, 2, 16, 8))

    def loss(p, xx):
        out, aux = tMOE.moe_apply(p, xx, top_k=2, capacity_factor=1.0)
        return torch.sum(out ** 2) + aux

    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
        tp, xs)
    for w in range(3):
        one = torch.func.grad(loss)(tp, xs[w])
        for k in tp:
            torch.testing.assert_close(batched[k][w], one[k], rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# SSM and RG-LRU
# ---------------------------------------------------------------------------

def test_linear_scan_matches_the_recurrence():
    a = np.random.default_rng(0).uniform(0.5, 1.0, (2, 37, 3)).astype(
        np.float32)
    b = _rand(1, 2, 37, 3)
    aa, hh = tSSM.linear_scan(_t(a), _t(b))
    h, prod = np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32)
    for t in range(37):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        np.testing.assert_allclose(hh[:, t].numpy(), h, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aa[:, t].numpy(), prod, rtol=1e-5)


def _recurrent(kind, seed=0, d=16):
    if kind == "mamba":
        jp = jSSM.init_mamba(jax.random.PRNGKey(seed), d, d_state=4)
        return jp, dict(d_state=4), jSSM.mamba_apply, tSSM.mamba_apply
    jp = jRG.init_rglru(jax.random.PRNGKey(seed), d, 24)
    return jp, {}, jRG.rglru_apply, tRG.rglru_apply


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32), (24, 16)])
def test_recurrent_block_matches_reference(kind, s, chunk):
    jp, kw, japply, tapply = _recurrent(kind)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    x = _rand(1, 2, s, 16)
    jy, _ = jax.jit(functools.partial(japply, chunk=chunk, **kw))(
        jp, jnp.asarray(x))
    ty, _ = tapply(tp, _t(x), chunk=chunk, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrent_chunked_equals_decode_chain(kind):
    """The chunked scan against the O(1) decode, step by step, in the port
    alone (the reference's own invariant), and the decode's state against
    the reference's decode."""
    jp, kw, japply, tapply = _recurrent(kind)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    x = _rand(2, 2, 24, 16)
    full, _ = tapply(tp, _t(x), chunk=8, **kw)
    if kind == "mamba":
        state = tSSM.init_mamba_state(2, 16, d_state=4, device="cpu")
        jstate = jSSM.init_mamba_state(2, 16, d_state=4)
    else:
        state = tRG.init_rglru_state(2, 24, device="cpu")
        jstate = jRG.init_rglru_state(2, 24)
    jstep = jax.jit(lambda p, xx, st: japply(p, xx, state=st, **kw))
    for t in range(24):
        y, state = tapply(tp, _t(x[:, t:t + 1]), state=state, **kw)
        jy, jstate = jstep(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        np.testing.assert_allclose(y.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)
    for k in state:
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   rtol=1e-5, atol=1e-6)
