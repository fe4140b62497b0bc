"""The port's options for a mixture-of-experts model whose layers mix
windowed and full attention, each off by default: a layer holding a share
of the experts (``models/moe.py``), YaRN's rotary frequencies
(``models/layers.py::rope``), the moe family's kinds from ``pattern``
(``ModelConfig.layer_kinds``), and the expert layer's phase and counts
(``obs/spans.py``).  On the CPU, in float32."""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.obs import spans

# the published Mellum2-12B-A2.5B full layers' YaRN: factor 16, original
# 8192, beta_fast 32, beta_slow 1, attention factor 0.1 ln 16 + 1
YARN = (16.0, 8192, 32.0, 1.0, 1.2772588722239782)
THETA = 500000.0
PERIOD = ("la+moe", "la+moe", "la+moe", "attn+moe")


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**kw) -> ModelConfig:
    base = dict(name="moe-window", family="moe", n_layers=4, d_model=32,
                n_heads=4, n_kv=2, head_dim=8, d_ff=16, vocab=64,
                n_experts=8, top_k=2, pattern=PERIOD, local_window=4,
                moe_group=8, compute_dtype="float32")
    base.update(kw)
    return ModelConfig(**base).validate()


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def _rope_without_yarn(x, positions, theta):
    """``rope`` as it stood before YaRN, line for line."""
    half = x.shape[-1] // 2
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    freq = torch.pow(float(torch.tensor(theta, dtype=torch.float32)), expo)
    ang = (positions[..., None].to(torch.float32) * freq)[..., None, :]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_without_yarn_is_bit_identical(dtype):
    x = torch.randn(2, 16, 4, 128, generator=torch.Generator().manual_seed(
        0)).to(dtype)
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    assert torch.equal(L.rope(x, pos, THETA), _rope_without_yarn(x, pos,
                                                                  THETA))
    assert torch.equal(L.rope(x, pos, THETA, None), L.rope(x, pos, THETA))


def test_yarn_ramp_is_the_published_models():
    # d = 128, L = 8192, theta = 5e5: 128 ln(8192 / (2 pi 32)) / (2 ln
    # 5e5) = 18.08 -> 18 and at beta_slow 34.98 -> 35
    assert L.yarn_ramp(64, THETA, YARN) == (18, 35)
    d = 128
    low = d * math.log(8192 / (2 * math.pi * 32)) / (2 * math.log(THETA))
    high = d * math.log(8192 / (2 * math.pi * 1)) / (2 * math.log(THETA))
    assert (math.floor(low), math.ceil(high)) == (18, 35)


def test_yarn_frequencies_and_scale_by_hand():
    """One position p, a unit vector at each frequency index i: ``rope``
    turns it by p f_i and scales it by the attention factor, with f_i the
    extrapolated theta^(-2i/d) above 35, interpolated (/ 16) below 18 and
    blended linearly between."""
    half, p = 64, 100
    x = torch.zeros(1, 1, half, 2 * half, dtype=torch.float64)
    for i in range(half):
        x[0, 0, i, i] = 1.0                   # the cos half, index i
    pos = torch.full((1, 1), p, dtype=torch.int32)
    out = L.rope(x.float(), pos, THETA, YARN)[0, 0].double()
    for i in range(half):
        f = THETA ** (-2.0 * i / (2 * half))
        ramp = min(max((i - 18) / (35 - 18), 0.0), 1.0)
        fi = f / 16.0 * ramp + f * (1.0 - ramp)
        want_cos = YARN[4] * math.cos(p * fi)
        want_sin = YARN[4] * math.sin(p * fi)
        # x1 = e_i: out's cos half reads cos, its sin half reads sin
        assert out[i, i] == pytest.approx(want_cos, abs=1e-4), i
        assert out[i, half + i] == pytest.approx(want_sin, abs=1e-4), i


def test_yarn_reaches_only_the_full_layers():
    cfg = _cfg(rope_yarn_factor=4.0, rope_yarn_original=16,
               rope_yarn_attn_factor=1.2)
    off = _cfg()
    g = torch.Generator().manual_seed(1)
    params = build_model(cfg).init(g)
    batch = {"tokens": torch.randint(0, 64, (2, 16), generator=g)}
    # the same weights with YaRN off: only the full layer's output differs
    outs = {}
    for name, c in (("yarn", cfg), ("off", off)):
        m = build_model(c)
        seen = []
        orig = L.attn_apply

        def spy(*a, **kw):
            y, cache = orig(*a, **kw)
            seen.append((kw["window"], kw["rope_yarn"]))
            return y, cache
        L.attn_apply = spy
        try:
            outs[name] = m.loss(params, batch)[0]
        finally:
            L.attn_apply = orig
        if name == "yarn":
            assert seen == [(4, None)] * 3 + [(0, cfg.rope_yarn)]
    assert not torch.equal(outs["yarn"], outs["off"])
    assert _cfg().rope_yarn is None


# ---------------------------------------------------------------------------
# the kinds of a pattern
# ---------------------------------------------------------------------------

def test_layer_kinds_of_the_pattern():
    assert _cfg().layer_kinds() == PERIOD
    assert _cfg(n_layers=8).layer_kinds() == PERIOD * 2
    assert _cfg(pattern=()).layer_kinds() == ("attn+moe",) * 4
    model = build_model(_cfg())
    assert not model.uniform and model.n_groups == 1 and not model.tail_kinds
    with pytest.raises(AssertionError):
        _cfg(pattern=("la", "attn+moe"))


# ---------------------------------------------------------------------------
# a share of the experts
# ---------------------------------------------------------------------------

def _layer(e=64, d=32, ff=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return MOE.init_moe(g, d, ff, e, "silu"), g


def _share(p, offset, held):
    return {k: v if k == "router" else v[offset:offset + held]
            for k, v in p.items()}


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_the_eight_shares_add_up_to_the_whole_layer(capacity_factor):
    """Experts 0-7, 8-15, ..., 56-63 of a 64-expert top-8 layer: the shares'
    outputs add up to the uncut layer's, each share's aux loss (from the
    router's full probabilities) is the whole layer's, counted once."""
    p, g = _layer()
    x = torch.randn(2, 64, 32, generator=g)
    kw = dict(top_k=8, capacity_factor=capacity_factor, group_size=32)
    whole, aux = MOE.moe_apply(p, x, **kw)
    parts = [MOE.moe_apply(_share(p, off, 8), x, offset=off, **kw)
             for off in range(0, 64, 8)]
    total = sum(o for o, _ in parts)
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-6)
    for _, a in parts:
        assert torch.equal(a, aux)


def test_a_share_routes_and_drops_as_the_whole_layer():
    """The capacity is the whole layer's (from the router's 64 outputs),
    and the assignments a share keeps are those the whole layer keeps on
    its experts: a share's output equals the whole layer's with every
    other expert's weights zero."""
    p, g = _layer()
    x = torch.randn(1, 32, 32, generator=g)
    kw = dict(top_k=8, capacity_factor=0.5, group_size=32)
    off = 16
    zeroed = dict(p, w_down=p["w_down"].clone())
    zeroed["w_down"][:off] = 0
    zeroed["w_down"][off + 8:] = 0
    want, _ = MOE.moe_apply(zeroed, x, **kw)
    got, _ = MOE.moe_apply(_share(p, off, 8), x, offset=off, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("held,offset", [(64, 0), (8, 16)])
def test_no_two_writes_meet_in_a_slot_or_a_row(held, offset):
    """The whole layer and a share take one dispatch: every assignment
    has a slot of its own (kept ones below ``held * capacity``, the others
    past it), and the empty slots' rows spread over the group, so no token
    row takes more slots than its k assignments and one in t of the
    slots."""
    p, g = _layer()
    x = torch.randn(2, 32, 32, generator=g)
    t, k, cap = 32, 8, 2
    logits = x @ p["router"]
    idx = torch.topk(torch.softmax(logits, -1), k, -1)[1].reshape(2, t * k)
    local = idx - offset
    mine = (local >= 0) & (local < held)
    slot = MOE._slots(local, mine, held=held, capacity=cap)
    n_slots = held * cap
    for row in slot:
        assert row.unique().numel() == t * k
    kept = slot < n_slots
    assert torch.equal(kept, mine & (slot < n_slots))
    tok = MOE._tokens(slot, n_slots=n_slots, t=t, top_k=k)
    for r in range(2):
        load = torch.bincount(tok[r], minlength=t)
        assert int(load.max()) <= k + -(-n_slots // t)


def test_a_share_runs_under_vmap_and_grad():
    p, g = _layer(e=16)
    share = _share(p, 4, 4)
    x = torch.randn(3, 1, 16, 32, generator=g)

    def loss(q, xx):
        out, aux = MOE.moe_apply(q, xx, top_k=4, group_size=16, offset=4)
        return out.square().mean() + 0.01 * aux

    grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(share,
                                                                      x)
    for i in range(3):
        one = torch.func.grad(loss)(share, x[i])
        for k in share:
            torch.testing.assert_close(grads[k][i], one[k], rtol=1e-5,
                                       atol=1e-7)


def test_held_experts_in_the_model():
    cfg = _cfg(experts_held=2, expert_offset=2)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert tuple(params["groups/0/moe/router"].shape) == (1, 32, 8)
    assert tuple(params["groups/0/moe/w_up"].shape) == (1, 2, 32, 16)
    with pytest.raises(AssertionError):
        _cfg(experts_held=4, expert_offset=6)


# ---------------------------------------------------------------------------
# phases and counts
# ---------------------------------------------------------------------------

def test_the_expert_layer_phase_and_its_counts():
    """Under a capture: each expert layer a ``grads/moe`` record a pass
    (forward, remat's recompute, backward), the forward's counting the
    assignments to its experts and those dropped; each attention's record
    its window, its backward's too."""
    cfg = _cfg(experts_held=4, remat=True, capacity_factor=1.0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    tok = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                        .manual_seed(3))
    grad = torch.func.vmap(torch.func.grad_and_value(model.loss,
                                                     has_aux=True),
                           in_dims=(None, 0))
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        grad(params, {"tokens": tok.reshape(2, 1, 16)})
    recs = spans.phases()
    moe = [r for r in recs if r.name == "grads/moe"]
    assert [r.pass_ for r in moe] == ["forward"] * 4 + ["recompute"] * 4 \
        + ["backward"] * 4
    fwd = moe[:4]
    # 2 workers x 16 tokens x top-2 over 8 experts, 4 of them held: the
    # assignments to held experts, counted on the routing itself
    for r in fwd:
        routed, dropped = (int(r.counts[k]) for k in ("moe_routed",
                                                      "moe_dropped"))
        assert 0 < routed <= 2 * 16 * 2 and 0 <= dropped <= routed
    assert [int(r.counts["moe_routed"]) for r in fwd] == \
        [int(r.counts["moe_routed"]) for r in moe[4:8]]
    attn = [r for r in recs if r.name == "grads/attention"]
    assert [r.counts["window"] for r in attn if r.pass_ == "forward"] == \
        [4, 4, 4, 0]
    assert sorted(r.counts["window"] for r in attn
                  if r.pass_ == "backward") == [0, 4, 4, 4]
    assert all("attn_fused" not in r.counts for r in attn
               if r.pass_ == "backward")
    assert not any(r.name == "grads/mlp" for r in recs)
    spans.reset()
