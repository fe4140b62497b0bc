"""The unified model: init / train loss / prefill / decode for every family
(port of ``repro/models/model.py``).

The parameters are a flat dict from the reference's leaf paths to tensors
(``"embed"``, ``"layers/attn/wq"``, ``"groups/0/rg/in_x"``, ``"tail/0/..."``)
in ``jax.tree.flatten`` order (dict keys sorted, tuples and lists by
index), with each layer stack kept as the reference's stacked ``[L, ...]``
leaf.  That is ``ToyMLP``'s contract: ``loss(params, batch)`` takes the
dict, so ``torch.func`` differentiates it, and ``core/dist.py`` lays it out
in the reference's buckets.  ``Model`` is therefore a plain class over that
dict, as the reference's is, not an ``nn.Module`` holding a second copy.

The layers run in a Python loop over the stack (the reference's
``lax.scan``); each layer's slice is cast to ``compute_dtype`` inside the
loop, as the reference's ``_cast`` does per scan step, and never a whole
stack.  Decode updates the cache in place.

With ``cfg.remat`` (the reference's ``jax.checkpoint``) a train step
rematerialises what the reference's does: each layer of a uniform stack,
each whole pattern group (not the tail layers), each encoder layer,
through ``models/remat.py`` under ``cfg.remat_policy``.  The enc-dec
family's cross K/V are computed outside the wrapped layer and passed in,
as the reference passes them precomputed.  Prefill and decode (a cache,
or no gradient wanted) run the layers as they are.

While a profiler runs, attention (self and cross, with its input norm),
the MLP (with its norm) and the head (the final norm and the chunked
cross-entropy) are the phases ``grads/attention``, ``grads/mlp`` and
``grads/head`` (``obs/spans.py``), their backward included.  Each
attention's record counts ``attn_fused``: 1 where the call went through the
fused kernel (``layers.attention`` counts it), 0 where it ran the eager
ops.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import default_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import remat as RM
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.obs import spans

Params = Dict[str, torch.Tensor]


def flatten_params(tree: Any, prefix: str = "",
                   name=str) -> Dict[str, Any]:
    """A nested dict / list / tuple / dataclass tree as ``{path: leaf}`` in
    ``jax.tree.flatten`` order (dict keys sorted, sequences by index, a
    dataclass's fields as declared); ``name`` maps each key to its part of
    the ``/``-joined path."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_params(
            v, f"{prefix}/{name(k)}" if prefix else name(k), name))
    return out


def sub(p: Params, name: str) -> Params:
    """The entries of ``p`` under ``name/``, with that prefix dropped."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def _index(p: Params, i: int) -> Params:
    """Layer ``i`` of a stack (views: writes reach the stack)."""
    return {k: v[i] for k, v in p.items()}


def _cast(p: Params, dtype) -> Params:
    return {k: v.to(dtype) if v.dtype in (torch.float32, torch.bfloat16)
            else v for k, v in p.items()}


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, kind: str, gen, cross: bool = False,
                lead=()) -> Dict[str, Any]:
    d, dt, dev = cfg.d_model, cfg.pdtype, gen.device
    lead = tuple(lead)

    def zeros():
        return torch.zeros(lead + (d,), device=dev)

    p: Dict[str, Any] = {"ln1": zeros()}
    if kind in ("attn+mlp", "attn+moe", "la"):
        p["attn"] = L.init_attn(gen, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                dtype=dt, lead=lead)
    if kind == "mamba":
        p["mamba"] = SSM.init_mamba(gen, d, cfg.ssm_state, cfg.ssm_conv,
                                    cfg.ssm_expand, dtype=dt, lead=lead)
        return p
    if kind == "rg":
        p["rg"] = RG.init_rglru(gen, d, cfg.lru_width, dtype=dt, lead=lead)
    p["ln2"] = zeros()
    if kind == "attn+moe":
        p["moe"] = MOE.init_moe(gen, d, cfg.d_ff, cfg.n_experts,
                                cfg.activation, dtype=dt, lead=lead)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype=dt,
                              lead=lead)
    if cross:
        p["lnx"] = zeros()
        p["xattn"] = L.init_attn(gen, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                 dtype=dt, lead=lead)
    return p


def _apply_layer(cfg: ModelConfig, kind: str, p: Params, x, positions, *,
                 causal=True, cache=None, pos=None, cross_kv=None):
    """Returns (x, aux_loss); a decode ``cache`` is updated in place."""
    cd = cfg.cdtype
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def norm(g, y):
        return L.rms_norm(y, g, cfg.norm_eps)

    if kind == "mamba":
        y, _ = SSM.mamba_apply(_cast(sub(p, "mamba"), cd), norm(p["ln1"], x),
                               d_state=cfg.ssm_state, chunk=cfg.scan_chunk,
                               state=cache)
        return x + y, aux

    if kind == "rg":
        y, _ = RG.rglru_apply(_cast(sub(p, "rg"), cd), norm(p["ln1"], x),
                              chunk=cfg.scan_chunk, state=cache)
        x = x + y
    else:  # attention kinds
        window = 0
        if kind == "la":
            window = cfg.local_window
        elif cfg.attn_kind == "sliding":
            window = cfg.window
        with spans.phase("grads/attention", attn_fused=0) as ph:
            y, _ = L.attn_apply(
                _cast(sub(p, "attn"), cd), norm(p["ln1"], x), positions,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                window=window, causal=causal, rope_theta=cfg.rope_theta,
                q_chunk=cfg.q_chunk,
                softmax_dtype=getattr(torch, cfg.softmax_dtype),
                cache=cache, pos=pos)
            ph.backward(x, y)
        x = x + y
        xattn = sub(p, "xattn")
        if xattn:
            with spans.phase("grads/attention", attn_fused=0) as ph:
                y, _ = L.attn_apply(_cast(xattn, cd), norm(p["lnx"], x),
                                    positions, n_heads=cfg.n_heads,
                                    n_kv=cfg.n_kv, head_dim=cfg.hd,
                                    causal=False,
                                    rope_theta=cfg.rope_theta,
                                    q_chunk=cfg.q_chunk, cross_kv=cross_kv,
                                    decode=cache is not None)
                ph.backward(x, y)
            x = x + y

    moe = sub(p, "moe")
    if moe:
        y, aux = MOE.moe_apply(_cast(moe, cd), norm(p["ln2"], x),
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               activation=cfg.activation,
                               group_size=cfg.moe_group)
        x = x + y
    else:
        mlp = sub(p, "mlp")
        if mlp:
            with spans.phase("grads/mlp") as ph:
                y = L.mlp_apply(_cast(mlp, cd), norm(p["ln2"], x),
                                cfg.activation)
                ph.backward(x, y)
            x = x + y
    return x, aux


def _layer_fn(cfg: ModelConfig, kind: str, *, causal=True, cache=None,
              pos=None):
    """One layer as ``fn(x, positions, p, *cross_kv) -> (x, aux)`` for
    ``Model._layers``."""
    def fn(x, positions, p, *cross_kv):
        return _apply_layer(cfg, kind, p, x, positions, causal=causal,
                            cache=cache, pos=pos, cross_kv=cross_kv or None)
    return fn


def _group_fn(cfg: ModelConfig, *, cache=None, pos=None):
    """One pattern group as ``fn(x, positions, p, aux) -> (x, aux)``, the
    aux summed layer by layer into the carried one (the reference's
    ``gbody``)."""
    def fn(x, positions, p, aux):
        for j, kind in enumerate(cfg.pattern):
            x, a = _apply_layer(cfg, kind, sub(p, str(j)), x, positions,
                                cache=None if cache is None else cache[j],
                                pos=pos)
            aux = aux + a
        return x, aux
    return fn


def _init_layer_cache(cfg: ModelConfig, kind: str, b: int, cache_len: int,
                      lead, device):
    if kind == "mamba":
        return SSM.init_mamba_state(b, cfg.d_model, cfg.ssm_state,
                                    cfg.ssm_conv, cfg.ssm_expand,
                                    dtype=cfg.cdtype, lead=lead,
                                    device=device)
    if kind == "rg":
        return RG.init_rglru_state(b, cfg.lru_width, dtype=cfg.cdtype,
                                   lead=lead, device=device)
    clen = cache_len
    if kind == "la":
        clen = min(cache_len, cfg.local_window)
    elif cfg.attn_kind == "sliding":
        clen = min(cache_len, cfg.window)
    return L.init_attn_cache(b, clen, cfg.n_kv, cfg.hd, dtype=cfg.cdtype,
                             lead=lead, device=device)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg.validate()
        self.kinds = cfg.layer_kinds()
        self.uniform = len(set(self.kinds)) == 1
        # the products a rematerialised layer keeps; None: no remat
        self.remat_keeps = (RM.saved_products(cfg.remat_policy)
                            if cfg.remat else None)
        if not self.uniform:
            period = len(cfg.pattern)
            self.n_groups = cfg.n_layers // period
            self.tail_kinds = self.kinds[self.n_groups * period:]
        # sharding hooks (set by the launcher; launch/mesh.py), off by
        # default: layer_constraint(p_slice) places each layer's slice of
        # the stacks, act_constraint(x) the residual stream, at the top of
        # every layer (every pattern group) of the stacks
        self.layer_constraint = None
        self.act_constraint = None

    def set_sharding(self, layer_constraint=None, act_constraint=None):
        self.layer_constraint = layer_constraint
        self.act_constraint = act_constraint
        return self

    def _constrain(self, p_l: Params, x):
        if self.layer_constraint is not None:
            p_l = self.layer_constraint(p_l)
        if self.act_constraint is not None:
            x = self.act_constraint(x)
        return p_l, x

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator) -> Params:
        """Fresh parameters drawn from ``generator``, on its device, as the
        flat dict in the reference's flatten order."""
        cfg, gen = self.cfg, generator
        d, dev = cfg.d_model, generator.device
        params: Dict[str, Any] = {
            "embed": L._init(gen, (cfg.vocab, d), scale=0.02,
                             dtype=cfg.pdtype),
            "unembed": L._init(gen, (d, cfg.vocab), scale=0.02,
                               dtype=cfg.pdtype),
            "final_norm": torch.zeros((d,), device=dev),
        }
        if self.uniform:
            params["layers"] = _init_layer(cfg, self.kinds[0], gen,
                                           cross=cfg.family == "encdec",
                                           lead=(cfg.n_layers,))
        else:
            params["groups"] = tuple(
                _init_layer(cfg, kind, gen, lead=(self.n_groups,))
                for kind in cfg.pattern)
            params["tail"] = [_init_layer(cfg, kind, gen)
                              for kind in self.tail_kinds]
        if cfg.family == "encdec":
            params["encoder"] = _init_layer(cfg, "attn+mlp", gen,
                                            lead=(cfg.enc_layers,))
            params["enc_norm"] = torch.zeros((d,), device=dev)
        if cfg.family in ("vlm", "encdec"):
            params["frontend_proj"] = L._init(gen, (d, d), dtype=cfg.pdtype)
        return flatten_params(params)

    # -- shared stacks --------------------------------------------------------

    def _cross_kv(self, p_l: Params, enc_out):
        """One decoder layer's cross K/V over the encoder output [B, F, d],
        each [B, F, KV * hd] (``attn_apply`` splits the heads)."""
        cd = self.cfg.cdtype
        return (enc_out @ p_l["xattn/wk"].to(cd),
                enc_out @ p_l["xattn/wv"].to(cd),
                torch.arange(enc_out.shape[1], device=enc_out.device))

    def _layers(self, fn, x, positions, p: Params, *extra, cache=None):
        """``fn(x, positions, p, *extra) -> (x, aux)``, rematerialised
        (``models/remat.py``) when the config asks for it, no cache is
        passed and a gradient may be taken.  Every tensor the layer reads
        comes in as an argument: ``torch.func`` refuses a rematerialised
        body that closes over one."""
        if (self.remat_keeps is None or cache is not None
                or not torch.is_grad_enabled()):
            return fn(x, positions, p, *extra)
        names = list(p)

        def body(x, positions, *ts):
            return fn(x, positions, dict(zip(names, ts[:len(names)])),
                      *ts[len(names):])
        return RM.checkpoint(body, self.remat_keeps, x, positions,
                             *p.values(), *extra)

    def _run_uniform(self, stack: Params, x, positions, *, causal=True,
                     cache=None, pos=None, enc_out=None):
        cfg = self.cfg
        kind = self.kinds[0]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            p_l, x = self._constrain(_index(stack, i), x)
            c_l = None if cache is None else _index(cache, i)
            # pin the residual stream to the compute dtype
            x = x.to(cfg.cdtype)
            kv = () if enc_out is None else self._cross_kv(p_l, enc_out)
            x, a = self._layers(
                _layer_fn(cfg, kind, causal=causal, cache=c_l, pos=pos), x,
                positions, p_l, *kv, cache=c_l)
            aux = aux + a
        return x, aux

    def _run_pattern(self, params: Params, x, positions, *, cache=None,
                     pos=None):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        stacks = [sub(params, f"groups/{j}") for j in range(len(cfg.pattern))]
        for g in range(self.n_groups):
            cs = (None if cache is None else
                  [_index(cache["groups"][j], g)
                   for j in range(len(cfg.pattern))])
            slices = []
            for j in range(len(cfg.pattern)):
                p_j, x = self._constrain(_index(stacks[j], g), x)
                slices.append(p_j)
            # one group's layers as one dict, its leaves keyed "j/<leaf>"
            p_g = {f"{j}/{k}": v for j, p_j in enumerate(slices)
                   for k, v in p_j.items()}
            x, aux = self._layers(_group_fn(cfg, cache=cs, pos=pos), x,
                                  positions, p_g, aux, cache=cs)
        for i, kind in enumerate(self.tail_kinds):
            c_l = None if cache is None else cache["tail"][i]
            x, a = _apply_layer(cfg, kind, sub(params, f"tail/{i}"), x,
                                positions, cache=c_l, pos=pos)
            aux = aux + a
        return x, aux

    def _encode(self, params: Params, frames):
        """Audio encoder over stubbed frame embeddings [B, F, d]."""
        cfg = self.cfg
        x = frames.to(cfg.cdtype) @ params["frontend_proj"].to(cfg.cdtype)
        b, f = frames.shape[:2]
        pos = torch.arange(f, dtype=torch.int32,
                           device=frames.device)[None].expand(b, f)
        stack = sub(params, "encoder")
        layer = _layer_fn(cfg, "attn+mlp", causal=False)
        for i in range(cfg.enc_layers):
            x, _ = self._layers(layer, x, pos, _index(stack, i))
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    # -- forward (train / prefill) -------------------------------------------

    def _forward(self, params: Params, batch, final_norm: bool = True):
        """Returns (hidden states [B, S_total, d], aux, text_offset); the
        final norm left to the caller unless ``final_norm``."""
        cfg = self.cfg
        tok = batch["tokens"]
        # gather the f32 rows, then convert (the same values as converting
        # the table first)
        x = L.embed(params["embed"], tok).to(cfg.cdtype)
        offset = 0
        if cfg.family == "vlm":
            emb = batch["embeds"].to(cfg.cdtype) @ params[
                "frontend_proj"].to(cfg.cdtype)
            x = torch.cat([emb, x], dim=1)
            offset = cfg.n_patches
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        if self.uniform:
            enc_out = (self._encode(params, batch["frames"])
                       if cfg.family == "encdec" else None)
            x, aux = self._run_uniform(sub(params, "layers"), x, positions,
                                       enc_out=enc_out)
        else:
            x, aux = self._run_pattern(params, x, positions)
        if final_norm:
            x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, aux, offset

    def loss(self, params: Params, batch):
        """Next-token cross-entropy (+ MoE aux). labels: tokens shifted."""
        cfg = self.cfg
        x, aux, off = self._forward(params, batch, final_norm=False)
        tok = batch["tokens"]
        labels = torch.cat([tok[:, 1:], torch.full(
            (tok.shape[0], 1), -1, dtype=tok.dtype, device=tok.device)],
            dim=1)
        with spans.phase("grads/head") as ph:
            h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
            nll = L.chunked_xent(h[:, off:, :],     # text region
                                 params["unembed"].to(cfg.cdtype), labels,
                                 chunk=cfg.xent_chunk)
            ph.backward(x, nll)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    def prefill_logits(self, params: Params, batch):
        """Forward returning ONLY the last position's logits [B, V]."""
        cfg = self.cfg
        x, _, _ = self._forward(params, batch)
        return (x[:, -1, :] @ params["unembed"].to(cfg.cdtype)).to(
            torch.float32)

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch_size: int, cache_len: int, device=None):
        """An empty decode cache on ``device`` (CUDA unless named)."""
        cfg, dev = self.cfg, default_device(device)
        if self.uniform:
            return {"layers": _init_layer_cache(cfg, self.kinds[0],
                                                batch_size, cache_len,
                                                (cfg.n_layers,), dev)}
        return {"groups": tuple(
                    _init_layer_cache(cfg, kind, batch_size, cache_len,
                                      (self.n_groups,), dev)
                    for kind in cfg.pattern),
                "tail": [_init_layer_cache(cfg, kind, batch_size, cache_len,
                                           (), dev)
                         for kind in self.tail_kinds]}

    def decode_step(self, params: Params, cache, token, pos: int,
                    enc_out=None):
        """One serve step: token [B] ints, pos a Python int.  Updates
        ``cache`` in place.  Returns (logits [B, V] f32, cache)."""
        cfg = self.cfg
        b = token.shape[0]
        x = L.embed(params["embed"], token).to(cfg.cdtype)[:, None, :]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        if self.uniform:
            if cfg.family == "encdec":
                assert enc_out is not None
            x, _ = self._run_uniform(sub(params, "layers"), x, positions,
                                     cache=cache["layers"], pos=pos,
                                     enc_out=enc_out)
        else:
            x, _ = self._run_pattern(params, x, positions, cache=cache,
                                     pos=pos)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x[:, 0] @ params["unembed"].to(cfg.cdtype)).to(
            torch.float32)
        return logits, cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
