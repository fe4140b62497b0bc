"""The plain reference of the language models the benchmark trains.

Plain PyTorch in float32, with TF32 off, written from the architecture as
the configuration file states it: pre-norm transformer layers with RMSNorm
(scale ``1 + gamma``), grouped-query attention with rotary positions
(halves concatenated), a tanh-GELU MLP, no biases, an untied output head and
a next-token cross-entropy averaged over the labelled positions.  The
encoder-decoder family (``whisper-tiny``) adds an encoder over frame
embeddings (a linear front end, non-causal attention, a final norm) and a
cross-attention in every decoder layer, whose keys and queries take no
rotary positions.

The parameters are a flat dict from ``/``-joined paths to tensors; the
stacked leaves hold all layers of a stack, ``[L, ...]``.  ``param_spec``
lists them in path order, each with its initial standard deviation (0 for
a norm's zeros).

``precision="fp8"`` is the control of the benchmark's check: every matrix
product takes its operands rounded to float8 (e4m3, scaled per tensor to
its largest magnitude) in the forward pass, and its output gradient rounded
to float8 (e5m2, scaled alike) in the backward pass.

A step's model FLOPs (``step_flops``) are ``portbench/flops.py``'s count.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.flops import step_flops  # noqa: F401  (REFERENCE_API)

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], float]]

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def _layer_spec(cfg: dict, prefix: str, n: int, cross: bool) -> Spec:
    d, ff, hd = cfg["d_model"], cfg["d_ff"], head_dim(cfg)
    hq, hk = cfg["n_heads"] * hd, cfg["n_kv"] * hd

    def attn(name):
        return [(f"{prefix}/{name}/wq", (n, d, hq), d ** -0.5),
                (f"{prefix}/{name}/wk", (n, d, hk), d ** -0.5),
                (f"{prefix}/{name}/wv", (n, d, hk), d ** -0.5),
                (f"{prefix}/{name}/wo", (n, hq, d), hq ** -0.5)]

    out = attn("attn") + [
        (f"{prefix}/ln1", (n, d), 0.0), (f"{prefix}/ln2", (n, d), 0.0),
        (f"{prefix}/mlp/w_up", (n, d, ff), d ** -0.5),
        (f"{prefix}/mlp/w_down", (n, ff, d), ff ** -0.5)]
    if cfg["activation"] == "silu":
        out.append((f"{prefix}/mlp/w_gate", (n, d, ff), d ** -0.5))
    if cross:
        out += attn("xattn") + [(f"{prefix}/lnx", (n, d), 0.0)]
    return out


def param_spec(cfg: dict) -> Spec:
    """Every parameter as (path, shape, initial std), in path order (the
    components compared one by one)."""
    if cfg["family"] not in ("dense", "encdec"):
        raise ValueError(f"no reference for the {cfg['family']!r} family")
    d, v = cfg["d_model"], cfg["vocab"]
    encdec = cfg["family"] == "encdec"
    spec = [("embed", (v, d), 0.02), ("unembed", (d, v), 0.02),
            ("final_norm", (d,), 0.0)]
    spec += _layer_spec(cfg, "layers", cfg["n_layers"], cross=encdec)
    if encdec:
        spec += _layer_spec(cfg, "encoder", cfg["enc_layers"], cross=False)
        spec += [("enc_norm", (d,), 0.0), ("frontend_proj", (d, d), d ** -0.5)]
    return sorted(spec, key=lambda s: s[0].split("/"))


# ---------------------------------------------------------------------------
# matrix products, plain or through the float8 control
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8 = _fp8(a, torch.float8_e4m3fn, E4M3_MAX)
        b8 = _fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        # a broadcast operand's gradient is summed over its broadcast dims
        return ((g8 @ b8.transpose(-1, -2)).sum_to_size(a8.shape),
                (a8.transpose(-1, -2) @ g8).sum_to_size(b8.shape))


class Numerics:
    """Matrix products in float32 (``"f32"``) or through float8
    (``"fp8"``)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + gamma)


def rope(x, theta: float):
    """x [B, S, H, D] at positions 0..S-1."""
    s, half = x.shape[1], x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(num: Numerics, q, k, v, causal: bool):
    """q [B, Sq, H, D], k and v [B, Sk, KV, D]: softmax(q k^T / sqrt(D)) v,
    each KV head serving H / KV query heads."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    qh = q.reshape(b, sq, kv, rep, d).permute(0, 2, 3, 1, 4)   # b kv r q d
    kh = k.permute(0, 2, 3, 1)[:, :, None]                     # b kv 1 d s
    vh = v.permute(0, 2, 1, 3)[:, :, None]                     # b kv 1 s d
    scores = num.mm(qh, kh) * d ** -0.5
    if causal:
        sk = k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    out = num.mm(torch.softmax(scores, dim=-1), vh)            # b kv r q d
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * d)


def attn_block(num: Numerics, cfg: dict, p: Params, x, *, causal=True,
               kv_in=None):
    """Self-attention (rotary positions on q and k), or cross-attention
    over ``kv_in`` (no rotary positions)."""
    b, s, _ = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv"], head_dim(cfg)
    src = x if kv_in is None else kv_in
    q = num.mm(x, p["wq"]).reshape(b, s, h, hd)
    k = num.mm(src, p["wk"]).reshape(b, src.shape[1], kv, hd)
    v = num.mm(src, p["wv"]).reshape(b, src.shape[1], kv, hd)
    if kv_in is None:
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    return num.mm(attention(num, q, k, v, causal and kv_in is None), p["wo"])


def mlp(num: Numerics, cfg: dict, p: Params, x):
    up = num.mm(x, p["w_up"])
    if cfg["activation"] == "silu":
        hid = torch.nn.functional.silu(num.mm(x, p["w_gate"])) * up
    elif cfg["activation"] == "gelu":
        hid = torch.nn.functional.gelu(up, approximate="tanh")
    else:
        raise ValueError(cfg["activation"])
    return num.mm(hid, p["w_down"])


def _layer(p: Params, prefix: str, i: int) -> Params:
    pre = prefix + "/"
    return {k[len(pre):]: v[i] for k, v in p.items() if k.startswith(pre)}


def _sub(p: Params, name: str) -> Params:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def encode(num: Numerics, cfg: dict, p: Params, frames):
    eps = cfg["norm_eps"]
    x = num.mm(frames, p["frontend_proj"])
    for i in range(cfg["enc_layers"]):
        lp = _layer(p, "encoder", i)
        x = x + attn_block(num, cfg, _sub(lp, "attn"),
                           rms_norm(x, lp["ln1"], eps), causal=False)
        x = x + mlp(num, cfg, _sub(lp, "mlp"), rms_norm(x, lp["ln2"], eps))
    return rms_norm(x, p["enc_norm"], eps)


def hidden(num: Numerics, cfg: dict, p: Params, batch) -> torch.Tensor:
    """The final normed hidden states [B, S, d] of the token positions."""
    eps = cfg["norm_eps"]
    x = p["embed"][batch["tokens"].long()]
    enc = (encode(num, cfg, p, batch["frames"])
           if cfg["family"] == "encdec" else None)
    for i in range(cfg["n_layers"]):
        lp = _layer(p, "layers", i)
        x = x + attn_block(num, cfg, _sub(lp, "attn"),
                           rms_norm(x, lp["ln1"], eps))
        if enc is not None:
            x = x + attn_block(num, cfg, _sub(lp, "xattn"),
                               rms_norm(x, lp["lnx"], eps), kv_in=enc)
        x = x + mlp(num, cfg, _sub(lp, "mlp"), rms_norm(x, lp["ln2"], eps))
    return rms_norm(x, p["final_norm"], eps)


def nll_sum(num: Numerics, cfg: dict, p: Params, batch):
    """(summed next-token NLL over the rows of ``batch``, labelled
    positions): every position but each row's last has a label."""
    x = hidden(num, cfg, p, batch)
    tok = batch["tokens"].long()
    logits = num.mm(x[:, :-1], p["unembed"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tok[:, 1:, None])[..., 0]
    return (logz - gold).sum(), tok.shape[0] * (tok.shape[1] - 1)


def rows(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def mean_loss_grad(num: Numerics, cfg: dict, p: Params, batch,
                   block: int) -> Tuple[float, List[torch.Tensor]]:
    """The mean NLL over ``batch`` and its gradient (in ``param_spec``'s
    order, float32), the rows taken ``block`` at a time."""
    names = list(p)
    leaves = [p[k].detach().requires_grad_(True) for k in names]
    pl = dict(zip(names, leaves))
    total, count = 0.0, 0
    grads = [torch.zeros_like(t) for t in leaves]
    n = batch["tokens"].shape[0]
    for lo in range(0, n, block):
        s, c = nll_sum(num, cfg, pl, rows(batch, lo, min(n, lo + block)))
        for g, d in zip(grads, torch.autograd.grad(s, leaves)):
            g += d
        total, count = total + float(s.detach()), count + c
    return total / count, [g / count for g in grads]


def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def param_count(spec: Spec) -> int:
    return sum(math.prod(s) for _, s, _ in spec)
