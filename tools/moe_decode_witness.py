"""Decode against the teacher-forced forward for a MoE, in the JAX reference
and in the PyTorch port, on the same parameters and tokens, on the CPU.

The question it answers: at a MoE's published width, is the bf16 gap
between the decode chain's logits and the forward's a property of the
model's numerics, shared by the reference, or of the port?  Both packages
run olmoe-1b-7b's published config with its depth cut (``--layers``), the
reference's ``init`` carried across by ``convert.lm_params``, at f32 and at
bf16 compute.  For each (package, dtype) it reports:

  * how many of the decode chain's top-k expert choices (one per token,
    layer and step) differ from the forward's over the same tokens;
  * how many of the B x T decode steps' logits lie beyond the bar that
    ``chip_smoke.py``'s ``lm serve`` holds decode to (bf16: 0.15 x the
    forward's logits rms + 0.05 x |logit|; f32: 0.01 x rms + 1e-3 x |logit|),
    and the largest |diff|;
  * and, per dtype, the port's decode chain against the reference's: the
    largest |diff| of their logits and the expert choices that differ.

Both MoE layers run at a dropless capacity (capacity factor E / k), as the
reference's ``test_decode_matches_prefill`` does.  The top-k calls are
recorded by standing in for ``jax.lax.top_k`` (through an ordered
``jax.debug.callback``) and ``torch.topk`` while the script runs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_decode_witness.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_decode_witness.py \\
        --reduced          # the reduced config: a few seconds

At the default two layers the parameters take ~4.2 GB in f32 and the run
peaks near 13 GB of host memory.  It prints one JSON object.
"""
import argparse
import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models.model import _cast as jcast
from repro.models.model import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models.model import build_model as tbuild

ARCH = "olmoe-1b-7b"


class _Recorder:
    """Records the router's top-k indices (calls over ``e`` with k = ``k``)
    of both packages while entered; any other top-k passes through."""

    def __init__(self, e, k):
        self.e, self.k, self.calls = e, k, []

    def __enter__(self):
        self._jax, self._torch = jax.lax.top_k, torch.topk
        jax.lax.top_k, torch.topk = self._jax_top_k, self._torch_topk
        return self

    def __exit__(self, *exc):
        jax.lax.top_k, torch.topk = self._jax, self._torch

    def _mine(self, x, k):
        return x.shape[-1] == self.e and k == self.k

    def _jax_top_k(self, x, k, **kw):
        gate, idx = self._jax(x, k, **kw)
        if self._mine(x, k):
            jax.debug.callback(lambda i: self.calls.append(np.asarray(i)),
                               idx, ordered=True)
        return gate, idx

    def _torch_topk(self, x, k, *a, **kw):
        gate, idx = self._torch(x, k, *a, **kw)
        if self._mine(x, k):
            self.calls.append(idx.numpy())
        return gate, idx


def _flips(dec_calls, fwd_calls, b, k):
    """Expert choices of the decode chain (one per token, layer and step)
    that differ from the forward's, of how many."""
    n_layers = len(fwd_calls)
    flips = 0
    for c, idx in enumerate(dec_calls):
        step, layer = divmod(c, n_layers)
        ref = fwd_calls[layer].reshape(b, -1, k)[:, step]
        got = idx.reshape(b, k)
        flips += int((np.sort(got, -1) != np.sort(ref, -1)).any(-1).sum())
    return flips, len(dec_calls) * b


def _gaps(dec, fwd, f32):
    """(steps beyond the bar, of how many; max |diff|): dec and fwd are the
    [B, T, V] logits, the bar per step from the forward's logits rms."""
    a, r = (0.01, 1e-3) if f32 else (0.15, 0.05)
    err = np.abs(dec - fwd)
    rms = np.sqrt((fwd ** 2).mean(axis=(0, 2), keepdims=True))
    beyond = (err > a * rms + r * np.abs(fwd)).any(-1)
    return int(beyond.sum()), beyond.size, float(err.max())


def _reference(cfg, params, toks, rec):
    m = jbuild(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jt = jnp.asarray(toks)
    b, t = toks.shape
    n0 = len(rec.calls)

    @jax.jit
    def forward(p, tok):
        x, _, _ = m._forward(p, {"tokens": tok})
        return (x @ jcast(p["unembed"], cfg.cdtype)).astype(jnp.float32)

    fwd = np.asarray(forward(jp, jt))
    jax.effects_barrier()
    fwd_calls = rec.calls[n0:]
    step = jax.jit(lambda p, c, tok, pos: m.decode_step(p, c, tok, pos))
    cache, dec = m.init_cache(b, t), []
    n1 = len(rec.calls)
    for i in range(t):
        lg, cache = step(jp, cache, jt[:, i], jnp.int32(i))
        dec.append(np.asarray(lg))
    jax.effects_barrier()
    return fwd, np.stack(dec, 1), fwd_calls, rec.calls[n1:]


def _port(cfg, params, toks, rec):
    m = tbuild(cfg)
    tt = torch.from_numpy(toks)
    b, t = toks.shape
    with torch.inference_mode():
        n0 = len(rec.calls)
        x, _, _ = m._forward(params, {"tokens": tt})
        fwd = (x @ params["unembed"].to(cfg.cdtype)).float().numpy()
        fwd_calls = rec.calls[n0:]
        cache, dec = m.init_cache(b, t, device="cpu"), []
        n1 = len(rec.calls)
        for i in range(t):
            lg, cache = m.decode_step(params, cache, tt[:, i], i)
            dec.append(lg.numpy())
    return fwd, np.stack(dec, 1), fwd_calls, rec.calls[n1:]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    torch.set_grad_enabled(False)
    base = {}
    for name, mod in (("ref", jconfigs), ("port", tconfigs)):
        c = mod.get_config(ARCH, reduced=args.reduced)
        base[name] = dataclasses.replace(
            c, n_layers=args.layers,
            capacity_factor=c.n_experts / c.top_k)
    cfg = base["ref"]
    t0 = time.perf_counter()
    params = jax.tree.map(np.asarray, jax.jit(jbuild(cfg).init)(
        jax.random.PRNGKey(args.seed)))
    tparams = convert.lm_params(params, device="cpu")
    toks = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (args.batch, args.steps)).astype(np.int32)
    out = {"arch": ARCH, "reduced": args.reduced, "layers": args.layers,
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "top_k": cfg.top_k, "batch": args.batch, "steps": args.steps,
           "seed": args.seed, "runs": {}}
    decoded, routed = {}, {}
    with _Recorder(cfg.n_experts, cfg.top_k) as rec:
        for dtype in ("float32", "bfloat16"):
            for name, run, p in (("ref", _reference, params),
                                 ("port", _port, tparams)):
                c = dataclasses.replace(base[name], compute_dtype=dtype)
                fwd, dec, fwd_calls, dec_calls = run(c, p, toks, rec)
                f32 = dtype == "float32"
                beyond, n, mx = _gaps(dec, fwd, f32)
                flips, choices = _flips(dec_calls, fwd_calls, args.batch,
                                        cfg.top_k)
                decoded[name, dtype], routed[name, dtype] = dec, dec_calls
                out["runs"][f"{name} {dtype}"] = {
                    "expert_flips": flips, "expert_choices": choices,
                    "steps_beyond_bar": beyond, "steps": n,
                    "max_abs_diff": mx,
                    "logits_rms": float(np.sqrt((fwd ** 2).mean())),
                    "bar": ("0.01 rms + 1e-3 |ref|" if f32
                            else "0.15 rms + 0.05 |ref|")}
    for dtype in ("float32", "bfloat16"):
        out[f"port vs ref, {dtype}"] = {
            "decode_max_abs_diff": float(np.abs(
                decoded["port", dtype] - decoded["ref", dtype]).max()),
            "decode_expert_flips": sum(
                int((np.sort(a.reshape(args.batch, -1), -1)
                     != np.sort(b.reshape(args.batch, -1), -1)).any(-1).sum())
                for a, b in zip(routed["port", dtype], routed["ref", dtype]))}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
