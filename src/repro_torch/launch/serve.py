"""Serving driver: batched greedy decoding against a KV cache (port of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
      --reduced --batch 4 --prompt-len 32 --gen 32

It runs on CUDA unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, default_device
from repro_torch.models.model import build_model


@torch.inference_mode()
def generate(model, params, prompt, max_len, gen, enc_out=None, *,
             return_logits=False):
    """Greedy generation: prompt [B, P] -> tokens [B, P+gen].  The prompt
    goes in through decode steps, as the reference's does, and the cache is
    updated in place.  ``return_logits``: also return the last step's
    logits [B, V] (the next token's, after the whole output)."""
    b, plen = prompt.shape
    cache = model.init_cache(b, max_len, device=prompt.device)
    toks = [prompt[:, i] for i in range(plen)]
    logits = None
    for i in range(plen):                      # prefill via decode steps
        logits, cache = model.decode_step(params, cache, toks[i], i,
                                          enc_out=enc_out)
    for i in range(gen):
        nxt = torch.argmax(logits, dim=-1).to(prompt.dtype)
        toks.append(nxt)
        logits, cache = model.decode_step(params, cache, nxt, plen + i,
                                          enc_out=enc_out)
    out = torch.stack(toks, dim=1)
    return (out, logits) if return_logits else out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    dev = default_device(args.device)
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    enc_out = None
    if cfg.family == "encdec":
        enc_out = torch.randn(
            (args.batch, cfg.n_frames, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(3)).to(
                cfg.cdtype)
    prompt = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1),
        dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(model, params, prompt, args.prompt_len + args.gen,
                   args.gen, enc_out=enc_out)
    host = out.cpu()                                # waits for the device
    dt = time.perf_counter() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "  # repro-lint: allow=print-in-library (CLI driver)
          f"({toks / dt:.0f} tok/s)")
    if not bool(((host >= 0) & (host < cfg.vocab)).all()):
        raise RuntimeError("a generated token is out of the vocabulary")
    print("sample:", host[0, :16].tolist())  # repro-lint: allow=print-in-library (CLI driver)
    return out


if __name__ == "__main__":
    main()
