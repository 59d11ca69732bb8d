"""Serving entry point: batched prefill + decode with an optional cascade
filter (the JAX package's ``launch/serve.py`` on one card).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --requests 16 --prompt-len 32 --gen 16 [--cascade] [--no-smoke] \\
        [--device cpu]

Weights are random, drawn from the specs' distributions with a
``torch.Generator`` seeded by ``--seed``; prompts are uniform token ids
from numpy's generator seeded by ``--seed + 1``.  An encoder-decoder
(whisper) gets standard normal frames in the parameter dtype, one
(enc_seq, d_model) block a request, from a ``torch.Generator`` seeded by
``--seed + 2``, and serves from their encoder output.  ``--smoke`` (the
default) takes the reduced config, ``--no-smoke`` the full one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import SamplerConfig, cascade_serve, generate


def build_model(cfg, device=None, seed: int = 0) -> Model:
    """``cfg`` on ``device`` (the card when None) with weights drawn from a
    ``torch.Generator`` on that device, seeded with ``seed``."""
    model = Model(cfg, device)
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def make_prompts(cfg, requests: int, prompt_len: int, seed: int,
                 device=None) -> torch.Tensor:
    """(requests, prompt_len) uniform token ids from numpy's generator."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (requests, prompt_len))
    return torch.as_tensor(toks, dtype=torch.long,
                           device=resolve_device(device))


def make_frames(cfg, requests: int, seed: int, device=None) -> torch.Tensor:
    """(requests, enc_seq, d_model) standard normal frame embeddings in the
    parameter dtype, drawn in float32 from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((requests, cfg.enc_seq, cfg.d_model), generator=gen,
                       device=dev).to(cfg.param_dtype)


def entropy_scorer(model):
    """The cascade's cheap scorer: the entropy of the next-token
    distribution after each request's last 8 tokens."""
    def score(batch):
        lg = model.logits(batch[:, -8:])[:, -1].float()
        p = torch.softmax(lg, dim=-1)
        return -(p * torch.log(p + 1e-9)).sum(dim=-1)
    return score


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cascade", action="store_true",
                    help="cheap-scorer filter in front (paper's §III insight)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, args.device, args.seed)
    prompts = make_prompts(cfg, args.requests, args.prompt_len, args.seed + 1,
                           model.device)
    sampler = SamplerConfig(temperature=args.temperature)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    enc_out = None
    if cfg.is_encdec:
        frames = make_frames(cfg, args.requests, args.seed + 2, model.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            enc_out = model.encode(frames)
        sync()
        print(f"[serve] encoded {args.requests} x {cfg.enc_seq} frames in "
              f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    if args.cascade:
        toks, _served, stats = cascade_serve(
            entropy_scorer(model),
            lambda b: generate(model, b, args.gen, sampler=sampler),
            prompts, threshold=0.0, capacity_fraction=0.5)
        print(f"[serve] cascade: {int(stats['n_served'])}/{args.requests} "
              "served by the big model")
    else:
        toks = generate(model, prompts, args.gen, enc_out=enc_out,
                        sampler=sampler, seed=args.seed)
    sync()
    dt = time.perf_counter() - t0
    n_tok = args.requests * args.gen
    print(f"[serve] {cfg.name} on {model.device}: {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s incl. prefill)")
    print(f"[serve] sample row: {toks[0][:8].tolist()}")
    return toks


if __name__ == "__main__":
    main()
