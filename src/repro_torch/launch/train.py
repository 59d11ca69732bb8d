"""Training entry point (the JAX package's ``launch/train.py`` on one card).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --steps 200 [--no-smoke] [--global-batch 16] [--seq 64] \\
        [--accum 1] [--ckpt-dir /path] [--ckpt-every 50] [--lr 3e-3] \\
        [--seed 0] [--device cpu]

``--smoke`` (the default) takes the reduced config, ``--no-smoke`` the
full one.  Resumes from the newest checkpoint in ``--ckpt-dir``.  Batches
are ``data.pipeline.batch_for_step`` (an encoder-decoder's:
``encdec_batch_for_step``, its frames cast to the parameter dtype); a
fresh start draws the weights with a ``torch.Generator`` seeded by
``--seed``.  The reference's ``--mesh``,
``--plan`` and ``--grad-compress`` need several devices and are not
ported.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.pipeline import (
    DataConfig,
    batch_for_step,
    encdec_batch_for_step,
)
from repro_torch.models.transformer import Model
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optimizer import AdamWConfig


def opt_config(lr: float, steps: int) -> AdamWConfig:
    """The CLI's optimizer: warmup over a tenth of the run, cosine decay
    over all of it."""
    return AdamWConfig(lr_peak=lr, warmup_steps=max(steps // 10, 1),
                       decay_steps=steps)


def batches(data: DataConfig, device, cfg=None):
    """``make_batch(step)``: the step's tokens on ``device``; for an
    encoder-decoder ``cfg`` also its frames ("enc_input"), cast to
    ``cfg.param_dtype``.  The reference's training CLI feeds them in
    float32, which its bf16 decoder scan refuses (the encoder output would
    promote the bf16 stream); its own tests feed them in the parameter
    dtype, as here."""
    def make_batch(step):
        if cfg is not None and cfg.is_encdec:
            b = encdec_batch_for_step(data, cfg.d_model, cfg.enc_seq, step)
            return {"tokens": torch.as_tensor(b["tokens"], device=device),
                    "enc_input": torch.as_tensor(b["enc_input"],
                                                 device=device).to(
                                                     cfg.param_dtype)}
        toks = batch_for_step(data, step)["tokens"]
        return {"tokens": torch.as_tensor(toks, device=device)}
    return make_batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, args.device)
    print(f"[train] {cfg.name}{' (reduced)' if args.smoke else ''} on "
          f"{model.device}: {model.n_params():,} params")
    data = DataConfig(vocab=cfg.vocab, seq=args.seq,
                      global_batch=args.global_batch, seed=args.seed)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, accum=args.accum)
    _model, _state, out = train(model, batches(data, model.device, cfg),
                                loop_cfg, opt_config(args.lr, args.steps),
                                seed=args.seed)
    hist = out["history"]
    if hist:
        print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
              f"median step "
              f"{1e3 * sorted(h['dt'] for h in hist)[len(hist) // 2]:.0f} ms; "
              f"stragglers flagged: {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
