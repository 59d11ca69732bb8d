"""Train, prefill and serve steps (the JAX package's ``train/step.py`` on
one card).

:func:`make_train_step` is the reference's plain step: loss -> gradients ->
AdamW.  The model's parameters are updated in place (the reference returns
new ones).  ``make_train_step_compressed`` (int8 gradient exchange over a
pod axis) needs the pod mesh and is not ported (ROADMAP.md item 4c).
"""

from __future__ import annotations

import torch

from repro_torch.core.reduction import div_const
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update


def grads_of(model, batch):
    """(loss, metrics, gradients): the gradient of ``model.loss`` at
    ``batch`` with respect to every parameter, by name in the model's leaf
    order (``Model.named_leaves``), in the parameters' dtype."""
    params = model.named_leaves()
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = model.loss(batch)
    loss.backward()
    grads = {}
    for n, p in params.items():
        grads[n] = p.grad
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, opt_cfg: AdamWConfig, accum: int = 1):
    """``step(opt_state, batch) -> (opt_state, metrics)``, metrics with
    "loss", "ce", "aux", "grad_norm" and "lr".  ``batch`` is {"tokens":
    (b, s) tensor on the model's device}, with "enc_input" (b, enc_seq,
    d_model) for an encoder-decoder.  ``accum`` > 1 splits the batch
    into that many microbatches, one after another, their gradients summed
    in float32 and divided by ``accum`` (a constant: ``div_const``, as
    XLA compiles the reference's ``g / accum``); the metrics other than
    the loss are the last microbatch's, as the reference's."""

    def train_step(opt_state: OptState, batch):
        if accum == 1:
            loss, metrics, grads = grads_of(model, batch)
        else:
            b = batch["tokens"].shape[0]
            assert b % accum == 0, (b, accum)
            micro = {k: v.reshape(accum, b // accum, *v.shape[1:])
                     for k, v in batch.items()}
            gsum, lsum = None, torch.zeros((), device=model.device)
            for i in range(accum):
                loss_i, metrics, g = grads_of(
                    model, {k: v[i] for k, v in micro.items()})
                if gsum is None:
                    gsum = {n: x.to(torch.float32) for n, x in g.items()}
                else:
                    for n, x in g.items():
                        gsum[n].add_(x.to(torch.float32))
                del g
                lsum = lsum + loss_i
            grads = {n: div_const(x, accum) for n, x in gsum.items()}
            del gsum
            loss = div_const(lsum, accum)
        params = model.named_leaves()
        with torch.no_grad():
            _new, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, opt_state, model.cfg.param_dtype, out=params)
        return opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(model):
    def prefill_step(batch):
        enc_out = (model.encode(batch["enc_input"]) if model.cfg.is_encdec
                   else None)
        return model.prefill(batch["tokens"], enc_out)
    return prefill_step


def make_serve_step(model):
    def serve_step(token, cache, position: int):
        return model.decode_step(token, cache, position)
    return serve_step
