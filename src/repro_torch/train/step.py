"""Train, prefill and serve steps (the JAX package's ``train/step.py``).

:func:`make_train_step` is the reference's plain step: loss -> gradients ->
AdamW.  :func:`make_train_step_compressed` is the paper's early data
reduction applied to the slowest link: each pod's gradients cross the pod
axis as int8 codes and float32 scales with error feedback
(``core.reduction.compressed_pod_allreduce``).  The pod axis is a
``torch.distributed`` process group, None for one pod.  The model's
parameters are updated in place (the reference returns new ones).
"""

from __future__ import annotations

import torch

from repro_torch.core.reduction import (
    EFState,
    compressed_pod_allreduce,
    div_const,
    pod_count,
    psum,
)
from repro_torch.models.transformer import STACKED
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update

BLOCK = 256                     # the int8 exchange's block of values


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


def ef_leaves(model) -> list:
    """[(name, stacked, the port's parameter names)] for every leaf of the
    reference's tree, in its leaf order; ``name`` is the leaf's JAX path
    joined by "/", and a stacked leaf's parameters are its slices in layer
    order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [("/".join(str(k) for k in path), path[0] in STACKED,
             [names[id(t)] for t in tensors])
            for path, _s, tensors in model._leaves()]


def n_calls(n_slices: int, numel: int) -> int:
    """How many calls of the exchange a leaf of ``n_slices`` slices of
    ``numel`` values takes: one a slice where each holds whole blocks (or
    the leaf is not stacked), else one over their concatenation."""
    return n_slices if n_slices == 1 or numel % BLOCK == 0 else 1


def init_ef_states(model) -> dict:
    """Error-feedback residuals, one float32 zero tensor a reference leaf
    (keyed as :func:`ef_leaves` names them, a stacked leaf's slices
    stacked along a leading axis), on the model's device."""
    params = model.named_leaves()
    out = {}
    for name, stacked, pnames in ef_leaves(model):
        shape = tuple(params[pnames[0]].shape)
        if stacked:
            shape = (len(pnames),) + shape
        out[name] = torch.zeros(shape, dtype=torch.float32,
                                device=model.device)
    return out


def exchange_grads(layout, grads: dict, ef: dict, pod_group=None) -> dict:
    """Every gradient of ``grads`` (name -> tensor, emptied as it goes: a
    bf16 gradient is freed as its float32 counterpart is made) through
    ``compressed_pod_allreduce`` over ``pod_group`` and divided by the
    number of pods: name -> float32 gradient.  ``layout`` is
    :func:`ef_leaves`'s, ``ef`` :func:`init_ef_states`'s dict, whose
    residuals are updated in place.

    The reference compresses whole leaves, and a stacked leaf's flat
    256-value blocks cross its layer slices wherever a slice's size is not
    a multiple of 256: such a leaf is compressed over the concatenation of
    its slices, in layer order.  Where every slice holds whole blocks the
    blocks are the same slice by slice, and no copy is made."""
    npods = pod_count(pod_group)
    out = {}
    for name, stacked, pnames in layout:
        res = ef[name]
        slots = res if stacked else res.unsqueeze(0)
        shape = grads[pnames[0]].shape
        n = grads[pnames[0]].numel()
        if n_calls(len(pnames), n) == len(pnames):
            for i, pn in enumerate(pnames):
                g = grads.pop(pn).to(torch.float32)
                summed, st = compressed_pod_allreduce(
                    g, EFState(slots[i]), pod_group=pod_group, block=BLOCK)
                del g
                slots[i].copy_(st.residual)
                out[pn] = div_const(summed, npods)
        else:
            g = torch.cat([grads.pop(pn).to(torch.float32).reshape(-1)
                           for pn in pnames])
            summed, st = compressed_pod_allreduce(
                g, EFState(res.reshape(-1)), pod_group=pod_group,
                block=BLOCK)
            del g
            res.copy_(st.residual.reshape(res.shape))
            summed = div_const(summed, npods)
            for i, pn in enumerate(pnames):
                out[pn] = summed[i * n:(i + 1) * n].reshape(shape)
        del summed, st
    return out


def make_train_step_compressed(model, opt_cfg: AdamWConfig, pod_group=None):
    """``step(opt_state, ef, batch) -> (opt_state, ef, metrics)`` with the
    int8 + error-feedback gradient exchange over ``pod_group`` (None: one
    pod), as the reference's: the gradient of ``model.loss``, each leaf
    cast to float32, exchanged and divided by the number of pods
    (:func:`exchange_grads`), the loss and metrics averaged over the pods,
    then AdamW on the float32 gradients.  ``batch`` is this pod's shard of
    the global batch's dim 0; ``ef`` is :func:`init_ef_states`'s dict,
    updated in place."""
    layout = ef_leaves(model)

    def train_step(opt_state: OptState, ef: dict, batch):
        npods = pod_count(pod_group)
        loss, metrics, grads = grads_of(model, batch)
        grads = exchange_grads(layout, grads, ef, pod_group)
        loss = div_const(psum(loss, (pod_group,)), npods)
        metrics = {k: div_const(psum(v, (pod_group,)), npods)
                   for k, v in metrics.items()}
        params = model.named_leaves()
        with torch.no_grad():
            _new, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, opt_state, model.cfg.param_dtype, out=params)
        return opt_state, ef, dict(metrics, loss=loss, **opt_metrics)

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
