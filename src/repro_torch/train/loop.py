"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler accounting (the JAX package's ``train/loop.py`` on one card).

The loop's contract is the reference's: any step may fail and the loop
recovers from the last durable checkpoint with the same data order;
checkpoints hold the reference's ``(params, OptState)`` tree in its layout
(``bridge.train_state_tree``), so a checkpoint written by either package's
loop resumes in the other's; per-step wall times feed a straggler monitor.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.bridge import train_state_tree
from repro_torch.ckpt.checkpoint import DirectoryCheckpoints
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 2
    max_retries: int = 3
    straggler_factor: float = 2.0      # step > factor * median => straggler
    accum: int = 1


@dataclasses.dataclass
class StragglerMonitor:
    times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float, factor: float):
        self.times.append(dt)
        med = float(np.median(self.times[-50:]))
        if len(self.times) > 5 and dt > factor * med:
            self.flagged.append((step, dt, med))

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def _fresh(model, seed: int):
    model.init(torch.Generator(device=model.device).manual_seed(seed))
    return init_opt_state(model.named_leaves())


def _restore(model, opt_state, store, step: int):
    """Load checkpoint ``step`` into the model and ``opt_state`` in place;
    returns (the state with its restored step, the checkpoint's extra)."""
    (_params, state), extra = store.restore(
        step, train_state_tree(model, opt_state))
    return opt_state._replace(step=state.step), extra


def train(model, make_batch, loop_cfg: LoopConfig,
          opt_cfg: AdamWConfig | None = None, params=None, seed: int = 0,
          fail_hook=None, log_every: int = 10, verbose: bool = True,
          store=None):
    """Run (or resume) training of ``model`` in place.  Returns (model,
    opt_state, {"history", "stragglers"}); each history entry holds the
    step, its loss, gradient norm and wall seconds.

    ``params`` (a tree in the JAX layout) starts from those weights;
    without it a fresh start draws them with ``model.init`` from a
    ``torch.Generator`` on the model's device seeded with ``seed``.
    ``make_batch(step) -> batch`` must be deterministic (data/pipeline.py);
    ``fail_hook(step)`` may raise to emulate a node failure: the loop
    restores the last checkpoint and replays.  ``store`` holds the
    checkpoints (``save``, ``restore``, ``latest_step``, ``prune``):
    ``DirectoryCheckpoints(loop_cfg.ckpt_dir)`` when None."""
    opt_cfg = opt_cfg or AdamWConfig()
    store = store or DirectoryCheckpoints(loop_cfg.ckpt_dir)
    step_fn = make_train_step(model, opt_cfg, accum=loop_cfg.accum)

    if params is None:
        opt_state = _fresh(model, seed)
    else:
        model.load_tree(params)
        opt_state = init_opt_state(model.named_leaves())

    start = 0
    last = store.latest_step()
    if last is not None:
        opt_state, extra = _restore(model, opt_state, store, last)
        start = extra["next_step"]
        if verbose:
            print(f"[loop] resumed from step {last} -> continuing at {start}")

    history = []
    monitor = StragglerMonitor()
    step = start
    retries = 0
    while step < loop_cfg.total_steps:
        t0 = time.time()
        try:
            if fail_hook is not None:
                fail_hook(step)
            batch = make_batch(step)
            opt_state, metrics = step_fn(opt_state, batch)
            loss = float(metrics["loss"])
            grad_norm = float(metrics["grad_norm"])
        except Exception as e:  # noqa: BLE001 — the recovery path IS the feature
            retries += 1
            if retries > loop_cfg.max_retries:
                raise
            last = store.latest_step()
            if verbose:
                print(f"[loop] step {step} failed ({e}); restoring ckpt {last}")
            if last is None:
                opt_state = _fresh(model, seed)
                step = 0
            else:
                opt_state, extra = _restore(model, opt_state, store, last)
                step = extra["next_step"]
            continue

        dt = time.time() - t0
        monitor.record(step, dt, loop_cfg.straggler_factor)
        history.append({"step": step, "loss": loss, "grad_norm": grad_norm,
                        "dt": dt})
        if verbose and step % log_every == 0:
            print(f"[loop] step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")

        step += 1
        if step % loop_cfg.ckpt_every == 0 or step == loop_cfg.total_steps:
            store.save(step, train_state_tree(model, opt_state),
                       extra={"next_step": step})
            store.prune(loop_cfg.keep)

    return model, opt_state, {"history": history,
                              "stragglers": monitor.flagged}
