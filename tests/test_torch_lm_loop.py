"""The port's LM training loop (``repro_torch.train.loop``), its CLI
(``launch.train``) and the JAX training record, on the CPU.

* The tests/test_train.py loop rules: the loss falls by 0.15 over 120
  steps; a replay after an injected failure ends identically, here bit
  for bit (the CPU arithmetic repeats); a resume continues at the
  checkpoint's step.
* A loop checkpoint written by either package's ``train`` resumes in the
  other's; its next loss is within max(1e-4, E) of the writer's own next
  loss, E the one-ulp sensitivity of that loss (eight draws).
* ``assets/lm_train_reference.npz`` through ``chip_smoke``'s own
  ``lm_train_record_check``, the check the card makes: step-0 gradient
  leaf norms and probes, and each step's loss, ce and grad norm, within
  max(1e-4, E) of the record's E; lr within an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import Model as JaxModel
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step

from chip_smoke import lm_train_record_check
from repro_torch.bridge import load_lm_train_reference, numpy_lm_params
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import train as train_cli
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, train
from test_torch_lm_train import FLOOR, ONE_ULP_SEEDS, SEQ, configs, one_ulp

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


# -- the loop --------------------------------------------------------------------


def _loop_model(arch="yi-9b"):
    _jc, pc = configs(arch)
    model = Model(pc, "cpu")
    data = DataConfig(vocab=pc.vocab, seq=32, global_batch=8, seed=0)
    return model, train_cli.batches(data, "cpu")


def test_loss_decreases(tmp_path):
    model, make_batch = _loop_model()
    lc = LoopConfig(total_steps=120, ckpt_every=60, ckpt_dir=str(tmp_path))
    _, _, out = train(model, make_batch, lc,
                      opt.AdamWConfig(lr_peak=5e-3, warmup_steps=15,
                                      decay_steps=120), verbose=False)
    hist = out["history"]
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    assert last < first - 0.15, (first, last)


def test_failure_recovery_replays_identically(tmp_path):
    """Run A (no crash) and run B (crash at step 25, recovered from the
    checkpoint at 20) end with the same bits: the data is deterministic,
    the checkpoint holds the whole state and the CPU arithmetic repeats."""
    kw = dict(warmup_steps=5, decay_steps=40)

    def lc(d):
        return LoopConfig(total_steps=40, ckpt_every=10, ckpt_dir=d,
                          max_retries=2)

    model_a, make_batch = _loop_model()
    train(model_a, make_batch, lc(str(tmp_path / "a")), opt.AdamWConfig(**kw),
          verbose=False)
    crashed = {"done": False}

    def fail_hook(step):
        if step == 25 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    model_b, _ = _loop_model()
    _, _, out = train(model_b, make_batch, lc(str(tmp_path / "b")),
                      opt.AdamWConfig(**kw), fail_hook=fail_hook,
                      verbose=False)
    assert crashed["done"]
    steps = [h["step"] for h in out["history"]]
    assert steps == list(range(25)) + list(range(20, 40))
    first = {h["step"]: h["loss"] for h in out["history"][:25]}
    assert all(h["loss"] == first[h["step"]] for h in out["history"][25:30])
    for (n, a), b in zip(model_a.named_leaves().items(),
                         model_b.named_leaves().values()):
        assert torch.equal(a, b), n


def test_resume_from_checkpoint(tmp_path):
    d = str(tmp_path)
    model, make_batch = _loop_model()
    train(model, make_batch, LoopConfig(total_steps=20, ckpt_every=10,
                                        ckpt_dir=d), verbose=False)
    from repro_torch.ckpt.checkpoint import latest_step
    assert latest_step(d) == 20
    model, _ = _loop_model()
    _, _, out = train(model, make_batch,
                      LoopConfig(total_steps=30, ckpt_every=10, ckpt_dir=d),
                      verbose=False)
    steps = [h["step"] for h in out["history"]]
    assert steps[0] == 20 and steps[-1] == 29


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loop_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """A loop checkpoint written by one package's ``train`` at step 4
    resumes in the other's; its step-4 loss is within max(1e-4, E) of the
    writer's own step 4, E the one-ulp sensitivity of the JAX step-4 loss
    from that checkpoint."""
    arch = "yi-9b"
    jc, pc = configs(arch)
    tree = numpy_lm_params(pc, 0)
    data = DataConfig(vocab=pc.vocab, seq=SEQ, global_batch=4, seed=0)
    kw = dict(lr_peak=3e-3, warmup_steps=2, decay_steps=6)
    jm = JaxModel(jc)

    def jax_batch(s):
        return {"tokens": jnp.asarray(batch_for_step(data, s)["tokens"])}

    def jax_train(d, steps, params=None):
        return jax_loop.train(jm, jax_batch, jax_loop.LoopConfig(
            total_steps=steps, ckpt_every=4, ckpt_dir=d),
            jax_opt.AdamWConfig(**kw), params=params, verbose=False)

    def port_train(d, steps):
        model = Model(pc, "cpu")
        return train(model, train_cli.batches(data, "cpu"), LoopConfig(
            total_steps=steps, ckpt_every=4, ckpt_dir=d),
            opt.AdamWConfig(**kw), params=tree, verbose=False)

    def jtree():        # fresh arrays: JAX's train donates its inputs
        return jax.tree_util.tree_map(jnp.array, tree)

    d = str(tmp_path / "run")
    if writer == "jax":
        jax_train(d, 4, jtree())
        _, _, own = jax_train(str(tmp_path / "own"), 5, jtree())
        _, _, out = port_train(d, 5)
    else:
        port_train(d, 4)
        _, _, own = port_train(str(tmp_path / "own"), 5)
        _, _, out = jax_train(d, 5, jtree())
    assert [h["step"] for h in out["history"]] == [4]
    want = own["history"][4]["loss"]
    # E: JAX's step-4 loss from the checkpoint's state with every weight
    # and master weight moved by one ulp
    from repro.ckpt.checkpoint import restore_checkpoint
    like = (jtree(), jax_opt.init_opt_state(jtree()))
    (params, state), _ = restore_checkpoint(d, 4, like)
    step = jax.jit(jax_make_train_step(jm, jax_opt.AdamWConfig(**kw)))
    _, _, base = step(params, state, jax_batch(4))
    e = 0.0
    for seed in ONE_ULP_SEEDS:
        _, _, met = step(one_ulp(params, seed),
                         state._replace(master=one_ulp(state.master, seed)),
                         jax_batch(4))
        e = max(e, abs(float(met["loss"]) - float(base["loss"]))
                / abs(float(base["loss"])))
    got = out["history"][0]["loss"]
    assert abs(got - want) / abs(want) <= max(FLOOR, e), (got, want, e)


# -- the CLI and the record ------------------------------------------------------


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(["--device", "cpu", "--smoke", "--arch", "yi-9b",
                          "--steps", "4", "--global-batch", "4", "--seq",
                          "16", "--ckpt-every", "2", "--ckpt-dir",
                          str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    assert "[train] loss" in capsys.readouterr().out
    # resumes at the last checkpoint and has nothing left to do
    again = train_cli.main(["--device", "cpu", "--arch", "yi-9b", "--steps",
                            "4", "--global-batch", "4", "--seq", "16",
                            "--ckpt-dir", str(tmp_path)])
    assert again["history"] == []


@pytest.mark.parametrize("name", ["yi", "rwkv"])
def test_jax_training_record(name):
    """``assets/lm_train_reference.npz`` on the CPU port, through the check
    chip_smoke.py makes on the card."""
    rec = load_lm_train_reference()[name]
    readings = lm_train_record_check(rec, "cpu")
    assert readings["steps"] == rec.steps


def test_memory_checkpoints_replay_as_the_directory_does(tmp_path):
    """The loop with its checkpoints in host memory (what chip_smoke.py
    runs at full width) goes through the same steps and ends with the same
    bits as the loop with them on disk."""
    from chip_smoke import MemoryCheckpoints

    ends = []
    for store in (None, MemoryCheckpoints()):
        crashed = []

        def fail_hook(step):
            if step == 9 and not crashed:
                crashed.append(step)
                raise RuntimeError("injected node failure")

        model, make_batch = _loop_model("rwkv6-7b")
        _, _, out = train(model, make_batch,
                          LoopConfig(total_steps=12, ckpt_every=4, keep=1,
                                     ckpt_dir=str(tmp_path)),
                          opt.AdamWConfig(warmup_steps=2, decay_steps=12),
                          fail_hook=fail_hook, verbose=False, store=store)
        assert [h["step"] for h in out["history"]] == (list(range(9))
                                                       + [8, 9, 10, 11])
        ends.append((out["history"], model.named_leaves()))
    assert [h["loss"] for h in ends[0][0]] == [h["loss"] for h in ends[1][0]]
    for n, p in ends[0][1].items():
        assert torch.equal(p, ends[1][1][n]), n
