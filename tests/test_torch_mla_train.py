"""MLA training in the port (deepseek-v2-236b: ``models.attention.mla_train``
under autograd, the dense prefix, the stacked MLA + MoE body with its
shared experts, ``train.step``, the loop) against the JAX package, on the
CPU, in float32, from seeded numpy inputs.

The model is DEEPSEEK_SMOKE (3 layers: the dense first layer and 2 MoE
layers of 8 experts top-2 with one shared expert) with MLA at the card's
widths (``CARD_MLA``: queries and folded keys of qk_nope 128 + qk_rope 64
= 192, values of 128, over a latent of 32) and the JAX records' 2 heads,
at the published capacity factor 1.25.  On the CPU autograd
differentiates the plain streaming attention with the rope key expanded
into every head (its gradient sums over the heads), as ``jax.grad``
differentiates the reference's ``mla_train``; on the card the same graph
runs the flash kernels at (192, 128), forward and backward.

Tolerances, as ``tests/test_torch_moe_train.py``'s: max(1e-4, E), E the
largest move of the JAX value under eight draws that move every weight by
one ulp (``ONE_ULP_SEEDS``), taken only over the draws that keep the
case's drops; the drops of every MoE layer in the forward equal to JAX's
(counted once a forward: under remat both packages dispatch again where
the backward recomputes a layer).  Remat against no remat is held bit for
bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.torch_export_lm_moe_train_reference import forward_drops
from chip_smoke import _ForwardDrops, lm_train_record_check
from repro.configs import registry as jax_registry
from repro.models.transformer import MLAConfig as JaxMLAConfig
from repro.models.transformer import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import (
    LM_MLA_TRAIN_ASSET,
    from_jax_tree,
    lm_params_from,
    load_lm_mla_train_reference,
    numpy_lm_params,
    to_jax_tree,
)
from repro_torch.configs import registry
from repro_torch.configs.lm_archs import MLAConfig
from repro_torch.launch import train as train_cli
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.step import grads_of, make_train_step
from test_torch_lm_train import FLOOR, HELD, HELD_LR, ONE_ULP_SEEDS, one_ulp
from test_torch_lm_train import tokens
from test_torch_mla import CARD_MLA
from test_torch_moe_train import jax_counted

torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"
RECORD_HEADS = {"n_heads": 2, "n_kv": 2}      # the JAX MLA records' heads
SEQ, BATCH = 40, 2
# numpy_lm_params' seed: at the published factor the 2 x 40 batch drops
# 53 and 16 of each MoE layer's 160 assignments
WEIGHT_SEED = 0


def configs(factor=1.25, **over):
    """(JAX, port) DEEPSEEK_SMOKE in float32 at the card's MLA widths and
    the records' heads, capacity ``factor``."""
    jc = dataclasses.replace(jax_registry.get_config(ARCH, smoke=True),
                             param_dtype=jnp.float32,
                             mla=JaxMLAConfig(**CARD_MLA), **RECORD_HEADS,
                             **over)
    pc = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                             param_dtype=torch.float32,
                             mla=MLAConfig(**CARD_MLA), **RECORD_HEADS,
                             **over)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=factor))
    pc = dataclasses.replace(pc, moe=dataclasses.replace(
        pc.moe, capacity_factor=factor))
    return jc, pc


def n_moe(pc) -> int:
    return sum(kind[1] == "moe" for kind in Model(pc, "meta").kinds)


def at(tree, path):
    """The entry of a JAX tree path (dict keys, and the prefix list's
    indices) in a nested dict / list."""
    for k in path:
        tree = tree[k.idx if hasattr(k, "idx") else k.key]
    return tree


def leaf_rel(got, want):
    """Per leaf: max |got - want| / max |want|, over the JAX tree (the
    prefix is a list)."""
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = at(got, path)
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w, np.float64)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
    return out


# -- the loss a batch row at a time ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_cross_entropy_is_autograds_bits(dtype):
    """``Model.loss``'s cross-entropy, a batch row of float32 logits at a
    time forward and backward (``transformer._NextTokenCE``), against
    autograd of the whole-tensor form it replaces: loss and gradient bit
    for bit, in float32 and from bf16 logits."""
    from repro_torch.models.transformer import _NextTokenCE

    rng = np.random.default_rng(31)
    x = torch.tensor(4 * rng.standard_normal((3, 17, 50)),
                     dtype=torch.float32).to(dtype)
    tokens = torch.as_tensor(rng.integers(0, 50, (3, 17)))
    tgt = tokens[:, 1:].long()
    runs = []
    for rows in (True, False):
        logits = x.clone().requires_grad_(True)
        if rows:
            ce = _NextTokenCE.apply(logits, tgt)
        else:
            lg = logits[:, :-1].float()
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
            ce = (logz - gold).mean()
        (3.0 * ce).backward()
        runs.append((ce.detach(), logits.grad))
    (c1, g1), (c2, g2) = runs
    assert g1.dtype == dtype and float(g1.abs().max()) > 0
    assert torch.equal(c1, c2) and torch.equal(g1, g2)


# -- the model's loss and gradients -------------------------------------------


@pytest.fixture(scope="module")
def model_case():
    """JAX's loss (ce, aux), every gradient leaf and the forward's drops a
    MoE layer, 2 x 40 tokens, with each quantity's E over the draws that
    keep the drops."""
    jc, pc = configs()
    L = n_moe(pc)
    tree_np = numpy_lm_params(pc, WEIGHT_SEED)
    batch = {"tokens": jnp.asarray(tokens(pc.vocab, seq=SEQ, batch=BATCH))}
    vg = jax_counted(jax.value_and_grad(JaxModel(jc).loss, has_aux=True))
    ((loss, met), grads), log = vg(jax.tree_util.tree_map(jnp.asarray,
                                                         tree_np), batch)
    drops = forward_drops(log, L, jc.remat)
    want = {"loss": float(loss), "ce": float(met["ce"]),
            "aux": float(met["aux"])}
    e, kept, e_leaf = {k: 0.0 for k in want}, 0, {}
    for seed in ONE_ULP_SEEDS:
        ((ml, mm), mg), mlog = vg(one_ulp(tree_np, seed), batch)
        if forward_drops(mlog, L, jc.remat) != drops:
            continue
        kept += 1
        for k, v in (("loss", ml), ("ce", mm["ce"]), ("aux", mm["aux"])):
            e[k] = max(e[k], abs(float(v) - want[k]) / abs(want[k]))
        for k, v in leaf_rel(mg, grads).items():
            e_leaf[k] = max(e_leaf.get(k, 0.0), v)
    assert kept >= 4, kept
    return pc, tree_np, want, grads, drops, e, e_leaf


@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_jax(model_case, remat):
    """The loss with its ce and aux, and every gradient leaf: the
    embeddings, the dense prefix's MLA and SwiGLU, the stacked body's MLA,
    router, routed experts and shared experts, the norms and the
    unembedding."""
    pc, tree_np, want, grads, drops, e, e_leaf = model_case
    model = lm_params_from(tree_np, dataclasses.replace(pc, remat=remat),
                           "cpu")
    with _ForwardDrops(model) as counted:
        loss, metrics, got = grads_of(model, {"tokens": torch.as_tensor(
            tokens(pc.vocab, seq=SEQ, batch=BATCH))})
    assert counted.groups() == [drops] and sum(drops) > 0
    for k, v in (("loss", loss), ("ce", metrics["ce"]),
                 ("aux", metrics["aux"])):
        assert abs(float(v) - want[k]) / abs(want[k]) <= max(FLOOR, e[k]), k
    rel_leaf = leaf_rel(to_jax_tree(model, got), grads)
    assert rel_leaf.keys() == e_leaf.keys()
    for part in ("['prefix'][0]['mixer']['wkv_down']",
                 "['stack']['sub0']['mixer']['wk_up']",
                 "['stack']['sub0']['mlp']['router']",
                 "['stack']['sub0']['mlp']['shared']['w_gate']"):
        assert part in rel_leaf, part
    for k, r in rel_leaf.items():
        assert r <= max(FLOOR, e_leaf[k]), (remat, k, r, e_leaf[k])
    for n, g in got.items():
        assert float(g.abs().max()) > 0, n


def test_remat_gives_the_same_bits_and_drops():
    """The port with remat and without: the recompute routes and drops as
    the forward did, so loss, aux, every gradient and the drops are
    bit-equal."""
    _jc, pc = configs()
    tree_np = numpy_lm_params(pc, WEIGHT_SEED)
    batch = {"tokens": torch.as_tensor(tokens(pc.vocab, step=1, seq=SEQ,
                                              batch=BATCH))}
    runs = []
    for remat in (True, False):
        model = lm_params_from(tree_np, dataclasses.replace(pc, remat=remat),
                               "cpu")
        with _ForwardDrops(model) as counted:
            loss, metrics, got = grads_of(model, batch)
        runs.append((loss, metrics["aux"], got, counted.groups()))
    (l1, a1, g1, d1), (l2, a2, g2, d2) = runs
    assert sum(d1[0]) > 0 and d1 == d2
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    for n, g in g1.items():
        assert torch.equal(g, g2[n]), n


# -- train steps ------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jitted_jax(accum):
    """Three steps of the jitted JAX ``make_train_step``; before each the
    port takes JAX's parameters and state, so each step is held on its own:
    loss, aux and grad norm within max(1e-4, E), E over the draws that
    keep the step's drops; the lr bit for bit; every parameter within
    HELD_LR lr where JAX's gradient is above HELD of its leaf's largest
    and within 2 lr elsewhere (``tests/test_torch_lm_train.py``'s rule).
    At accum 2 each microbatch routes and drops on its own, in both
    packages."""
    jc, pc = configs()
    L = n_moe(pc)
    kw = dict(lr_peak=3e-3, warmup_steps=1, decay_steps=3)
    jm = JaxModel(jc)
    jstep = jax_counted(jax_make_train_step(jm, jax_opt.AdamWConfig(**kw),
                                            accum=accum))
    vg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    numpy_lm_params(pc, WEIGHT_SEED))
    state = jax_opt.init_opt_state(params)
    model = lm_params_from(numpy_lm_params(pc, WEIGHT_SEED), pc, "cpu")
    step_fn = make_train_step(model, opt.AdamWConfig(**kw), accum=accum)

    def micro_drops(log):
        n = len(log) // accum
        return [forward_drops(log[i * n:(i + 1) * n], L, jc.remat)
                for i in range(accum)]

    dropped = 0
    for t in range(3):
        batch = tokens(pc.vocab, step=t, seq=24, batch=4)
        jb = {"tokens": jnp.asarray(batch)}
        g = jax.tree_util.tree_map(lambda *gs: sum(gs) / accum, *(
            vg(params, {"tokens": jnp.asarray(mb)})[1]
            for mb in np.split(batch, accum)))
        (new_params, new_state, met), log = jstep(params, state, jb)
        drops = micro_drops(log)
        want = {k: float(met[k]) for k in ("loss", "aux", "grad_norm")}
        e, kept = {k: 0.0 for k in want}, 0
        for seed in ONE_ULP_SEEDS:
            moved = state._replace(master=one_ulp(state.master, seed))
            (_p, _s, m), mlog = jstep(one_ulp(params, seed), moved, jb)
            if micro_drops(mlog) != drops:
                continue
            kept += 1
            for k in want:
                e[k] = max(e[k], abs(float(m[k]) - want[k]) / abs(want[k]))
        assert kept >= 4, (t, kept)

        model.load_tree(params)
        mine = opt.OptState(
            step=torch.tensor(int(state.step), dtype=torch.int32),
            master=from_jax_tree(model, state.master),
            mu=from_jax_tree(model, state.mu),
            nu=from_jax_tree(model, state.nu))
        with _ForwardDrops(model) as counted:
            _state, got = step_fn(mine, {"tokens": torch.as_tensor(batch)})
        assert counted.groups() == drops, (t, drops)
        dropped += sum(map(sum, drops))
        for k in want:
            assert (abs(float(got[k]) - want[k]) / abs(want[k])
                    <= max(FLOOR, e[k])), (t, k)
        lr = np.float32(met["lr"])
        assert np.float32(got["lr"]) == lr
        now = to_jax_tree(model, model.named_leaves())
        for path, w in jax.tree_util.tree_flatten_with_path(new_params)[0]:
            p = at(now, path)
            w = np.asarray(w, np.float64)
            gp = np.abs(np.asarray(at(g, path)))
            held = gp > HELD * gp.max()
            diff = np.abs(p.numpy() - w) - 1e-6 * np.abs(w).max()
            assert (diff[held] <= HELD_LR * lr).all(), (t, path)
            assert (diff[~held] <= 2 * lr).all(), (t, path)
        params, state = new_params, new_state
    assert dropped > 0


def test_cli_trains_deepseek_on_the_cpu(tmp_path):
    out = train_cli.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                          "--steps", "3", "--global-batch", "4", "--seq",
                          "16", "--ckpt-every", "2", "--ckpt-dir",
                          str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])


# -- the JAX MLA training record ----------------------------------------------------


def test_mla_train_asset_is_small():
    """The record: DEEPSEEK_SMOKE at MLA's card widths, 2 heads, the dense
    prefix and 2 MoE layers at the published factor; 4 x 650 tokens a
    step (ragged against every tile)."""
    assert os.path.getsize(LM_MLA_TRAIN_ASSET) < 3_000_000
    rec = load_lm_mla_train_reference()
    cfg = rec.cfg
    assert cfg.mla == MLAConfig(**CARD_MLA) and cfg.n_heads == 2
    assert cfg.n_layers == 3 and cfg.first_dense == 1
    assert cfg.moe.capacity_factor == 1.25
    assert (rec.data["global_batch"], rec.data["seq"]) == (4, 650)
    assert rec.steps >= 3 and rec.drops.shape == (rec.steps, 2)
    assert rec.aux.shape == (rec.steps,) and (rec.aux > 0).all()
    assert any(n.startswith("prefix/0/") for n in rec.leaf_names)
    assert len(rec.sensitivity["aux"]) == rec.steps


def test_port_matches_the_mla_train_record():
    """What chip_smoke.py holds the card to (``lm_train_record_check``),
    on the CPU: the step-0 gradient of every leaf, each step's loss, ce,
    aux and grad norm within max(1e-4, E), the lr within an ulp, each
    step's drops equal."""
    rec = load_lm_mla_train_reference()
    r = lm_train_record_check(rec, "cpu")
    assert r["steps"] == rec.steps
    assert np.array_equal(r["drops"], rec.drops)
