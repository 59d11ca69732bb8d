"""The port's LM training slice (``repro_torch.data``, ``train``,
``launch.train``, ``Model.loss``) against the JAX package, on the CPU.

The same numpy inputs go through both packages: batches from
``batch_for_step``, weights from ``bridge.numpy_lm_params`` (the six
configs the port runs, their SMOKE variants in float32).  On the CPU
autograd differentiates the plain versions of the kernels, as JAX
differentiates the reference.

Tolerances, each with its reading:

* ``batch_for_step`` and the bias corrections ``1 - b ** step``: bit for
  bit.
* ``lr_schedule``: bit for bit in the warmup; in the cosine decay within
  one ulp, at no more than 1% of the steps (XLA's float32 cosine is its
  own polynomial; the port takes the float64 cosine rounded once and
  reads 5 of 901 steps an ulp off).
* ``adamw_update``: from the zero state, one step bit for bit (parameters,
  moments, grad norm, lr); over six steps the parameters within one ulp
  and the moments within MOMENT_REL of the leaf's largest entry (the
  global norm's float32 sum runs in another order and reads an ulp off at
  some steps, which moves the clip scale by ~1e-7).
* Loss and every gradient leaf against ``jax.value_and_grad(model.loss)``,
  leaf by leaf relative to the leaf's largest |g|, within max(1e-4, E),
  E the one-ulp sensitivity of the same quantity: the largest move of the
  JAX value under eight draws that move every weight by one ulp
  (ONE_ULP_SEEDS; a single draw varies by 5x: granite's gradients read
  2.9e-4 from JAX against single draws of 1.5e-4 to 7.2e-4).
* Train steps against the jitted JAX step, each from JAX's parameters and
  state: loss and grad norm within max(1e-4, E), E their one-ulp
  sensitivity at that step; lr bit for bit; parameters, beyond 1e-6 of the
  leaf's largest |p|, within HELD_LR lr where |g_jax| is above HELD of the
  leaf's largest (far above the gradient bound, so g's sign is sure;
  reading 0.011 lr) and within 2 lr elsewhere (Adam moves an entry by
  about lr sign(g), and sign(g) is noise where |g| is at the gradient
  bound).

The loop, the CLI and the JAX training record are in
tests/test_torch_lm_loop.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import pipeline as jax_pipeline
from repro.models.transformer import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step

from repro_torch.bridge import (
    from_jax_tree,
    leaf_layout,
    lm_params_from,
    numpy_lm_params,
    to_jax_tree,
)
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.train import optimizer as opt
from repro_torch.train.step import grads_of, make_train_step

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

RUNNABLE = ["yi-9b", "codeqwen1.5-7b", "phi3-medium-14b", "granite-34b",
            "chameleon-34b", "rwkv6-7b"]
FLOOR = 1e-4
ONE_ULP_SEEDS = tuple(range(5, 13))
MOMENT_REL = 1e-6
HELD, HELD_LR = 0.1, 0.05
SEQ, BATCH = 24, 2


def configs(arch):
    jc = dataclasses.replace(jax_registry.get_config(arch, smoke=True),
                             param_dtype=jnp.float32)
    pc = dataclasses.replace(registry.get_config(arch, smoke=True),
                             param_dtype=torch.float32)
    return jc, pc


def one_ulp(tree, seed):
    """Every weight moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(np.nextafter(a, np.where(
            rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(np.float32)))

    return jax.tree_util.tree_map(move, tree)


def leaf_rel(got, want):
    """Per leaf: max |got - want| / max |want|, over the JAX tree."""
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w, np.float64)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
    return out


def tokens(vocab, step=0, seq=SEQ, batch=BATCH):
    return batch_for_step(DataConfig(vocab, seq, batch, 0), step)["tokens"]


# -- data -----------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (256, 32, 8, 0, 0), (100, 17, 4, 3, 17), (64000, 65, 8, 0, 12345),
    (512, 650, 4, 0, 3)])
@pytest.mark.parametrize("host_count", [1, 2, 4])
def test_batch_for_step_equals_jax(vocab, seq, batch, seed, step, host_count):
    for host in range(host_count):
        got = batch_for_step(DataConfig(vocab, seq, batch, seed), step, host,
                             host_count)["tokens"]
        want = jax_pipeline.batch_for_step(
            jax_pipeline.DataConfig(vocab, seq, batch, seed), step, host,
            host_count)["tokens"]
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- optimizer --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(lr_peak=3e-3, warmup_steps=100, decay_steps=1000),
    dict(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10, decay_steps=100),
    dict(lr_peak=3e-3, warmup_steps=1, decay_steps=12), dict()])
def test_lr_schedule_equals_jitted_jax(kw):
    jc, pc = jax_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    f = jax.jit(lambda s: jax_opt.lr_schedule(jc, s))
    steps = np.arange(0, 1001, dtype=np.int32)
    want = np.array([np.asarray(f(jnp.int32(s))) for s in steps])
    got = opt.lr_schedule(pc, torch.as_tensor(steps)).numpy()
    warm = steps < pc.warmup_steps
    assert np.array_equal(got[warm], want[warm])
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 0.01


@pytest.mark.parametrize("b", [0.9, 0.95])
def test_bias_correction_equals_jitted_jax(b):
    f = jax.jit(lambda s: 1 - b ** s.astype(jnp.float32))
    steps = np.arange(1, 1001, dtype=np.int32)
    want = np.array([np.asarray(f(jnp.int32(s))) for s in steps])
    got = opt.bias_correction(b, torch.as_tensor(steps)).numpy()
    assert np.array_equal(got, want)


def _fixed_tree(rng):
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(33).astype(np.float32)}}


def test_adamw_update_equals_jitted_jax():
    rng = np.random.default_rng(0)
    tree = _fixed_tree(rng)
    kw = dict(lr_peak=3e-3, warmup_steps=3, decay_steps=20)
    jc, pc = jax_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    js = jax_opt.init_opt_state(jax.tree_util.tree_map(jnp.asarray, tree))
    flat = {"a": tree["a"], "b/c": tree["b"]["c"]}
    ps = opt.init_opt_state({n: torch.tensor(v) for n, v in flat.items()})
    upd = jax.jit(lambda g, s: jax_opt.adamw_update(jc, g, s,
                                                    param_dtype=jnp.float32))
    for step in range(6):
        g = {"a": rng.standard_normal((7, 5)).astype(np.float32) * 0.3,
             "b": {"c": rng.standard_normal(33).astype(np.float32) * 2}}
        jp, js, jm = upd(jax.tree_util.tree_map(jnp.asarray, g), js)
        pp, ps, pm = opt.adamw_update(
            pc, {"a": torch.tensor(g["a"]), "b/c": torch.tensor(g["b"]["c"])},
            ps, torch.float32)
        assert int(ps.step) == int(js.step) == step + 1
        assert np.float32(pm["lr"]) == np.float32(jm["lr"])
        for n, path in (("a", ("a",)), ("b/c", ("b", "c"))):
            def at(t):
                for k in path:
                    t = t[k]
                return np.asarray(t)
            got, want = pp[n].numpy(), at(jp)
            ulps = np.abs(got.view(np.int32) - want.view(np.int32))
            if step == 0:
                assert np.array_equal(got, want)
                assert np.array_equal(ps.mu[n].numpy(), at(js.mu))
                assert np.array_equal(ps.nu[n].numpy(), at(js.nu))
                assert np.float32(pm["grad_norm"]) == np.float32(
                    jm["grad_norm"])
            assert ulps.max() <= 1, (step, n)
            for mine, theirs in ((ps.mu[n], js.mu), (ps.nu[n], js.nu)):
                mine, theirs = mine.numpy(), at(theirs)
                assert (np.abs(mine - theirs).max()
                        <= MOMENT_REL * np.abs(theirs).max()), (step, n)


def test_adamw_descends_quadratic():
    """tests/test_train.py's quadratic, in the port."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init_opt_state(params)
    cfg = opt.AdamWConfig(lr_peak=0.1, warmup_steps=1, decay_steps=1000,
                          weight_decay=0.0)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.adamw_update(cfg, g, state,
                                            param_dtype=torch.float32)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


# -- loss and gradients ---------------------------------------------------------


@pytest.fixture(scope="module", params=RUNNABLE)
def jax_grads(request):
    """JAX's loss and gradient tree on the arch's smoke config, with the
    one-ulp sensitivity of the loss and of each leaf."""
    arch = request.param
    jc, pc = configs(arch)
    tree = numpy_lm_params(pc, 0)
    batch = {"tokens": jnp.asarray(tokens(pc.vocab))}
    vg = jax.jit(jax.value_and_grad(JaxModel(jc).loss, has_aux=True))
    (loss, _), grads = vg(jax.tree_util.tree_map(jnp.asarray, tree), batch)
    e_loss, e_leaf = 0.0, {}
    for seed in ONE_ULP_SEEDS:
        (ml, _), mg = vg(one_ulp(tree, seed), batch)
        e_loss = max(e_loss, abs(float(ml) - float(loss)) / abs(float(loss)))
        for k, v in leaf_rel(mg, grads).items():
            e_leaf[k] = max(e_leaf.get(k, 0.0), v)
    return arch, pc, tree, float(loss), grads, e_loss, e_leaf


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(jax_grads, remat):
    arch, pc, tree, loss, grads, e_loss, e_leaf = jax_grads
    model = lm_params_from(tree, dataclasses.replace(pc, remat=remat), "cpu")
    got_loss, metrics, got = grads_of(model, {"tokens": torch.as_tensor(
        tokens(pc.vocab))})
    assert float(metrics["aux"]) == 0.0
    assert float(metrics["ce"]) == float(got_loss)
    assert abs(float(got_loss) - loss) / abs(loss) <= max(FLOOR, e_loss)
    rel = leaf_rel(to_jax_tree(model, got), grads)
    assert rel.keys() == e_leaf.keys()
    for k, r in rel.items():
        assert r <= max(FLOOR, e_leaf[k]), (arch, k, r, e_leaf[k])


@pytest.mark.parametrize("arch", RUNNABLE)
def test_remat_gives_the_same_gradients(arch):
    _jc, pc = configs(arch)
    tree = numpy_lm_params(pc, 1)
    batch = {"tokens": torch.as_tensor(tokens(pc.vocab, step=1))}
    runs = []
    for remat in (True, False):
        model = lm_params_from(tree, dataclasses.replace(pc, remat=remat),
                               "cpu")
        runs.append(grads_of(model, batch))
    assert torch.equal(runs[0][0], runs[1][0])
    for n, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][n]), n


def test_serving_logits_keep_their_bits():
    """``logits`` (no autograd) is ``forward`` without the graph, and the
    parameters stay without ``requires_grad`` after a gradient."""
    _jc, pc = configs("yi-9b")
    model = lm_params_from(numpy_lm_params(pc, 0), pc, "cpu")
    toks = torch.as_tensor(tokens(pc.vocab))
    before = model.logits(toks)
    grads_of(model, {"tokens": toks})
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        assert torch.equal(model.forward(toks), before)
    assert torch.equal(model.logits(toks), before)


def test_jax_tree_round_trip():
    _jc, pc = configs("yi-9b")
    model = lm_params_from(numpy_lm_params(pc, 0), pc, "cpu")
    named = model.named_leaves()
    assert len(named) == len(list(model.parameters()))
    tree = to_jax_tree(model, named)
    back = from_jax_tree(model, tree)
    assert all(torch.equal(back[n], p) for n, p in named.items())
    paths = [p for p, _names in leaf_layout(model)]
    assert paths == [tuple(k.key for k in path) for path, _l in
                     jax.tree_util.tree_flatten_with_path(tree)[0]]


# -- the train step ------------------------------------------------------------


@pytest.mark.parametrize("arch,accum", [("yi-9b", 1), ("yi-9b", 2),
                                        ("rwkv6-7b", 1), ("rwkv6-7b", 2)])
def test_train_step_matches_jitted_jax(arch, accum):
    """Three steps; before each, the port takes JAX's parameters and
    optimizer state, so each step is held on its own."""
    jc, pc = configs(arch)
    kw = dict(lr_peak=3e-3, warmup_steps=1, decay_steps=3)
    jm = JaxModel(jc)
    jstep = jax.jit(jax_make_train_step(jm, jax_opt.AdamWConfig(**kw),
                                        accum=accum))
    vg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    params = jax.tree_util.tree_map(jnp.asarray, numpy_lm_params(pc, 0))
    state = jax_opt.init_opt_state(params)
    model = lm_params_from(numpy_lm_params(pc, 0), pc, "cpu")
    step_fn = make_train_step(model, opt.AdamWConfig(**kw), accum=accum)
    for t in range(3):
        batch = tokens(pc.vocab, step=t, batch=4)
        jb = {"tokens": jnp.asarray(batch)}
        _, g = vg(params, jb)
        new_params, new_state, met = jstep(params, state, jb)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        e_loss = e_norm = 0.0
        for seed in ONE_ULP_SEEDS:
            moved = state._replace(master=one_ulp(state.master, seed))
            _, _, m = jstep(one_ulp(params, seed), moved, jb)
            e_loss = max(e_loss, abs(float(m["loss"]) - loss) / abs(loss))
            e_norm = max(e_norm, abs(float(m["grad_norm"]) - gnorm) / gnorm)

        model.load_tree(params)
        mine = opt.OptState(
            step=torch.tensor(int(state.step), dtype=torch.int32),
            master=from_jax_tree(model, state.master),
            mu=from_jax_tree(model, state.mu),
            nu=from_jax_tree(model, state.nu))
        _state, got = step_fn(mine, {"tokens": torch.as_tensor(batch)})
        assert abs(float(got["loss"]) - loss) / abs(loss) <= max(FLOOR,
                                                                 e_loss)
        assert abs(float(got["grad_norm"]) - gnorm) / gnorm <= max(FLOOR,
                                                                   e_norm)
        lr = np.float32(met["lr"])
        assert np.float32(got["lr"]) == lr
        tree = to_jax_tree(model, model.named_leaves())
        for path, want in jax.tree_util.tree_flatten_with_path(new_params)[0]:
            gp, p = g, tree
            for k in path:
                gp, p = gp[k.key], p[k.key]
            want, gp = np.asarray(want, np.float64), np.abs(np.asarray(gp))
            held = gp > HELD * gp.max()
            diff = np.abs(p.numpy() - want) - 1e-6 * np.abs(want).max()
            assert (diff[held] <= HELD_LR * lr).all(), (t, path)
            assert (diff[~held] <= 2 * lr).all(), (t, path)
        params, state = new_params, new_state
