"""MoE training in the port (``repro_torch.models.moe`` under autograd,
``train.step``, ``train.optimizer``'s slices, the loop) against the JAX
package, on the CPU, in float32, from seeded numpy inputs.

The reference computes MoE outside any Pallas kernel, and so does the
port: autograd differentiates the router (softmax, top-k with ties to the
lower index, the top-k renormalisation), the balance loss (whose expert
counts carry no gradient, a one-hot there and a count here) and the
z-loss, the scatter into the (e * cap + 1, d) buffer (its overflow row
takes every dropped assignment and is cut off, so a dropped assignment
gets no gradient in either package), the float32 combine and the
experts' float32 gate and up sums, as ``jax.grad`` differentiates
``_moe_local``.

Tolerances: max(1e-4, E), E the largest move of the JAX value under
eight draws that move every input by one ulp (ONE_ULP_SEEDS), taken only
over the draws that keep the case's drops (a draw that drops otherwise
routes otherwise).  Drops are counted in the forward, once: under remat
both packages dispatch again where the backward recomputes a layer (the
port counts while ``Model.loss`` runs, ``chip_smoke._ForwardDrops``; JAX
takes a loss's first L ordered callbacks, its forward's).  Where a case
is bit-exact (remat against no remat, the sliced AdamW) it is held bit
for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.torch_export_lm_moe_reference import counting_drops
from benchmarks.torch_export_lm_moe_train_reference import forward_drops
from chip_smoke import (
    MemoryCheckpoints,
    _ForwardDrops,
    lm_train_record_check,
    train_flops,
)
from repro.configs import registry as jax_registry
from repro.models import moe as jmoe
from repro.models.transformer import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import (
    LM_MOE_TRAIN_ASSET,
    from_jax_tree,
    lm_params_from,
    load_lm_moe_train_reference,
    numpy_lm_params,
    to_jax_tree,
)
from repro_torch.configs import registry
from repro_torch.launch import train as train_cli
from repro_torch.models import moe
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.step import grads_of, make_train_step
from test_torch_lm_train import (
    FLOOR,
    HELD,
    HELD_LR,
    ONE_ULP_SEEDS,
    leaf_rel,
    one_ulp,
    tokens,
)
from test_torch_moe import moe_case, tree

torch.set_num_threads(1)

ARCH = "mixtral-8x22b"
# the JAX records' head shape: the card's flash kernel is built for
# d_head 64 and 128
RECORD_HEADS = {"n_heads": 6, "n_kv": 1, "d_head": 128}
SEQ, BATCH = 40, 2
# numpy_lm_params' seed for the model cases: at the published factor every
# batch of them drops assignments (at seed 0 the 2 x 40 batch drops none)
WEIGHT_SEED = 2
# one list for every JAX dispatch count of this file: a jitted function
# traced under ``counting_drops`` appends to the list it was traced with
JAX_LOG = []


def configs(factor, **over):
    """(JAX, port) MIXTRAL_SMOKE in float32 at capacity ``factor``."""
    jc = dataclasses.replace(jax_registry.get_config(ARCH, smoke=True),
                             param_dtype=jnp.float32, **over)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=factor))
    pc = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                             param_dtype=torch.float32, **over)
    pc = dataclasses.replace(pc, moe=dataclasses.replace(
        pc.moe, capacity_factor=factor))
    return jc, pc


def n_moe(pc) -> int:
    return sum(kind[1] == "moe" for kind in Model(pc, "meta").kinds)


def jax_counted(fn):
    """``fn`` jitted, each call's dispatches counted into JAX_LOG (the
    counting ``sort_dispatch`` is traced in at the first call): (its
    output, the counts)."""
    jitted = jax.jit(fn)

    def call(*args):
        JAX_LOG.clear()
        with counting_drops(JAX_LOG):
            out = jitted(*args)
        jax.effects_barrier()
        return out, list(JAX_LOG)
    return call


# -- moe_ffn ----------------------------------------------------------------------


def skewed_case(arch, factor):
    """``test_torch_moe.moe_case`` with one direction shared by every
    token, as a residual stream's mean: the router then favours some
    experts, and at 1.25 they overflow (8 and 16 of 96 assignments of
    mixtral's and deepseek's MoE drop; without it 0 and 1)."""
    jc, jm, pc, pm, p, x = moe_case(arch, factor)
    x = x + np.random.default_rng(23).standard_normal(
        x.shape[-1]).astype(np.float32)
    return jc, jm, pc, pm, p, x


def layer_drops(route, topk, dispatch, p, m, x):
    """Assignments dropped by a MoE layer on x, in one package."""
    xt = x.reshape(-1, x.shape[-1])
    _w, idx, _aux = route(p["router"], m, xt)
    cap = moe._capacity(xt.shape[0], m)
    keep = dispatch(xt, topk(idx), m.n_experts, cap)[2]
    return int((~np.asarray(keep)).sum())


@pytest.fixture(scope="module", params=[
    ("mixtral-8x22b", 1.25), ("mixtral-8x22b", 16.0),
    ("deepseek-v2-236b", 1.25), ("deepseek-v2-236b", 16.0)])
def ffn_case(request):
    """JAX's gradient of sum(y r) + aux through ``moe_ffn`` without a mesh
    with respect to x and every parameter (the shared experts included),
    the drops, and the gradient's one-ulp E a leaf."""
    arch, factor = request.param
    jc, jm, pc, pm, p, x = skewed_case(arch, factor)
    r = np.random.default_rng(17).standard_normal(x.shape, dtype=np.float32)

    def objective(params, xs):
        y, aux = jmoe.moe_ffn(params, jc, jm, xs)
        return jnp.sum(y * r) + aux

    vg = jax.jit(jax.value_and_grad(objective, argnums=(0, 1)))
    drops = layer_drops(jmoe.router_topk, jnp.asarray, jmoe.sort_dispatch,
                        tree(p, jnp.asarray), jm, jnp.asarray(x))
    val, (gp, gx) = vg(tree(p, jnp.asarray), jnp.asarray(x))
    want = {"params": gp, "x": gx}
    e, kept = {}, 0
    for seed in ONE_ULP_SEEDS:
        mp, mx = one_ulp(p, seed), one_ulp({"x": x}, seed + 100)["x"]
        if layer_drops(jmoe.router_topk, jnp.asarray, jmoe.sort_dispatch,
                       mp, jm, mx) != drops:
            continue
        kept += 1
        _v, (mgp, mgx) = vg(mp, mx)
        for k, v in leaf_rel({"params": mgp, "x": mgx}, want).items():
            e[k] = max(e.get(k, 0.0), v)
    assert kept >= 4, kept
    return arch, factor, pc, pm, p, x, r, float(val), want, drops, e


def test_moe_ffn_grads_match_jax(ffn_case):
    """The router, the experts, the shared experts (deepseek's) and the
    input, through the capacity drops at 1.25 and with none at 16."""
    arch, factor, pc, pm, p, x, r, val, want, drops, e = ffn_case
    tp = tree(p, lambda a: torch.tensor(a, requires_grad=True))
    tx = torch.tensor(x, requires_grad=True)
    assert layer_drops(moe.router_topk, torch.as_tensor, moe.sort_dispatch,
                       tp, pm, tx.detach()) == drops
    assert (drops > 0) if factor == 1.25 else (drops == 0)
    y, aux = moe.moe_ffn(tp, pc, pm, tx)
    obj = (y * torch.as_tensor(r)).sum() + aux
    obj.backward()
    assert abs(float(obj) - val) <= max(FLOOR, 1e-6) * abs(val)
    got = {"params": tree(tp, lambda t: t.grad), "x": tx.grad}
    if "shared" in p:
        assert float(got["params"]["shared"]["w_gate"].abs().max()) > 0
    for k, v in leaf_rel(got, want).items():
        assert v <= max(FLOOR, e[k]), (arch, factor, k, v, e[k])


def test_dropped_assignments_get_no_gradient():
    """The dispatch's gradient with respect to the tokens: the scatter's
    overflow row, which takes every dropped assignment, is cut off, so a
    token gets the gradient of its kept assignments alone (of a sum over
    the expert buffer, their count), in both packages alike."""
    _jc, jm, _pc, pm, p, x = skewed_case("mixtral-8x22b", 1.25)
    tp = tree(p, torch.as_tensor)
    xt = torch.tensor(x.reshape(-1, x.shape[-1]), requires_grad=True)
    _w, idx, _aux = moe.router_topk(tp["router"], pm, xt.detach())
    cap = moe._capacity(xt.shape[0], pm)
    expert_in, _slot, keep = moe.sort_dispatch(xt, idx, pm.n_experts, cap)
    assert (~keep).any()
    expert_in.sum().backward()
    kept = keep.sum(dim=1, keepdim=True).float().expand_as(xt)
    assert torch.equal(xt.grad, kept)
    want = jax.grad(lambda a: jnp.sum(jmoe.sort_dispatch(
        a, jnp.asarray(idx.numpy()), jm.n_experts, cap)[0]))(
            jnp.asarray(xt.detach().numpy()))
    assert np.array_equal(np.asarray(want), kept.numpy())


# -- the model's loss and gradients -------------------------------------------------


@pytest.fixture(scope="module", params=[1.25, 16.0])
def model_case(request):
    """JAX's loss (ce, aux), every gradient leaf and the forward's drops
    a MoE layer on MIXTRAL_SMOKE with the records' heads, 2 x 40 tokens,
    with each quantity's E over the draws that keep the drops."""
    factor = request.param
    jc, pc = configs(factor, **RECORD_HEADS)
    L = n_moe(pc)
    tree_np = numpy_lm_params(pc, WEIGHT_SEED)
    batch = {"tokens": jnp.asarray(tokens(pc.vocab, seq=SEQ, batch=BATCH))}
    vg = jax_counted(jax.value_and_grad(JaxModel(jc).loss, has_aux=True))
    ((loss, met), grads), log = vg(jax.tree_util.tree_map(jnp.asarray,
                                                         tree_np), batch)
    drops = forward_drops(log, L, jc.remat)
    want = {"loss": float(loss), "ce": float(met["ce"]),
            "aux": float(met["aux"])}
    e, kept = {k: 0.0 for k in want}, 0
    e_leaf = {}
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
    return factor, pc, tree_np, want, grads, drops, e, e_leaf


@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_jax(model_case, remat):
    factor, pc, tree_np, want, grads, drops, e, e_leaf = model_case
    model = lm_params_from(tree_np, dataclasses.replace(pc, remat=remat),
                           "cpu")
    with _ForwardDrops(model) as counted:
        loss, metrics, got = grads_of(model, {"tokens": torch.as_tensor(
            tokens(pc.vocab, seq=SEQ, batch=BATCH))})
    assert counted.groups() == [drops]
    assert (sum(drops) > 0) if factor == 1.25 else (sum(drops) == 0)
    for k, v in (("loss", loss), ("ce", metrics["ce"]),
                 ("aux", metrics["aux"])):
        assert abs(float(v) - want[k]) / abs(want[k]) <= max(FLOOR, e[k]), k
    rel_leaf = leaf_rel(to_jax_tree(model, got), grads)
    assert rel_leaf.keys() == e_leaf.keys()
    for k, r in rel_leaf.items():
        assert r <= max(FLOOR, e_leaf[k]), (factor, remat, k, r, e_leaf[k])
    for n, g in got.items():
        assert float(g.abs().max()) > 0, n


def test_remat_gives_the_same_bits_and_drops():
    """The port with remat and without, at the published factor: the
    recompute routes and drops as the forward did, so loss, aux, every
    gradient and the drops are bit-equal."""
    _jc, pc = configs(1.25, **RECORD_HEADS)
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


# -- train steps --------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jitted_jax(accum):
    """Three steps of the jitted JAX ``make_train_step`` on MIXTRAL_SMOKE
    with the records' heads at the published factor; before each the port
    takes JAX's parameters and state, so each step is held on its own, as
    ``tests/test_torch_lm_train.py`` holds the dense configs.  At accum 2
    each microbatch routes and drops on its own, in both packages: the
    drops of each microbatch's forward are equal."""
    jc, pc = configs(1.25, **RECORD_HEADS)
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
        # the step's gradient, which sets which entries are held: the mean
        # of the microbatches' (each routes with its own capacity)
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
            gp, p = g, now
            for k in path:
                gp, p = gp[k.key], p[k.key]
            w, gp = np.asarray(w, np.float64), np.abs(np.asarray(gp))
            held = gp > HELD * gp.max()
            diff = np.abs(p.numpy() - w) - 1e-6 * np.abs(w).max()
            assert (diff[held] <= HELD_LR * lr).all(), (t, path)
            assert (diff[~held] <= 2 * lr).all(), (t, path)
        params, state = new_params, new_state
    assert dropped > 0


# -- AdamW in slices ------------------------------------------------------------------


@pytest.mark.parametrize("write_out", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sliced_adamw_is_the_whole_leaf_update(monkeypatch, dtype,
                                               write_out):
    """``adamw_update`` with its slice patched to 7 elements (every leaf
    cut, most raggedly) against the whole-leaf update, four steps from
    the same state: parameters, master and moments bit for bit."""
    rng = np.random.default_rng(2)
    shapes = {"a": (7, 5), "b": (33,), "c": (3, 11, 13), "d": (7,),
              "e": (1,)}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    grads = [{n: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2))
              .astype(np.float32) for n, s in shapes.items()}
             for _ in range(4)]
    cfg = opt.AdamWConfig(lr_peak=3e-3, warmup_steps=2, decay_steps=10)
    ends = []
    for size in (1 << 30, 7):
        monkeypatch.setattr(opt, "SLICE", size)
        params = {n: torch.tensor(v).to(dtype) for n, v in init.items()}
        state = opt.init_opt_state(params)
        for g in grads:
            new, state, met = opt.adamw_update(
                cfg, {n: torch.tensor(v).to(dtype) for n, v in g.items()},
                state, dtype, out=params if write_out else None)
            if not write_out:
                params = {n: t.clone() for n, t in new.items()}
        ends.append((params, state, met))
    (p1, s1, m1), (p2, s2, m2) = ends
    words = {torch.bfloat16: torch.int16, torch.float32: torch.int32}

    def same(a, b):
        return torch.equal(a.view(words[a.dtype]), b.view(words[b.dtype]))

    assert int(s1.step) == int(s2.step) == 4
    assert same(m1["grad_norm"], m2["grad_norm"]) and same(m1["lr"],
                                                           m2["lr"])
    for n in shapes:
        assert same(p1[n], p2[n]), n
        for a, b in ((s1.master, s2.master), (s1.mu, s2.mu),
                     (s1.nu, s2.nu)):
            assert same(a[n], b[n]), n


# -- chip_smoke's accounting ------------------------------------------------------------


# the counts of the training runs as they stood before MoE training: the
# six-N rule over all parameters, which is the active count of a model
# without routed experts
DENSE_FLOPS = {"yi-9b": (8, 2048, 8, 194211307585536.0),
               "rwkv6-7b": (8, 2048, 8, 225789383540736.0),
               "whisper-medium": (None, 448, 8, 41247788630016.0)}


@pytest.mark.parametrize("arch", sorted(DENSE_FLOPS) + [ARCH,
                                                         "deepseek-v2-236b"])
def test_train_flops_counts_active_parameters(arch):
    """``train_flops`` on the meta device: yi's, rwkv's and whisper's at
    their training runs' sizes as before; mixtral's (1 layer, 8 x 2048)
    6 x ``n_active_params`` a token (the reference's count, 1,094,780,928
    of 2,906,720,256 parameters) plus causal attention; deepseek's (1
    layer: the dense MLA prefix, 1,466,777,088 parameters, all active) with
    MLA's products at their own widths, 2 s t (qk_nope + qk_rope) for the
    logits and 2 s t v_dim for P V a head (192 and 128: d_head's 2 s t 128
    twice would count 0.8 of it)."""
    cfg = registry.get_config(arch)
    layers, seq, batch, want = DENSE_FLOPS.get(arch, (1, 2048, 8, None))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, device="meta")
    got = train_flops(cfg, model, batch, seq)
    if want is not None:
        assert got == want
        return
    pairs = seq * (seq + 1) // 2 * cfg.n_layers
    if cfg.attn_type == "mla":
        assert model.n_active_params() == model.n_params() == 1_466_777_088
        attention = 3 * 2 * batch * cfg.n_heads * (192 + 128) * pairs
        assert got == 6.0 * model.n_active_params() * batch * seq + attention
        assert got == 148_315_236_728_832.0
        return
    assert model.n_active_params() == 1_094_780_928
    assert model.n_params() == 2_906_720_256
    attention = (3 * 4 * batch * cfg.n_heads * cfg.d_head
                 * seq * (seq + 1) // 2 * cfg.n_layers)
    assert got == 6.0 * model.n_active_params() * batch * seq + attention


def test_memory_checkpoints_hold_one_checkpoint():
    """A second save drops the first before it copies (into the first's
    arrays); the store restores the second."""
    from repro_torch.bridge import train_state_tree

    _jc, pc = configs(1.25)
    pc = dataclasses.replace(pc, param_dtype=torch.bfloat16)
    model = Model(pc, "cpu")
    model.init(torch.Generator().manual_seed(0))
    state = opt.init_opt_state(model.named_leaves())
    store = MemoryCheckpoints()
    store.save(4, train_state_tree(model, state), extra={"next_step": 4})
    first = {n: a for n, a in store._saved[4][0].items()}
    before = {n: p.clone() for n, p in model.named_leaves().items()}
    for p in model.named_leaves().values():
        p.add_(1)
    store.save(6, train_state_tree(model, state), extra={"next_step": 6})
    assert list(store._saved) == [6] and store.latest_step() == 6
    leaves = store._saved[6][0]
    assert any(leaves[n] is a for n, a in first.items() if a.ndim > 0)
    for p in model.named_leaves().values():
        p.zero_()
    _tree, extra = store.restore(6, train_state_tree(model, state))
    assert extra == {"next_step": 6}
    for n, p in model.named_leaves().items():
        assert torch.equal(p, before[n] + 1), n


def test_cli_trains_mixtral_on_the_cpu(tmp_path):
    out = train_cli.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                          "--steps", "3", "--global-batch", "4", "--seq",
                          "16", "--ckpt-every", "2", "--ckpt-dir",
                          str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])


# -- the JAX training record --------------------------------------------------------------


def test_moe_train_asset_is_small():
    assert os.path.getsize(LM_MOE_TRAIN_ASSET) < 3_000_000
    rec = load_lm_moe_train_reference()
    assert rec.cfg.moe.capacity_factor == 1.25 and rec.cfg.window == 16
    assert (rec.cfg.n_heads, rec.cfg.n_kv, rec.cfg.d_head) == (6, 1, 128)
    assert rec.steps >= 3 and rec.drops.shape == (rec.steps, 4)
    assert rec.aux.shape == (rec.steps,) and (rec.aux > 0).all()
    assert len(rec.sensitivity["aux"]) == rec.steps


def test_port_matches_the_moe_train_record():
    """What chip_smoke.py holds the card to (``lm_train_record_check``),
    on the CPU: the step-0 gradient of every leaf, each step's loss, ce,
    aux and grad norm within max(1e-4, E), the lr within an ulp, each
    step's drops equal."""
    rec = load_lm_moe_train_reference()
    r = lm_train_record_check(rec, "cpu")
    assert r["steps"] == rec.steps
    assert np.array_equal(r["drops"], rec.drops)


def test_mm32_backward_is_autograd_of_the_float32_product(monkeypatch):
    """The card's bf16 expert product with a float32 output has no
    derivative in PyTorch; ``_MM32``'s backward (the float32 cotangent
    times the other operand in float32, rounded to its dtype: JAX's
    transpose of ``dot_general`` with ``preferred_element_type=float32``)
    gives, bit for bit, what autograd of the CPU route ``a.float() @
    b.float()`` gives.  The card's forward is stood in for by the CPU
    route's, which the CPU cannot run."""
    monkeypatch.setattr(moe, "_mm_f32_out", lambda a, b: a.float() @ b.float())
    rng = np.random.default_rng(8)
    a0, b0 = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32))
              .bfloat16() for s in ((12, 32), (32, 48)))
    probe = torch.as_tensor(rng.standard_normal((12, 48), dtype=np.float32))
    grads = []
    for route in (moe._MM32.apply, lambda a, b: a.float() @ b.float()):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        out = route(a, b)
        assert out.dtype == torch.float32
        (torch.nn.functional.silu(out) * probe).sum().backward()
        grads.append((a.grad, b.grad))
    for mine, plain in zip(*grads):
        assert mine.dtype == torch.bfloat16 and torch.equal(mine, plain)
