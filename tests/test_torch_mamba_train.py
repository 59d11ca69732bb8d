"""Mamba training in the port (jamba-v0.1-52b: ``models.ssm._mamba_scan``
under autograd, a checkpoint a chunk, in the hybrid model with its MoE and
attention layers, ``train.step``) against the JAX package, on the CPU, in
float32, from seeded numpy inputs.

* The checkpointed scan: loss and every input's gradient bit-equal to
  autograd through the same chunks without checkpoints, and to the
  earlier form that read each step by a select; across chunk sizes every
  gradient but A's bit-equal, A's (a sum over b and t, summed a chunk at a
  time) within a float32 summation bound; the bytes autograd keeps for
  the backward below one (b, s, d_inner, d_state) float32 tensor; without
  grad no checkpoint is taken.
* JAMBA_SMOKE with MoE at the hybrid record's widths (d_head 128 over 4
  query and 2 KV heads, d_state 16): ``Model.loss`` and every gradient
  leaf against ``jax.value_and_grad`` at capacity factors 1.25 and 16,
  several chunks a scan with a ragged last one (``MAMBA_CHUNK_BYTES``
  lowered by monkeypatch); remat on and off bit-equal; three train steps
  against the jitted JAX step at accum 1 and 2.
* ``assets/lm_hybrid_train_reference.npz`` through chip_smoke's
  ``lm_train_record_check``; ``train_flops``'s attention term.

Tolerances, as ``tests/test_torch_moe_train.py``'s: max(1e-4, E), E the
largest move of the JAX value under eight draws that move every weight by
one ulp (``ONE_ULP_SEEDS``), taken only over the draws that keep the
case's drops; the drops of every MoE layer in the forward equal to JAX's
(counted once a forward, ``chip_smoke._ForwardDrops``; JAX's first L
ordered callbacks of a loss).

XLA on the CPU flushes subnormal floats to zero, inputs and results; the
port's CPU arithmetic does so too in this file (``torch.set_flush_denormal``,
restored after it).  The random-weight attention's probabilities hold
many subnormal entries, on which the CPU's products and exps run up to
100 times slower.
"""

import dataclasses
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.torch_export_lm_moe_train_reference import forward_drops
from chip_smoke import (
    _ForwardDrops,
    lm_train_record_check,
    scan_selects,
    train_flops,
)
from repro.configs import registry as jax_registry
from repro.models import ssm as jssm
from repro.models.transformer import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import (
    LM_HYBRID_TRAIN_ASSET,
    from_jax_tree,
    lm_params_from,
    load_lm_hybrid_train_reference,
    numpy_lm_params,
    to_jax_tree,
)
from repro_torch.configs import registry
from repro_torch.configs.lm_archs import MambaConfig
from repro_torch.models import ssm
from repro_torch.models.transformer import Model, layer_kinds
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
from test_torch_mamba import MAMBA16, scan_inputs
from test_torch_moe_train import jax_counted

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
RECORD_OVER = {"d_head": 128}       # the hybrid records' heads: 4 / 2 of 128
SEQ, BATCH = 24, 2
# numpy_lm_params' seed: at the published factor the 2 x 24 batch drops
# 2 of layer 5's 48 assignments
WEIGHT_SEED = 3
# the scan's chunk in the model cases: 7 steps at 2 requests of d_inner
# 128 and d_state 16 (24 = 3 x 7 + 3)
CHUNK_BYTES = 7 * 4 * BATCH * 128 * 16
STEP_OPT = dict(lr_peak=3e-3, warmup_steps=1, decay_steps=3)


@pytest.fixture(scope="module", autouse=True)
def flush_subnormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def configs(factor):
    """(JAX, port) JAMBA_SMOKE in float32 at the records' widths, capacity
    ``factor``."""
    jc = dataclasses.replace(jax_registry.get_config(ARCH, smoke=True),
                             param_dtype=jnp.float32,
                             mamba=jssm.MambaConfig(**MAMBA16), **RECORD_OVER)
    pc = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                             param_dtype=torch.float32,
                             mamba=MambaConfig(**MAMBA16), **RECORD_OVER)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=factor))
    pc = dataclasses.replace(pc, moe=dataclasses.replace(
        pc.moe, capacity_factor=factor))
    return jc, pc


def n_moe(pc) -> int:
    return sum(kind[1] == "moe" for kind in layer_kinds(pc))


# each jitted JAX function once in this module: (kind, factor, accum) ->
# the counted function
_JAX = {}


def jax_fn(kind, factor, accum=1):
    key = (kind, factor, accum)
    if key not in _JAX:
        jc, _pc = configs(factor)
        jm = JaxModel(jc)
        _JAX[key] = jax_counted(
            jax.value_and_grad(jm.loss, has_aux=True) if kind == "vg" else
            jax_make_train_step(jm, jax_opt.AdamWConfig(**STEP_OPT),
                                accum=accum))
    return _JAX[key]


# -- the scan under autograd -----------------------------------------------------


def chunks_plain(delta, A, B, xc, C, h0, chunk):
    """The scan's chunks (``ssm._scan_chunk``) without checkpoints."""
    h, ys = h0, []
    for t0 in range(0, delta.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        y, h = ssm._scan_chunk(h, delta[:, sl], A, B[:, sl], xc[:, sl],
                               C[:, sl])
        ys.append(y)
    return torch.cat(ys, 1), h


def scan_grads(form, arrays, chunk, seed=11):
    """Loss y . P + h_s . Q (P, Q drawn) through ``form`` and the gradients
    of delta, A, B, xc, C and h0; the bytes autograd saved for the
    backward (``saved_tensors_hooks``, views at their own size)."""
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    rng = np.random.default_rng(seed)
    b, s, di = arrays[0].shape
    P = torch.as_tensor(rng.standard_normal((b, s, di), dtype=np.float32))
    Q = torch.as_tensor(rng.standard_normal(arrays[-1].shape,
                                            dtype=np.float32))
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, h = form(*xs, chunk)
    loss = (y * P).sum() + (h * Q).sum()
    loss.backward()
    return loss.detach(), [x.grad for x in xs], saved[0]


@pytest.fixture(scope="module")
def scan_arrays():
    return scan_inputs(2, 20, 32, 16, seed=12)


@pytest.mark.parametrize("chunk", [1, 7, 20])
def test_checkpointed_scan_is_autograds_bits(scan_arrays, chunk):
    """At chunk 1, a ragged chunk (7 of 20 steps) and the whole length:
    the loss and the gradients of delta, A, B, xc, C and h0 through the
    checkpointed scan equal, under ``torch.equal``, those through the same
    chunks without checkpoints, and those of the select form."""
    loss, grads, _ = scan_grads(ssm._mamba_scan, scan_arrays, chunk)
    for form in (chunks_plain, scan_selects):
        l2, g2, _ = scan_grads(form, scan_arrays, chunk)
        assert torch.equal(loss, l2), form.__name__
        for name, a, b in zip(("delta", "A", "B", "xc", "C", "h0"), grads,
                              g2):
            assert float(a.abs().max()) > 0, name
            assert torch.equal(a, b), (form.__name__, name)


def a_terms_abs_sum(arrays, seed=11):
    """Sum over b and t of the absolute terms of A's gradient, in float64:
    the gradient of an A given a copy at every (b, t)."""
    delta, A, B, xc, C, h0 = (torch.tensor(a, dtype=torch.float64)
                              for a in arrays)
    b, s, di = delta.shape
    A_all = A.expand(b, s, *A.shape).clone().requires_grad_()
    rng = np.random.default_rng(seed)
    P = torch.as_tensor(rng.standard_normal((b, s, di), dtype=np.float32))
    Q = torch.as_tensor(rng.standard_normal(h0.shape, dtype=np.float32))
    y, h = ssm._scan_chunk(h0, delta, A_all, B, xc, C)
    ((y * P.double()).sum() + (h * Q.double()).sum()).backward()
    return A_all.grad.abs().sum(dim=(0, 1))


@pytest.mark.parametrize("chunk", [1, 7])
def test_only_a_gradient_depends_on_the_chunk(scan_arrays, chunk):
    """Against one chunk of the whole length: every gradient but A's
    bit-equal (each is per (b, t), or per (b, t, d) summed over d_state or
    d_inner); A's, a sum of N = b s terms taken a chunk at a time, within
    twice float32's recursive-summation bound, 2 (N - 1) 2^-24 sum |term|,
    and not bit-equal here."""
    _l, whole, _ = scan_grads(ssm._mamba_scan, scan_arrays, 20)
    _l, got, _ = scan_grads(ssm._mamba_scan, scan_arrays, chunk)
    for name, a, b in zip(("delta", "B", "xc", "C", "h0"),
                          got[:1] + got[2:], whole[:1] + whole[2:]):
        assert torch.equal(a, b), name
    b, s = scan_arrays[0].shape[:2]
    bound = 2 * (b * s - 1) * 2.0 ** -24 * a_terms_abs_sum(scan_arrays)
    diff = (got[1].double() - whole[1].double()).abs()
    assert (diff <= bound).all()
    assert float(diff.max()) > 0


@pytest.mark.parametrize("b,s,di,n,chunk", [(2, 64, 32, 4, 16),
                                            (2, 64, 32, 16, 16)])
def test_scan_keeps_less_than_one_state_tensor(b, s, di, n, chunk):
    """The bytes autograd keeps for the scan's backward: below one (b, s,
    d_inner, d_state) float32 tensor (the chunk-start states, A, and views
    of delta, B, xc and C); the select form kept more than four."""
    arrays = scan_inputs(b, s, di, n, seed=13)
    one = 4 * b * s * di * n
    _l, _g, kept = scan_grads(ssm._mamba_scan, arrays, chunk)
    _l, _g, before = scan_grads(scan_selects, arrays, chunk)
    assert kept < one, kept / one
    assert before > 4 * one, before / one


def test_no_checkpoint_without_grad(monkeypatch, scan_arrays):
    """Serving's path: without grad, and with inputs that need none, the
    scan takes no checkpoint, and gives the chunks' own bits."""
    def refuse(*a, **kw):
        raise AssertionError("checkpoint taken")

    monkeypatch.setattr(ssm, "checkpoint", refuse)
    args = [torch.as_tensor(a) for a in scan_arrays]
    y, h = ssm._mamba_scan(*args, chunk=7)
    with torch.no_grad():
        grad_args = [a.clone().requires_grad_() for a in args]
        y2, h2 = ssm._mamba_scan(*grad_args, chunk=7)
    y3, h3 = chunks_plain(*args, 7)
    assert torch.equal(y, y3) and torch.equal(h, h3)
    assert torch.equal(y2, y3) and torch.equal(h2, h3)


# -- the JAX hybrid training record ---------------------------------------------------


def test_hybrid_train_asset_is_small():
    """The record: JAMBA_SMOKE at the card's flash pair (d_head 128, 4 / 2
    heads) and d_state 16, 8 layers (attention at 2 and 6, MoE on the odd
    layers) at the published factor; 4 x 650 tokens a step (ragged
    against every tile and chunk), four steps at a peak lr of 3e-6."""
    assert os.path.getsize(LM_HYBRID_TRAIN_ASSET) < 100_000
    rec = load_lm_hybrid_train_reference()
    cfg = rec.cfg
    assert cfg.d_head == 128 and (cfg.n_heads, cfg.n_kv) == (4, 2)
    assert cfg.mamba == MambaConfig(**MAMBA16)
    assert [k[0] for k in layer_kinds(cfg)] == [
        "mamba", "mamba", "attn", "mamba"] * 2
    assert cfg.moe.capacity_factor == 1.25
    assert (rec.data["global_batch"], rec.data["seq"]) == (4, 650)
    assert rec.steps == 4 and rec.drops.shape == (4, 4)
    assert rec.opt["lr_peak"] == 3e-6
    assert rec.aux.shape == (4,) and (rec.aux > 0).all()
    assert any(n.endswith("/A_log") for n in rec.leaf_names)
    assert max(rec.sensitivity["grad_norm"]) < 1e-2


def record_check(_key):
    """chip_smoke's ``lm_train_record_check`` of the record on the CPU
    (a child's job) -> (steps, drops)."""
    torch.set_flush_denormal(True)
    r = lm_train_record_check(load_lm_hybrid_train_reference(), "cpu")
    return r["steps"], r["drops"]


def test_port_matches_the_hybrid_train_record(spawned):
    """What chip_smoke.py holds the card to (``lm_train_record_check``),
    on the CPU: the step-0 gradient of every leaf, each step's loss, ce,
    aux and grad norm within max(1e-4, E), the lr within an ulp, each
    step's drops equal."""
    rec = load_lm_hybrid_train_reference()
    steps, drops = spawned("record", None)
    assert steps == rec.steps
    assert np.array_equal(drops, rec.drops)


# -- chip_smoke's accounting -------------------------------------------------------


@pytest.mark.parametrize("layers", [1, 5])
def test_train_flops_counts_attention_layers_only(layers):
    """``train_flops`` of jamba's training run (8 x 2048) on the meta
    device: at 1 layer (Mamba, 818,352,416 parameters) 6 N a token and no
    attention term; at 5 layers the attention term of layer 4 alone, 3 x
    2 x 2 s t d_head a head over the causal pairs."""
    batch, seq = 8, 2048
    cfg = dataclasses.replace(registry.get_config(ARCH), n_layers=layers)
    model = Model(cfg, device="meta")
    dense = 6.0 * model.n_active_params() * batch * seq
    got = train_flops(cfg, model, batch, seq)
    if layers == 1:
        assert model.n_params() == 818_352_416
        assert got == dense
        return
    assert [k[0] for k in layer_kinds(cfg)].count("attn") == 1
    attention = (3 * 2 * batch * cfg.n_heads * 2 * cfg.d_head
                 * seq * (seq + 1) // 2)
    assert got == dense + attention


# -- the jobs of child processes --------------------------------------------------------


def jax_model_case(factor):
    """JAX's loss (ce, aux), every gradient leaf and the forward's drops a
    MoE layer, 2 x 24 tokens, with each quantity's E over the draws that
    keep the drops (numpy trees)."""
    _jc, pc = configs(factor)
    L = n_moe(pc)
    tree_np = numpy_lm_params(pc, WEIGHT_SEED)
    batch = {"tokens": jnp.asarray(tokens(pc.vocab, seq=SEQ, batch=BATCH))}
    vg = jax_fn("vg", factor)
    ((loss, met), grads), log = vg(jax.tree_util.tree_map(jnp.asarray,
                                                         tree_np), batch)
    drops = forward_drops(log, L, pc.remat)
    want = {"loss": float(loss), "ce": float(met["ce"]),
            "aux": float(met["aux"])}
    e, kept, e_leaf = {k: 0.0 for k in want}, 0, {}
    for seed in ONE_ULP_SEEDS:
        ((ml, mm), mg), mlog = vg(one_ulp(tree_np, seed), batch)
        if forward_drops(mlog, L, pc.remat) != drops:
            continue
        kept += 1
        for k, v in (("loss", ml), ("ce", mm["ce"]), ("aux", mm["aux"])):
            e[k] = max(e[k], abs(float(v) - want[k]) / abs(want[k]))
        for k, v in leaf_rel(mg, grads).items():
            e_leaf[k] = max(e_leaf.get(k, 0.0), v)
    return dict(want=want, grads=jax.tree_util.tree_map(np.asarray, grads),
                drops=drops, e=e, e_leaf=e_leaf, kept=kept)


def jax_train_steps(accum):
    """Three steps of the jitted JAX ``make_train_step`` at the published
    factor from ``numpy_lm_params``' weights, on batches of 2 requests a
    microbatch: per step the batch, the parameters and state before it,
    JAX's gradient (the microbatches' mean), the new parameters, the
    metrics, each microbatch's drops and E over the draws that keep
    them (numpy trees)."""
    _jc, pc = configs(1.25)
    L = n_moe(pc)
    jstep = jax_fn("step", 1.25, accum)
    vg = jax_fn("vg", 1.25)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    numpy_lm_params(pc, WEIGHT_SEED))
    state = jax_opt.init_opt_state(params)

    def micro_drops(log):
        n = len(log) // accum
        return [forward_drops(log[i * n:(i + 1) * n], L, pc.remat)
                for i in range(accum)]

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    steps = []
    for t in range(3):
        batch = tokens(pc.vocab, step=t, seq=SEQ, batch=BATCH * accum)
        jb = {"tokens": jnp.asarray(batch)}
        g = jax.tree_util.tree_map(lambda *gs: sum(gs) / accum, *(
            vg(params, {"tokens": jnp.asarray(mb)})[0][1]
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
        steps.append(dict(
            batch=batch, params=host(params), state=host(state._asdict()),
            g=host(g), new_params=host(new_params), want=want,
            lr=np.float32(met["lr"]), drops=drops, e=e, kept=kept))
        params, state = new_params, new_state
    return steps


def child_job(kind, key):
    """One child's share: the model case at factor ``key`` ("case"), the
    train steps at accum ``key`` ("steps") or the record ("record")."""
    return {"case": jax_model_case, "steps": jax_train_steps,
            "record": record_check}[kind](key)


JOBS = (("record", None), ("case", 1.25), ("case", 16.0), ("steps", 1),
        ("steps", 2))


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """The JAX side of the model cases and train steps, which does not
    depend on the port, and the port's record check: computed in spawned
    processes, one a job (each jits its JAX functions once), while the
    other tests run.  -> ``get(kind, key)``, a job's result."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(JOBS), mp_context=ctx) as pool:
        futures = {job: pool.submit(child_job, *job) for job in JOBS}
        yield lambda kind, key: futures[kind, key].result(timeout=900)


# -- the model's loss and gradients ---------------------------------------------------


def counted_chunks(monkeypatch):
    """Lower the scan's chunk to 7 steps at 2 requests (monkeypatch) and
    count the chunks the scans run: a list, one entry a chunk."""
    monkeypatch.setattr(ssm, "MAMBA_CHUNK_BYTES", CHUNK_BYTES)
    seen, chunk_fn = [], ssm._scan_chunk

    def spy(h, delta, *rest):
        seen.append(delta.shape[1])
        return chunk_fn(h, delta, *rest)

    monkeypatch.setattr(ssm, "_scan_chunk", spy)
    return seen


def test_remat_gives_the_same_bits_and_drops(monkeypatch):
    """The port with remat and without: the recompute routes and drops as
    the forward did, and the scans' checkpoints recompute the same chunks,
    so loss, aux, every gradient and the drops are bit-equal."""
    counted_chunks(monkeypatch)
    _jc, pc = configs(1.25)
    tree_np = numpy_lm_params(pc, WEIGHT_SEED)
    batch = {"tokens": torch.as_tensor(tokens(pc.vocab, seq=SEQ,
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


MAMBA_LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                "dt_bias", "A_log", "D", "out_proj", "dt_norm", "b_norm",
                "c_norm")


@pytest.mark.parametrize("factor", [1.25, 16.0])
@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_jax(spawned, factor, remat,
                                        monkeypatch):
    """The loss with its ce and aux, and every gradient leaf (the
    embeddings, every Mamba leaf, both attention layers, the routers and
    experts, the norms and the unembedding) against
    ``jax.value_and_grad``, through scans of 4 chunks with a ragged last
    one; the drops equal to JAX's, > 0 at 1.25 and none at 16."""
    case = spawned("case", factor)
    want, grads, drops, e, e_leaf = (case[k] for k in (
        "want", "grads", "drops", "e", "e_leaf"))
    assert case["kept"] >= 4, case["kept"]
    _jc, pc = configs(factor)
    seen = counted_chunks(monkeypatch)
    model = lm_params_from(numpy_lm_params(pc, WEIGHT_SEED),
                           dataclasses.replace(pc, remat=remat), "cpu")
    with _ForwardDrops(model) as counted:
        loss, metrics, got = grads_of(model, {"tokens": torch.as_tensor(
            tokens(pc.vocab, seq=SEQ, batch=BATCH))})
    assert counted.groups() == [drops]
    assert (sum(drops) > 0) if factor == 1.25 else (sum(drops) == 0)
    # 6 Mamba layers, each scan in chunks of 7, 7, 7 and 3
    assert seen[:4] == [7, 7, 7, 3] and len(seen) % 24 == 0
    for k, v in (("loss", loss), ("ce", metrics["ce"]),
                 ("aux", metrics["aux"])):
        assert abs(float(v) - want[k]) / abs(want[k]) <= max(FLOOR, e[k]), k
    rel_leaf = leaf_rel(to_jax_tree(model, got), grads)
    assert rel_leaf.keys() == e_leaf.keys()
    for part in ["['stack']['sub0']['mixer']['" + k + "']"
                 for k in MAMBA_LEAVES] + [
            "['stack']['sub2']['mixer']['wq']",
            "['stack']['sub1']['mlp']['router']",
            "['stack']['sub3']['mlp']['w_gate']"]:
        assert part in rel_leaf, part
    for k, r in rel_leaf.items():
        assert r <= max(FLOOR, e_leaf[k]), (factor, remat, k, r, e_leaf[k])
    for n, g in got.items():
        assert float(g.abs().max()) > 0, n


# -- train steps --------------------------------------------------------------------


def at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jitted_jax(spawned, accum, monkeypatch):
    """Three steps of the jitted JAX ``make_train_step`` at the published
    factor, on batches of 2 requests a microbatch (2 x 24 at accum 1, 4 x
    24 at accum 2); before each the port takes JAX's parameters and state,
    so each step is held on its own: loss, aux and grad norm within
    max(1e-4, E), E over the draws that keep the step's drops; the lr bit
    for bit; every parameter within HELD_LR lr where JAX's gradient is
    above HELD of its leaf's largest and within 2 lr elsewhere
    (``tests/test_torch_lm_train.py``'s rule); each microbatch's drops
    equal to JAX's."""
    counted_chunks(monkeypatch)
    _jc, pc = configs(1.25)
    model = lm_params_from(numpy_lm_params(pc, WEIGHT_SEED), pc, "cpu")
    step_fn = make_train_step(model, opt.AdamWConfig(**STEP_OPT),
                              accum=accum)
    dropped = 0
    for t, js in enumerate(spawned("steps", accum)):
        assert js["kept"] >= 4, (t, js["kept"])
        want, e, drops, lr = js["want"], js["e"], js["drops"], js["lr"]
        model.load_tree(js["params"])
        st = js["state"]
        mine = opt.OptState(
            step=torch.tensor(int(st["step"]), dtype=torch.int32),
            master=from_jax_tree(model, st["master"]),
            mu=from_jax_tree(model, st["mu"]),
            nu=from_jax_tree(model, st["nu"]))
        with _ForwardDrops(model) as counted:
            _state, got = step_fn(mine, {"tokens": torch.as_tensor(
                js["batch"])})
        assert counted.groups() == drops, (t, drops)
        dropped += sum(map(sum, drops))
        for k in want:
            assert (abs(float(got[k]) - want[k]) / abs(want[k])
                    <= max(FLOOR, e[k])), (t, k)
        assert np.float32(got["lr"]) == lr
        now = to_jax_tree(model, model.named_leaves())
        for path, w in jax.tree_util.tree_flatten_with_path(
                js["new_params"])[0]:
            p = at(now, path)
            w = np.asarray(w, np.float64)
            gp = np.abs(at(js["g"], path))
            held = gp > HELD * gp.max()
            diff = np.abs(p.numpy() - w) - 1e-6 * np.abs(w).max()
            assert (diff[held] <= HELD_LR * lr).all(), (t, path)
            assert (diff[~held] <= 2 * lr).all(), (t, path)
    assert dropped > 0
