"""The port's MLA attention and dense prefix (deepseek-v2-236b) against the
JAX package, on the CPU.

* The flash kernels' MLA mode (queries and folded keys of 192, values of
  128): the plain form and both kernels' CPU emulations
  (``tensor_core_emulation``, ``cuda_core_emulation`` of
  tests/test_torch_flash_attention.py, the latter at the key tile that
  ``csrc/flash_attention.cu`` builds for the pair) against the Pallas
  kernel in interpret mode; the wrappers' refusals.
* ``mla_train`` and ``mla_decode`` against the reference's, step by step
  in float32 with the cache entries, on DEEPSEEK_SMOKE's MLA and at the
  card's 192 / 128 widths.
* The dense prefix: the spec tree, parameter counts of the full config
  (meta device), the JAX tree round trip.
* The model on DEEPSEEK_SMOKE in float32 on ``numpy_lm_params`` weights:
  forward, loss, prefill, decode steps and greedy ``generate`` within
  max(1e-4, E) of JAX's (E the JAX model's one-ulp sensitivity), every
  MoE layer's dropped assignments equal to JAX's, at the published
  capacity factor 1.25 and at 16 (``_f32_nodrop``, where nothing drops).
* The gradient of a dense MLA variant (no MoE) against ``jax.grad``.
* ``assets/lm_mla_reference.npz`` through chip_smoke's
  ``moe_record_check``.
"""

import contextlib
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.layers import is_spec
from repro.models.transformer import MLAConfig as JaxMLAConfig
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import generate as jax_generate

from repro_torch.bridge import (
    LM_MLA_ASSET,
    from_jax_tree,
    leaf_layout,
    lm_params_from,
    load_lm_mla_reference,
    numpy_lm_params,
    to_jax_tree,
)
from repro_torch.configs import registry
from repro_torch.configs.lm_archs import MLAConfig
from repro_torch.kernels.flash_attention import cuda as fcuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.layers import numpy_leaf, tree_leaves
from repro_torch.models.transformer import Model, model_specs
from repro_torch.serve.engine import generate
from repro_torch.train.step import grads_of

from test_torch_flash_attention import (
    RANDOM_BOUND,
    cuda_core_emulation,
    plain_bf16,
    tensor_core_emulation,
    worst,
)

torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"
REL = 1e-4
F32 = 2e-5                          # tests/test_kernels.py:43, float32
CARD_MLA = {"kv_lora": 32, "qk_nope": 128, "qk_rope": 64, "v_dim": 128}
B, S, EXTRA, GEN = 2, 12, 4, 5
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc", "flash_attention.cu")


def rel_err(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def configs(mla=None, **kw):
    """(JAX, port) DEEPSEEK_SMOKE in float32, MLA widths ``mla`` (a dict)
    and fields ``kw`` replaced."""
    jc = jax_registry.get_config(ARCH, smoke=True)
    pc = registry.get_config(ARCH, smoke=True)
    jc = dataclasses.replace(jc, param_dtype=jnp.float32, **kw)
    pc = dataclasses.replace(pc, param_dtype=torch.float32, **kw)
    if mla is not None:
        jc = dataclasses.replace(jc, mla=JaxMLAConfig(**mla))
        pc = dataclasses.replace(pc, mla=MLAConfig(**mla))
    return jc, pc


def with_factor(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def keystr(path):
    """A port tree path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in path)


def one_ulp(tree, seed):
    """Every weight moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(np.nextafter(a, np.where(
            rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(np.float32)))

    return jax.tree_util.tree_map(move, tree)


# -- the flash kernels' MLA mode ----------------------------------------------


def cuda_core_tile(d, dv):
    """The float32 kernel's key tile for (d, dv), as the C entry builds
    it."""
    with open(CSRC) as f:
        m = re.search(rf"cuda_core::launch<{d}, {dv}, (\d+)>", f.read())
    return int(m.group(1))


@pytest.mark.parametrize("b,s,H", [(1, 128, 2), (2, 100, 3), (1, 300, 2)])
def test_mla_flash_mode_against_pallas_interpret(b, s, H):
    """Causal, GQA 1 (MLA's folded keys have a head each), s ragged
    against the kernels' tiles: the plain form, the float32 kernel's
    emulation at its MLA tile (32 keys) and the bf16 kernel's, each
    against ``flash_attention_bhsd(interpret=True)``."""
    rng = np.random.default_rng(b * 1000 + s)
    shapes = [(b, s, H, 192), (b, s, H, 192), (b, s, H, 128)]
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    scale = 192 ** -0.5
    block = s if s % 128 else 128

    def pallas(dtype):
        q, k, v = (jnp.moveaxis(jnp.asarray(a, dtype), 2, 1).reshape(
            b * H, s, a.shape[-1]) for a in arrs)
        o = flash_attention_bhsd(q, k, v, causal=True, scale=scale,
                                 block_q=block, block_k=block,
                                 interpret=True)
        return np.moveaxis(np.asarray(o, np.float32).reshape(b, H, s, 128),
                           1, 2)

    tq, tk, tv = (torch.tensor(a) for a in arrs)
    want = pallas(jnp.float32)
    plain = flash_attention(tq, tk, tv, scale=scale)
    assert plain.shape == (b, s, H, 128)
    np.testing.assert_allclose(plain.numpy(), want, atol=F32, rtol=F32)
    assert cuda_core_tile(192, 128) == 32
    emu = cuda_core_emulation(tq, tk, tv, scale, bk=cuda_core_tile(192, 128))
    np.testing.assert_allclose(emu.numpy(), want, atol=F32, rtol=F32)
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), atol=F32,
                               rtol=F32)

    bq, bk_, bv = (t.bfloat16() for t in (tq, tk, tv))
    got = tensor_core_emulation(bq, bk_, bv, scale)
    assert worst(got, plain_bf16(bq, bk_, bv, scale), RANDOM_BOUND) <= 1
    np.testing.assert_allclose(got.float().numpy(), pallas(jnp.bfloat16),
                               atol=2e-2, rtol=2e-2)


def test_flash_wrappers_refuse_unbuilt_pairs():
    """Both kernels, the forward and its backward, are built for (64, 64),
    (128, 128) and MLA's (192, 128) and refuse any other pair, such as
    (96, 128); the forward takes a v whose first three axes are k's, the
    backward an o and a dout of v's width; a built pair then needs CUDA
    tensors."""
    assert fcuda.PAIRS == ((64, 64), (128, 128), (192, 128))
    assert fcuda.BWD_PAIRS == fcuda.PAIRS
    q, k = torch.zeros(1, 8, 2, 192), torch.zeros(1, 8, 2, 192)
    v = torch.zeros(1, 8, 2, 128)
    for bad in (torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 192)):
        with pytest.raises(ValueError, match="not built"):
            fcuda.flash_attention_cuda(q, k, bad)
    with pytest.raises(ValueError, match="not built"):
        fcuda.flash_attention_cuda(q[..., :96], k[..., :96], v)
    for bad in (torch.zeros(1, 9, 2, 128), torch.zeros(1, 8, 1, 128),
                torch.zeros(2, 8, 2, 128)):
        with pytest.raises(ValueError, match="do not match"):
            fcuda.flash_attention_cuda(q, k, bad)
    with pytest.raises(ValueError, match="CUDA"):
        fcuda.flash_attention_cuda(q, k, v)
    o, lse = torch.zeros(1, 8, 2, 128), torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="not built"):
        fcuda.flash_attention_bwd_cuda(q[..., :96], k[..., :96], v, o, o,
                                       lse)
    for bad in (q, torch.zeros(1, 8, 2, 64)):        # o of q's width
        with pytest.raises(ValueError, match="do not match"):
            fcuda.flash_attention_bwd_cuda(q, k, v, bad, bad, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fcuda.flash_attention_bwd_cuda(q, k, v, o, o, lse)


# -- mla_train and mla_decode ---------------------------------------------------


@pytest.mark.parametrize("mla", [None, CARD_MLA], ids=["smoke", "card"])
def test_mla_prefill_and_decode_match_jax(mla):
    """One MLA layer, float32: the prefill output and its cache entry
    (normed latent, roped key), then EXTRA decode steps, each step's
    output and the whole cache, against the jitted reference."""
    jc, pc = configs(mla, n_heads=2) if mla else configs()
    rng = np.random.default_rng(3)
    params = {k: numpy_leaf(s, rng) for k, s in attn.attn_specs(pc).items()}
    x = rng.standard_normal((B, S + EXTRA, pc.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    tp = {k: torch.tensor(a) for k, a in params.items()}
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))

    y_j, entry_j = jax.jit(lambda p, h: jattn.mla_train(
        p, jc, h, jnp.asarray(pos), return_kv=True))(jp, x[:, :S])
    y_t, entry_t = attn.mla_train(tp, pc, torch.tensor(x[:, :S]),
                                  torch.tensor(pos), return_kv=True)
    assert rel_err(y_t, y_j) < REL
    assert sorted(entry_t) == ["ckv", "krope"]
    for k in entry_t:
        assert tuple(entry_t[k].shape) == entry_j[k].shape
        assert rel_err(entry_t[k], entry_j[k]) < REL, k

    def pad(a, xp):
        return xp.concatenate([a, xp.zeros((B, EXTRA) + a.shape[2:],
                                           a.dtype)], 1)

    cache_j = {k: pad(a, jnp) for k, a in entry_j.items()}
    cache_t = {k: torch.tensor(np.asarray(pad(a.numpy(), np)))
               for k, a in entry_t.items()}
    step = jax.jit(lambda p, h, c, t: jattn.mla_decode(p, jc, h, c, t))
    for t in range(S, S + EXTRA):
        out_j, cache_j = step(jp, x[:, t:t + 1], cache_j, jnp.int32(t))
        out_t, new = attn.mla_decode(tp, pc, torch.tensor(x[:, t:t + 1]),
                                     cache_t, t)
        assert new is cache_t                # written in place
        assert rel_err(out_t, out_j) < REL, t
        for k in cache_t:
            assert rel_err(cache_t[k], cache_j[k]) < REL, (t, k)


def test_mla_cache_is_the_latent_and_rope_key():
    _jc, pc = configs()
    want = JaxModel(configs()[0]).init_cache(2, 7)
    got = Model(pc, device="cpu").init_cache(2, 7)
    assert len(got) == pc.n_layers == 1 + want["stack"]["sub0"]["ckv"].shape[0]
    for i, entry in enumerate(got):
        theirs = (want["prefix"][0] if i == 0 else
                  {k: a[i - 1] for k, a in want["stack"]["sub0"].items()})
        assert sorted(entry) == sorted(theirs) == ["ckv", "krope"]
        for k, a in theirs.items():
            assert tuple(entry[k].shape) == a.shape and not entry[k].any()


# -- the dense prefix -----------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_equals_jax(smoke):
    """``model_specs`` is the reference's ``Model.specs()``: the dense
    prefix unstacked under "prefix", the body stacked over the periods
    after it; every leaf's path, shape, initializer, scale and dtype."""
    jc = jax_registry.get_config(ARCH, smoke=smoke)
    pc = registry.get_config(ARCH, smoke=smoke)
    theirs = jax.tree_util.tree_flatten_with_path(JaxModel(jc).specs(),
                                                  is_leaf=is_spec)[0]
    mine = list(tree_leaves(model_specs(pc)))
    assert [jax.tree_util.keystr(p) for p, _ in theirs] == [
        keystr(p) for p, _ in mine]
    for (_p, a), (path, s) in zip(theirs, mine):
        assert (a.shape, a.init, a.scale) == (s.shape, s.init, s.scale), path
        assert jnp.dtype(a.dtype).name == str(s.dtype).split(".")[-1], path
    assert mine[0][0][0] == "embed" and any(p[0] == "prefix" for p, _ in mine)


def test_parameter_counts_of_the_full_config():
    """236 B parameters, 21 B active a token, counted on the meta device
    (nothing allocated): the reference's counts."""
    jmodel = JaxModel(jax_registry.get_config(ARCH))
    model = Model(registry.get_config(ARCH), device="meta")
    assert model.n_params() == jmodel.n_params()
    assert model.n_active_params() == jmodel.n_active_params()
    assert len(model.layers) == 60 and model.period == 1


def test_prefix_tree_round_trip():
    """``prefix[0]`` goes to layer 0, ``stack/sub0[i]`` to layer 1 + i;
    ``to_jax_tree`` / ``from_jax_tree`` and ``leaf_layout`` keep the
    reference's layout and order, the prefix a list."""
    _jc, pc = configs()
    tree = numpy_lm_params(pc, 0)
    model = lm_params_from(tree, pc, device="cpu")
    assert np.array_equal(model.layers[0].mixer["wq"].numpy(),
                          tree["prefix"][0]["mixer"]["wq"])
    assert "w_up" in model.layers[0].mlp and "router" not in model.layers[0].mlp
    for i in (0, 1):
        assert np.array_equal(model.layers[1 + i].mlp["w_gate"].numpy(),
                              tree["stack"]["sub0"]["mlp"]["w_gate"][i])
    named = model.named_leaves()
    back = to_jax_tree(model, named)
    assert isinstance(back["prefix"], list) and len(back["prefix"]) == 1
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [keystr(p) for p, _n in leaf_layout(model)] == [
        jax.tree_util.keystr(p) for p, _ in flat]
    for (_p, a), (_q, b) in zip(flat, jax.tree_util.tree_flatten_with_path(
            tree)[0]):
        assert np.array_equal(a.numpy(), b)
    again = from_jax_tree(model, tree)
    assert all(torch.equal(again[n], p) for n, p in named.items())


# -- the model ------------------------------------------------------------------


@contextlib.contextmanager
def jax_drops(log):
    """The reference's ``sort_dispatch`` appending each call's dropped
    assignments to ``log`` (an ordered debug callback)."""
    orig = jmoe.sort_dispatch

    def counted(xt, top_idx, e, cap):
        out = orig(xt, top_idx, e, cap)
        jax.debug.callback(lambda n: log.append(int(n)), jnp.sum(~out[2]),
                           ordered=True)
        return out

    jmoe.sort_dispatch = counted
    try:
        yield log
    finally:
        jmoe.sort_dispatch = orig


@contextlib.contextmanager
def port_drops(log):
    orig = moe.sort_dispatch

    def counted(*args):
        out = orig(*args)
        log.append(int((~out[2]).sum()))
        return out

    moe.sort_dispatch = counted
    try:
        yield log
    finally:
        moe.sort_dispatch = orig


def serve_run(prefill, decode_step, pad_cache, toks):
    """Prefill of S tokens, then EXTRA teacher-forced decode steps ->
    (B, 1 + EXTRA, vocab) logits."""
    lg, cache = prefill(toks[:, :S])
    out = [np.asarray(lg, np.float32)]
    cache = pad_cache(cache, EXTRA)
    for t in range(S, S + EXTRA):
        lg, cache = decode_step(toks[:, t:t + 1], cache, t)
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, 1)


@pytest.fixture(scope="module", params=[1.25, 16.0])
def smoke_case(request):
    """JAX's answers on DEEPSEEK_SMOKE at a capacity factor, each with its
    bound max(REL, E), E the move of that answer under one-ulp moves of
    every weight (two draws), and the drops of every MoE dispatch."""
    factor = request.param
    jc, pc = configs()
    jc, pc = with_factor(jc, factor), with_factor(pc, factor)
    tree = numpy_lm_params(pc, 0)
    jm = JaxModel(jc)
    toks = np.random.default_rng(7).integers(0, jc.vocab, (B, S + EXTRA))
    jt = jnp.asarray(toks, jnp.int32)

    def run(params, log=None):
        with jax_drops(log) if log is not None else contextlib.nullcontext():
            logits, _ = jax.jit(jm.logits)(params, jt)
            loss, metrics = jax.jit(jm.loss)(params, {"tokens": jt})
            step = jax.jit(jm.decode_step)
            served = serve_run(
                lambda t: jax.jit(jm.prefill)(params, t),
                lambda t, c, i: step(params, t, c, jnp.int32(i)),
                jm.pad_cache, jt)
            jax.effects_barrier()
        return {"logits": np.asarray(logits), "served": served,
                "loss": np.array([loss, metrics["ce"], metrics["aux"]])}

    log = []
    want = run(jax.tree_util.tree_map(jnp.asarray, tree), log)
    tol = {k: REL for k in want}
    for seed in (1, 2):
        moved = run(one_ulp(tree, seed))
        for k in want:
            tol[k] = max(tol[k], rel_err(moved[k], want[k])
                         if k != "loss" else
                         float((np.abs(moved[k] - want[k])
                                / np.abs(want[k])).max()))
    want["greedy"] = np.asarray(jax_generate(
        jm, jax.tree_util.tree_map(jnp.asarray, tree), jt[:, :S], GEN))
    model = lm_params_from(tree, pc, device="cpu")
    return factor, model, torch.as_tensor(toks), want, tol, log


def test_smoke_model_matches_jax(smoke_case):
    """Forward logits, loss with ce and aux, prefill and decode logits
    within max(1e-4, E) of JAX's; every MoE dispatch (the two MoE layers
    in the forward, the loss's forward, the prefill and each decode step)
    drops what JAX's drops, and nothing at factor 16."""
    factor, model, toks, want, tol, jax_log = smoke_case
    log = []
    with port_drops(log):
        logits = model.logits(toks)
        loss, metrics = model.loss({"tokens": toks})
        served = serve_run(model.prefill, model.decode_step,
                           model.pad_cache, toks)
    assert rel_err(logits, want["logits"]) < tol["logits"]
    got = np.array([float(loss), float(metrics["ce"]), float(metrics["aux"])])
    assert (np.abs(got - want["loss"]) / np.abs(want["loss"])
            <= tol["loss"]).all(), (got, want["loss"])
    rel = np.abs(served - want["served"]).max(-1) / np.abs(
        want["served"]).max(-1)
    assert rel.max() < tol["served"]
    n_moe = model.cfg.n_layers - model.cfg.first_dense
    assert len(log) == len(jax_log) == n_moe * (3 + EXTRA)
    assert log == jax_log
    assert (sum(log) > 0) == (factor < 16)


def test_smoke_model_generates_jax_tokens(smoke_case):
    """Greedy ``generate`` equal to JAX's (no near tie at these seeds:
    the top two logits of every step lie further apart than the bound)."""
    _factor, model, toks, want, tol, _log = smoke_case
    got = generate(model, toks[:, :S], GEN)
    np.testing.assert_array_equal(got.numpy(), want["greedy"])


def test_dense_mla_gradients_match_jax():
    """A dense MLA variant (DEEPSEEK_SMOKE without MoE: the prefix and a
    stacked body of SwiGLU layers) at the card's MLA widths: the loss and
    every gradient leaf within max(1e-4, E) of ``jax.value_and_grad``, E
    over the eight one-ulp draws of tests/test_torch_lm_train.py (jitted
    and eager JAX themselves differ by up to 1.2e-4 on these leaves)."""
    jc, pc = configs(CARD_MLA, n_heads=2, moe=None)
    tree = numpy_lm_params(pc, 1)
    toks = np.random.default_rng(9).integers(0, pc.vocab, (B, 20))
    vg = jax.jit(jax.value_and_grad(JaxModel(jc).loss, has_aux=True))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    (loss, _), grads = vg(jax.tree_util.tree_map(jnp.asarray, tree), batch)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    e_loss, e_leaf = REL, [REL] * len(flat)
    for seed in range(5, 13):
        (ml, _), mg = vg(one_ulp(tree, seed), batch)
        e_loss = max(e_loss, abs(float(ml) - float(loss)) / abs(float(loss)))
        for i, g in enumerate(jax.tree_util.tree_leaves(mg)):
            e_leaf[i] = max(e_leaf[i], rel_err(g, flat[i][1]))
    model = lm_params_from(tree, pc, device="cpu")
    got_loss, metrics, got = grads_of(model, {"tokens": torch.as_tensor(
        toks)})
    assert float(metrics["aux"]) == 0.0
    assert abs(float(got_loss) - float(loss)) / abs(float(loss)) <= e_loss
    mine = jax.tree_util.tree_flatten_with_path(to_jax_tree(model, got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in mine] == [
        jax.tree_util.keystr(p) for p, _ in flat]
    for i, ((path, g), (_p, w)) in enumerate(zip(mine, flat)):
        assert rel_err(g, w) <= e_leaf[i], (jax.tree_util.keystr(path),
                                            e_leaf[i])


# -- the record and the entry point --------------------------------------------


def test_mla_asset_is_small_and_at_the_card_widths():
    """The record: DEEPSEEK_SMOKE at MLA's card widths, 2 heads, the dense
    prefix and 2 MoE layers, at the published factor; 4 x 650 prompts,
    16 decode steps at 4 requests (capacity round(1.25) = 1: steps
    drop)."""
    assert os.path.getsize(LM_MLA_ASSET) < 3_000_000
    rec, extras = load_lm_mla_reference()
    cfg = rec.cfg
    assert cfg.mla == MLAConfig(**CARD_MLA) and cfg.n_heads == 2
    assert cfg.n_layers == 3 and cfg.first_dense == 1
    assert cfg.moe.capacity_factor == 1.25
    assert rec.prompts.shape == (4, 650) and rec.teacher.shape == (4, 16)
    assert extras["decode_drops"].shape == (16, 2)
    assert extras["decode_drops"].sum() > 0


def test_port_matches_the_mla_record():
    """What chip_smoke.py holds the card to (``moe_record_check``), on the
    CPU: forward, loss, prefill, decode steps and greedy tokens within
    max(1e-4, E) of JAX, every MoE layer's drops equal to JAX's."""
    from chip_smoke import moe_record_check

    rec, extras = load_lm_mla_reference()
    model = lm_params_from(numpy_lm_params(rec.cfg, rec.seed), rec.cfg,
                           device="cpu")
    r = moe_record_check(model, rec, extras)
    assert r["greedy_compared"] > 0


def test_serve_cli_runs_deepseek_on_the_cpu(capsys):
    toks = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--prompt-len", "9",
                           "--gen", "3"])
    assert toks.shape == (3, 3)
    assert "deepseek" in capsys.readouterr().out
