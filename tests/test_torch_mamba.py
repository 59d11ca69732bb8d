"""The port's Mamba mixer and the hybrid model (jamba-v0.1-52b) against the
JAX package, on the CPU, in float32.

* ``mamba_specs``: the reference's tree, shapes, initialisers, scales and
  dtypes, at jamba's full width and its smoke config.
* ``_mamba_scan`` against the reference's (its Bx built whole there) from
  the zero state and from a drawn one; the chunked scan bit-equal to an
  unchunked one that builds exp(delta A) and Bx whole, at chunk sizes 1,
  7, s and more than s (s = 650).
* ``mamba_mixer`` over a full sequence and step by step with the carried
  state (outputs, the conv state bit for bit, the ssm state), at the smoke
  widths (d_state 4) and at the published d_state of 16; its gradient, and
  that of a jamba variant without MoE, against ``jax.grad``.
* ``init_cache`` by layer kind; ``pad_cache`` growing only the attention
  entries of a hybrid cache; the JAX tree round trip at the full config's
  period of 8; the training CLI on JAMBA_SMOKE.
* ``assets/lm_hybrid_reference.npz`` through chip_smoke's
  ``moe_record_check``.

Tolerance: max(1e-4, E) of the largest entry, E the reference's own move
under one-ulp moves of its inputs (as in tests/test_torch_lm.py), unless a
case is bit-exact.  The scan cannot be bit-equal to JAX: XLA fuses each
step's ``dA h + Bx`` into one FMA and its exp and softplus differ from
PyTorch's in the last bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import ssm as jssm
from repro.models.transformer import Model as JaxModel

from repro_torch.bridge import (
    LM_HYBRID_ASSET,
    from_jax_tree,
    lm_params_from,
    load_lm_hybrid_reference,
    numpy_lm_params,
    to_jax_tree,
)
from repro_torch.configs import registry
from repro_torch.configs.lm_archs import MambaConfig
from repro_torch.launch import train as train_cli
from repro_torch.models import ssm
from repro_torch.models.layers import tree_leaves
from repro_torch.models.transformer import Model, layer_kinds
from repro_torch.train.step import grads_of

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
REL = 1e-4
MAMBA16 = {"d_state": 16, "d_conv": 4, "expand": 2, "dt_rank": 16}


def rel_err(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def configs(mamba=None, **kw):
    """(JAX, port) JAMBA_SMOKE in float32, Mamba widths ``mamba`` (a dict)
    and fields ``kw`` replaced."""
    jc = dataclasses.replace(jax_registry.get_config(ARCH, smoke=True),
                             param_dtype=jnp.float32, **kw)
    pc = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                             param_dtype=torch.float32, **kw)
    if mamba is not None:
        jc = dataclasses.replace(jc, mamba=jssm.MambaConfig(**mamba))
        pc = dataclasses.replace(pc, mamba=MambaConfig(**mamba))
    return jc, pc


def one_ulp(a, rng):
    a = np.asarray(a, np.float32)
    return np.nextafter(a, np.where(rng.random(a.shape) < 0.5, -np.inf,
                                    np.inf).astype(np.float32))


def moved(tree, seed):
    """Every leaf of a (nested) dict moved by one ulp up or down."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(one_ulp(a, rng)),
                                  tree)


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# -- specs ----------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_mamba_specs_equal_jax(smoke):
    pc = registry.get_config(ARCH, smoke=smoke)
    jc = jax_registry.get_config(ARCH, smoke=smoke)
    mine = ssm.mamba_specs(pc, pc.mamba)
    theirs = jssm.mamba_specs(jc, jc.mamba)
    assert sorted(mine) == sorted(theirs)
    for k, s in theirs.items():
        m = mine[k]
        assert (m.shape, m.init, m.scale) == (s.shape, s.init, s.scale), k
        assert str(m.dtype).split(".")[-1] == jnp.dtype(s.dtype).name, k
    for k in ("dt_bias", "A_log", "D"):
        assert mine[k].dtype == torch.float32
    assert mine["conv_w"].init == "normal" and mine["conv_w"].scale == 1.0


# -- the scan -------------------------------------------------------------------


def scan_inputs(b, s, di, n, seed):
    """Drawn float32 scan inputs: delta > 0, A < 0 (the reference's
    -exp(A_log) over Mamba's 1..16), B, xc, C unit normals."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((b, s, di)))).astype(
        np.float32)
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    B, C = (rng.standard_normal((b, s, n), dtype=np.float32)
            for _ in range(2))
    xc = rng.standard_normal((b, s, di), dtype=np.float32)
    h0 = rng.standard_normal((b, di, n), dtype=np.float32)
    return delta, A, B, xc, C, h0


def jax_scan(delta, A, B, xc, C, h0):
    delta, A, B, xc, C = map(jnp.asarray, (delta, A, B, xc, C))
    Bx = delta[..., None] * B[:, :, None, :] * xc[..., None]
    return jax.jit(jssm._mamba_scan)(delta, A, Bx, C,
                                     None if h0 is None else jnp.asarray(h0))


@pytest.mark.parametrize("from_state", [False, True])
def test_scan_matches_jax(from_state):
    delta, A, B, xc, C, h0 = scan_inputs(2, 37, 24, 16, seed=1)
    h0 = h0 if from_state else None
    y, h = jax_scan(delta, A, B, xc, C, h0)
    rng = np.random.default_rng(2)
    my, mh = jax_scan(*(one_ulp(a, rng) for a in (delta, A, B, xc, C)), h0)
    tol_y = max(REL, rel_err(np.asarray(my), y))
    tol_h = max(REL, rel_err(np.asarray(mh), h))
    gy, gh = ssm._mamba_scan(t(delta), t(A), t(B), t(xc), t(C),
                             None if h0 is None else t(h0))
    assert gy.shape == y.shape and gh.shape == h.shape
    assert rel_err(gy, y) <= tol_y and rel_err(gh, h) <= tol_h


def unchunked_scan(delta, A, B, xc, C, h0):
    """The reference's layout: exp(delta A) and Bx built whole, then the
    same step and readout a time step at a time."""
    dA = torch.exp(delta[..., None] * A)
    Bx = (delta[..., None] * B[:, :, None, :]) * xc[..., None]
    h, hs = h0, []
    for i in range(delta.shape[1]):
        h = torch.addcmul(Bx[:, i], dA[:, i], h)
        hs.append(h)
    return (torch.stack(hs, 1) * C[:, :, None, :]).sum(-1), h


@pytest.fixture(scope="module")
def long_scan():
    args = [t(a) for a in scan_inputs(2, 650, 32, 16, seed=3)]
    return args, unchunked_scan(*args)


@pytest.mark.parametrize("chunk", [1, 7, 650, 1000])
def test_chunked_scan_is_bit_equal_to_unchunked(long_scan, chunk):
    args, (y, h) = long_scan
    gy, gh = ssm._mamba_scan(*args, chunk=chunk)
    assert torch.equal(gy, y) and torch.equal(gh, h)


def test_chunk_size_keeps_buffers_near_a_gib():
    """At jamba's full width and 8 requests, 256 steps a chunk: 1 GiB for
    each (b, steps, d_inner, d_state) float32 buffer."""
    cfg = registry.get_config(ARCH)
    di = cfg.mamba.expand * cfg.d_model
    assert ssm.mamba_chunk(8, di, cfg.mamba.d_state) == 256
    assert ssm.mamba_chunk(1, 8, 4) >= 4096


# -- the mixer ------------------------------------------------------------------


def mixer_case(mamba, seed, b=2, s=13):
    """(JAX config, port config, float32 params, x).  x and in_proj lie on
    grids of 1/4 and 1/8, so in_proj's products and sums are exact in
    float32 in any order: the conv state, rows of that product, can be
    held bit for bit.  The other leaves are drawn away from their constant
    initialisers (A_log as log 1..n, dt_bias, D, the norms)."""
    jc, pc = configs(mamba)
    m = pc.mamba
    rng = np.random.default_rng(seed)
    p = {}
    for k, s_ in ssm.mamba_specs(pc, m).items():
        p[k] = rng.standard_normal(s_.shape).astype(np.float32) * np.float32(
            0.3 if s_.init in ("zeros", "ones") else
            1 / np.sqrt(s_.shape[0]))
    p["in_proj"] = rng.integers(-4, 5, p["in_proj"].shape).astype(
        np.float32) / 8
    p["A_log"] = np.log(np.tile(np.arange(1, m.d_state + 1, dtype=np.float32),
                                (m.expand * pc.d_model, 1)))
    p["D"] += 1
    for k in ("dt_norm", "b_norm", "c_norm"):
        p[k] += 1
    x = rng.integers(-4, 5, (b, s, pc.d_model)).astype(np.float32) / 4
    return jc, pc, p, x


def jax_mixer(jc, p, x, steps):
    """The reference's mixer over the whole sequence, then step by step
    with the carried state -> (out, state, [(out, state)] per step)."""
    f = jax.jit(lambda p, x, st: jssm.mamba_mixer(p, jc, jc.mamba, x, st))
    p = jax.tree_util.tree_map(jnp.asarray, p)
    out, st = jax.jit(lambda p, x: jssm.mamba_mixer(p, jc, jc.mamba, x))(
        p, jnp.asarray(x))
    state = jssm.mamba_state_init(jc, jc.mamba, x.shape[0])
    per = []
    if steps:
        for i in range(x.shape[1]):
            o, state = f(p, jnp.asarray(x[:, i:i + 1]), state)
            per.append((np.asarray(o), jax.tree_util.tree_map(np.asarray,
                                                              state)))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, st), per


@pytest.mark.parametrize("mamba", [None, MAMBA16], ids=["smoke", "d_state16"])
def test_mixer_matches_jax_full_and_step_by_step(mamba):
    jc, pc, p, x = mixer_case(mamba, seed=4)
    out, st, per = jax_mixer(jc, p, x, steps=True)
    m_out, m_st, m_per = jax_mixer(jc, moved(p, 5), x, steps=True)
    tol_out = max(REL, rel_err(m_out, out),
                  *(rel_err(a[0], b[0]) for a, b in zip(m_per, per)))
    tol_ssm = max(REL, rel_err(m_st["ssm"], st["ssm"]),
                  *(rel_err(a[1]["ssm"], b[1]["ssm"])
                    for a, b in zip(m_per, per)))
    tp = {k: t(v) for k, v in p.items()}
    got, gst = ssm.mamba_mixer(tp, pc, pc.mamba, t(x))
    assert rel_err(got, out) <= tol_out
    assert rel_err(gst["ssm"], st["ssm"]) <= tol_ssm
    np.testing.assert_array_equal(gst["conv"].numpy(), st["conv"])
    state = ssm.mamba_state_init(pc, pc.mamba, x.shape[0], "cpu")
    for i, (o, jst) in enumerate(per):
        g, state = ssm.mamba_mixer(tp, pc, pc.mamba, t(x[:, i:i + 1]), state)
        assert rel_err(g, o) <= tol_out, i
        assert rel_err(state["ssm"], jst["ssm"]) <= tol_ssm, i
        np.testing.assert_array_equal(state["conv"].numpy(), jst["conv"])
    # the steps carry on as the full sequence does
    np.testing.assert_array_equal(state["conv"].numpy(), gst["conv"].numpy())
    assert rel_err(state["ssm"], gst["ssm"]) <= tol_ssm


def test_mixer_gradient_matches_jax():
    """d/d(params, x) of out . P + ssm state . Q (P, Q drawn) through the
    port's scan under autograd, against ``jax.grad`` of the reference's
    mixer, each leaf within max(1e-4, E), E over four one-ulp draws of the
    parameters."""
    jc, pc, p, x = mixer_case(MAMBA16, seed=6, s=21)
    rng = np.random.default_rng(7)
    di = pc.mamba.expand * pc.d_model
    P = rng.standard_normal(x.shape, dtype=np.float32)
    Q = rng.standard_normal((x.shape[0], di, pc.mamba.d_state),
                            dtype=np.float32)

    def jloss(p, x):
        out, st = jssm.mamba_mixer(p, jc, jc.mamba, x)
        return jnp.sum(out * P) + jnp.sum(st["ssm"] * Q)

    g = jax.jit(jax.grad(jloss, argnums=(0, 1)))
    want = g(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    names = sorted(p)
    tol = {k: REL for k in names + ["x"]}
    for seed in range(8, 12):
        mp, mx = g(moved(p, seed), jnp.asarray(x))
        for k in names:
            tol[k] = max(tol[k], rel_err(np.asarray(mp[k]), want[0][k]))
        tol["x"] = max(tol["x"], rel_err(np.asarray(mx), want[1]))
    tp = {k: t(v).requires_grad_() for k, v in p.items()}
    tx = t(x).requires_grad_()
    out, st = ssm.mamba_mixer(tp, pc, pc.mamba, tx)
    ((out * t(P)).sum() + (st["ssm"] * t(Q)).sum()).backward()
    for k in names:
        assert rel_err(tp[k].grad, want[0][k]) <= tol[k], (k, tol[k])
    assert rel_err(tx.grad, want[1]) <= tol["x"]


def test_dense_jamba_gradients_match_jax():
    """JAMBA_SMOKE without MoE (Mamba layers, attention at layers 2 and 6,
    SwiGLU MLPs) at d_state 16: the loss and every gradient leaf within
    max(1e-4, E) of ``jax.value_and_grad``, E over four one-ulp draws;
    ``Model.loss`` with remat, through the plain scan under autograd."""
    jc, pc = configs(MAMBA16, moe=None)
    tree = numpy_lm_params(pc, 1)
    toks = np.random.default_rng(9).integers(0, pc.vocab, (2, 20))
    vg = jax.jit(jax.value_and_grad(JaxModel(jc).loss, has_aux=True))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    (loss, _), grads = vg(jax.tree_util.tree_map(jnp.asarray, tree), batch)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    e_loss, e_leaf = REL, [REL] * len(flat)
    for seed in range(5, 9):
        (ml, _), mg = vg(moved(tree, seed), batch)
        e_loss = max(e_loss, abs(float(ml) - float(loss)) / abs(float(loss)))
        for i, g in enumerate(jax.tree_util.tree_leaves(mg)):
            e_leaf[i] = max(e_leaf[i], rel_err(g, flat[i][1]))
    model = lm_params_from(tree, pc, device="cpu")
    assert model.cfg.remat
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


# -- caches and trees -------------------------------------------------------------


def jax_layer_caches(cache, model):
    """The JAX cache (a stack of periods) as one dict per layer."""
    p = model.period
    return [{k: np.asarray(a[i // p]) for k, a in
             cache["stack"][f"sub{i % p}"].items()}
            for i in range(model.cfg.n_layers)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_by_layer_kind(dtype):
    jc, pc = configs()
    jc = dataclasses.replace(jc, param_dtype=getattr(jnp, dtype))
    pc = dataclasses.replace(pc, param_dtype=getattr(torch, dtype))
    jm = JaxModel(jc)
    want = jax_layer_caches(jm.init_cache(3, 11), jm)
    model = Model(pc, device="cpu")
    got = model.init_cache(3, 11)
    assert len(got) == len(want) == 8
    for kind, mine, theirs in zip(model.kinds, got, want):
        assert sorted(mine) == sorted(theirs) == (
            ["k", "v"] if kind[0] == "attn" else ["conv", "ssm"])
        for k, a in theirs.items():
            assert tuple(mine[k].shape) == a.shape, k
            assert str(mine[k].dtype).split(".")[-1] == a.dtype.name, k
            assert not mine[k].any()


def test_pad_cache_grows_only_attention_entries():
    """A hybrid prefill cache: the attention layers' k and v grow by the
    extra positions (zeros), the Mamba layers' conv and ssm state keep
    their size and values; so did JAX's name-based ``grow``."""
    jc, pc = configs()
    tree = numpy_lm_params(pc, 2)
    toks = np.random.default_rng(3).integers(0, pc.vocab, (2, 9))
    model = lm_params_from(tree, pc, device="cpu")
    _lg, cache = model.prefill(torch.as_tensor(toks))
    grown = model.pad_cache(cache, 5)
    jm = JaxModel(jc)
    _jl, jcache = jax.jit(jm.prefill)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(toks))
    want = jax_layer_caches(jm.pad_cache(jcache, 5), jm)
    for kind, old, new, theirs in zip(model.kinds, cache, grown, want):
        for k in new:
            assert tuple(new[k].shape) == theirs[k].shape, (kind, k)
        if kind[0] == "attn":
            for k in ("k", "v"):
                assert torch.equal(new[k][:, :9], old[k])
                assert not new[k][:, 9:].any()
        else:
            for k in ("conv", "ssm"):
                assert new[k] is old[k]


def test_tree_round_trip_at_the_full_period():
    """numpy_lm_params -> lm_params_from -> to_jax_tree -> from_jax_tree at
    the full config's layer pattern (attention at layer 4 of every 8, MoE
    on odd layers: a period of 8), two periods deep, at smoke widths: the
    JAX init tree's paths, and every leaf back bit for bit."""
    jc, pc = configs(n_layers=16, attn_every=8, attn_offset=4)
    model = Model(pc, device="cpu")
    assert model.period == JaxModel(jc).period == 8
    assert [k[0] for k in model.kinds[:8]] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3
    tree = numpy_lm_params(pc, 4)
    jtree = JaxModel(jc).init(jax.random.PRNGKey(0))
    assert [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(jtree)] == [
        "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in p)
        for p, _ in tree_leaves(tree)]
    model = lm_params_from(tree, pc, device="cpu")
    named = dict(model.named_leaves())
    back = to_jax_tree(model, {k: v.detach() for k, v in named.items()})
    for (_p, a), (_q, b) in zip(tree_leaves(tree), tree_leaves(back)):
        np.testing.assert_array_equal(a, b.numpy())
    again = from_jax_tree(model, tree, device="cpu")
    for k, v in named.items():
        assert torch.equal(again[k], v.detach())


def test_training_cli_runs_jamba_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                          "--steps", "2", "--global-batch", "2", "--seq",
                          "12", "--ckpt-every", "2", "--ckpt-dir",
                          str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    assert "jamba" in capsys.readouterr().out


# -- the record -------------------------------------------------------------------


def test_hybrid_asset_is_small_and_at_the_card_widths():
    """The record: JAMBA_SMOKE at d_head 128 (the card's flash pair) and
    d_state 16, 8 layers (attention at 2 and 6, MoE on odd layers) at the
    published factor; 4 x 650 prompts, 16 decode steps at 4 requests
    (capacity round(1.25 * 4 * 2 / 4) = 2 an expert: steps drop)."""
    assert os.path.getsize(LM_HYBRID_ASSET) < 3_000_000
    rec, extras = load_lm_hybrid_reference()
    cfg = rec.cfg
    assert cfg.d_head == 128 and cfg.mamba == MambaConfig(**MAMBA16)
    assert cfg.n_layers == 8 and cfg.moe.capacity_factor == 1.25
    assert [k[0] for k in layer_kinds(cfg)] == [
        "mamba", "mamba", "attn", "mamba"] * 2
    assert rec.prompts.shape == (4, 650) and rec.teacher.shape == (4, 16)
    assert extras["decode_drops"].shape == (16, 4)
    assert extras["decode_drops"].sum() > 0


def test_port_matches_the_hybrid_record():
    """What chip_smoke.py holds the card to (``moe_record_check``), on the
    CPU: forward, loss, prefill, decode steps and greedy tokens within
    max(1e-4, E) of JAX, every MoE layer's drops equal to JAX's."""
    from chip_smoke import moe_record_check

    rec, extras = load_lm_hybrid_reference()
    model = lm_params_from(numpy_lm_params(rec.cfg, rec.seed), rec.cfg,
                           device="cpu")
    r = moe_record_check(model, rec, extras)
    assert r["greedy_compared"] > 0
