"""The port's encoder-decoder (whisper) against the JAX package, on the CPU.

WHISPER_SMOKE in float32 (2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, 16 frames), weights from ``bridge.numpy_lm_params`` in both
packages, frames and tokens from numpy's generator: the spec tree and
parameter count (also at full width, where nothing is allocated), the
sinusoidal table, ``encode``, ``logits`` with cross-attention, ``prefill``
with its cross keys and values and teacher-forced decode steps, the loss
and every gradient leaf, ``encdec_batch_for_step``, ``pad_cache``, the
dtype rule, the JAX tree round trip, greedy ``generate`` from the encoder
output, the prefill step, the CLIs, and the JAX record
``assets/lm_encdec_reference.npz`` through ``chip_smoke``'s own checks.

Tolerances.  Against JAX each output within max(1e-4, E) of its largest
entry and each gradient leaf within max(1e-4, E) of its largest |g|, E the
JAX quantity's one-ulp sensitivity (its largest move, relative to its
largest entry, under draws that move every weight by one ulp; four draws
for the outputs, eight for the gradients, as in tests/test_torch_lm.py and
tests/test_torch_lm_train.py).  The reference's init draws a stacked leaf
with its fan-in taken from the stacked axis (2 here), so the attention
logits are large and the softmax nearly one-hot: the outputs' E reads
about 1e-4, and some gradients are rounding noise (the key bias's, zero in
exact arithmetic).  Within the port, prefill + decode reproduce the full
forward within 1e-4 (REL).  Greedy tokens equal up to the reference's
first near tie (top two logits within that bound of the largest).  The sinusoidal table: row p within (p + 1) 2^-22 (see
``models.layers.sinusoidal_positions``).  ``encdec_batch_for_step`` and
remat: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import pipeline as jax_pipeline
from repro.models.layers import is_spec
from repro.models.layers import sinusoidal_positions as jax_sinusoidal
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import generate as jax_generate
from repro.train.step import make_prefill_step as jax_make_prefill_step

from repro_torch.bridge import (
    from_jax_tree,
    leaf_layout,
    lm_params_from,
    load_lm_encdec_reference,
    numpy_lm_params,
    to_jax_tree,
    train_state_tree,
)
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, encdec_batch_for_step
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.layers import param_count, sinusoidal_positions
from repro_torch.models.transformer import Model, model_specs, unsupported
from repro_torch.serve.engine import generate, stream
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import grads_of, make_prefill_step

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

ARCH = "whisper-medium"
REL = 1e-4
ONE_ULP_SEEDS = tuple(range(5, 13))
B, S, EXTRA, GEN = 2, 10, 4, 6


def configs(smoke=True, dtype="float32"):
    jc = dataclasses.replace(jax_registry.get_config(ARCH, smoke=smoke),
                             param_dtype=jnp.dtype(dtype))
    pc = dataclasses.replace(registry.get_config(ARCH, smoke=smoke),
                             param_dtype=getattr(torch, dtype))
    return jc, pc


def rel_err(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def one_ulp(tree, seed):
    """Every weight moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(np.nextafter(a, np.where(
            rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(np.float32)))

    return jax.tree_util.tree_map(move, tree)


def jax_leaf_paths(tree, is_leaf=None):
    return [tuple(str(k.key) for k in path) for path, _l in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


@pytest.fixture(scope="module")
def ref():
    """JAX's answers on WHISPER_SMOKE in float32, and the port on the same
    weights."""
    jc, pc = configs()
    tree = numpy_lm_params(pc, 0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm = JaxModel(jc)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((B, jc.enc_seq, jc.d_model), np.float32)
    toks = rng.integers(0, jc.vocab, (B, S + EXTRA)).astype(np.int32)
    jt = jnp.asarray(toks)
    encode, logits, prefill, step = (
        jax.jit(jm.encode), jax.jit(jm.logits), jax.jit(jm.prefill),
        jax.jit(jm.decode_step))

    def run(params):
        enc = encode(params, jnp.asarray(frames))
        full, _ = logits(params, jt, enc)
        pl, cache = prefill(params, jt[:, :S], enc)
        out = {"enc": np.asarray(enc), "full": np.asarray(full),
               "prefill": np.asarray(pl), "prefill_cache": cache}
        cache = jm.pad_cache(cache, EXTRA)
        steps = []
        for t in range(S, S + EXTRA):
            lg, cache = step(params, jt[:, t:t + 1], cache, jnp.int32(t))
            steps.append(np.asarray(lg[:, 0]))
        out["decode"], out["decode_cache"] = np.stack(steps, 1), cache
        return out

    want = run(params)
    outputs = ("enc", "full", "prefill", "decode")
    want["tol"] = max([REL] + [rel_err(moved[k], want[k]) for moved in (
        run(one_ulp(tree, seed)) for seed in ONE_ULP_SEEDS[:4])
        for k in outputs])
    enc = jnp.asarray(want["enc"])
    want["greedy"] = np.asarray(jax_generate(jm, params, jt[:, :S], GEN,
                                             enc_out=enc))
    gl, gc = prefill(params, jt[:, :S], enc)
    gc = jm.pad_cache(gc, GEN)
    gaps, tops = [], []
    for t in range(GEN):
        srt = np.sort(np.asarray(gl), axis=-1)
        gaps.append(srt[:, -1] - srt[:, -2])
        tops.append(np.abs(srt).max(-1))
        lg, gc = step(params, jnp.asarray(want["greedy"][:, t:t + 1]), gc,
                      jnp.int32(S + t))
        gl = lg[:, 0]
    want["gap"], want["top"] = np.stack(gaps, 1), np.stack(tops, 1)
    model = lm_params_from(tree, pc, device="cpu")
    return (model, tree, torch.as_tensor(frames),
            torch.as_tensor(toks).long(), want)


# -- specs and parameters ---------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_and_n_params(smoke):
    """The port's spec tree is the reference's, path for path and shape
    for shape, ``enc_stack`` and each layer's ``cross`` included; at full
    width (on the meta device: nothing allocated) whisper-medium counts
    758,501,376 parameters, as JAX's ``n_params``."""
    jc, pc = configs(smoke, "bfloat16")
    jspecs = JaxModel(jc).specs()
    mine = model_specs(pc)
    jl = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=is_spec)[0]
    assert jax_leaf_paths(jspecs, is_spec) == jax_leaf_paths(mine)
    ml = jax.tree_util.tree_leaves(mine)
    for (path, a), b in zip(jl, ml):
        assert (a.shape, a.init, a.scale) == (b.shape, b.init, b.scale), path
        assert b.dtype == torch.bfloat16
    model = Model(pc, device="meta")
    assert model.n_params() == param_count(mine) == JaxModel(jc).n_params()
    assert sum(p.numel() for p in model.parameters()) == model.n_params()
    if not smoke:
        assert model.n_params() == 758_501_376
    assert len(model.enc_layers) == pc.enc_layers
    assert set(dict(model.layers[0].named_children())) == {
        "norm1", "mixer", "norm_cross", "cross", "norm2", "mlp"}


def test_numpy_params_laid_out_as_jax_init():
    jc, pc = configs()
    jtree = JaxModel(jc).init(jax.random.PRNGKey(0))
    ntree = numpy_lm_params(pc, seed=0)
    assert jax_leaf_paths(jtree) == jax_leaf_paths(ntree)
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(ntree)):
        a = np.asarray(a)
        assert a.shape == b.shape and b.dtype == np.float32
        if (a == a.flat[0]).all():          # zeros / ones initializers
            np.testing.assert_array_equal(a, b)


def test_unsupported_refuses_only_the_rest():
    """Nothing is left to refuse: jamba's Mamba runs too."""
    for arch in (ARCH, "mixtral-8x22b", "deepseek-v2-236b",
                 "jamba-v0.1-52b"):
        assert unsupported(registry.get_config(arch)) is None
    assert Model(registry.get_config("jamba-v0.1-52b", smoke=True),
                 device="cpu").kinds[2] == ("attn", "swiglu")


# -- the sinusoidal table ----------------------------------------------------


@pytest.mark.parametrize("seq,d", [(1500, 1024), (150, 256), (16, 64)])
@pytest.mark.parametrize("jit", [False, True])
def test_sinusoidal_table(seq, d, jit):
    fn = (jax.jit(jax_sinusoidal, static_argnums=(0, 1)) if jit
          else jax_sinusoidal)
    want = np.asarray(fn(seq, d))
    got = sinusoidal_positions(seq, d, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy().astype(np.float64) - want).max(axis=1)
    assert (err <= (np.arange(seq) + 1) * 2.0 ** -22).all()


# -- forward, serving ----------------------------------------------------------


@pytest.mark.parametrize("fn", ["cross_attention", "bidir_attention"])
def test_attention_functions_match_jax(fn):
    """The encoder's and the cross attention, function for function, on
    one layer's weights and unit-scale inputs (dense einsums on both
    sides: float32 sums in another order)."""
    from repro.models import attention as jax_attn

    from repro_torch.models import attention as attn

    jc, pc = configs()
    layer = numpy_lm_params(pc, 2)["stack"]["sub0"]
    params = {k: v[0] for k, v in layer["cross" if fn.startswith("cross")
                                        else "mixer"].items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, pc.d_model), np.float32)
    enc = rng.standard_normal((B, pc.enc_seq, pc.d_model), np.float32)
    args = (x, enc) if fn.startswith("cross") else (x,)
    want = getattr(jax_attn, fn)({k: jnp.asarray(v) for k, v in
                                  params.items()}, jc,
                                 *(jnp.asarray(a) for a in args))
    got = getattr(attn, fn)({k: torch.as_tensor(v) for k, v in
                             params.items()}, pc,
                            *(torch.as_tensor(a) for a in args))
    assert rel_err(got, want) < REL


def test_encode(ref):
    model, _tree, frames, _toks, want = ref
    got = model.encode(frames)
    assert got.dtype == torch.float32 and tuple(got.shape) == want["enc"].shape
    assert rel_err(got, want["enc"]) < want["tol"]


def test_logits_with_cross_attention(ref):
    model, _tree, frames, toks, want = ref
    got = model.logits(toks, model.encode(frames))
    assert rel_err(got, want["full"]) < want["tol"]
    # and on JAX's own encoder output
    assert rel_err(model.logits(toks, torch.tensor(want["enc"])),
                   want["full"]) < want["tol"]


def _cross(jax_cache, i):
    return {k: np.asarray(jax_cache["cross"][k][i]) for k in ("k", "v")}


def _self(jax_cache, i):
    return {k: np.asarray(a[i]) for k, a in
            jax_cache["stack"]["sub0"].items()}


def test_prefill_and_decode_steps(ref):
    model, _tree, frames, toks, want = ref
    enc = model.encode(frames)
    logits, cache = model.prefill(toks[:, :S], enc)
    assert rel_err(logits, want["prefill"]) < want["tol"]
    for i, entry in enumerate(cache):
        assert sorted(entry) == ["cross", "k", "v"]
        for k, a in _self(want["prefill_cache"], i).items():
            assert rel_err(entry[k], a) < want["tol"], (i, k)
        for k, a in _cross(want["prefill_cache"], i).items():
            assert rel_err(entry["cross"][k], a) < want["tol"], (i, k)
    cache = model.pad_cache(cache, EXTRA)
    for i, t in enumerate(range(S, S + EXTRA)):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        assert rel_err(lg[:, 0], want["decode"][:, i]) < want["tol"]
    for i, entry in enumerate(cache):
        for k, a in _self(want["decode_cache"], i).items():
            assert rel_err(entry[k], a) < want["tol"], (i, k)


def test_prefill_decode_parity(ref):
    """Prefill + decode steps reproduce the full forward."""
    model, _tree, frames, toks, _want = ref
    enc = model.encode(frames)
    full = model.logits(toks, enc)
    logits, cache = model.prefill(toks[:, :S], enc)
    errs = [float((logits - full[:, S - 1]).abs().max())]
    cache = model.pad_cache(cache, EXTRA)
    for t in range(S, S + EXTRA):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / float(full.abs().max()) < REL


def test_pad_cache_keeps_cross(ref):
    model, _tree, frames, toks, want = ref
    _lg, cache = model.prefill(toks[:, :S], model.encode(frames))
    grown = model.pad_cache(cache, EXTRA)
    jgrown = JaxModel(configs()[0]).pad_cache(want["prefill_cache"], EXTRA)
    for i, (old, new) in enumerate(zip(cache, grown)):
        assert new["cross"] is old["cross"]
        assert tuple(new["k"].shape) == _self(jgrown, i)["k"].shape
        assert torch.equal(new["k"][:, :S], old["k"])
        assert not new["k"][:, S:].any() and not new["v"][:, S:].any()
    assert jgrown["cross"]["k"].shape == want["prefill_cache"]["cross"][
        "k"].shape


def test_init_cache_matches_jax():
    jc, pc = configs()
    want = JaxModel(jc).init_cache(2, 12)
    got = Model(pc, device="cpu").init_cache(2, 12)
    assert len(got) == jc.n_layers
    for i, entry in enumerate(got):
        assert sorted(entry) == ["cross", "k", "v"]
        for k, a in list(_self(want, i).items()) + [
                (f"cross/{k}", a) for k, a in _cross(want, i).items()]:
            t = entry["cross"][k[6:]] if k.startswith("cross/") else entry[k]
            assert tuple(t.shape) == a.shape, k
            assert t.dtype == torch.float32 and not t.any(), k


def test_generate_from_the_encoder_output(ref):
    model, _tree, frames, toks, want = ref
    enc = model.encode(frames)
    got = generate(model, toks[:, :S], GEN, enc_out=enc).numpy()
    for row in range(B):
        for t in range(GEN):
            if want["gap"][row, t] < want["tol"] * want["top"][row, t]:
                break
            assert got[row, t] == want["greedy"][row, t], (row, t)
    streamed = torch.stack([tok for tok, _lg in stream(
        model, toks[:, :S], GEN, enc_out=enc)], 1)
    assert np.array_equal(streamed.numpy(), got)


def test_prefill_step_encodes(ref):
    model, tree, frames, toks, want = ref
    jm = JaxModel(configs()[0])
    jl, _jc = jax.jit(jax_make_prefill_step(jm))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {"tokens": jnp.asarray(toks[:, :S].numpy()),
         "enc_input": jnp.asarray(frames.numpy())})
    logits, cache = make_prefill_step(model)({"tokens": toks[:, :S],
                                              "enc_input": frames})
    assert rel_err(logits, jl) < want["tol"]
    assert "cross" in cache[0]


# -- the dtype rule ------------------------------------------------------------


def test_mismatched_dtypes_raise():
    """bf16 weights with float32 frames: the reference's decoder scan
    refuses the promoted stream, and the port raises a ValueError naming
    both dtypes.  With frames in the parameter dtype both run, and the
    port's loss lies within twice JAX's own bf16 error of JAX's float32
    loss."""
    jc, pc = configs(dtype="bfloat16")
    jc32, _ = configs()
    tree = numpy_lm_params(pc, 0)
    data = DataConfig(vocab=pc.vocab, seq=12, global_batch=2, seed=0)
    batch = encdec_batch_for_step(data, pc.d_model, pc.enc_seq, 0)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    with pytest.raises(TypeError, match="carry"):
        JaxModel(jc).loss(jparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    model = lm_params_from(tree, pc, device="cpu")
    tokens = torch.as_tensor(batch["tokens"])
    frames32 = torch.as_tensor(batch["enc_input"])
    for call in (lambda: model.loss({"tokens": tokens,
                                     "enc_input": frames32}),
                 lambda: model.prefill(tokens, frames32),
                 lambda: model.logits(tokens, None)):
        with pytest.raises(ValueError, match="encoder output"):
            call()
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        model.loss({"tokens": tokens, "enc_input": frames32})
    cast = {"tokens": jnp.asarray(batch["tokens"]),
            "enc_input": jnp.asarray(batch["enc_input"], jnp.bfloat16)}
    jax_bf16 = float(JaxModel(jc).loss(jparams, cast)[0])
    jax_f32 = float(JaxModel(jc32).loss(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                               jparams),
        {"tokens": cast["tokens"],
         "enc_input": cast["enc_input"].astype(jnp.float32)})[0])
    with torch.no_grad():
        mine = float(model.loss({"tokens": tokens,
                                 "enc_input": frames32.bfloat16()})[0])
    assert abs(mine - jax_f32) <= 2 * abs(jax_bf16 - jax_f32)


# -- training -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's loss and gradient tree on encdec_batch_for_step's batch, with
    the one-ulp sensitivity of the loss and of each leaf."""
    jc, pc = configs()
    tree = numpy_lm_params(pc, 0)
    batch = encdec_batch_for_step(DataConfig(pc.vocab, 24, 2, 0), pc.d_model,
                                  pc.enc_seq, 0)
    vg = jax.jit(jax.value_and_grad(JaxModel(jc).loss, has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = vg(jax.tree_util.tree_map(jnp.asarray, tree), jb)
    flat = {p: np.asarray(g, np.float64) for p, g in zip(
        jax_leaf_paths(grads), jax.tree_util.tree_leaves(grads))}
    e_loss, e_leaf = 0.0, dict.fromkeys(flat, 0.0)
    for seed in ONE_ULP_SEEDS:
        (ml, _), mg = vg(one_ulp(tree, seed), jb)
        e_loss = max(e_loss, abs(float(ml) - float(loss)) / abs(float(loss)))
        for p, g in zip(jax_leaf_paths(mg), jax.tree_util.tree_leaves(mg)):
            e_leaf[p] = max(e_leaf[p], rel_err(np.asarray(g), flat[p]))
    return pc, tree, batch, float(loss), flat, e_loss, e_leaf


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(jax_grads, remat):
    pc, tree, batch, loss, grads, e_loss, e_leaf = jax_grads
    model = lm_params_from(tree, dataclasses.replace(pc, remat=remat), "cpu")
    got_loss, _met, got = grads_of(
        model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(got_loss) - loss) / abs(loss) <= max(REL, e_loss)
    mine = to_jax_tree(model, got)
    paths = jax_leaf_paths(mine)
    assert paths == list(grads)
    assert any(p[0] == "enc_stack" for p in paths)
    assert any(p[0] == "stack" and p[2] == "cross" for p in paths)
    for p, g in zip(paths, jax.tree_util.tree_leaves(mine)):
        assert rel_err(g, grads[p]) <= max(REL, e_leaf[p]), (p, e_leaf[p])


def test_remat_gives_the_same_gradients():
    _jc, pc = configs()
    tree = numpy_lm_params(pc, 1)
    batch = {k: torch.as_tensor(v) for k, v in encdec_batch_for_step(
        DataConfig(pc.vocab, 24, 2, 0), pc.d_model, pc.enc_seq, 1).items()}
    runs = [grads_of(lm_params_from(tree, dataclasses.replace(
        pc, remat=remat), "cpu"), batch) for remat in (True, False)]
    assert torch.equal(runs[0][0], runs[1][0])
    for n, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][n]), n


@pytest.mark.parametrize("step,seed,host_index,host_count", [
    (0, 0, 0, 1), (3, 0, 0, 1), (5, 7, 1, 2), (1, 3, 3, 4)])
def test_encdec_batch_for_step_equals_jax(step, seed, host_index,
                                          host_count):
    data = DataConfig(vocab=512, seq=33, global_batch=8, seed=seed)
    jdata = jax_pipeline.DataConfig(vocab=512, seq=33, global_batch=8,
                                    seed=seed)
    got = encdec_batch_for_step(data, 48, 20, step, host_index, host_count)
    want = jax_pipeline.encdec_batch_for_step(jdata, 48, 20, step,
                                              host_index, host_count)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_jax_tree_round_trip():
    _jc, pc = configs()
    model = lm_params_from(numpy_lm_params(pc, 0), pc, "cpu")
    named = model.named_leaves()
    assert len(named) == len(list(model.parameters()))
    tree = to_jax_tree(model, named)
    back = from_jax_tree(model, tree)
    assert all(torch.equal(back[n], p) for n, p in named.items())
    assert [p for p, _n in leaf_layout(model)] == [
        tuple(p) for p in jax_leaf_paths(tree)]
    assert tree["enc_stack"]["mixer"]["wq"].shape == (
        pc.enc_layers, pc.d_model, pc.n_heads, pc.d_head)
    params, state = train_state_tree(model, init_opt_state(named))
    leaf = params["enc_stack"]["mlp"]["w_fc"]
    assert leaf.shape == (pc.enc_layers, pc.d_model, pc.d_ff)
    np.testing.assert_array_equal(np.asarray(leaf),
                                  tree["enc_stack"]["mlp"]["w_fc"].numpy())
    assert np.asarray(state.mu["stack"]["sub0"]["cross"]["wk"]).shape == (
        pc.n_layers, pc.d_model, pc.n_heads, pc.d_head)


# -- entry points and the JAX record ---------------------------------------------


def test_serve_cli_on_the_cpu(capsys):
    toks = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "3", "--prompt-len", "7", "--gen", "3"])
    assert toks.shape == (3, 3)
    assert "encoded 3 x 16 frames" in capsys.readouterr().out


def test_train_cli_on_the_cpu(tmp_path):
    out = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                          "--global-batch", "2", "--seq", "12",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_frames_reach_the_model_in_its_dtype():
    _jc, pc = configs(dtype="bfloat16")
    data = DataConfig(pc.vocab, 12, 2, 0)
    batch = train_cli.batches(data, "cpu", pc)(3)
    want = encdec_batch_for_step(data, pc.d_model, pc.enc_seq, 3)
    assert batch["enc_input"].dtype == torch.bfloat16
    assert torch.equal(batch["enc_input"], torch.as_tensor(
        want["enc_input"]).bfloat16())
    assert serve_cli.make_frames(pc, 2, 0, "cpu").dtype == torch.bfloat16


def test_jax_record_on_the_cpu():
    """``assets/lm_encdec_reference.npz`` through ``chip_smoke``'s own
    record checks, on the CPU port."""
    from chip_smoke import lm_record_check, lm_train_record_check

    serve, train = load_lm_encdec_reference()
    assert serve.cfg.is_encdec and serve.frames.shape == (4, 150, 256)
    model = lm_params_from(numpy_lm_params(serve.cfg, serve.seed), serve.cfg,
                           device="cpu")
    worst, tol, compared = lm_record_check(model, serve)
    assert worst <= tol and compared > 0
    readings = lm_train_record_check(train, "cpu")
    assert all(v <= 1 for v in readings["grad_of_bound"].values())
    assert train.leaf_names == ["/".join(p) for p, _n in leaf_layout(model)]
    assert any(n.startswith("enc_stack/") for n in train.leaf_names)
    assert any("/cross/" in n for n in train.leaf_names)
