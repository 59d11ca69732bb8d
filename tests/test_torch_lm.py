"""The port's LM stack (``repro_torch.models``, ``serve``, ``launch``)
against the JAX package, on the CPU.

For each of the nine decoder-only configs (their SMOKE variants in
float32, as ``_f32_nodrop`` in tests/test_models.py:22, but mixtral,
deepseek and jamba at their published MoE capacity factor of 1.25, so
that both packages drop the same assignments), and sliding-window variants of yi's and mixtral's
whose window binds, the JAX model's own ``init`` parameters go through
``bridge.lm_params_from``; then ``logits``, ``prefill`` (last-token logits
and every layer's cache), teacher-forced ``decode_step``s and greedy
``generate`` are held to the JAX ``Model`` and ``generate`` on the same
tokens.

Tolerances.  Within the port, prefill + decode must reproduce the full
forward within 1e-4 of the largest |logit| (tests/test_models.py:88); a
MoE config is held there at capacity factor 16, as the reference's own
parity test holds it (``test_prefill_decode_parity``).
Against JAX the bound is max(1e-4, E) of the largest entry, where E is
the JAX model's own float32 sensitivity: how far that output (the logits,
or one entry of the cache) moves, relative to its largest entry, when
every weight moves by one ulp.  The two implementations round some operations differently
(XLA's and PyTorch's tanh and exp differ by an ulp or two), and these
random-weight models amplify such differences layer by layer: at
RWKV6_SMOKE, E is 1.7e-4 and the port sits 1.3e-4 from JAX (yi's smoke
config: 8.9e-6 and 7.2e-6).  Greedy tokens must be equal up to the
first step where JAX's top two logits lie within that bound of the
largest |logit| (a near tie, which rounding may break either way).  In bf16 the port is held to JAX's own bf16 error against the
float32 model (``test_bf16_logits_and_decode``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import cascade_serve as jax_cascade_serve
from repro.serve.engine import generate as jax_generate

from repro_torch.bridge import lm_params_from, numpy_lm_params
from repro_torch.configs import registry
from repro_torch.configs.shapes import KERNEL_SHAPES, SHAPES
from repro_torch.launch import serve as serve_cli
from repro_torch.models.layers import param_count, tree_leaves
from repro_torch.models.transformer import Model, model_specs, unsupported
from repro_torch.serve.engine import (
    SamplerConfig,
    cascade_serve,
    generate,
    sample,
)

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

RUNNABLE = ["yi-9b", "codeqwen1.5-7b", "phi3-medium-14b", "granite-34b",
            "chameleon-34b", "mixtral-8x22b", "deepseek-v2-236b", "rwkv6-7b",
            "jamba-v0.1-52b"]
SWA = {"yi-swa": "yi-9b", "mixtral-swa": "mixtral-8x22b"}
REL = 1e-4
B, S, EXTRA, GEN = 2, 10, 4, 6


def f32(cfg, jax_side):
    dt = jnp.float32 if jax_side else torch.float32
    return dataclasses.replace(cfg, param_dtype=dt)


def configs(name):
    """(JAX config, port config) pairs; "yi-swa" and "mixtral-swa" are
    yi's and mixtral's smoke configs with a window of 6, so the prompt
    overruns the ring buffer."""
    arch = SWA.get(name, name)
    jc = f32(jax_registry.get_config(arch, smoke=True), True)
    pc = f32(registry.get_config(arch, smoke=True), False)
    if name in SWA:
        jc = dataclasses.replace(jc, attn_type="swa", window=6)
        pc = dataclasses.replace(pc, attn_type="swa", window=6)
    return jc, pc


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def rel_err(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def layer_slices(jax_cache, n_layers):
    """The JAX cache (a dense prefix's layers in its list, then the stack
    of periods, ``sub{j}`` a period's j-th layer) as one dict per layer."""
    out = [{k: np.asarray(a) for k, a in c.items()}
           for c in jax_cache.get("prefix", [])]
    period = len(jax_cache["stack"])
    return out + [{k: np.asarray(a[i // period]) for k, a in
                   jax_cache["stack"][f"sub{i % period}"].items()}
                  for i in range(n_layers - len(out))]


def greedy_agree(got, want, gap, top, tol):
    """Tokens equal per row up to the first near tie of the reference."""
    for row in range(want.shape[0]):
        for t in range(want.shape[1]):
            if gap[row, t] < tol * top[row, t]:
                break
            assert got[row, t] == want[row, t], (row, t)


def one_ulp(tree, seed):
    """Every weight moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        return np.nextafter(a, np.where(rng.random(a.shape) < 0.5, -np.inf,
                                        np.inf).astype(np.float32))

    return jax.tree_util.tree_map(lambda a: jnp.asarray(move(a)), tree)


def jax_run(jm, fns, params, jt, n_layers):
    """The JAX model's full logits, prefill (logits, per-layer cache) and
    teacher-forced decode (logits, per-layer cache) on ``jt``; ``fns`` are
    its jitted logits, prefill and decode_step."""
    logits, prefill, decode_step = fns
    full, _ = logits(params, jt)
    pl, cache = prefill(params, jt[:, :S])
    out = {"full": np.asarray(full), "prefill": np.asarray(pl),
           "prefill_cache": layer_slices(cache, n_layers)}
    cache = jm.pad_cache(cache, EXTRA)
    steps = []
    for t in range(S, S + EXTRA):
        lg, cache = decode_step(params, jt[:, t:t + 1], cache, jnp.int32(t))
        steps.append(np.asarray(lg[:, 0]))
    out["decode"] = np.stack(steps, 1)
    out["decode_cache"] = layer_slices(cache, n_layers)
    return out


@pytest.fixture(scope="module", params=RUNNABLE + sorted(SWA))
def case(request):
    """The JAX answers on one config, each with its bound: max(REL, E),
    E how far that answer moves (relative to its largest entry) when every
    weight moves by one ulp."""
    jc, pc = configs(request.param)
    jm = JaxModel(jc)
    params = jm.init(jax.random.PRNGKey(42))
    toks = np.random.default_rng(7).integers(0, jc.vocab, (B, S + EXTRA))
    jt = jnp.asarray(toks, jnp.int32)
    fns = (jax.jit(jm.logits), jax.jit(jm.prefill), jax.jit(jm.decode_step))
    want = jax_run(jm, fns, params, jt, jc.n_layers)
    moved = jax_run(jm, fns, one_ulp(params, 1), jt, jc.n_layers)
    want["tol"] = max(REL, *(rel_err(moved[k], want[k])
                             for k in ("full", "prefill", "decode")))
    jl = jax.jit(jm.loss)
    batch = {"tokens": jt}
    want["loss"] = [float(a) for a in _loss_parts(*jl(params, batch))]
    moved_loss = _loss_parts(*jl(one_ulp(params, 1), batch))
    want["loss_tol"] = max(REL, *(abs(float(m) - w) / abs(w)
                                  for m, w in zip(moved_loss, want["loss"])
                                  if w))
    want["cache_tol"] = {
        k: max(REL, *(rel_err(m[k], w[k])
                      for c in ("prefill_cache", "decode_cache")
                      for m, w in zip(moved[c], want[c]) if k in w))
        for k in {k for c in want["prefill_cache"] for k in c}}
    want["greedy"] = np.asarray(jax_generate(jm, params, jt[:, :S], GEN))
    # the reference's logits along its own greedy path, for the tie rule
    gl, gc = fns[1](params, jt[:, :S])
    gc = jm.pad_cache(gc, GEN)
    gaps, tops = [], []
    for t in range(GEN):
        srt = np.sort(np.asarray(gl), axis=-1)
        gaps.append(srt[:, -1] - srt[:, -2])
        tops.append(np.abs(srt).max(-1))
        lg, gc = fns[2](params, jnp.asarray(want["greedy"][:, t:t + 1]), gc,
                        jnp.int32(S + t))
        gl = lg[:, 0]
    want["gap"], want["top"] = np.stack(gaps, 1), np.stack(tops, 1)
    model = lm_params_from(to_np(params), pc, device="cpu")
    return request.param, model, torch.as_tensor(toks), want


def _loss_parts(loss, metrics):
    return loss, metrics["ce"], metrics["aux"]


def test_logits(case):
    _name, model, toks, want = case
    got = model.logits(toks)
    assert got.shape == want["full"].shape and got.dtype == torch.float32
    assert rel_err(got, want["full"]) < want["tol"]


def test_prefill_logits_and_cache(case):
    _name, model, toks, want = case
    logits, cache = model.prefill(toks[:, :S])
    assert rel_err(logits, want["prefill"]) < want["tol"]
    assert len(cache) == len(want["prefill_cache"])
    for mine, theirs in zip(cache, want["prefill_cache"]):
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            assert tuple(mine[k].shape) == theirs[k].shape, k
            assert rel_err(mine[k], theirs[k]) < want["cache_tol"][k], k


def test_decode_steps_and_cache(case):
    _name, model, toks, want = case
    _logits, cache = model.prefill(toks[:, :S])
    cache = model.pad_cache(cache, EXTRA)
    for i, t in enumerate(range(S, S + EXTRA)):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        assert lg.shape == (B, 1, model.cfg.vocab)
        assert rel_err(lg[:, 0], want["decode"][:, i]) < want["tol"]
    for mine, theirs in zip(cache, want["decode_cache"]):
        for k in theirs:
            assert rel_err(mine[k], theirs[k]) < want["cache_tol"][k], k


def test_loss_matches_jax(case):
    """``Model.loss``: ce + aux, and each part, within max(1e-4, E) of
    JAX's (aux is the MoE routers' balance and z losses, 0 without
    MoE)."""
    _name, model, toks, want = case
    loss, metrics = model.loss({"tokens": toks})
    got = [float(a) for a in _loss_parts(loss, metrics)]
    for g, w in zip(got, want["loss"]):
        assert abs(g - w) <= want["loss_tol"] * abs(w), (got, want["loss"])
    assert (want["loss"][2] > 0) == (model.cfg.moe is not None)


def test_prefill_decode_parity(case):
    """tests/test_models.py::test_prefill_decode_parity on the port alone.
    A MoE config runs at capacity factor 16, as the reference's own test
    does (``_f32_nodrop``): the capacity depends on how many tokens a call
    routes, so at the published 1.25 a prefill of the prompt and a decode
    step of one token a request drop other assignments than one forward
    over the whole sequence.  The reference itself then misses: on
    MIXTRAL_SMOKE in float32 (B 2, S 24 + 4 steps) its own prefill and
    decode differ from its forward by 0.888 of max |logit| at 1.25, and by
    8.0e-6 at 16 (tests/test_torch_moe.py::
    test_reference_prefill_decode_misses_at_the_published_factor)."""
    _name, model, toks, _want = case
    cfg = model.cfg
    if cfg.moe is not None:
        nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
        state = model.state_dict()
        model = Model(nodrop, device="cpu")
        model.load_state_dict(state)
    full = model.logits(toks)
    logits, cache = model.prefill(toks[:, :S])
    errs = [float((logits - full[:, S - 1]).abs().max())]
    cache = model.pad_cache(cache, EXTRA)
    for t in range(S, S + EXTRA):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) / (float(full.abs().max()) + 1e-9) < REL


def test_greedy_generate(case):
    _name, model, toks, want = case
    got = generate(model, toks[:, :S], GEN)
    assert got.shape == (B, GEN)
    greedy_agree(got.numpy(), want["greedy"], want["gap"], want["top"],
                 want["tol"])


@pytest.mark.parametrize("name", ["yi-9b", "granite-34b", "rwkv6-7b",
                                  "yi-swa", "mixtral-8x22b",
                                  "deepseek-v2-236b", "jamba-v0.1-52b"])
def test_init_cache_matches_jax(name):
    jc, pc = configs(name)
    want = layer_slices(JaxModel(jc).init_cache(2, 12), jc.n_layers)
    got = Model(pc, device="cpu").init_cache(2, 12)
    assert len(got) == len(want)
    for mine, theirs in zip(got, want):
        assert sorted(mine) == sorted(theirs)
        for k, a in theirs.items():
            assert tuple(mine[k].shape) == a.shape, k
            assert str(mine[k].dtype).split(".")[-1] == a.dtype.name, k
            assert not mine[k].any()


def test_bf16_logits_and_decode():
    """yi's smoke config in bf16, the JAX model's bf16 init bridged
    through float32 (bf16 values are exact in float32).  The two
    frameworks round bf16 intermediates at different places, so the port
    is held to JAX's own bf16 error: against JAX's bf16 logits it must lie
    closer than those lie to the float32 model's on the same weights, and
    its own distance to the float32 logits may be at most twice JAX's."""
    jc = jax_registry.get_config("yi-9b", smoke=True)
    jm = JaxModel(jc)
    jm32 = JaxModel(f32(jc, True))
    params = jm.init(jax.random.PRNGKey(3))
    p32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                 params)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (B, S + 1))
    jt = jnp.asarray(toks, jnp.int32)
    model = lm_params_from(to_np(params), registry.get_config("yi-9b", True),
                           device="cpu")
    assert model.layers[0].mixer["wq"].dtype == torch.bfloat16

    def decode_one(m, p):
        _lg, cache = m.prefill(p, jt[:, :S])
        lg, _ = m.decode_step(p, jt[:, S:], m.pad_cache(cache, 1),
                              jnp.int32(S))
        return np.asarray(lg, np.float32)

    _pl, pc = model.prefill(torch.as_tensor(toks[:, :S]))
    plg, _ = model.decode_step(torch.as_tensor(toks[:, S:]),
                               model.pad_cache(pc, 1), S)
    got = model.logits(torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16 and plg.dtype == torch.bfloat16
    for mine, theirs, exact in (
            (got, jm.logits(params, jt)[0], jm32.logits(p32, jt)[0]),
            (plg, decode_one(jm, params), decode_one(jm32, p32))):
        theirs = np.asarray(theirs, np.float32)
        jax_err = rel_err(theirs, exact)
        assert rel_err(mine, theirs) < jax_err
        assert rel_err(mine, exact) < 2 * jax_err


@pytest.mark.parametrize("arch", RUNNABLE)
def test_numpy_params_laid_out_as_jax_init(arch):
    jc, pc = configs(arch)
    jtree = JaxModel(jc).init(jax.random.PRNGKey(0))
    ntree = numpy_lm_params(pc, seed=0)
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    nl = list(tree_leaves(ntree))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in p)
        for p, _ in nl]
    for (_p, a), (path, b) in zip(jl, nl):
        assert a.shape == b.shape and b.dtype == np.float32, path
        a = np.asarray(a)
        if (a == a.flat[0]).all():          # zeros / ones initializers
            np.testing.assert_array_equal(a, b)
        elif a.size >= 2000:                # same distribution
            assert abs(b.std() / a.std() - 1) < 0.1, path
    # numpy_lm_params is a pure function of (cfg, seed)
    again = numpy_lm_params(pc, seed=0)
    for (_p, a), (_q, b) in zip(nl, tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_numpy_params_drive_both_models():
    jc, pc = configs("rwkv6-7b")
    tree = numpy_lm_params(pc, seed=5)
    toks = np.random.default_rng(6).integers(0, jc.vocab, (B, S))
    jm, jt = JaxModel(jc), jnp.asarray(toks, jnp.int32)
    full, _ = jm.logits(jax.tree_util.tree_map(jnp.asarray, tree), jt)
    moved, _ = jm.logits(one_ulp(tree, 1), jt)
    got = lm_params_from(tree, pc, device="cpu").logits(torch.as_tensor(toks))
    assert rel_err(got, full) < max(REL, rel_err(np.asarray(moved), full))


@pytest.mark.parametrize("arch", RUNNABLE)
def test_full_config_parameter_count(arch):
    """The full configs' spec trees count the reference's parameters."""
    cfg = registry.get_config(arch)
    assert param_count(model_specs(cfg)) == JaxModel(
        jax_registry.get_config(arch)).n_params()


def _normalised(cfg):
    d = dataclasses.asdict(cfg)
    d["param_dtype"] = str(d["param_dtype"]).split(".")[-1]
    return d


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jax_registry.list_archs())
def test_get_config_field_for_field(arch, smoke):
    mine = registry.get_config(arch, smoke=smoke)
    theirs = jax_registry.get_config(arch, smoke=smoke)
    want = dataclasses.asdict(theirs)
    want["param_dtype"] = jnp.dtype(want["param_dtype"]).name
    assert _normalised(mine) == want
    assert mine.is_encdec == theirs.is_encdec


def test_registry_and_shapes():
    from repro.configs.shapes import KERNEL_SHAPES as JAX_KERNEL_SHAPES
    from repro.configs.shapes import SHAPES as JAX_SHAPES

    assert registry.list_archs() == jax_registry.list_archs()
    with pytest.raises(KeyError):
        registry.get_config("gpt-5")
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for name in ("flash_attention", "rwkv_scan"):
        assert KERNEL_SHAPES[name] == JAX_KERNEL_SHAPES[name]


@pytest.mark.parametrize("arch", jax_registry.list_archs())
def test_unsupported_names_what_is_left(arch):
    """All ten configs run, full and smoke."""
    for smoke in (False, True):
        assert unsupported(registry.get_config(arch, smoke)) is None


def test_mla_without_moe_runs():
    """MLA without MoE (the prefix and a dense body) builds and runs."""
    mla = dataclasses.replace(registry.get_config("deepseek-v2-236b", True),
                              moe=None)
    model = serve_cli.build_model(mla, "cpu", seed=0)
    toks = serve_cli.make_prompts(mla, 2, 7, seed=1, device="cpu")
    logits = model.logits(toks)
    assert logits.shape == (2, 7, mla.vocab)
    assert torch.isfinite(logits.float()).all()
    assert generate(model, toks, 2).shape == (2, 2)


# ---------------------------------------------------------------------------
# serve engine
# ---------------------------------------------------------------------------


def _value_scorer_jax(items):
    return jnp.mean(items, axis=tuple(range(1, items.ndim)))


def _value_scorer(items):
    return items.float().mean(dim=tuple(range(1, items.dim())))


@pytest.mark.parametrize("vals,kw", [
    ([0, 5, 0, 5, 5, 0, 5, 0], dict(capacity=2)),
    ([3, 0, 3, 3], dict(capacity=4)),
    ([5] * 8, dict(capacity_fraction=0.25)),
    ([5] * 8, dict(capacity_fraction=0.0)),
    ([5] * 8, dict(capacity=99)),
    ([0, 0, 0, 0], dict(capacity=2)),
])
def test_cascade_serve_matches_jax(vals, kw):
    """tests/test_serving.py::TestCascadeServe's cases, both packages,
    with a pytree output."""
    reqs = np.tile(np.asarray(vals, np.float32)[:, None], (1, 3))

    def big_jax(x):
        return {"double": x * 2.0, "row_sum": jnp.sum(x, axis=-1)}

    def big(x):
        return {"double": x * 2.0, "row_sum": x.sum(dim=-1)}

    out_j, served_j, stats_j = jax_cascade_serve(
        _value_scorer_jax, big_jax, jnp.asarray(reqs), threshold=1.0, **kw)
    out, served, stats = cascade_serve(_value_scorer, big,
                                       torch.as_tensor(reqs), threshold=1.0,
                                       **kw)
    np.testing.assert_array_equal(served.numpy(), np.asarray(served_j))
    for k in out_j:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_j[k]))
    for k in stats_j:
        np.testing.assert_array_equal(np.asarray(stats[k]),
                                      np.asarray(stats_j[k]))


def test_cascade_serve_in_front_of_generate():
    """The CLI's --cascade: entropy scorer, then greedy generation of the
    survivors, the rest zeros."""
    cfg = registry.get_config("yi-9b", smoke=True)
    model = serve_cli.build_model(cfg, "cpu", seed=0)
    prompts = serve_cli.make_prompts(cfg, 6, 12, seed=1, device="cpu")
    toks, served, stats = cascade_serve(
        serve_cli.entropy_scorer(model),
        lambda b: generate(model, b, 3), prompts, threshold=0.0,
        capacity_fraction=0.5)
    assert int(stats["n_served"]) == 3 and served.sum() == 3
    np.testing.assert_array_equal(toks[served].numpy(),
                                  generate(model, prompts[served], 3).numpy())
    assert not toks[~served].any()


@pytest.mark.parametrize("top_k", [0, 1, 7, 12])
def test_sample(top_k):
    logits = torch.as_tensor(np.random.default_rng(0).normal(
        size=(5, 7)).astype(np.float32))
    greedy = sample(logits, None, SamplerConfig())
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jnp.argmax(logits.numpy(), -1)))
    cfg = SamplerConfig(temperature=1.0, top_k=top_k)
    a = sample(logits, torch.Generator().manual_seed(3), cfg)
    b = sample(logits, torch.Generator().manual_seed(3), cfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    if 0 < top_k < 7:
        allowed = torch.topk(logits, top_k, dim=-1).indices
        assert (allowed == a[:, None]).any(dim=-1).all()
    if top_k == 1:
        np.testing.assert_array_equal(a.numpy(), greedy.numpy())


@pytest.mark.parametrize("argv", [
    ["--arch", "yi-9b", "--smoke"],
    ["--arch", "mixtral-8x22b", "--smoke"],
    ["--arch", "deepseek-v2-236b", "--smoke"],
    ["--arch", "jamba-v0.1-52b", "--smoke"],
    ["--arch", "rwkv6-7b", "--cascade"],
    ["--arch", "granite-34b", "--temperature", "0.7"],
])
def test_cli_on_the_cpu(argv, capsys):
    toks = serve_cli.main(argv + ["--device", "cpu", "--requests", "4",
                                  "--prompt-len", "9", "--gen", "3"])
    assert toks.shape == (4, 3)
    assert "[serve]" in capsys.readouterr().out


def test_cli_smoke_flag_reaches_full_configs(monkeypatch):
    """``--no-smoke`` asks for the full config (the JAX CLI's ``--smoke``
    is always on); stop before building anything."""
    seen = []

    def get_config(arch, smoke):
        seen.append(smoke)
        raise SystemExit(0)

    monkeypatch.setattr(serve_cli, "get_config", get_config)
    for flag in ("--smoke", "--no-smoke"):
        with pytest.raises(SystemExit):
            serve_cli.main(["--device", "cpu", flag])
    assert seen == [True, False]


def test_rope_freqs_resolves_its_device(monkeypatch):
    """``rope_freqs`` picks its device as every entry point does: the CPU
    when asked for it, with the float64 fold rounded once; the card when
    None, which raises where there is none rather than falling back."""
    from repro_torch.models.layers import rope_freqs

    exact = 1.0 / 10000.0 ** (np.arange(0, 128, 2) / 128)
    got = rope_freqs(128, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    assert rope_freqs(128, device=torch.device("cpu")) is got   # cached
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rope_freqs(128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rope_freqs(64, device=None)
