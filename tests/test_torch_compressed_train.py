"""The port's compressed gradient exchange and compressed train step
(``core.reduction.compressed_pod_allreduce`` /
``uncompressed_pod_allreduce``, ``train.step.exchange_grads`` /
``make_train_step_compressed``) against the JAX package, on the CPU.

The pod axis is a ``torch.distributed`` gloo group of spawned processes
(``file://`` init), one a mesh device, ranks in the mesh's device order
(pod-major); the reference runs ``shard_map`` on the same mesh of fake
CPU devices, through tests/conftest.py's ``subproc``.  Every process
starts at once, in threads, while the in-process tests run.

Tolerances, each with its reason:

* the pod all-reduce, compressed and not, at 2 pods and at 2 pods x 2
  inner ranks, three feedback rounds: each rank's output and residual
  bit-equal to the reference's shard (the sums run in the reference's
  device order);
* the stacked-leaf blocking: the port's per-layer slices compressed over
  their concatenation equal the reference's whole-leaf compression bit for
  bit, at SMOKE widths (a norm's 64 values cross blocks) and at widths
  whose slices hold whole blocks (slice by slice, no concatenation);
* the compressed train step on yi-9b's SMOKE config in float32, at 1 pod
  and 2 pods, against the reference's step on a mesh with
  ``AxisType.Auto`` axes: at step 0, from the same weights, every int8
  code equal to JAX's (from ``quantize_int8`` of JAX's own gradient of
  the pod's rows) except near ties: JAX's target / scale within the
  distance between the two quotients, plus an ulp, of a rounding boundary
  k + 1/2; each step, started from JAX's state through the bridge
  (parameters, optimizer state, residuals), its loss, grad norm and
  residual norm within max(1e-4, E), E their one-ulp sensitivity at that
  step over ONE_ULP_SEEDS; lr bit for bit;
* the JAX compressed-training record
  (``assets/lm_compressed_train_reference.npz``) through chip_smoke's own
  ``compressed_record_check`` at 1 pod and, in two gloo processes, at 2.
"""

import dataclasses
import os
import pickle
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compressed_record_check
from repro.core import reduction as jred

from repro_torch.bridge import (
    ef_from_jax_tree,
    from_jax_tree,
    lm_params_from,
    load_lm_compressed_train_reference,
    numpy_lm_params,
)
from repro_torch.configs import registry
from repro_torch.core import reduction as pred
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
FLOOR = 1e-4
ONE_ULP_SEEDS = tuple(range(5, 13))
ROUNDS = 3
SEQ, BATCH = 32, 4
OPT = dict(lr_peak=3e-3, warmup_steps=1, decay_steps=3)
STEPS = 3
SHARD = (3, 700)                    # a rank's gradient: 2100 values, 8
                                    # blocks of 256 and a ragged 52


def smoke_cfg(**over):
    return dataclasses.replace(registry.get_config("yi-9b", smoke=True),
                               param_dtype=torch.float32, **over)


def tokens(vocab, step):
    return batch_for_step(DataConfig(vocab, SEQ, BATCH, 0), step)["tokens"]


# -- the spawned processes ----------------------------------------------------


def ar_inputs(world):
    """The global gradient of each round, (world * 3, 700) float32, split on
    dim 0 one shard a rank: normals at several scales, a rank's first two
    blocks zero, and the last rank's shard all zero in round 1."""
    rng = np.random.default_rng(world)
    g = rng.standard_normal((world * SHARD[0], SHARD[1])).astype(np.float32)
    g *= np.repeat(np.float32([1, 30, 1e-3, 4])[:world], SHARD[0])[:, None]
    g.reshape(world, -1)[1, :512] = 0
    rounds = [(g * np.float32(1 + 0.25 * r)).astype(np.float32)
              for r in range(ROUNDS)]
    rounds[1].reshape(world, -1)[world - 1] = 0
    return rounds


JAX_AR = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.reduction import EFState, compressed_pod_allreduce, \\
    uncompressed_pod_allreduce
from repro.parallel.axes import compat_shard_map
sys.path.insert(0, {tests!r})
from test_torch_compressed_train import ar_inputs

out = {{}}
for world, shape, names, inner in ((2, (2,), ("pod",), ()),
                                   (4, (2, 2), ("pod", "data"), ("data",))):
    mesh = jax.make_mesh(shape, names, devices=jax.devices()[:world])
    spec = P(names)

    def body(g, ef):
        o, st = compressed_pod_allreduce(g, EFState(ef), pod_axis="pod",
                                         inner_axes=inner)
        return o, st.residual

    f = jax.jit(compat_shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec), check_vma=False))
    u = jax.jit(compat_shard_map(
        lambda g: uncompressed_pod_allreduce(g, pod_axis="pod",
                                             inner_axes=inner),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))
    rounds = ar_inputs(world)
    ef = jnp.zeros_like(rounds[0])
    res = []
    for g in rounds:
        o, ef = f(jnp.asarray(g), ef)
        res.append((np.asarray(o), np.asarray(ef),
                    np.asarray(u(jnp.asarray(g)))))
    out[world] = res
pickle.dump(out, open({out!r}, "wb"))
"""

RANK_PRELUDE = """
import os, pickle, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
sys.path.insert(0, {repo!r})
RANK, WORLD, OUT = {rank}, {world}, {out!r}
dist.init_process_group("gloo", init_method="file://" + {init!r},
                        rank=RANK, world_size=WORLD)
"""

PORT_AR = """
from repro_torch.core.reduction import EFState, compressed_pod_allreduce, \\
    uncompressed_pod_allreduce
from test_torch_compressed_train import SHARD, ar_inputs
if WORLD == 2:
    pod_group, inner_group = dist.group.WORLD, None
else:
    # the mesh's groups, every rank making each in the same order:
    # pod-major device order, inner ranks adjacent
    inner = [dist.new_group([p * 2 + i for i in range(2)]) for p in range(2)]
    pods = [dist.new_group([p * 2 + i for p in range(2)]) for i in range(2)]
    pod_group, inner_group = pods[RANK % 2], inner[RANK // 2]
state = None
res = []
for g in ar_inputs(WORLD):
    mine = torch.as_tensor(g.reshape(WORLD, *SHARD)[RANK].copy())
    state = state or EFState.init(mine)
    o, state = compressed_pod_allreduce(mine, state, pod_group=pod_group,
                                        inner_group=inner_group)
    u = uncompressed_pod_allreduce(mine, pod_group=pod_group,
                                   inner_group=inner_group)
    res.append((o.numpy(), state.residual.numpy(), u.numpy()))
pickle.dump(res, open(OUT, "wb"))
dist.destroy_process_group()
"""

JAX_STEPS = """
import pickle, sys
import jax, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_compressed_train import jax_compressed_steps
pickle.dump({{n: jax_compressed_steps(n) for n in (1, 2)}},
            open({out!r}, "wb"))
"""

PORT_STEPS = """
from test_torch_compressed_train import port_compressed_steps
want = pickle.load(open({jax_out!r}, "rb"))[2]
pickle.dump(port_compressed_steps(want, dist.group.WORLD, RANK),
            open(OUT, "wb"))
dist.destroy_process_group()
"""

PORT_RECORD = """
from chip_smoke import compressed_record_check
from repro_torch.bridge import load_lm_compressed_train_reference
rel = compressed_record_check(load_lm_compressed_train_reference(), "cpu",
                              dist.group.WORLD)
pickle.dump(rel, open(OUT, "wb"))
dist.destroy_process_group()
"""


def _ranks(subproc, code, world, tmp, tag, **kw):
    """Run ``code`` in ``world`` gloo processes at once (threads around
    ``subproc``); each rank's pickled result, in rank order."""
    init = str(tmp / f"{tag}.init")
    outs = [str(tmp / f"{tag}.{r}.pkl") for r in range(world)]
    src = [RANK_PRELUDE.format(tests=TESTS, repo=REPO, rank=r, world=world,
                               out=outs[r], init=init)
           + textwrap.dedent(code).format(**kw) for r in range(world)]
    with ThreadPoolExecutor(world) as pool:
        list(pool.map(lambda s: subproc(s, 1), src))
    return [pickle.load(open(o, "rb")) for o in outs]


def _jax(subproc, code, n_devices, tmp, tag):
    out = str(tmp / f"{tag}.pkl")
    subproc(code.format(tests=TESTS, out=out), n_devices)
    return out


@pytest.fixture(scope="module")
def spawned(subproc, tmp_path_factory):
    """Every spawned job, started at once: -> ``get(name)``, its result."""
    tmp = tmp_path_factory.mktemp("compressed")

    def steps():
        out = _jax(subproc, JAX_STEPS, 2, tmp, "jax_steps")
        port = _ranks(subproc, PORT_STEPS, 2, tmp, "port_steps",
                      jax_out=out)
        return pickle.load(open(out, "rb")), port

    jobs = {
        "jax_ar": lambda: pickle.load(open(_jax(subproc, JAX_AR, 4, tmp,
                                                "jax_ar"), "rb")),
        "port_ar2": lambda: _ranks(subproc, PORT_AR, 2, tmp, "ar2"),
        "port_ar4": lambda: _ranks(subproc, PORT_AR, 4, tmp, "ar4"),
        "record2": lambda: _ranks(subproc, PORT_RECORD, 2, tmp, "record2"),
        "steps": steps,
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(f) for k, f in jobs.items()}
        yield lambda name: futures[name].result(timeout=600)


# -- the pod all-reduce -------------------------------------------------------


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("world", [2, 4])
def test_pod_allreduce_equals_reference_shards(spawned, world):
    """2 pods, and 2 pods x 2 inner ranks: each rank's compressed output,
    residual and uncompressed sum == the reference's shard, every round."""
    want = spawned("jax_ar")[world]
    ranks = spawned(f"port_ar{world}")
    for r, got in enumerate(ranks):
        for i, ((o, res, u), (jo, jres, ju)) in enumerate(zip(got, want)):
            shard = slice(r * SHARD[0], (r + 1) * SHARD[0])
            assert _bits(o, jo[shard]), (world, r, i, "out")
            assert _bits(res, jres[shard]), (world, r, i, "residual")
            assert _bits(u, ju[shard]), (world, r, i, "uncompressed")
    # the pods' sums differ from the exact sum by int8 quantization only
    exact = want[0][2]
    assert 0 < np.abs(want[0][0] - exact).max() < 0.02 * np.abs(exact).max()


def test_pod_allreduce_single_member_axes():
    """None groups stand for axes of one member: the output is the one
    pod's dequantized codes, as the reference's on a mesh of one."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal(1000).astype(np.float32)
    out, st_ = pred.compressed_pod_allreduce(torch.as_tensor(g),
                                             pred.EFState.init(
                                                 torch.as_tensor(g)))
    (_q, _s), deq, want = pred.ef_compress_int8(
        torch.as_tensor(g), pred.EFState.init(torch.as_tensor(g)))
    assert torch.equal(out, deq) and torch.equal(st_.residual, want.residual)
    assert torch.equal(pred.uncompressed_pod_allreduce(torch.as_tensor(g)),
                       torch.as_tensor(g))


# -- the stacked-leaf blocking ------------------------------------------------


@jax.jit
def _jax_ef(x, r):
    (_q, _s), deq, st_ = jred.ef_compress_int8(x, jred.EFState(r))
    return deq, st_.residual


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("over,whole", [
    ({}, False),
    ({"d_model": 256, "d_ff": 512, "d_head": 64}, True)])
def test_stacked_leaves_compress_as_whole_leaves(over, whole, monkeypatch):
    """Three rounds of drawn gradients through ``exchange_grads`` against
    the reference's ``ef_compress_int8`` of each whole (stacked) leaf: the
    sent gradients and residuals bit for bit.  At SMOKE widths a norm's
    64-value slices cross blocks and are concatenated; where every slice
    holds whole blocks nothing is concatenated."""
    model = lm_params_from(numpy_lm_params(smoke_cfg(**over), 0),
                           smoke_cfg(**over), "cpu")
    layout = step_mod.ef_leaves(model)
    ef = step_mod.init_ef_states(model)
    params = model.named_leaves()
    cats = []
    real_cat = torch.cat

    def counted_cat(*a, **kw):
        cats.append(1)
        return real_cat(*a, **kw)

    monkeypatch.setattr(torch, "cat", counted_cat)
    rng = np.random.default_rng(1)
    jres = {name: np.zeros(r.shape, np.float32) for name, r in ef.items()}
    ragged = [name for name, stacked, pn in layout
              if stacked and params[pn[0]].numel() % 256]
    assert bool(ragged) != whole
    for _ in range(ROUNDS):
        grads = {n: torch.as_tensor(rng.standard_normal(tuple(p.shape))
                                    .astype(np.float32))
                 for n, p in params.items()}
        stacked_g = {name: np.stack([grads[n].numpy() for n in pn])
                     if stacked else grads[pn[0]].numpy()
                     for name, stacked, pn in layout}
        out = step_mod.exchange_grads(layout, dict(grads), ef)
        for name, stacked, pn in layout:
            deq, jres[name] = (np.asarray(a) for a in _jax_ef(
                jnp.asarray(stacked_g[name]), jnp.asarray(jres[name])))
            got = np.stack([out[n].numpy() for n in pn]) if stacked else \
                out[pn[0]].numpy()
            assert _bits(got, deq), name
            assert _bits(ef[name].numpy(), jres[name]), name
    assert (len(cats) == 0) == whole
    assert len(cats) == ROUNDS * len(ragged)


def test_slices_alone_would_not_be_the_reference():
    """The control: a 64-value norm's slices compressed one by one differ
    from the whole stacked leaf's compression."""
    rng = np.random.default_rng(2)
    g = (rng.standard_normal((4, 64)) * np.float32([[1], [10], [0.1], [3]])
         ).astype(np.float32)
    want, _r = _jax_ef(jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    alone = np.stack([pred.ef_compress_int8(
        torch.as_tensor(s), pred.EFState.init(torch.as_tensor(s)))[1].numpy()
        for s in g])
    assert not np.array_equal(alone, np.asarray(want))


# -- the compressed train step ------------------------------------------------


def one_ulp(tree, seed):
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(np.nextafter(a, np.where(
            rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(np.float32)))

    return jax.tree_util.tree_map(move, tree)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _res_norm(ef_leaves) -> float:
    return float(np.sqrt(sum(np.sum(np.asarray(r, np.float64) ** 2)
                             for r in ef_leaves)))


def pod_trees(ef, npods) -> list:
    """Each pod's residual tree.  The reference's step returns the
    residuals as replicated over the pods (``out_specs`` ``P()``) while
    each pod's differ: a pod keeps its own on its device.  The initial
    zeros, on one device, are every pod's."""
    leaves, treedef = jax.tree_util.tree_flatten(ef)
    per = [[np.asarray(sh.data) for sh in sorted(
        leaf.addressable_shards, key=lambda sh: sh.device.id)]
        for leaf in leaves]
    return [jax.tree_util.tree_unflatten(treedef, [p[i % len(p)]
                                                   for p in per])
            for i in range(npods)]


def _pod_norms(ef, npods) -> list:
    return [_res_norm(jax.tree_util.tree_leaves(t))
            for t in pod_trees(ef, npods)]


def jax_compressed_steps(npods):
    """The reference's jitted compressed step at ``npods`` pods (run in a
    process with that many fake devices): per step the state before it,
    its loss, grad norm, lr and each pod's residual norm after it, and
    their one-ulp E; at step 0 each pod's targets (JAX's gradient of the
    pod's rows, residual 0), codes and scales per leaf, flat."""
    from repro.configs.registry import get_config
    from repro.models.transformer import Model
    from repro.parallel.axes import use_sharding
    from repro.train import optimizer as jopt
    from repro.train.step import init_ef_states, make_train_step_compressed

    jc = dataclasses.replace(get_config("yi-9b", smoke=True),
                             param_dtype=jnp.float32)
    model = Model(jc)
    mesh = jax.make_mesh((npods,), ("pod",), devices=jax.devices()[:npods],
                         axis_types=(jax.sharding.AxisType.Auto,))
    vg = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    q8 = jax.jit(lambda x: jred.quantize_int8(x))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    numpy_lm_params(smoke_cfg(), 0))
    state = jopt.init_opt_state(params)
    ef = init_ef_states(params)
    out = {"steps": [], "pods": []}
    with use_sharding(mesh):
        jstep = jax.jit(make_train_step_compressed(
            model, jopt.AdamWConfig(**OPT)))
        for t in range(STEPS):
            toks = tokens(jc.vocab, t)
            if t == 0:
                rows = BATCH // npods
                for p in range(npods):
                    _, g = vg(params, {"tokens": jnp.asarray(
                        toks[p * rows:(p + 1) * rows])})
                    leaves = {}
                    for path, x in jax.tree_util.tree_flatten_with_path(g)[0]:
                        q, s = q8(x)
                        leaves["/".join(k.key for k in path)] = (
                            np.asarray(x).reshape(-1),
                            np.asarray(q).reshape(-1), np.asarray(s))
                    out["pods"].append(leaves)
            jb = {"tokens": jnp.asarray(toks)}
            new_p, new_s, new_ef, met = jstep(params, state, ef, jb)
            want = {"loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    "res_norm": np.array(_pod_norms(new_ef, npods))}
            e = {k: 0.0 * v for k, v in want.items()}
            for seed in ONE_ULP_SEEDS:
                moved = state._replace(master=one_ulp(state.master, seed))
                _p, _s, m_ef, m = jstep(one_ulp(params, seed), moved, ef, jb)
                got = {"loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "res_norm": np.array(_pod_norms(m_ef, npods))}
                for k in want:
                    e[k] = np.maximum(e[k], np.abs(got[k] - want[k])
                                      / np.abs(want[k]))
            out["steps"].append(dict(
                params=_host(params), state=_host(state._asdict()),
                ef=pod_trees(ef, npods), want=want, e=e,
                lr=np.float32(met["lr"])))
            params, state, ef = new_p, new_s, new_ef
    return out


class _Codes:
    """Keeps each ``ef_compress_int8`` call's target, codes and scales."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._fn = pred.ef_compress_int8

        def spy(x, state, block=256):
            out = self._fn(x, state, block=block)
            (q, s), _deq, _st = out
            self.calls.append(((x.float() + state.residual).reshape(-1),
                               q.reshape(-1), s.reshape(-1)))
            return out

        pred.ef_compress_int8 = spy
        return self

    def __exit__(self, *exc):
        pred.ef_compress_int8 = self._fn

    def by_leaf(self, model):
        """The calls of one exchange gathered per reference leaf: (target,
        codes, scales) flat over the whole leaf."""
        params, calls, out = model.named_leaves(), iter(self.calls), {}
        for name, _stacked, pn in step_mod.ef_leaves(model):
            n = params[pn[0]].numel()
            k = step_mod.n_calls(len(pn), n)
            parts = [next(calls) for _ in range(k)]
            t, q, s = (torch.cat([p[i] for p in parts]).numpy()
                       for i in range(3))
            out[name] = (t, q, s)
        return out


def port_compressed_steps(want, pod_group=None, rank=0):
    """The port's compressed step from each of JAX's states (``want``:
    ``jax_compressed_steps``' result at this pod count): per step the
    metrics and residual norm; at step 0 this pod's codes per leaf."""
    pc = smoke_cfg()
    model = lm_params_from(numpy_lm_params(pc, 0), pc, "cpu")
    step_fn = step_mod.make_train_step_compressed(
        model, opt.AdamWConfig(**OPT), pod_group)
    npods = pred.pod_count(pod_group)
    rows = BATCH // npods
    got = {"steps": []}
    for t, js in enumerate(want["steps"]):
        model.load_tree(js["params"])
        st = js["state"]
        state = opt.OptState(
            step=torch.tensor(int(st["step"]), dtype=torch.int32),
            master=from_jax_tree(model, st["master"]),
            mu=from_jax_tree(model, st["mu"]),
            nu=from_jax_tree(model, st["nu"]))
        ef = ef_from_jax_tree(model, js["ef"][rank])
        toks = torch.as_tensor(tokens(pc.vocab, t)[rank * rows:
                                                   (rank + 1) * rows])
        with _Codes() as codes:
            _s, ef, met = step_fn(state, ef, {"tokens": toks})
        if t == 0:
            got["codes"] = codes.by_leaf(model)
        got["steps"].append({
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "res_norm": _res_norm([r.numpy() for r in ef.values()]),
            "lr": np.float32(float(met["lr"]))})
    return got


def near_tie_check(got_codes, want_codes):
    """Every differing code a near tie (module docstring); returns the
    count of differing codes and of codes."""
    differ = total = 0
    for name, (jt, jq, js) in want_codes.items():
        pt, pq, ps = got_codes[name]
        js = js.reshape(-1)
        assert len(pq) == len(jq) and len(ps) == len(js), name
        block = np.arange(len(jq)) // 256
        bad = np.flatnonzero(pq != jq)
        differ += len(bad)
        total += len(jq)
        if not len(bad):
            continue
        y_j = jt[bad].astype(np.float64) / js[block[bad]]
        y_p = pt[bad].astype(np.float64) / ps[block[bad]]
        dist = np.abs(y_j - (np.floor(y_j) + 0.5))
        ulp = np.spacing(np.abs(y_j).astype(np.float32)).astype(np.float64)
        assert (np.abs(pq[bad].astype(int) - jq[bad]) == 1).all(), name
        assert (dist <= np.abs(y_p - y_j) + ulp).all(), (
            name, dist, np.abs(y_p - y_j))
    return differ, total


def _held_steps(got, want, rank=0):
    for t, (g, js) in enumerate(zip(got["steps"], want["steps"])):
        for k in ("loss", "grad_norm", "res_norm"):
            w, e = js["want"][k], js["e"][k]
            if k == "res_norm":                 # this pod's
                w, e = w[rank], e[rank]
            rel = abs(g[k] - w) / abs(w)
            assert rel <= max(FLOOR, e), (rank, t, k, rel, e)
        assert g["lr"] == js["lr"], t


@pytest.fixture(scope="module")
def jax_steps(spawned):
    return spawned("steps")


def test_compressed_step_one_pod(jax_steps):
    want = jax_steps[0][1]
    got = port_compressed_steps(want)
    differ, total = near_tie_check(got["codes"], want["pods"][0])
    assert differ <= total * 1e-3, (differ, total)
    _held_steps(got, want)


def test_compressed_step_two_pods(jax_steps):
    want, ranks = jax_steps[0][2], jax_steps[1]
    for rank, got in enumerate(ranks):
        differ, total = near_tie_check(got["codes"], want["pods"][rank])
        assert differ <= total * 1e-3, (rank, differ, total)
        _held_steps(got, want, rank)
    for a, b in zip(*(r["steps"] for r in ranks)):
        assert all(a[k] == b[k] for k in ("loss", "grad_norm", "lr"))


# -- the JAX compressed-training record ---------------------------------------


def test_record_one_pod():
    rec = load_lm_compressed_train_reference()
    rel = compressed_record_check(rec, "cpu")
    assert len(rel["loss"]) == rec.steps


def test_record_two_pods(spawned):
    rec = load_lm_compressed_train_reference()
    ranks = spawned("record2")
    assert [len(r["loss"]) for r in ranks] == [rec.steps] * 2
    assert ranks[0]["loss"] == ranks[1]["loss"]
