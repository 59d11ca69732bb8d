"""The port's pod-scale cost stack (``core.costmodel.Roofline``,
``core.placement``'s sharding-plan solver, ``core.reduction``'s
error-feedback compressors and boundary compression) against the JAX
package, on the CPU.

Tolerances: none.  The roofline and the planner are the reference's
Python float arithmetic in its order, so every term, row, table and
reason is equal with ``==``.  The compressors follow the reference as
``jit`` compiles it (``/ 127.0`` a reciprocal multiply: ``div_const``),
so their codes, scales, dequantized values and residuals are bit-equal to
``jax.jit`` of the reference's, ties and all.  The pod all-reduce and the
compressed train step are in tests/test_torch_compressed_train.py.
"""

import dataclasses
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.core import costmodel as jcost
from repro.core import placement as jplace
from repro.core import reduction as jred
from repro.launch.plan_search import candidates

from repro_torch.core import costmodel as pcost
from repro_torch.core import placement as pplace
from repro_torch.core import reduction as pred

torch.set_num_threads(1)

ROUNDS = 20


# -- the roofline -------------------------------------------------------------


def test_pod_profiles_are_the_reference_s():
    for name in ("TPU_V5E", "POD_LINK"):
        assert (dataclasses.asdict(getattr(pcost, name))
                == dataclasses.asdict(getattr(jcost, name)))
    assert pcost.H100_SXM.flops_per_s == 989e12
    assert pcost.H100_SXM.mem_bw == 3.35e12


def _profile(mod, p):
    return mod.HardwareProfile(**dataclasses.asdict(p))


def _rooflines(args, chip=None, link=None):
    name, flops, hbm, coll, chips, mflops, ibytes = args
    kw = {}
    if chip is not None:
        kw = {"chip": chip, "link": link}
    pk = {k: _profile(pcost, v) for k, v in kw.items()}
    return (jcost.Roofline(name, flops, hbm, coll, chips, mflops, ibytes,
                           **kw),
            pcost.Roofline(name, flops, hbm, coll, chips, mflops, ibytes,
                           **pk))


PROPS = ("compute_s", "memory_s", "collective_s", "step_s", "dominant",
         "useful_flop_fraction", "ideal_s", "roofline_fraction")


def _same_roofline(j, p):
    for prop in PROPS:
        assert getattr(p, prop) == getattr(j, prop), prop
    assert p.row() == j.row()


@given(st.floats(0.0, 1e21), st.floats(0.0, 1e15), st.floats(0.0, 1e14),
       st.integers(1, 4096), st.floats(0.0, 1e21), st.floats(0.0, 1e15))
@settings(max_examples=40, deadline=None)
def test_roofline_equals_reference(flops, hbm, coll, chips, mflops, ibytes):
    args = ("drawn", flops, hbm, coll, chips, mflops, ibytes)
    rows = []
    card = jcost.HardwareProfile("h100_sxm", flops_per_s=989e12,
                                 mem_bw=3.35e12)
    for prof, link in ((None, None), (jcost.TPU_V5E, jcost.POD_LINK),
                       (card, jcost.TPU_V5E)):
        j, p = _rooflines(args, prof, link)
        _same_roofline(j, p)
        rows.append((j, p))
    assert (pcost.format_roofline_table([p for _j, p in rows])
            == jcost.format_roofline_table([j for j, _p in rows]))


@pytest.mark.parametrize("args", [
    ("zeros", 0.0, 0.0, 0.0, 1, 0.0, 0.0),
    ("memory-bound decode", 1e12, 5e11, 0.0, 8, 0.0, 4e11),
    ("compute", 4e18, 1e13, 1e12, 256, 3e18, 0.0),
    ("a name longer than the thirty-eight columns", 1.0, 2.0, 3.0, 3,
     1.0, 2.0),
    ("ties", 197e12, 819e9, 50e9, 1, 197e12, 0.0)])
def test_roofline_edges_equal_reference(args):
    j, p = _rooflines(args)
    _same_roofline(j, p)
    assert (pcost.format_roofline_table([p])
            == jcost.format_roofline_table([j]))


# -- the sharding-plan solver -------------------------------------------------


def _port_plan(plan):
    return pplace.ShardingPlan(**dataclasses.asdict(plan))


def _grid():
    plans = []
    for chips, pods in ((1, 1), (8, 1), (16, 2), (64, 4), (256, 1),
                        (256, 2)):
        plans += candidates(chips, pods)
    plans += [jplace.ShardingPlan("ep", data=2, tensor=4, expert=4),
              jplace.ShardingPlan("sp", data=2, sequence=4, pod=2,
                                  grad_compress=True),
              jplace.ShardingPlan("all", data=2, fsdp=2, tensor=2, expert=2,
                                  sequence=2, pod=2)]
    return plans


MODELS = {
    "dense": dict(params=8.83e9, active_params=8.83e9, d_model=4096,
                  n_layers=48),
    "moe": dict(params=1.41e11, active_params=3.9e10, d_model=6144,
                n_layers=56, n_experts=8, top_k=2),
}


def _estimators(model, train, hbm_gib):
    seq, batch = (4096, 256) if train else (1, 128)
    tokens = seq * batch
    kw = dict(MODELS[model], name=f"{model}|{'train' if train else 'serve'}",
              layer_flops=2 * MODELS[model]["active_params"] * tokens,
              train=train, tokens=tokens, seq=seq, batch=batch,
              hbm_gib=hbm_gib)
    return (lambda plan: jplace.estimate_plan(plan, **kw),
            lambda plan: pplace.estimate_plan(plan, **kw))


def _same_score(j, p):
    assert dataclasses.asdict(p.plan) == dataclasses.asdict(j.plan)
    assert p.feasible == j.feasible
    assert p.why_infeasible == j.why_infeasible
    for f in ("name", "flops", "hbm_bytes", "collective_bytes", "n_chips",
              "model_flops", "ideal_bytes"):
        assert getattr(p.roofline, f) == getattr(j.roofline, f), f
    _same_roofline(j.roofline, p.roofline)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("hbm_gib", [16.0, 80])
def test_estimate_plan_equals_reference(model, train, hbm_gib):
    jest, pest = _estimators(model, train, hbm_gib)
    for plan in _grid():
        pp = _port_plan(plan)
        assert pp.n_chips == plan.n_chips
        assert pp.describe() == plan.describe()
        _same_score(jest(plan), pest(pp))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("hbm_gib", [16.0, 80, 1e-3])
def test_solve_and_rank_sharding_equal_reference(model, train, hbm_gib):
    jest, pest = _estimators(model, train, hbm_gib)
    grid = _grid()
    pgrid = [_port_plan(p) for p in grid]
    j, p = jplace.solve_sharding(grid, jest), pplace.solve_sharding(pgrid,
                                                                   pest)
    _same_score(j, p)
    jr = jplace.rank_sharding(grid, jest)
    pr = pplace.rank_sharding(pgrid, pest)
    assert [s.plan.describe() for s in pr] == [s.plan.describe() for s in jr]
    for a, b in zip(jr, pr):
        _same_score(a, b)


# -- the error-feedback compressors -------------------------------------------


def _round32(exact: Fraction) -> np.float32:
    """``exact`` rounded once to float32, half to even."""
    x0 = np.float32(float(exact))
    cands = [np.nextafter(x0, np.float32(-np.inf)), x0,
             np.nextafter(x0, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.asarray(c).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """``fma32(q, s, c)`` == q * s + c rounded once, on drawn codes, scales
    and partial sums, and on products at exact float32 midpoints with a
    partial sum below float64's resolution of them, either sign, where
    rounding the float64 sum to float32 would round twice (the control)."""
    rng = np.random.default_rng(7)
    q = rng.integers(-127, 128, 2000).astype(np.int8)
    s = (rng.random(2000) * 0.1).astype(np.float32)
    c = (rng.standard_normal(2000) * 3).astype(np.float32)
    mids = []
    for m in rng.integers(2 ** 23, 2 ** 24, 4000):
        if (3 * int(m)) % 4 == 2 and 3 * int(m) >= 2 ** 25:
            mids.append(np.float32(int(m) * 2.0 ** -23))    # 3 s: a midpoint
        if len(mids) == 100:
            break
    tiny = np.float32(2.0 ** -60)
    q = np.concatenate([q, np.full(200, 3, np.int8)])
    s = np.concatenate([s, np.array(mids * 2, np.float32)])
    c = np.concatenate([c, np.repeat(np.float32([tiny, -tiny]), 100)])
    got = pred.fma32(torch.as_tensor(q), torch.as_tensor(s),
                     torch.as_tensor(c)).numpy()
    want = np.array([_round32(Fraction(int(a)) * Fraction(float(b))
                              + Fraction(float(d)))
                     for a, b, d in zip(q, s, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    twice = (q.astype(np.float64) * s + c).astype(np.float32)
    assert (twice[-200:] != want[-200:]).sum() >= 50


@functools.partial(jax.jit, static_argnames="block")
def _jax_ef_int8(x, r, block):
    (q, s), deq, st_ = jred.ef_compress_int8(x, jred.EFState(r), block=block)
    return q, s, deq, st_.residual


def tie_input(n, block, seed):
    """Normals with all-zero blocks and, in every fourth block, values at
    exact .5 ties of x / scale: the block's absmax is 127 (scale 1, as the
    reference computes it) and the others k + 1/2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * 3
    nb = -(-n // block)
    for b in range(nb):
        lo, hi = b * block, min((b + 1) * block, n)
        if b % 5 == 1:
            x[lo:hi] = 0
        elif b % 4 == 0 and hi - lo > 1:
            k = rng.integers(-126, 126, hi - lo).astype(np.float32)
            x[lo:hi] = k + np.float32(0.5)
            x[lo] = 127
    return x


def test_tie_input_has_exact_ties():
    x = tie_input(2000, 256, 0)
    scale = np.float32(127) * (np.float32(1) / np.float32(127))
    assert scale == 1
    y = x / scale
    assert (np.abs(y - np.floor(y)) == 0.5).sum() > 100


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("n", [256 * 8, 1000, 2000 + 77])
def test_ef_compress_int8_equals_jitted_jax(block, n):
    """20 feedback rounds; each round's input is the first scaled by
    1 + 0.01 i, as tests/test_core.py's EF test."""
    x0 = tie_input(n, block, n + block)
    jr = np.zeros(n, np.float32)
    state = pred.EFState.init(torch.as_tensor(x0))
    for i in range(ROUNDS):
        x = (x0 * np.float32(1 + 0.01 * i)).astype(np.float32)
        jq, js, jdeq, jr = (np.asarray(a) for a in _jax_ef_int8(
            jnp.asarray(x), jnp.asarray(jr), block=block))
        (q, s), deq, state = pred.ef_compress_int8(torch.as_tensor(x), state,
                                                   block=block)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), jq), i
        assert np.array_equal(s.numpy().view(np.int32), js.view(np.int32)), i
        assert np.array_equal(deq.numpy().view(np.int32),
                              jdeq.view(np.int32)), i
        assert np.array_equal(state.residual.numpy().view(np.int32),
                              jr.view(np.int32)), i


def test_ef_compress_int8_keeps_shape_and_dtype():
    x = torch.randn(3, 5, 7, dtype=torch.bfloat16)
    (q, s), deq, st_ = pred.ef_compress_int8(x, pred.EFState.init(x))
    assert q.shape == (1, 256) and s.shape == (1, 1)
    assert deq.shape == x.shape and deq.dtype == torch.float32
    assert st_.residual.dtype == torch.float32


@jax.jit
def _jax_topk(x, r):
    (v, i), dense, st_ = jred.ef_compress_topk(x, jred.EFState(r),
                                               k_fraction=0.1)
    return v, i, dense, st_.residual


def topk_ties(n, seed):
    """Magnitudes from a few levels with random signs: exact ties at and
    around the k-th magnitude."""
    rng = np.random.default_rng(seed)
    mag = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0, 3.0]), n,
                     p=[0.3, 0.3, 0.2, 0.15, 0.05])
    return (mag * rng.choice([-1, 1], n)).astype(np.float32)


@pytest.mark.parametrize("shape", [(240,), (16, 25), (1000,)])
def test_ef_compress_topk_equals_jitted_jax(shape):
    n = int(np.prod(shape))
    x = topk_ties(n, n).reshape(shape)
    k = max(1, int(n * 0.1))
    flat = np.abs(x.reshape(-1))
    kth = np.sort(flat)[::-1][k - 1]
    assert (flat == kth).sum() > 1 and (np.sort(flat)[::-1][k] == kth)
    jr = np.zeros(shape, np.float32)
    state = pred.EFState.init(torch.as_tensor(x))
    for i in range(ROUNDS):
        jv, ji, jd, jr = (np.asarray(a) for a in _jax_topk(
            jnp.asarray(x), jnp.asarray(jr)))
        (v, idx), dense, state = pred.ef_compress_topk(
            torch.as_tensor(x), state, k_fraction=0.1)
        assert np.array_equal(idx.numpy(), ji), i
        assert np.array_equal(v.numpy().view(np.int32), jv.view(np.int32))
        assert np.array_equal(dense.numpy().view(np.int32),
                              jd.view(np.int32))
        assert np.array_equal(state.residual.numpy().view(np.int32),
                              jr.view(np.int32))


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("shape", [(3, 300), (512,), (7, 11, 5)])
def test_compress_boundary_equals_jax(bits, shape):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jred.compress_boundary(
        a, bits=bits))(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(
        jred.compress_boundary(a, bits=bits) * w))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = pred.compress_boundary(xt, bits=bits)
    (got * torch.as_tensor(w)).sum().backward()
    assert np.array_equal(got.detach().numpy().view(np.int32),
                          want.view(np.int32))
    assert np.array_equal(xt.grad.numpy(), jgrad)
    assert np.array_equal(jgrad, w)              # the identity


# -- tests/test_core.py's reduction invariants, in the port -------------------


def _normal(seed, shape):
    return torch.as_tensor(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_error_feedback_bounded():
    x = _normal(4, 1024)
    st_ = pred.EFState.init(x)
    norms = []
    for i in range(ROUNDS):
        _, _, st_ = pred.ef_compress_int8(x * (1 + 0.01 * i), st_)
        norms.append(float(torch.linalg.norm(st_.residual)))
    assert max(norms) < 0.1 * float(torch.linalg.norm(x))


def test_topk_ef_converges_on_constant_input():
    x = _normal(5, 256)
    st_ = pred.EFState.init(x)
    acc = torch.zeros_like(x)
    for _ in range(40):
        _, dense, st_ = pred.ef_compress_topk(x, st_, k_fraction=0.1)
        acc += dense
    assert float(torch.linalg.norm(acc / 40 - x)) < 0.2 * float(
        torch.linalg.norm(x))


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_error_feedback_time_average_converges(seed):
    x = _normal(seed, 512)
    state = pred.EFState.init(x)
    acc = torch.zeros_like(x)
    n = 24
    for _ in range(n):
        _, deq, state = pred.ef_compress_int8(x, state, block=128)
        acc = acc + deq
    mean_err = float(torch.linalg.norm(acc / n - x))
    one_shot = float(torch.linalg.norm(
        pred.dequantize_int8(*pred.quantize_int8(x, block=128), x.shape) - x))
    assert mean_err < one_shot / 4
    assert float(state.residual.abs().max()) < 0.2


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_bit_knee_shape(seed):
    x = _normal(seed, 4096)
    nrm = float(torch.linalg.norm(x))
    rel = {b: float(torch.linalg.norm(pred.quantize_bits(x, b) - x)) / nrm
           for b in (16, 8, 4)}
    assert rel[16] < rel[8] < rel[4]
    assert rel[8] < 0.02
    assert rel[4] > 0.05
    assert rel[16] < 1e-3
