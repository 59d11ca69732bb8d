"""The port's pure-Python offload stack against the JAX package's: the
cost model, the cut solver, the §III pipeline descriptors and their
calibration, the link simulator, and the cut controller.

All of it is host arithmetic in float64, so the two packages must agree
exactly.  The controller runs on deterministic stand-in executors (as
tests/test_offload.py:283 does) so that its fitted bytes, objectives and
chosen cut can be compared without wall-clock noise.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.camera.offload import BACKSCATTER as JAX_BACKSCATTER
from repro.camera.offload import CutController as JaxController
from repro.camera.offload import CutMeasurement as JaxMeasurement
from repro.camera.offload import WirePayload as JaxPayload
from repro.camera.offload import link as jlink
from repro.camera import pipelines as jpipe
from repro.core import costmodel as jcost
from repro.core import placement as jplace
from repro.core.pipeline import linear_pipeline as jax_linear_pipeline

from repro_torch.camera.offload import (
    BACKSCATTER,
    CutController,
    CutMeasurement,
    LinkProfile,
    WirePayload,
    link_energy_w,
    simulate_shared_link,
)
from repro_torch.camera.offload import link as tlink
from repro_torch.camera import pipelines as tpipe
from repro_torch.core import costmodel as tcost
from repro_torch.core import placement as tplace
from repro_torch.core.pipeline import linear_pipeline
from repro_torch.core.timing import block, timed

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

CUTS = ("sensor", "motion", "vj", "nn")
STATS = [dict(), dict(n_frames=10, motion_frames=5, windows_to_nn=17),
         dict(n_frames=62, motion_frames=22, windows_to_nn=549)]
DUTIES = {"sensor": 1.0, "motion": 1.0, "vj": 0.0, "nn": 1.0}


def _both(stats):
    return (jpipe.fa_pipeline(jpipe.FAWorkloadStats(**stats)),
            tpipe.fa_pipeline(tpipe.FAWorkloadStats(**stats)))


@pytest.mark.parametrize("stats", STATS)
def test_fa_pipeline_and_calibration_equal(stats):
    jp, tp = _both(stats)
    for i in range(len(tp)):
        assert tp.cut_payload_bytes(i) == jp.cut_payload_bytes(i)
        assert dataclasses.asdict(tp.blocks[i]) == dataclasses.asdict(
            jp.blocks[i]) | {"kind": tp.blocks[i].kind}
        assert tp.blocks[i].kind.value == jp.blocks[i].kind.value
    assert tp.total_flops() == jp.total_flops()
    jc = jpipe.calibrate_fa(jpipe.FAWorkloadStats(**stats))
    tc = tpipe.calibrate_fa(tpipe.FAWorkloadStats(**stats))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.nn_profile()) == dataclasses.asdict(
        jc.nn_profile())
    assert dataclasses.asdict(tc.rf_link()) == dataclasses.asdict(
        jc.rf_link())


def _profiles(mod_pipe, cal):
    prof = mod_pipe.fa_profiles()
    prof["nn"] = cal.nn_profile()
    return prof


@pytest.mark.parametrize("stats", STATS)
@pytest.mark.parametrize("regime", ["energy", "throughput"])
def test_cost_and_solver_equal(stats, regime):
    jp, tp = _both(stats)
    jc = jpipe.calibrate_fa(jpipe.FAWorkloadStats(**stats))
    tc = tpipe.calibrate_fa(tpipe.FAWorkloadStats(**stats))
    jprof, tprof = _profiles(jpipe, jc), _profiles(tpipe, tc)
    jl = jcost.HardwareProfile("rf", link_bw=8e3,
                               joules_per_byte=jc.rf_joules_per_byte)
    tl = tcost.HardwareProfile("rf", link_bw=8e3,
                               joules_per_byte=tc.rf_joules_per_byte)
    full_j = jp.configure(jp.optional_names)
    full_t = tp.configure(tp.optional_names)
    for cut in CUTS:
        if regime == "energy":
            a = jcost.energy_cost(full_j, jprof, jl, cut, duties=DUTIES)
            b = tcost.energy_cost(full_t, tprof, tl, cut, duties=DUTIES)
            assert (b.total_w, b.per_block_w) == (a.total_w, a.per_block_w)
        else:
            a = jcost.throughput_cost(full_j, jprof, jl, cut)
            b = tcost.throughput_cost(full_t, tprof, tl, cut)
            assert (b.fps, b.per_block_fps) == (a.fps, a.per_block_fps)
    for duties in (None, DUTIES):
        js = jplace.solve_cut(jp, jprof, jl, regime=regime, duties=duties)
        ts = tplace.solve_cut(tp, tprof, tl, regime=regime, duties=duties)
        assert (ts.cut_after, ts.objective) == (js.cut_after, js.objective)
        assert [r.config_name for r in ts.all_reports] == \
            [r.config_name for r in js.all_reports]
        assert tuple(b.name for b in ts.pipeline.blocks) == \
            tuple(b.name for b in js.pipeline.blocks)


def _traces(seed, shape):
    rng = np.random.default_rng(seed)
    tr = rng.exponential(300.0, shape)
    tr[rng.random(shape) < 0.3] = 0.0
    tr[rng.random(shape) < 0.05] = 1.0 / 8.0
    return tr


@pytest.mark.parametrize("seed,shape,period,duty,stagger", [
    (0, (1, 40), 1.0, 1.0, True), (1, (8, 30), 0.05, 1.0, True),
    (2, (4, 25), 0.2, 0.4, False), (3, (3, 0), 1.0, 1.0, True),
    (4, (16, 20), 0.01, 2.0, True)])
def test_simulate_shared_link_equal(seed, shape, period, duty, stagger):
    tr = _traces(seed, shape)
    for jl, tl in ((JAX_BACKSCATTER, BACKSCATTER),
                   (jlink.ETH_25G_LINK, tlink.ETH_25G_LINK),
                   (jlink.LinkProfile("l", 1000.0, 0.01, 1e-6),
                    LinkProfile("l", 1000.0, 0.01, 1e-6))):
        a = jlink.simulate_shared_link(tr, jl, period, duty=duty,
                                       stagger=stagger)
        b = simulate_shared_link(tr, tl, period, duty=duty, stagger=stagger)
        np.testing.assert_array_equal(b.latency_s, a.latency_s)
        for f in ("link", "n_streams", "frame_period_s", "bytes_total",
                  "joules", "utilization", "offered_bps", "delivered_fps",
                  "mean_latency_s", "p99_latency_s", "max_latency_s"):
            assert getattr(b, f) == getattr(a, f), f
        assert b.realtime_fraction(0.5) == a.realtime_fraction(0.5)
        assert link_energy_w(123.0, 2.0, tl) == jlink.link_energy_w(
            123.0, 2.0, jl)
    assert tlink.ETH_400G_LINK == LinkProfile(**dataclasses.asdict(
        jlink.ETH_400G_LINK))
    assert BACKSCATTER.scaled(0.5) == LinkProfile(**dataclasses.asdict(
        JAX_BACKSCATTER.scaled(0.5)))
    with pytest.raises(ValueError):
        BACKSCATTER.scaled(0.0)


def test_timing_waits_and_returns_the_output():
    seen = []

    def fn(x):
        seen.append(x)
        return {"a": torch.ones(3), "b": (torch.zeros(2), [1])}

    sec, out = timed(fn, 7, reps=2)
    assert sec >= 0 and len(seen) == 3 and torch.equal(out["a"], torch.ones(3))
    block(WirePayload("sensor", 8, {"x": torch.zeros(1)}, {}, torch.zeros(())))


# -- the controller ------------------------------------------------------------


class _FakeSplitExec:
    """Deterministic stand-in with the split-executor protocol."""

    def __init__(self, cut, wire_bytes):
        self.cut = cut
        self._b = float(wire_bytes)

    def encode(self, frames):
        return WirePayload(cut=self.cut, bits=8,
                           arrays={"x": torch.zeros((1,))}, meta={},
                           wire_b=torch.tensor(self._b))

    def decode_run(self, payload):
        return torch.zeros(())


class _JaxFakeSplitExec(_FakeSplitExec):
    def encode(self, frames):
        return JaxPayload(cut=self.cut, bits=8, arrays={"x": jnp.zeros((1,))},
                          meta={}, wire_b=jnp.asarray(self._b, jnp.float32))

    def decode_run(self, payload):
        return jnp.zeros(())


TOY = [dict(name="src", flops=0, bytes_in=0, bytes_out=1000, kind="source"),
       dict(name="filt", flops=1e3, bytes_in=1000, bytes_out=200,
            kind="optional", selectivity=0.5),
       dict(name="heavy", flops=1e6, bytes_in=200, bytes_out=10)]


def _toy_profiles(mod):
    return {
        "src": mod.HardwareProfile("s", p_active_w=10e-6, p_leak_w=10e-6),
        "filt": mod.HardwareProfile("f", flops_per_s=1e6, p_active_w=20e-6,
                                    p_leak_w=5e-6),
        "heavy": mod.HardwareProfile("h", flops_per_s=1e6,
                                     p_active_w=100e-6, p_leak_w=50e-6),
    }


def _controller(wire, **kw):
    link = LinkProfile("rf", bytes_per_s=1e4, joules_per_byte=1e-7)
    return CutController(
        lambda cut: _FakeSplitExec(cut, wire[cut]),
        cuts=("src", "filt", "heavy"),
        template=linear_pipeline("toy", TOY),
        profiles=_toy_profiles(tcost), link=link, **kw)


def _jax_controller(wire, **kw):
    link = jlink.LinkProfile("rf", bytes_per_s=1e4, joules_per_byte=1e-7)
    return JaxController(
        lambda cut: _JaxFakeSplitExec(cut, wire[cut]),
        cuts=("src", "filt", "heavy"),
        template=jax_linear_pipeline("toy", TOY),
        profiles=_toy_profiles(jcost), link=link, **kw)


def test_fit_reproduces_measured_bytes_exactly():
    wire = {"src": 1000.0, "filt": 120.0, "heavy": 7.0}
    ctl = _controller(wire, regime="energy")
    ctl.calibrate(torch.zeros((4, 2, 2)))
    pipe = ctl.measured_pipeline()
    for cut, b in wire.items():
        assert pipe.cut_payload_bytes(pipe.index(cut)) == pytest.approx(
            b / 4.0), cut


def test_chosen_cut_is_exhaustive_measured_optimum():
    wire = {"src": 4000.0, "filt": 120.0, "heavy": 7.0}
    ctl = _controller(wire, regime="energy",
                      duties={"src": 1.0, "filt": 1.0, "heavy": 1.0})
    ctl.calibrate(torch.zeros((4, 2, 2)))
    rep = ctl.report()
    assert rep.chosen_cut == rep.measured_best_cut
    assert rep.agrees
    assert rep.chosen_cut == min(rep.measured_objectives,
                                 key=rep.measured_objectives.get)


def test_measured_bytes_flip_the_decision():
    duties = {"src": 1.0, "filt": 1.0, "heavy": 1.0}
    ctl = _controller({"src": 4000.0, "filt": 120.0, "heavy": 7.0},
                      regime="energy", duties=duties)
    ctl.calibrate(torch.zeros((4, 2, 2)))
    ctl2 = _controller({"src": 40.0, "filt": 4000.0, "heavy": 4000.0},
                       regime="energy", duties=duties)
    ctl2.calibrate(torch.zeros((4, 2, 2)))
    assert ctl.report().chosen_cut != ctl2.report().chosen_cut
    assert ctl2.report().chosen_cut == "src"


@pytest.mark.parametrize("wire", [
    {"src": 4000.0, "filt": 120.0, "heavy": 7.0},
    {"src": 40.0, "filt": 4000.0, "heavy": 4000.0},
    {"src": 1000.0, "filt": 990.0, "heavy": 3.5}])
def test_controller_equals_jax_controller(wire):
    """Same measured bytes in, same fitted pipeline bytes, objectives and
    choice out (node times do not enter: every duty is given)."""
    duties = {"src": 1.0, "filt": 0.5, "heavy": 1.0}
    ctl = _controller(wire, regime="energy", duties=duties)
    jctl = _jax_controller(wire, regime="energy", duties=duties)
    ctl.calibrate(torch.zeros((4, 2, 2)))
    jctl.calibrate(jnp.zeros((4, 2, 2)))
    rep, jrep = ctl.report(), jctl.report()
    for a, b in zip(rep.measured_pipeline.blocks,
                    jrep.measured_pipeline.blocks):
        assert (a.name, a.bytes_out, a.selectivity, a.bytes_in) == \
            (b.name, b.bytes_out, b.selectivity, b.bytes_in)
    assert rep.measured_objectives == jrep.measured_objectives
    assert rep.predicted_objectives == jrep.predicted_objectives
    assert (rep.chosen_cut, rep.measured_best_cut, rep.agrees,
            rep.rank_agreement) == (jrep.chosen_cut, jrep.measured_best_cut,
                                    jrep.agrees, jrep.rank_agreement)
    assert ctl.comm_watts("filt") == jctl.comm_watts("filt")
    res, payload, sol = ctl.execute(torch.zeros((4, 2, 2)))
    assert sol.cut_after == rep.chosen_cut and payload.cut == sol.cut_after


@pytest.mark.parametrize("regime", ["energy", "throughput"])
def test_controller_fit_equals_jax_on_the_same_measurements(regime):
    """One measurement table, node times included, fitted and solved by
    both controllers: equal flops, bytes, objectives and choice."""
    table = [("src", 1e-4, 1e-3, 4000.0), ("filt", 3e-4, 8e-4, 120.0),
             ("heavy", 9e-3, 1e-4, 7.0)]
    ctl = _controller({}, regime=regime)
    jctl = _jax_controller({}, regime=regime)
    for c, meas in ((ctl, CutMeasurement), (jctl, JaxMeasurement)):
        c.measurements = [
            meas(cut=cut, node_s=node, cloud_s=cloud, wire_bytes=b,
                 capacity_bytes=2 * b, units=4)
            for cut, node, cloud, b in table]
    rep, jrep = ctl.report(), jctl.report()
    for a, b in zip(rep.measured_pipeline.blocks,
                    jrep.measured_pipeline.blocks):
        assert (a.name, a.flops, a.bytes_in, a.bytes_out, a.selectivity,
                a.meta) == (b.name, b.flops, b.bytes_in, b.bytes_out,
                            b.selectivity, b.meta)
    assert rep.measured_objectives == jrep.measured_objectives
    assert rep.predicted_objectives == jrep.predicted_objectives
    assert (rep.chosen_cut, rep.measured_best_cut, rep.rank_agreement) == \
        (jrep.chosen_cut, jrep.measured_best_cut, jrep.rank_agreement)


def test_controller_validates_its_table():
    ctl = _controller({"src": 1.0, "filt": 1.0, "heavy": 1.0})
    with pytest.raises(RuntimeError):
        ctl.measured_pipeline()
    bad = _controller({"src": float("nan"), "filt": 1.0, "heavy": 1.0})
    with pytest.raises(ValueError, match="src"):
        bad.calibrate(torch.zeros((4, 2, 2)))
    with pytest.raises(ValueError):
        _controller({}, regime="latency")
