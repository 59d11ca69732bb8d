"""The port's offload resilience layer against the JAX package's.

Every class of tests/test_resilience.py has a counterpart here that runs
both packages on the same inputs: the fault models (outcome and power
sequences, seeds 0-7), the degradation ladder (transitions on one record
stream), zero-fault sessions (results and payload CRC at every cut x
bits), laddered sessions under faults (``dataclasses.astuple`` records),
brownout recovery from commit points, the controller's windowed re-solve
and rungs, VR sessions, and telemetry.  The funnel is the fixture of
tests/test_torch_offload.py (10 frames, the smoke cascade, weights carried
by the bridge), the port executor reading the JAX integral tables
(``read_jax_integrals``) so that both funnels compute the same payloads.
Equality is exact throughout: the fault process, the clock and the
records are host floats summed in the same order on the same bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.camera.bssa import GridSpec as JaxGridSpec
from repro.camera.offload import BrownoutModel as JaxBrownout
from repro.camera.offload import CutController as JaxController
from repro.camera.offload import CutMeasurement as JaxMeasurement
from repro.camera.offload import DegradationLadder as JaxLadder
from repro.camera.offload import DeliveryRecord as JaxRecord
from repro.camera.offload import FaceAuthOffloadExecutor as JaxOffload
from repro.camera.offload import FaultInjector as JaxInjector
from repro.camera.offload import GilbertElliott as JaxGE
from repro.camera.offload import LinkProfile as JaxLink
from repro.camera.offload import OffloadSession as JaxSession
from repro.camera.offload import VROffloadExecutor as JaxVROffload
from repro.camera.offload import fleet_link_report as jax_fleet_report
from repro.camera.offload import payload_checksum as jax_checksum
from repro.camera.offload.payloads import WirePayload as JaxPayload
from repro.camera.pipelines import FaceAuthExecutor as JaxExecutor
from repro.camera.pipelines import VRRigExecutor as JaxRig
from repro.core.costmodel import HardwareProfile as JaxProfile
from repro.core.pipeline import linear_pipeline as jax_linear_pipeline
from repro.obs import Telemetry

from test_torch_pipeline import read_jax_integrals

from repro_torch.bridge import cascade_from, face_nn_from
from repro_torch.camera.bssa import GridSpec
from repro_torch.camera.offload import (
    BACKSCATTER,
    ON_NODE,
    BrownoutModel,
    CutController,
    CutMeasurement,
    DegradationLadder,
    DeliveryRecord,
    FaceAuthOffloadExecutor,
    FaultInjector,
    GilbertElliott,
    LinkProfile,
    OffloadSession,
    VROffloadExecutor,
    WirePayload,
    fleet_link_report,
    payload_checksum,
)
from repro_torch.camera.offload.payloads import SESSION_SIDEBAND_BYTES
from repro_torch.camera.pipelines import FaceAuthExecutor, VRRigExecutor
from repro_torch.core.costmodel import HardwareProfile
from repro_torch.core.pipeline import linear_pipeline

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

CUTS = ("sensor", "motion", "vj", "nn")
ALL_BITS = (None, 16, 8, 4)
RUNGS = [("nn", 16), ("nn", 8), ("nn", 4), ON_NODE]
FIELDS = ("motion", "n_windows", "n_auth", "scores", "window_id",
          "window_valid", "auth", "windows_dropped", "motion_dropped",
          "cascade_dropped")


@pytest.fixture(scope="module")
def fa():
    from benchmarks.workloads import fa_cascade, fa_scan
    from repro.camera.face_nn import train_face_nn
    from repro.camera.synthetic import face_dataset, security_video

    frames, _truth = security_video(n_frames=10, motion_frames=5, seed=1)
    casc = fa_cascade(smoke=True)
    X, y, _ = face_dataset(n_per_class=80, seed=3)
    nn = train_face_nn(X, y, steps=60)
    sf, st, ad = fa_scan(True)
    scan = dict(scale_factor=sf, step=st, adaptive=ad)
    h, w = frames.shape[1:]
    jx = JaxExecutor(casc, nn, h, w, **scan)
    jx.calibrate(frames)
    tx = FaceAuthExecutor(cascade_from(casc), face_nn_from(nn, "cpu"), h, w,
                          device="cpu", **scan)
    read_jax_integrals(tx.det)
    tx.calibrate(frames)
    joffs, toffs = {}, {}

    def jmake(cut, bits):
        if (cut, bits) not in joffs:
            joffs[(cut, bits)] = JaxOffload(jx, cut, bits=bits)
        return joffs[(cut, bits)]

    def tmake(cut, bits):
        if (cut, bits) not in toffs:
            toffs[(cut, bits)] = FaceAuthOffloadExecutor(tx, cut, bits=bits)
        return toffs[(cut, bits)]

    return dict(frames=frames, fj=jnp.asarray(frames),
                ft=torch.from_numpy(frames), jx=jx, tx=tx, jmake=jmake,
                tmake=tmake)


def _fields_equal(got, want):
    return [f for f in FIELDS
            if not np.array_equal(np.asarray(getattr(got, f)),
                                  np.asarray(getattr(want, f)))]


def _records(sess):
    return [dataclasses.astuple(r) for r in sess.records]


# -- fault models ------------------------------------------------------------


def _injectors(seed, **kw):
    """The same injector in both packages; ``loss`` / ``brownout`` given
    as argument dicts."""
    out = []
    for ge, bo, inj in ((JaxGE, JaxBrownout, JaxInjector),
                        (GilbertElliott, BrownoutModel, FaultInjector)):
        args = dict(kw)
        if "loss" in args:
            args["loss"] = ge(**args["loss"])
        if "brownout" in args:
            args["brownout"] = bo(**args["brownout"])
        out.append(inj(seed=seed, **args))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_fault_outcomes_equal_jax(seed):
    """Burst loss, outages and corruption: the same seed and the same
    attempt times give the same outcome sequence, attempt and loss
    counts, also after ``reset``."""
    rng = np.random.default_rng(100 + seed)
    kw = dict(loss=dict(p_gb=float(rng.uniform(0.05, 0.6)),
                        p_bg=float(rng.uniform(0.1, 0.9)),
                        loss_good=float(rng.uniform(0, 0.1))),
              outage_period_s=float(rng.uniform(1, 20)),
              outage_duty=float(rng.uniform(0, 0.4)),
              corrupt_fraction=float(rng.uniform(0, 1)))
    j, t = _injectors(seed, **kw)
    times = np.cumsum(rng.exponential(0.3, 400))
    want = [j.attempt(float(x)) for x in times]
    assert [t.attempt(float(x)) for x in times] == want
    assert (t.attempts, t.losses, t.empirical_loss) == \
        (j.attempts, j.losses, j.empirical_loss)
    assert {"ok", "lost"} <= set(want)
    t.reset()
    assert [t.attempt(float(x)) for x in times] == want
    assert [t.outage_at(float(x)) for x in times[:50]] == \
        [j.outage_at(float(x)) for x in times[:50]]
    assert [t.next_outage_end(float(x)) for x in times[:50]] == \
        [j.next_outage_end(float(x)) for x in times[:50]]


@pytest.mark.parametrize("seed", range(8))
def test_power_edges_equal_jax(seed):
    """The brownout schedule: the same ``power_window`` answers and the
    same jittered power edges."""
    bo = dict(harvest_w=15e-6, storage_j=13e-6, load_w=200e-6,
              jitter=0.1 * (seed % 4))
    j, t = _injectors(seed, brownout=bo)
    qs = np.sort(np.random.default_rng(seed).uniform(0, 30, 200))
    assert [t.power_window(float(q)) for q in qs] == \
        [j.power_window(float(q)) for q in qs]
    assert t._power_edges == j._power_edges
    assert (t.brownout.on_s, t.brownout.recharge_s) == \
        (j.brownout.on_s, j.brownout.recharge_s)


def test_fault_model_properties_and_validation_equal_jax():
    for cls_j, cls_t in ((JaxGE, GilbertElliott),):
        a, b = cls_j(p_gb=0.1, p_bg=0.4), cls_t(p_gb=0.1, p_bg=0.4)
        assert (a.stationary_bad, a.stationary_loss, a.mean_burst_len) == \
            (b.stationary_bad, b.stationary_loss, b.mean_burst_len)
    bad = [(lambda m: m(p_gb=1.5)), (lambda m: m(p_bg=float("nan")))]
    for make in bad:
        with pytest.raises(ValueError) as je:
            make(JaxGE)
        with pytest.raises(ValueError, match="probability") as te:
            make(GilbertElliott)
        assert str(te.value) == str(je.value)
    for kw in (dict(harvest_w=2e-4, load_w=1e-4), dict(storage_j=0.0),
               dict(jitter=1.0)):
        with pytest.raises(ValueError) as je:
            JaxBrownout(**kw)
        with pytest.raises(ValueError) as te:
            BrownoutModel(**kw)
        assert str(te.value) == str(je.value)
    for kw in (dict(outage_period_s=0.0), dict(outage_duty=1.0),
               dict(corrupt_fraction=2.0)):
        with pytest.raises(ValueError) as je:
            JaxInjector(**kw)
        with pytest.raises(ValueError) as te:
            FaultInjector(**kw)
        assert str(te.value) == str(je.value)
    assert FaultInjector(seed=0).power_window(5.0) == (True, float("inf"))


# -- the degradation ladder --------------------------------------------------


def _record_stream(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        att = int(rng.choice([1, 1, 1, 2, 3, 5]))
        out.append(dict(
            seq=i, cut="nn", bits=16, delivered=bool(rng.random() > 0.08),
            fallback=bool(rng.random() < 0.03), attempts=att, lost=att - 1,
            corrupt=0, payload_bytes=100.0, bytes_on_air=100.0 * att,
            compute_s=0.0, latency_s=float(rng.exponential(0.1)),
            energy_j=0.0, brownouts=0, restores=0, recovery_s=0.0))
    return out


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(window=4, recover_after=6)),
    (2, dict(window=4, max_retry_frac=0.2, deadline_s=0.15)),
    (3, dict(window=8, max_retry_frac=0.5, recover_after=3))])
def test_ladder_transitions_equal_jax(seed, kw):
    jl, tl = JaxLadder(RUNGS, **kw), DegradationLadder(RUNGS, **kw)
    levels = []
    for r in _record_stream(seed):
        jl.observe(JaxRecord(**r))
        tl.observe(DeliveryRecord(**r))
        assert tl.level == jl.level
        levels.append(tl.level)
    assert tl.transitions == jl.transitions and tl.rung == jl.rung
    assert len(set(levels)) > 1                  # the stream moves it


def test_ladder_validation_equal_jax():
    for rungs in ([], [("nn", 8), ("nn", 8)]):
        with pytest.raises(ValueError) as je:
            JaxLadder(rungs)
        with pytest.raises(ValueError) as te:
            DegradationLadder(rungs)
        assert str(te.value) == str(je.value)
    r = dict(_record_stream(0, 1)[0], attempts=3, bytes_on_air=300.0)
    assert DeliveryRecord(**r).retransmit_overhead == \
        JaxRecord(**r).retransmit_overhead


# -- sessions: zero-fault pinning --------------------------------------------


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("bits", ALL_BITS)
def test_zero_fault_session_equals_jax(fa, cut, bits):
    """Faults off: the session's result is the split executor's bit for
    bit, its payload CRC and record are JAX's, and the receiver saw the
    same sideband."""
    off = fa["tmake"](cut, bits)
    want, payload = off(fa["ft"])
    sess = OffloadSession(off, link=BACKSCATTER)
    got, rec = sess.send(fa["ft"])
    assert _fields_equal(got, want) == []
    jsess = JaxSession(fa["jmake"](cut, bits))
    jgot, jrec = jsess.send(fa["fj"])
    assert _fields_equal(got, jgot) == []
    crc = payload_checksum(payload)
    assert crc == jax_checksum(fa["jmake"](cut, bits).encode(fa["fj"]))
    assert int(sess.received[0]["crc"]) == crc
    assert dataclasses.astuple(rec) == dataclasses.astuple(jrec)
    assert rec.payload_bytes == payload.nbytes() + SESSION_SIDEBAND_BYTES
    assert [dict(sb) for sb in sess.received] == \
        [dict(sb) for sb in jsess.received]


def test_disabled_injector_identical_to_no_injector(fa):
    off = fa["tmake"]("nn", 8)
    a = OffloadSession(off, link=BACKSCATTER)
    b = OffloadSession(off, link=BACKSCATTER, injector=FaultInjector(seed=3))
    for _ in range(3):
        ra, _ = a.send(fa["ft"])
        rb, _ = b.send(fa["ft"])
        assert _fields_equal(ra, rb) == []
    assert _records(a) == _records(b)
    assert np.array_equal(a.attempt_trace(), b.attempt_trace())
    assert [int(s["seq"]) for s in a.received] == [0, 1, 2]
    assert a.seq_gaps() == []


# -- sessions under faults ---------------------------------------------------


def _laddered(fa, pkg, injector, n_sends, rungs=RUNGS, **kw):
    """A laddered session over the nn cut in one package; returns the
    session and each send's auth decisions (None when undelivered)."""
    if pkg == "jax":
        sess = JaxSession(make_executor=fa["jmake"], cut=rungs[0][0],
                          bits=rungs[0][1], injector=injector,
                          ladder=JaxLadder(list(rungs)),
                          on_node_fn=lambda f: fa["jx"](f), **kw)
        x = fa["fj"]
    else:
        sess = OffloadSession(make_executor=fa["tmake"], cut=rungs[0][0],
                              bits=rungs[0][1], injector=injector,
                              ladder=DegradationLadder(list(rungs)),
                              on_node_fn=lambda f: fa["tx"](f), **kw)
        x = fa["ft"]
    auths = []
    for _ in range(n_sends):
        got, _rec = sess.send(x)
        auths.append(None if got is None else np.asarray(got.auth))
    return sess, auths


# the determinism cell and two cells of the resilience sweep
# (benchmarks/offload_resilience.py: seeds _SEED + loss * 1000 + duty * 10)
CELLS = {
    "determinism": dict(loss=dict(p_gb=0.2, p_bg=0.4), corrupt_fraction=0.3,
                        seed=4321),
    "loss10_duty00": dict(loss=dict(p_gb=0.1 * 0.45 / 0.9, p_bg=0.45),
                          seed=4321 + 100),
    "loss20_duty20": dict(loss=dict(p_gb=0.2 * 0.45 / 0.8, p_bg=0.45),
                          outage_period_s=60.0, outage_duty=0.2,
                          seed=4321 + 200 + 2),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_laddered_records_equal_jax(fa, cell):
    """Burst loss, corruption and outages under the 16 -> 8 -> 4 ->
    on-node ladder: every send's record equal to JAX's, tuple for tuple,
    and equal auth decisions on every delivered send."""
    kw = dict(CELLS[cell])
    seed = kw.pop("seed")
    j, t = _injectors(seed, **kw)
    jsess, jauth = _laddered(fa, "jax", j, 20)
    tsess, tauth = _laddered(fa, "torch", t, 20)
    assert _records(tsess) == _records(jsess)
    assert tsess.ladder.transitions == jsess.ladder.transitions
    assert sum(r.attempts - 1 for r in tsess.records) > 0
    if cell == "determinism":                      # the ladder moved
        assert len({(r.cut, r.bits) for r in tsess.records}) > 1
    for a, b in zip(tauth, jauth):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)
    assert np.array_equal(tsess.attempt_trace(), jsess.attempt_trace())
    assert tsess.seq_gaps() == jsess.seq_gaps()


def test_exhausted_retries_and_corruption_equal_jax(fa):
    for kw, retries in ((dict(loss=dict(p_gb=1.0, p_bg=0.0, loss_good=1.0)),
                         1),
                        (dict(loss=dict(p_gb=0.0, p_bg=1.0, loss_good=1.0),
                              corrupt_fraction=1.0), 2)):
        j, t = _injectors(3, **kw)
        js = JaxSession(fa["jmake"]("nn", 8), injector=j,
                        max_retries=retries)
        ts = OffloadSession(fa["tmake"]("nn", 8), injector=t,
                            max_retries=retries)
        jgot, jrec = js.send(fa["fj"])
        tgot, trec = ts.send(fa["ft"])
        assert tgot is None and jgot is None
        assert dataclasses.astuple(trec) == dataclasses.astuple(jrec)
        assert ts.seq_gaps() == js.seq_gaps() == [0]


def test_fleet_congestion_equals_jax(fa):
    def fleet(pkg, faulty):
        sessions = []
        for s in range(3):
            j, t = _injectors(s, loss=dict(p_gb=0.5, p_bg=0.3))
            if pkg == "jax":
                sess = JaxSession(fa["jmake"]("nn", 8),
                                  injector=j if faulty and s == 0 else None)
                x = fa["fj"]
            else:
                sess = OffloadSession(
                    fa["tmake"]("nn", 8),
                    injector=t if faulty and s == 0 else None)
                x = fa["ft"]
            for _ in range(4):
                sess.send(x)
            sessions.append(sess)
        report = jax_fleet_report if pkg == "jax" else fleet_link_report
        return report(sessions, BACKSCATTER, frame_period_s=1.0,
                      stagger=False)

    for faulty in (False, True):
        j, t = fleet("jax", faulty), fleet("torch", faulty)
        assert t.p99_latency_s == j.p99_latency_s
        assert np.array_equal(t.latency_s, j.latency_s)
        assert t.bytes_total == j.bytes_total
    assert fleet("torch", True).p99_latency_s > \
        fleet("torch", False).p99_latency_s
    with pytest.raises(ValueError, match="no sends"):
        fleet_link_report([OffloadSession(fa["tmake"]("nn", 8))],
                          BACKSCATTER, frame_period_s=1.0)


# -- brownout recovery -------------------------------------------------------


@pytest.mark.parametrize("cut,seed", [("nn", 5), ("vj", 2)])
def test_brownout_resume_equals_jax(fa, tmp_path, cut, seed):
    """A brownout mid-funnel restores the last commit and re-enters
    there: the result is the fused split executor's, and the records,
    the stages started and completed and the newest commit's metadata
    are JAX's."""
    from repro_torch.ckpt.checkpoint import latest_step, read_extra

    # an on-window of ~0.07 s against 0.02 s a stage
    bo = dict(harvest_w=15e-6, storage_j=13e-6, load_w=200e-6, jitter=0.0)
    j, t = _injectors(seed, brownout=bo)
    off = fa["tmake"](cut, 8)
    want, _ = off(fa["ft"])
    ts = OffloadSession(off, injector=t, ckpt_dir=str(tmp_path / "t"),
                        stage_cost_s=0.02, keep_ckpts=3)
    js = JaxSession(fa["jmake"](cut, 8), injector=j,
                    ckpt_dir=str(tmp_path / "j"), stage_cost_s=0.02,
                    keep_ckpts=3)
    for _ in range(2):
        got, trec = ts.send(fa["ft"])
        _jgot, _jrec = js.send(fa["fj"])
        assert _fields_equal(got, want) == []
    assert _records(ts) == _records(js)
    assert sum(r.brownouts for r in ts.records) >= 1
    assert ts.stage_started == js.stage_started
    assert ts.stage_completed == js.stage_completed
    assert ts.stage_completed["motion"] == 2
    step = latest_step(str(tmp_path / "t"))
    assert step == latest_step(str(tmp_path / "j"))
    assert read_extra(str(tmp_path / "t"), step) == \
        {"stage": {"nn": "nn", "vj": "gather"}[cut], "seq": 1}
    assert len(list((tmp_path / "t").iterdir())) == 3


def test_brownout_needs_a_ckpt_dir(fa):
    _j, t = _injectors(0, brownout=dict(storage_j=13e-6))
    sess = OffloadSession(fa["tmake"]("nn", 8), injector=t)
    with pytest.raises(ValueError, match="ckpt_dir"):
        sess.send(fa["ft"])


# -- the controller's re-solve and rungs -------------------------------------


def _controllers():
    """The toy controller of tests/test_resilience.py in both packages,
    with one calibration table (fake executors have no wall clock)."""
    blocks = [dict(name="src", flops=0, bytes_in=0, bytes_out=1000,
                   kind="source"),
              dict(name="filt", flops=1e3, bytes_in=1000, bytes_out=200,
                   kind="optional", selectivity=0.5),
              dict(name="heavy", flops=1e6, bytes_in=200, bytes_out=10)]
    prof = dict(src=dict(name="s", p_active_w=10e-6, p_leak_w=10e-6),
                filt=dict(name="f", flops_per_s=1e6, p_active_w=20e-6,
                          p_leak_w=5e-6),
                heavy=dict(name="h", flops_per_s=1e6, p_active_w=100e-6,
                           p_leak_w=50e-6))
    table = [("src", 1e-4, 2e-4, 1000.0), ("filt", 3e-3, 1e-4, 120.0),
             ("heavy", 9e-3, 1e-5, 7.0)]
    out = []
    for pipe, hw, ctl, meas, link in (
            (jax_linear_pipeline, JaxProfile, JaxController, JaxMeasurement,
             JaxLink),
            (linear_pipeline, HardwareProfile, CutController, CutMeasurement,
             LinkProfile)):
        c = ctl(lambda cut: None, cuts=("src", "filt", "heavy"),
                template=pipe("toy", blocks),
                profiles={k: hw(**v) for k, v in prof.items()},
                link=link("rf", bytes_per_s=1e4, joules_per_byte=1e-7))
        c.measurements = [meas(cut=cut, node_s=n, cloud_s=cl, wire_bytes=b,
                               capacity_bytes=b, units=4)
                          for cut, n, cl, b in table]
        out.append(c)
    return out


def test_degradation_rungs_equal_jax():
    j, t = _controllers()
    for cut in (None, "src", "filt", "heavy"):
        assert t.degradation_rungs(cut) == j.degradation_rungs(cut)
        assert t.degradation_rungs(cut, bits_ladder=(8, 4)) == \
            j.degradation_rungs(cut, bits_ladder=(8, 4))
    assert t.degradation_ladder().rungs == j.degradation_ladder().rungs
    assert t.degradation_rungs()[-1] == ON_NODE
    with pytest.raises(ValueError, match="not in"):
        t.degradation_rungs("ghost")


def test_resolve_window_equals_jax():
    """Windowed samples, predicted bytes and the congestion deadline give
    the JAX controller's cut and objective at each step."""
    j, t = _controllers()
    tel_j, tel_t = Telemetry(), Telemetry()
    j.telemetry, t.telemetry = tel_j, tel_t
    rng = np.random.default_rng(0)
    for step in range(12):
        cut = ("src", "filt", "heavy")[step % 3]
        sample = dict(units=int(rng.integers(1, 8)),
                      wire_bytes=float(rng.uniform(1, 5000)),
                      node_s=None if step % 2 else float(rng.uniform(0, 1e-2)),
                      cloud_s=float(rng.uniform(0, 1e-3)))
        j.observe(cut, **sample)
        t.observe(cut, **sample)
        kw = {}
        if step % 4 == 1:
            kw = dict(deadline_s=0.5, cut_latency_s={
                "src": float(rng.uniform(0, 1)), "filt": 0.9, "heavy": 0.2})
        if step % 4 == 3:
            kw = dict(predicted_bytes={"heavy": float(rng.uniform(1, 900))})
        js, ts = j.resolve_window(**kw), t.resolve_window(**kw)
        assert ts.cut_after == js.cut_after
        assert ts.objective == js.objective
        assert [dataclasses.astuple(m) for m in t.window_measurements()] == \
            [dataclasses.astuple(m) for m in j.window_measurements()]
    assert t.resolves == j.resolves == 12
    assert tel_t.counters.totals() == tel_j.counters.totals()
    with pytest.raises(ValueError, match="not in"):
        t.observe("ghost", units=1, wire_bytes=1.0)


# -- VR sessions -------------------------------------------------------------


@pytest.fixture(scope="module")
def rig():
    from repro.camera.synthetic import stereo_pair

    views = [stereo_pair(h=48, w=64, max_disp=4, seed=2 + s)[:2]
             for s in range(2)]
    lefts = np.stack([v[0] for v in views])
    rights = np.stack([v[1] for v in views])
    jbase = JaxRig(JaxGridSpec(sigma_spatial=8), max_disp=4, n_iters=2,
                   rig_parallel=False)
    base = VRRigExecutor(GridSpec(sigma_spatial=8), max_disp=4, n_iters=2,
                         device="cpu")
    return base, jbase, lefts, rights


@pytest.mark.parametrize("cut", VROffloadExecutor.CUTS)
def test_vr_zero_fault_session(rig, cut):
    base, jbase, lefts, rights = rig
    off = VROffloadExecutor(base, cut, bits=8)
    (lp0, rp0), payload = off(lefts, rights)
    sess = OffloadSession(off)
    (lp, rp), rec = sess.send(lefts, rights)
    assert torch.equal(lp, lp0) and torch.equal(rp, rp0)
    _jres, jrec = JaxSession(JaxVROffload(jbase, cut, bits=8)).send(
        jnp.asarray(lefts), jnp.asarray(rights))
    assert dataclasses.astuple(rec) == dataclasses.astuple(jrec)
    if cut == "capture":            # the port's payload bytes are JAX's
        assert payload_checksum(payload) == jax_checksum(
            JaxVROffload(jbase, cut, bits=8).encode(jnp.asarray(lefts),
                                                    jnp.asarray(rights)))


def test_vr_brownout_recovery(rig, tmp_path):
    """tests/test_resilience.py's brownout at the stitch cut: the result
    bit-equal to the split executor, the depth stage run once, records
    and stage counters equal to JAX's."""
    base, jbase, lefts, rights = rig
    off = VROffloadExecutor(base, "stitch", bits=8)
    (lp0, rp0), _ = off(lefts, rights)
    bo = dict(harvest_w=15e-6, storage_j=9e-6, load_w=200e-6, jitter=0.0)
    j, t = _injectors(6, brownout=bo)
    sess = OffloadSession(off, injector=t, ckpt_dir=str(tmp_path / "t"),
                          stage_cost_s=0.02)
    (lp, rp), rec = sess.send(lefts, rights)
    assert rec.brownouts >= 1 and rec.restores >= 1
    assert sess.stage_completed["depth"] == 1
    assert torch.equal(lp, lp0) and torch.equal(rp, rp0)
    js = JaxSession(JaxVROffload(jbase, "stitch", bits=8), injector=j,
                    ckpt_dir=str(tmp_path / "j"), stage_cost_s=0.02)
    js.send(jnp.asarray(lefts), jnp.asarray(rights))
    assert _records(sess) == _records(js)
    assert sess.stage_started == js.stage_started


# -- telemetry ---------------------------------------------------------------


def test_telemetry_counters_and_spans_equal_jax(fa, tmp_path):
    """One JAX ``Telemetry`` handed to each package's session: equal
    counters, span names and ledger latencies, under faults, the ladder
    and a brownout."""
    tels = {}
    for pkg in ("jax", "torch"):
        tel = Telemetry(enabled=True)
        j, t = _injectors(7, loss=dict(p_gb=0.3, p_bg=0.4),
                          corrupt_fraction=0.3)
        inj = j if pkg == "jax" else t
        sess, _ = _laddered(fa, pkg, inj, 12, telemetry=tel, sid="cam0")
        jb, tb = _injectors(5, brownout=dict(harvest_w=15e-6,
                                             storage_j=13e-6, load_w=200e-6,
                                             jitter=0.0))
        cls = JaxSession if pkg == "jax" else OffloadSession
        make = fa["jmake"] if pkg == "jax" else fa["tmake"]
        bsess = cls(make("nn", 8), injector=jb if pkg == "jax" else tb,
                    ckpt_dir=str(tmp_path / pkg), stage_cost_s=0.02,
                    telemetry=tel, sid="cam1")
        bsess.send(fa["fj"] if pkg == "jax" else fa["ft"])
        tels[pkg] = tel
    j, t = tels["jax"], tels["torch"]
    assert t.counters.totals() == j.counters.totals()
    assert t.counters.totals()["offload.sends"] == 13
    spans = [(r.kind, r.name, r.t, r.dur, r.sid, r.args)
             for r in t.trace.records()]
    assert spans == [(r.kind, r.name, r.t, r.dur, r.sid, r.args)
                     for r in j.trace.records()]
    assert ("ladder", "descend") in [sp[:2] for sp in spans]
    assert t.ledger.report() == j.ledger.report()


def test_disabled_telemetry_is_absent(fa):
    tel = Telemetry(enabled=False)
    sess = OffloadSession(fa["tmake"]("nn", 8), telemetry=tel)
    sess.send(fa["ft"])
    assert tel.counters.totals() == {} and tel.trace.records() == []


def test_fake_split_executor_session():
    """A session runs any executor with ``cut``, ``bits``, ``encode`` and
    ``decode_run`` (tests/test_resilience.py's fake); its CRC over equal
    arrays equals JAX's."""
    class Fake:
        cut, bits = "capture", 8

        def encode(self, frames):
            return WirePayload(cut="capture", bits=8, arrays={
                "x": torch.arange(6, dtype=torch.int8),
                "m": torch.tensor([True, False])},
                meta={}, wire_b=torch.tensor(10.0))

        def decode_run(self, payload):
            return payload.arrays["x"].sum()

    sess = OffloadSession(Fake())
    got, rec = sess.send(torch.zeros((4, 2, 2)))
    assert int(got) == 15 and rec.payload_bytes == 10.0 + 12.0
    jpay = JaxPayload(cut="src", bits=8, arrays={
        "x": jnp.arange(6, dtype=jnp.int8), "m": jnp.asarray([True, False])},
        meta={}, wire_b=jnp.asarray(10.0))
    assert payload_checksum(Fake().encode(None)) == jax_checksum(jpay)
    # brownout recovery stages only the registered executor families
    _j, t = _injectors(0, brownout=dict(storage_j=13e-6))
    with pytest.raises(TypeError, match="no staged node plan"):
        OffloadSession(Fake(), injector=t, ckpt_dir="unused").send(None)
