"""The port's split executor against the JAX package's, at the sizes of the
reference's own offload tests (tests/test_offload.py:38-56: 10 frames, the
smoke cascade, ``train_face_nn(steps=60)``), with the weights carried
across by the bridge.

Two port executors run: one on its own integral tables and one reading
the JAX package's (``read_jax_integrals``), the only arithmetic the two
funnels do not share.  Payload arrays, byte counts and results are held
equal to the JAX ``FaceAuthOffloadExecutor``'s at every cut and width.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.camera.offload import FaceAuthOffloadExecutor as JaxOffload
from repro.camera.pipelines import FaceAuthExecutor as JaxExecutor

from test_torch_pipeline import read_jax_integrals

from repro_torch.bridge import cascade_from, face_nn_from
from repro_torch.camera.offload import (
    BACKSCATTER,
    CutController,
    FaceAuthOffloadExecutor,
    WirePayload,
    static_array_bytes,
)
from repro_torch.camera.pipelines import (
    FAWorkloadStats,
    FaceAuthExecutor,
    calibrate_fa,
    fa_pipeline,
    fa_profiles,
)

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

CUTS = ("sensor", "motion", "vj", "nn")
BITS = (None, 8, 4)
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
    ports = {}
    for name in ("own", "jax_tables"):
        tx = FaceAuthExecutor(cascade_from(casc), face_nn_from(nn, "cpu"),
                              h, w, device="cpu", **scan)
        if name == "jax_tables":
            read_jax_integrals(tx.det)
        tx.calibrate(frames)
        ports[name] = tx
    fj = jnp.asarray(frames)
    jax_runs = {(cut, bits): JaxOffload(jx, cut, bits=bits)(fj)
                for cut in CUTS for bits in BITS}
    port_runs = {(name, cut, bits): FaceAuthOffloadExecutor(
        tx, cut, bits=bits)(frames)
        for name, tx in ports.items() for cut in CUTS for bits in BITS}
    return dict(frames=frames, jx=jx, ports=ports,
                base=ports["own"](frames), jax_runs=jax_runs,
                port_runs=port_runs)


def _fields_equal(a, b):
    return [f for f in FIELDS
            if not np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f)))]


CASES = [(c, b) for c in CUTS for b in BITS]
IDS = [f"{c}-{b}" for c, b in CASES]


@pytest.mark.parametrize("tables", ["own", "jax_tables"])
@pytest.mark.parametrize("cut,bits", CASES, ids=IDS)
def test_wire_bytes_equal_jax(fa, cut, bits, tables):
    _jres, jpay = fa["jax_runs"][(cut, bits)]
    _tres, tpay = fa["port_runs"][(tables, cut, bits)]
    assert tpay.wire_b.dtype == torch.float32 and tpay.wire_b.dim() == 0
    assert tpay.nbytes() == jpay.nbytes()
    assert tpay.capacity_bytes() == jpay.capacity_bytes()
    assert set(tpay.arrays) == set(jpay.arrays) == \
        FaceAuthOffloadExecutor.PAYLOAD_SCHEMA[cut].declared(bits)


@pytest.mark.parametrize("cut,bits", [(c, b) for c in ("sensor", "motion")
                                      for b in BITS])
def test_raw_and_motion_payloads_bit_equal(fa, cut, bits):
    """The sensor and motion cuts carry frames the port reproduces
    exactly, so every payload byte and scale equals the reference's, on
    the port's own integral tables."""
    _jres, jpay = fa["jax_runs"][(cut, bits)]
    _tres, tpay = fa["port_runs"][("own", cut, bits)]
    for k, v in jpay.arrays.items():
        got, want = tpay.arrays[k].numpy(), np.asarray(v)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("cut,bits", CASES, ids=IDS)
def test_results_equal_jax_on_jax_tables(fa, cut, bits):
    """With the reference's integral tables, every payload array and every
    result field equals the JAX offload executor's."""
    jres, jpay = fa["jax_runs"][(cut, bits)]
    tres, tpay = fa["port_runs"][("jax_tables", cut, bits)]
    for k, v in jpay.arrays.items():
        np.testing.assert_array_equal(tpay.arrays[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert _fields_equal(tres, jres) == []


@pytest.mark.parametrize("cut", CUTS)
def test_raw_split_equals_fused(fa, cut):
    """bits=None: node + cloud = the port's fused funnel, field for field."""
    res, payload = fa["port_runs"][("own", cut, None)]
    assert _fields_equal(res, fa["base"]) == []
    assert payload.cut == cut and payload.bits is None


def test_halves_compose(fa):
    """``encode`` then ``decode_run`` is ``__call__``."""
    off = FaceAuthOffloadExecutor(fa["ports"]["own"], "vj", bits=8)
    payload = off.encode(fa["frames"])
    assert isinstance(payload, WirePayload)
    assert _fields_equal(off.decode_run(payload),
                         fa["port_runs"][("own", "vj", 8)][0]) == []


def test_wire_bytes_shrink_down_the_funnel(fa):
    for bits in BITS:
        b = {cut: fa["port_runs"][("own", cut, bits)][1].nbytes()
             for cut in CUTS}
        assert b["sensor"] > b["motion"] > b["vj"] > b["nn"], bits


def test_capacity_vs_measured_gap(fa):
    pay = fa["port_runs"][("own", "vj", 8)][1]
    assert pay.nbytes() < pay.capacity_bytes()


def test_codec_bits_halve_wire_bytes(fa):
    b = {bits: fa["port_runs"][("own", "vj", bits)][1].nbytes()
         for bits in BITS}
    assert b[8] < 0.30 * b[None]
    assert b[4] < 0.65 * b[8]


def test_nn_cut_int8_keeps_auth_decisions(fa):
    res, _pay = fa["port_runs"][("own", "nn", 8)]
    base = fa["base"]
    for f in ("motion", "n_windows", "n_auth", "auth", "window_id",
              "window_valid"):
        assert torch.equal(getattr(base, f), getattr(res, f)), f
    assert float((base.scores - res.scores).abs().max()) < 1.0 / 127


def test_measured_bytes_match_analytic_descriptors(fa):
    """The analytic descriptors of ``fa_pipeline`` agree with what the
    port puts on the wire at 8 bits, within codec scales and sideband."""
    base, n = fa["base"], len(fa["frames"])
    stats = FAWorkloadStats(
        n_frames=n, motion_frames=max(int(base.motion.sum()), 1),
        windows_to_nn=max(int(base.n_windows.sum()), 1))
    pipe = fa_pipeline(stats)
    for cut in ("sensor", "motion", "vj"):
        measured = fa["port_runs"][("own", cut, 8)][1].nbytes() / n
        analytic = pipe.cut_payload_bytes(pipe.index(cut))
        assert measured == pytest.approx(analytic, rel=0.10), cut
    assert fa["port_runs"][("own", "nn", 8)][1].nbytes() / n < 150


def test_16_bit_payload_roundtrips(fa):
    """16 bits runs through the same path (the kernels on a card)."""
    off = FaceAuthOffloadExecutor(fa["ports"]["own"], "sensor", bits=16)
    res, pay = off(fa["frames"])
    jres, jpay = JaxOffload(fa["jx"], "sensor", bits=16)(
        jnp.asarray(fa["frames"]))
    assert pay.nbytes() == jpay.nbytes()
    for k, v in jpay.arrays.items():
        np.testing.assert_array_equal(pay.arrays[k].numpy(), np.asarray(v))
    assert _fields_equal(res, jres) == []


def test_static_array_bytes():
    assert static_array_bytes(torch.zeros((3, 8), dtype=torch.bool)) == 3.0
    assert static_array_bytes(torch.zeros((3, 5), dtype=torch.int8)) == 15.0
    assert static_array_bytes(torch.zeros((), dtype=torch.int32)) == 4.0


def test_bad_cut_and_bits_raise(fa):
    with pytest.raises(ValueError):
        FaceAuthOffloadExecutor(fa["ports"]["own"], "stitch")
    with pytest.raises(ValueError):
        FaceAuthOffloadExecutor(fa["ports"]["own"], "vj", bits=6)


def test_fa_controller_end_to_end(fa):
    """On the port's live §III funnel: the solver's choice is the measured
    optimum, and the measured payloads reproduce through the fitted
    pipeline."""
    base, n = fa["base"], len(fa["frames"])
    stats = FAWorkloadStats(
        n_frames=n, motion_frames=max(int(base.motion.sum()), 1),
        windows_to_nn=max(int(base.n_windows.sum()), 1))
    cal = calibrate_fa(stats)
    profiles = fa_profiles()
    profiles["nn"] = cal.nn_profile()
    link = dataclasses.replace(BACKSCATTER,
                               joules_per_byte=cal.rf_joules_per_byte)
    ctl = CutController(
        lambda cut: FaceAuthOffloadExecutor(fa["ports"]["own"], cut, bits=8),
        cuts=CUTS, template=fa_pipeline(stats), profiles=profiles, link=link,
        regime="energy",
        duties={"sensor": 1.0, "motion": 1.0, "vj": 0.0, "nn": 1.0})
    ctl.calibrate(torch.as_tensor(fa["frames"]))
    rep = ctl.report()
    assert rep.agrees
    assert rep.rank_agreement >= 0.8
    mp = rep.measured_pipeline
    for m in rep.measurements:
        assert m.wire_bytes == fa["port_runs"][("own", m.cut, 8)][1].nbytes()
        assert mp.cut_payload_bytes(mp.index(m.cut)) == pytest.approx(
            m.bytes_per_unit)
    res, payload, sol = ctl.execute(fa["frames"])
    assert payload.cut == sol.cut_after == rep.chosen_cut
    assert _fields_equal(
        res, fa["port_runs"][("own", rep.chosen_cut, 8)][0]) == []
