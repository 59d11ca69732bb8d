"""The port's streaming serving runtime against the JAX package's.

Counterparts of tests/test_serving.py, at its fixture (10 frames, the
smoke cascade, ``train_face_nn(steps=60)``), the weights carried across by
the bridge and the port executor reading the JAX integral tables
(``read_jax_integrals``), so that both funnels compute the same payloads:
``FaceAuthExecutor.batch_step`` (equal to single-stream serving and to
the JAX step, quiet invalid slots, closure caching, shape errors, shards
over a device list), the bytes model at every cut, the stream-batched
offload halves (each slot equal to the same frames sent alone, at every
cut x bits), churn, requeue and admission, the windowed re-solve, tick
reports equal to the JAX server's field for field (wall times aside) at
local and at every cut x bits, and single-stream bit-identity through the
server.  Equality is exact throughout: the scheduling is host logic on
the same numbers, and the payloads are the same float32 arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.camera.offload.link import ETH_25G_LINK as JAX_ETH_25G
from repro.camera.pipelines import FaceAuthExecutor as JaxExecutor
from repro.camera.serve import ServeConfig as JaxServeConfig
from repro.camera.serve import StreamingServer as JaxServer
from repro.camera.serve import fa_cut_bytes as jax_fa_cut_bytes
from repro.camera.serve.runtime import Completion as JaxCompletion
from repro.camera.serve.runtime import TickReport as JaxTickReport

from chip_smoke import COMPLETION_FIELDS, REPORT_FIELDS, reports_differ
from chip_smoke import FA_FIELDS as FIELDS
from test_torch_pipeline import read_jax_integrals

from repro_torch.bridge import cascade_from, face_nn_from
from repro_torch.camera.offload import (
    BACKSCATTER,
    ETH_25G_LINK,
    CutController,
    FaceAuthOffloadExecutor,
)
from repro_torch.camera.pipelines import (
    FAWorkloadStats,
    FaceAuthExecutor,
    calibrate_fa,
    fa_pipeline,
    fa_profiles,
)
from repro_torch.camera.serve import (
    FA_CUTS,
    ServeConfig,
    StreamingServer,
    chunk_motion_scores,
    fa_cut_bytes,
    fa_quiet_bytes,
)
from repro_torch.camera.serve.runtime import Completion, TickReport

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

ALL_BITS = (None, 16, 8, 4)
RUNGS = [(None, None)] + [(c, b) for c in FA_CUTS for b in ALL_BITS]


def build_fa():
    """The fixture of tests/test_serving.py in both packages."""
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

    def make(**kw):
        tx = FaceAuthExecutor(cascade_from(casc), face_nn_from(nn, "cpu"),
                              h, w, device="cpu", **scan, **kw)
        read_jax_integrals(tx.det)
        tx.calibrate(frames)
        return tx

    tx = make()
    return dict(frames=frames, jx=jx, tx=tx, make=make,
                base=tx(torch.from_numpy(frames)))


@pytest.fixture(scope="module")
def fa():
    return build_fa()


def motion_pair(frames, base):
    """Two consecutive frames whose transition passes the motion gate."""
    motion = base.motion.numpy()
    i = int(np.argmax(motion[1:])) + 1
    assert motion[i]
    return np.stack([frames[i - 1], frames[i]])


def _fields_equal(got: dict, want) -> list:
    return [f for f in FIELDS
            if not np.array_equal(np.asarray(got[f]),
                                  np.asarray(getattr(want, f)))]


# ---------------------------------------------------------------------------
# FaceAuthExecutor.batch_step
# ---------------------------------------------------------------------------


class TestBatchStep:
    def test_matches_single_stream_bitwise(self, fa):
        frames, tx = fa["frames"], fa["tx"]
        chunks = np.stack([frames[0:4], frames[4:8], frames[2:6]])
        out = tx.batch_step(3, 4)(torch.from_numpy(chunks),
                                  torch.ones(3, dtype=torch.bool))
        for i, ch in enumerate(chunks):
            ref = tx(torch.from_numpy(ch))
            assert _fields_equal({k: v[i] for k, v in out.items()},
                                 ref) == [], i

    def test_matches_jax_batch_step(self, fa):
        frames, tx, jx = fa["frames"], fa["tx"], fa["jx"]
        chunks = np.stack([frames[0:4], frames[4:8], frames[6:10]])
        valid = np.array([True, False, True])
        got = tx.batch_step(3, 4)(torch.from_numpy(chunks),
                                  torch.from_numpy(valid))
        want = jx.batch_step(3, 4)(jnp.asarray(chunks), jnp.asarray(valid))
        for f in FIELDS:
            assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f

    def test_invalid_slots_carry_quiet_result(self, fa):
        frames, tx = fa["frames"], fa["tx"]
        pair = motion_pair(frames, fa["base"])
        hot = torch.from_numpy(np.concatenate([pair, pair]))
        assert tx(hot).motion.any()             # served, it has motion
        stack = torch.stack([torch.from_numpy(frames[0:4]), hot])
        out = tx.batch_step(2, 4)(stack, torch.tensor([True, False]))
        assert not out["motion"][1].any()
        assert (out["window_id"][1] == -1).all()
        assert not out["scores"][1].any()
        assert not out["window_valid"][1].any()
        assert int(out["motion_dropped"][1]) == 0

    def test_closure_cached_and_invalidated_by_calibrate(self, fa):
        tx = fa["make"]()
        step = tx.batch_step(2, 4)
        assert tx.batch_step(2, 4) is step
        assert tx.batch_step(2, 4, devices=["cpu"]) is step
        tx.calibrate(fa["frames"])      # same data: rebuild, same semantics
        assert tx.batch_step(2, 4) is not step

    def test_shape_validation(self, fa):
        frames, tx = fa["frames"], fa["tx"]
        step = tx.batch_step(2, 4)
        with pytest.raises(ValueError, match="shape-bound"):
            step(torch.from_numpy(np.stack([frames[0:3], frames[3:6]])),
                 torch.ones(2, dtype=torch.bool))
        with pytest.raises(ValueError):
            step(torch.from_numpy(np.stack([frames[0:4]])),
                 torch.ones(1, dtype=torch.bool))
        with pytest.raises(ValueError, match="valid"):
            step(torch.from_numpy(np.stack([frames[0:4], frames[4:8]])),
                 torch.ones(3, dtype=torch.bool))
        with pytest.raises(ValueError, match="non-empty"):
            tx.batch_step(2, 4, devices=[])

    @pytest.mark.parametrize("n_devices", [2, 4, 3])
    def test_device_shards_bit_identical(self, fa, n_devices):
        # 4 slots over 2 or 4 devices shard; over 3 they do not divide and
        # the step is the single-device batch
        frames, tx = fa["frames"], fa["tx"]
        chunks = torch.from_numpy(np.stack(
            [np.roll(frames, k, axis=0)[:4] for k in range(4)]))
        valid = torch.tensor([True, True, False, True])
        whole = tx.batch_step(4, 4)(chunks, valid)
        step = tx.batch_step(4, 4, devices=["cpu"] * n_devices)
        assert (step is tx.batch_step(4, 4)) == (4 % n_devices != 0)
        sharded = step(chunks, valid)
        for k, v in whole.items():
            assert torch.equal(v, sharded[k]), k


    def test_shards_on_copies_of_the_constants(self, fa):
        # "cpu:0" is not the executor's device ("cpu"), so each shard runs
        # on a replica whose constants were copied there: what a host of
        # several cards runs
        frames = fa["frames"]
        tx = fa["make"]()
        chunks = torch.from_numpy(np.stack(
            [np.roll(frames, k, axis=0)[:4] for k in range(4)]))
        valid = torch.tensor([True, True, False, True])
        whole = tx.batch_step(4, 4)(chunks, valid)
        sharded = tx.batch_step(4, 4, devices=["cpu:0", "cpu:0"])(chunks,
                                                                 valid)
        for k, v in whole.items():
            assert torch.equal(v, sharded[k]), k
        rep = tx._replicas["cpu:0"]
        assert rep is not tx and rep.device == torch.device("cpu:0")
        assert rep.det is not tx.det and rep.qnn is not tx.qnn
        assert rep.stages is not tx.stages
        tx.calibrate(frames)            # the replicas hold old capacities
        assert tx._replicas == {}


# ---------------------------------------------------------------------------
# the bytes model == the node halves' measured wire bytes
# ---------------------------------------------------------------------------


class TestBytesModel:
    @pytest.mark.parametrize("cut", FA_CUTS)
    def test_quiet_chunk_bytes_exact(self, fa, cut):
        frames, tx = fa["frames"], fa["tx"]
        off = FaceAuthOffloadExecutor(tx, cut, bits=8)
        quiet = torch.from_numpy(np.stack([frames[0], frames[0]]))
        _, wb = off.encode_slots(quiet[None])
        h, w = frames.shape[1:]
        assert float(wb[0]) == fa_quiet_bytes(cut, 8, frames=2, h=h, w=w)

    @pytest.mark.parametrize("cut", FA_CUTS)
    def test_live_chunk_bytes_exact_at_measured_stats(self, fa, cut):
        frames, tx = fa["frames"], fa["tx"]
        chunk = torch.from_numpy(frames[:4])
        res = tx(chunk)
        m, v = int(res.motion.sum()), int(res.window_valid.sum())
        _, wb = FaceAuthOffloadExecutor(tx, cut, bits=8).encode_slots(
            chunk[None])
        h, w = frames.shape[1:]
        assert float(wb[0]) == fa_cut_bytes(cut, 8, frames=4, h=h, w=w,
                                            motion_frames=m,
                                            valid_windows=v)

    @pytest.mark.parametrize("cut", FA_CUTS)
    def test_equals_jax_model(self, cut):
        for bits in ALL_BITS:
            for m, v in ((0.0, 0.0), (1.0, 3.0), (2.5, 7.25), (4.0, 64.0)):
                kw = dict(frames=4, h=144, w=176, motion_frames=m,
                          valid_windows=v)
                assert fa_cut_bytes(cut, bits, **kw) == \
                    jax_fa_cut_bytes(cut, bits, **kw), (bits, m, v)

    def test_unknown_cut_raises(self):
        with pytest.raises(ValueError):
            fa_cut_bytes("head", 8, frames=4, h=16, w=16)


# ---------------------------------------------------------------------------
# the stream-batched offload halves == the same frames sent alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", FA_CUTS)
def test_slot_halves_equal_one_stream(fa, cut):
    frames, tx = fa["frames"], fa["tx"]
    chunks = [frames[0:4], frames[3:7], frames[6:10]]
    stack = torch.from_numpy(np.stack(chunks))
    for bits in ALL_BITS:
        off = FaceAuthOffloadExecutor(tx, cut, bits=bits)
        arrays, wire_b = off.encode_slots(stack)
        res = off.decode_slots(arrays, (4,) + frames.shape[1:])
        for i, ch in enumerate(chunks):
            want_res, pay = off(torch.from_numpy(ch))
            assert set(arrays) == set(pay.arrays), (bits, i)
            for k, v in pay.arrays.items():
                assert arrays[k][i].dtype == v.dtype, (bits, i, k)
                assert torch.equal(arrays[k][i], v), (bits, i, k)
            assert float(wire_b[i]) == float(pay.wire_b), (bits, i)
            assert _fields_equal({k: v[i] for k, v in res.items()},
                                 want_res) == [], (bits, i)


def test_slot_codec_blocks_never_straddle_slots(fa):
    # the vj payload of one slot is 400 x M x W values: with a block that
    # does not divide it, each slot's last block is zero-padded on its own
    frames, tx = fa["frames"], fa["tx"]
    off = FaceAuthOffloadExecutor(tx, "nn", bits=8)
    stack = torch.from_numpy(np.stack([frames[0:4], frames[4:8]]))
    arrays, _ = off.encode_slots(stack)
    W = tx.stages.window_capacity
    M = arrays["fidx"].shape[1]
    assert arrays["scores"].shape[:2] == (2, -(-M * W // 256))
    assert arrays["scores_scales"].shape == (2, -(-M * W // 256), 1)


def test_chunk_motion_scores_gate_matches_funnel(fa):
    # a chunk scores above the server's threshold iff the funnel's motion
    # gate passes one of its frames
    frames, tx = fa["frames"], fa["tx"]
    chunks = torch.from_numpy(np.stack(
        [frames[k:k + 2] for k in range(len(frames) - 1)]))
    thr = float(np.nextafter(np.float32(tx.motion_threshold),
                             np.float32(np.inf)))
    scores = chunk_motion_scores(chunks, tx.motion_factor)
    for k, ch in enumerate(chunks):
        assert bool(scores[k] >= thr) == bool(tx(ch).motion.any()), k
    one = chunk_motion_scores(chunks[:, :1], tx.motion_factor)
    assert torch.isinf(one).all() and (one < 0).all()


# ---------------------------------------------------------------------------
# StreamingServer: churn, requeue, admission
# ---------------------------------------------------------------------------


def _local_server(tx, **kw):
    cfg = ServeConfig(chunk=2, capacity=2, tick_s=1.0, max_queue_s=100.0,
                      **kw)
    return StreamingServer(tx, config=cfg)


class TestStreamingChurn:
    def test_join_mid_window(self, fa):
        frames, tx = fa["frames"], fa["tx"]
        srv = _local_server(tx)
        srv.register("a", fps=1.0)
        srv.enqueue("a", frames[0], t=0.0)
        srv.enqueue("a", frames[1], t=0.5)
        rep1 = srv.tick(1.0)
        assert {c.sid for c in rep1.completions} == {"a"}
        srv.register("b", fps=1.0, t=1.0)
        srv.enqueue("b", frames[2], t=1.1)
        srv.enqueue("b", frames[3], t=1.2)
        rep2 = srv.tick(2.0)
        assert {c.sid for c in rep2.completions} == {"b"}
        assert set(srv.streams) == {"a", "b"}

    def test_leave_with_queued_frames_drains_then_reaps(self, fa):
        frames, tx = fa["frames"], fa["tx"]
        srv = _local_server(tx)
        srv.register("a", fps=1.0)
        for i in range(3):
            srv.enqueue("a", frames[i], t=float(i) / 10)
        assert srv.unregister("a") == 3
        with pytest.raises(ValueError, match="draining"):
            srv.enqueue("a", frames[3], t=1.0)
        done = [c for t in (1.0, 2.0) for c in srv.tick(t).completions]
        assert sum(c.n_frames for c in done) == 3
        assert "a" not in srv.streams
        assert srv.frames_served() == 3

    def test_unregister_empty_queue_is_immediate(self, fa):
        srv = _local_server(fa["tx"])
        srv.register("a", fps=1.0)
        assert srv.unregister("a") == 0
        assert "a" not in srv.streams

    def test_empty_tick(self, fa):
        srv = _local_server(fa["tx"])
        srv.register("a", fps=1.0)
        rep = srv.tick(1.0)
        assert rep.n_ready == 0 and rep.completions == ()
        assert srv.batch_lat_s == []
        assert srv.p99_batch_s() == 0.0

    def test_duplicate_register_raises(self, fa):
        srv = _local_server(fa["tx"])
        srv.register("a", fps=1.0)
        with pytest.raises(ValueError, match="already registered"):
            srv.register("a", fps=1.0)

    def test_capacity_overflow_requeues_without_loss(self, fa):
        frames, tx = fa["frames"], fa["tx"]
        srv = StreamingServer(tx, config=ServeConfig(
            chunk=2, capacity=1, tick_s=1.0, max_queue_s=100.0))
        hot = motion_pair(frames, fa["base"])
        for sid in ("a", "b"):
            srv.register(sid, fps=0.5)
            srv.enqueue(sid, hot[0], t=0.0)
            srv.enqueue(sid, hot[1], t=0.1)
        rep1 = srv.tick(1.0)
        assert rep1.n_served == 1 and rep1.n_requeued == 1
        rep2 = srv.tick(2.0)
        assert rep2.n_served == 1 and rep2.n_requeued == 0
        assert srv.frames_served() == 4
        assert sum(s.requeues for s in srv.streams.values()) == 1

    def test_local_admission_compute_budget(self, fa):
        srv = StreamingServer(fa["tx"], config=ServeConfig(
            chunk=2, capacity=1, tick_s=1.0))
        assert srv.register("a", fps=1.0).admitted
        dec = srv.register("b", fps=1.0)
        assert not dec.admitted and dec.reason.startswith("compute")
        assert srv.rejections and srv.rejections[-1].sid == "b"

    def test_offload_admission_rejects_on_starved_link(self, fa):
        link = dataclasses.replace(BACKSCATTER, bytes_per_s=1.0)
        srv = StreamingServer(fa["tx"], link=link,
                              config=ServeConfig(chunk=2))
        dec = srv.register("a", fps=1.0, cut="vj", bits=8)
        assert not dec.admitted and "uplink" in dec.reason

    def test_offload_admission_replaces_cut_under_pressure(self, fa):
        link = dataclasses.replace(BACKSCATTER, bytes_per_s=100.0)
        srv = StreamingServer(fa["tx"], link=link,
                              config=ServeConfig(chunk=2))
        dec = srv.register("a", fps=1.0, cut="vj", bits=8)
        assert dec.admitted and dec.cut == "nn"
        assert "re-placed" in dec.reason
        assert srv.streams["a"].cut == "nn"

    def test_bad_cut_raises(self, fa):
        srv = _local_server(fa["tx"])
        with pytest.raises(ValueError, match="not in"):
            srv.register("a", fps=1.0, cut="head", bits=8)

    def test_runs_on_the_executor_device(self, fa):
        srv = _local_server(fa["tx"])
        assert srv._devices == [torch.device("cpu")]
        with pytest.raises(ValueError, match="at least one"):
            StreamingServer(fa["tx"], devices=[])


def test_windowed_resolve_skips_zero_traffic_stream(fa):
    """A stream with no traffic serves no frames, so its cut is never
    re-solved, while a served neighbor's is."""
    frames, tx, base = fa["frames"], fa["tx"], fa["base"]
    stats = FAWorkloadStats(
        n_frames=len(frames), motion_frames=max(int(base.motion.sum()), 1),
        windows_to_nn=max(int(base.n_windows.sum()), 1))
    cal = calibrate_fa(stats)
    profiles = fa_profiles()
    profiles["nn"] = cal.nn_profile()
    ctl = CutController(
        lambda cut: FaceAuthOffloadExecutor(tx, cut, bits=8),
        cuts=FA_CUTS, template=fa_pipeline(stats), profiles=profiles,
        link=dataclasses.replace(BACKSCATTER,
                                 joules_per_byte=cal.rf_joules_per_byte),
        regime="energy", unit_rate_hz=1.0,
        duties={"sensor": 1.0, "motion": 1.0, "vj": 0.0, "nn": 1.0})
    ctl.calibrate(torch.from_numpy(frames))
    cfg = ServeConfig(chunk=2, capacity=2, tick_s=1.0, resolve_every=2,
                      link_window=2, max_queue_s=100.0)
    srv = StreamingServer(tx, link=BACKSCATTER.scaled(100.0),
                          controller=ctl, config=cfg)
    srv.register("live", fps=1.0, cut="vj", bits=8)
    srv.register("idle", fps=1.0, cut="vj", bits=8)
    hot = motion_pair(frames, base)
    before = ctl.resolves
    fired = 0
    for k in range(3):
        srv.enqueue("live", hot[0], t=float(k))
        srv.enqueue("live", hot[1], t=float(k) + 0.1)
        fired += srv.tick(float(k + 1)).resolves_fired
    assert srv.streams["live"].resolves >= 1
    assert ctl.resolves - before == fired == srv.total_resolves() - before
    assert srv.streams["idle"].resolves == 0
    assert srv.streams["idle"].cut == "vj"
    assert srv.streams["idle"].frames_since_resolve == 0


# ---------------------------------------------------------------------------
# tick reports == the JAX server's, at local and at every cut x bits
# ---------------------------------------------------------------------------


def drive(server_cls, cfg_cls, ex, link, frames, pair, cut, bits):
    """Three streams at one placement, capacity 2, each fed two frames a
    tick from the same script (every stream hot on even ticks, so the
    capacity drop requeues); returns the server and its tick reports."""
    srv = server_cls(ex, link=link, config=cfg_cls(
        chunk=2, capacity=2, tick_s=1.0, max_queue_s=100.0,
        max_queue_frames=5))
    sids = ("a", "b", "c")
    for sid in sids:
        dec = srv.register(sid, fps=0.5, cut=cut, bits=bits)
        assert dec.admitted and dec.cut == cut, dec
    reports = []
    for tick in range(5):
        for k, sid in enumerate(sids):
            if tick % 2 == 0 or k == tick % 3:    # even ticks: all hot
                a, b = pair
            else:
                a = b = frames[(2 * tick + k) % len(frames)]
            srv.enqueue(sid, a, t=float(tick))
            srv.enqueue(sid, b, t=float(tick) + 0.5)
        reports.append(srv.tick(float(tick + 1)))
    return srv, reports


@pytest.mark.parametrize("cut,bits", RUNGS,
                         ids=[f"{c or 'local'}-{b or 'raw'}"
                              for c, b in RUNGS])
def test_tick_reports_equal_jax(fa, cut, bits):
    frames = fa["frames"]
    pair = motion_pair(frames, fa["base"])
    jsrv, jrep = drive(JaxServer, JaxServeConfig, fa["jx"], JAX_ETH_25G,
                       frames, pair, cut, bits)
    tsrv, trep = drive(StreamingServer, ServeConfig, fa["tx"], ETH_25G_LINK,
                       frames, pair, cut, bits)
    assert reports_differ(jrep, trep) == []
    assert sum(r.n_served for r in trep) >= 4
    assert sum(r.n_requeued for r in trep) >= 1
    assert tsrv.seq_audit() == jsrv.seq_audit()
    assert tsrv.seq_audit()["ok"]
    for c in (c for r in trep for c in r.completions):
        assert all(isinstance(v, (np.ndarray, np.generic))
                   for v in c.result.values())


@pytest.mark.parametrize("cls,compared,aside", [
    (TickReport, REPORT_FIELDS, {"batch_s", "completions"}),
    (JaxTickReport, REPORT_FIELDS, {"batch_s", "completions"}),
    (Completion, COMPLETION_FIELDS, {"result"}),
    (JaxCompletion, COMPLETION_FIELDS, {"result"})],
    ids=["port-report", "jax-report", "port-completion", "jax-completion"])
def test_report_comparison_covers_every_field(cls, compared, aside):
    """``reports_differ`` compares every field of both packages' tick
    reports and completions but the wall clock, and the completions and
    their result arrays on their own."""
    names = {f.name for f in dataclasses.fields(cls)}
    assert set(compared) | aside == names
    assert not set(compared) & aside


# ---------------------------------------------------------------------------
# single-stream bit-identity through the serving path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut,bits", RUNGS,
                         ids=[f"{c or 'local'}-{b or 'raw'}"
                              for c, b in RUNGS])
def test_single_stream_matches_executor(fa, cut, bits):
    """Served as one chunk, a stream equals the port's FaceAuthExecutor
    (local, and every cut raw), or its split executor at the same cut and
    width (coded), with the split executor's wire bytes."""
    frames, tx = fa["frames"], fa["tx"]
    cfg = ServeConfig(chunk=len(frames), capacity=1, tick_s=1.0,
                      max_queue_s=1e9)
    srv = StreamingServer(tx, link=ETH_25G_LINK, config=cfg)
    dec = srv.register("s", fps=1.0, cut=cut, bits=bits)
    assert dec.admitted and dec.cut == cut
    for i, f in enumerate(frames):
        srv.enqueue("s", f, t=i / len(frames))
    (comp,) = srv.tick(1.0).completions
    assert comp.kind == "served" and comp.n_frames == len(frames)
    if cut is None:
        want, wire = fa["base"], 0.0
    else:
        want, pay = FaceAuthOffloadExecutor(tx, cut, bits=bits)(
            torch.from_numpy(frames))
        wire = float(pay.wire_b)
        if bits is None:
            assert _fields_equal(comp.result, fa["base"]) == []
    assert _fields_equal(comp.result, want) == []
    assert comp.wire_bytes == wire
