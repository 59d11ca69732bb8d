"""The port's fleet telemetry plane against the JAX package's.

Counterparts of tests/test_obs.py at the serving fixture
(tests/test_torch_serving.py): telemetry off or absent leaves every output
bit-identical (executor, split sessions at every cut, server tick
reports); the counters equal the real outputs (the funnel, ``run_streams``,
``batch_step``, the VR rig, the server's ``exec.*`` harvest) and equal the
JAX package's counters on the same drive; the counter panel, the trace and
the SLO ledger round-trip their state, also through a server checkpoint;
trace ids, JSONL, the ring and the Perfetto export; the sorted-sid shed and
audit order; the ledger's rung keys and flip attribution; the counter
dtype law; the bench.v1 schema; a device-kill chain reconstructed from
the port's trace alone; and ``python -m repro_torch.obs`` prints what
``python -m repro.obs`` prints on the same files.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jax_obs
from repro.camera.offload.link import ETH_25G_LINK as JAX_ETH_25G
from repro.camera.serve import ServeConfig as JaxServeConfig
from repro.camera.serve import StreamingServer as JaxServer
from repro.obs.cli import main as jax_cli

from chip_smoke import FA_FIELDS as FIELDS
from chip_smoke import reports_differ
from test_torch_serving import build_fa, motion_pair

import repro_torch.obs as obs
from repro_torch.camera.offload import (
    BACKSCATTER,
    ETH_25G_LINK,
    FaceAuthOffloadExecutor,
    GilbertElliott,
    OffloadSession,
)
from repro_torch.camera.serve import (
    ChaosSpec,
    ServeConfig,
    StreamingServer,
)
from repro_torch.obs import (
    ALLOWED_DTYPES,
    TELEMETRY_AUX,
    CounterPanel,
    SLOLedger,
    Telemetry,
    TraceRecord,
    TraceRecorder,
    bench_record,
    diff_bench,
    format_diff,
    graph_counter,
    graph_counters,
    kind_counts,
    load_bench,
    rung_key,
    telemetry_decl,
    telemetry_on,
    write_bench,
)
from repro_torch.obs.cli import main as cli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fa():
    return build_fa()


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _server(ex, *, chunk=2, capacity=2, chaos=None, telemetry=None,
            devices=None, link=None, **kw):
    kw.setdefault("max_queue_s", 100.0)
    cfg = ServeConfig(chunk=chunk, capacity=capacity, tick_s=1.0, **kw)
    return StreamingServer(ex, config=cfg, chaos=chaos, telemetry=telemetry,
                           devices=devices, link=link)


def _drive(srv, frames, pair, ticks=3):
    """A vj stream and a local stream, hot and quiet chunks in turn."""
    dec = srv.register("a", fps=1.0, cut="vj", bits=8)
    assert dec.admitted and dec.cut == "vj", dec
    srv.register("b", fps=1.0)
    reports = []
    for tick in range(ticks):
        for sid in ("a", "b"):
            two = pair if tick % 2 == 0 else frames[2 * tick:2 * tick + 2]
            srv.enqueue(sid, two[0], t=float(tick))
            srv.enqueue(sid, two[1], t=float(tick) + 0.5)
        reports.append(srv.tick(float(tick + 1)))
    return reports


# ---------------------------------------------------------------------------
# telemetry off (or absent) changes nothing; on, the counters are real
# ---------------------------------------------------------------------------


class TestCountersOffBitIdentity:
    def test_disabled_executor_is_the_plain_executor(self, fa):
        frames = torch.from_numpy(fa["frames"])
        off = fa["make"](telemetry=Telemetry(enabled=False))
        on = fa["make"](telemetry=Telemetry(enabled=True))
        plain_out = fa["tx"]._funnel(frames[None])
        assert set(off._funnel(frames[None])) == set(plain_out)
        assert not any(k.startswith("tel_") for k in plain_out)
        assert {k for k in on._funnel(frames[None]) if k.startswith(
            "tel_")} == {"tel_" + c for c, _ in
                         TELEMETRY_AUX["face_auth.funnel"]}
        assert _same(fa["base"], off(frames))
        assert _same(fa["base"], on(frames))
        assert off.telemetry.counters.totals() == {}

    def test_session_bit_identical_at_every_cut(self, fa):
        frames = torch.from_numpy(fa["frames"])
        for cut in FaceAuthOffloadExecutor.CUTS:
            off = FaceAuthOffloadExecutor(fa["tx"], cut, bits=8)
            want, _ = off(frames)
            for tel in (None, Telemetry(enabled=False),
                        Telemetry(enabled=True)):
                got, rec = OffloadSession(off, link=BACKSCATTER,
                                          telemetry=tel,
                                          sid="cam0").send(frames)
                assert rec.delivered
                assert _same(want, got), (cut, tel)

    def test_enabled_session_counts_enabled_only(self, fa):
        frames = torch.from_numpy(fa["frames"])
        off = FaceAuthOffloadExecutor(fa["tx"], "nn", bits=8)
        tel_off = Telemetry(enabled=False)
        OffloadSession(off, link=BACKSCATTER, telemetry=tel_off).send(frames)
        assert tel_off.counters.totals() == {}
        assert len(tel_off.trace) == 0
        tel = Telemetry(enabled=True)
        OffloadSession(off, link=BACKSCATTER, telemetry=tel,
                       sid="cam0").send(frames)
        tot = tel.counters.totals()
        assert (tot["offload.sends"], tot["offload.delivered"],
                tot["offload.attempts"]) == (1, 1, 1)
        assert tot["offload.bytes_on_air"] > 0
        (link_ev,) = tel.trace.records("link")
        assert link_ev.sid == "cam0" and link_ev.args["delivered"]
        assert tel.ledger.keys() == [("cam0", "nn@8")]

    def test_server_reports_identical_with_none_off_on(self, fa):
        frames, pair = fa["frames"], motion_pair(fa["frames"], fa["base"])
        runs = []
        for tel in (None, Telemetry(enabled=False), Telemetry(enabled=True)):
            ex = fa["make"](telemetry=tel)
            srv = _server(ex, telemetry=tel, link=ETH_25G_LINK)
            runs.append(_drive(srv, frames, pair))
        assert reports_differ(runs[0], runs[1]) == []
        assert reports_differ(runs[0], runs[2]) == []


class TestCountersMatchOutputs:
    def test_funnel_counters(self, fa):
        tel = Telemetry(enabled=True)
        res = fa["make"](telemetry=tel)(torch.from_numpy(fa["frames"]))
        tot = tel.counters.totals()
        assert tot["fa.windows"] == int(res.n_windows.sum())
        assert tot["fa.auth"] == int(res.n_auth.sum())
        assert tot["fa.motion_dropped"] == int(res.motion_dropped)
        assert tot["fa.cascade_dropped"] == int(res.cascade_dropped.sum())
        assert tot["fa.windows"] > 0
        # the JAX executor's counters on the same frames
        jtel = jax_obs.Telemetry(enabled=True)
        from repro.camera.pipelines import FaceAuthExecutor as JaxExecutor

        jx = fa["jx"]
        jon = JaxExecutor.__new__(JaxExecutor)
        jon.__dict__.update(jx.__dict__)
        jon.telemetry, jon._tel_on = jtel, True
        jon._rebuild()
        jon(fa["frames"])
        assert jtel.counters.totals() == tot

    def test_run_streams_and_batch_step_counters(self, fa):
        frames = fa["frames"]
        tel = Telemetry(enabled=True)
        ex = fa["make"](telemetry=tel)
        streams = torch.from_numpy(np.stack([frames, frames[::-1].copy()]))
        res = ex.run_streams(streams)
        assert tel.counters.totals()["fa.windows"] == int(
            res.n_windows.sum())
        out = ex.batch_step(2, 10)(streams, torch.tensor([True, False]))
        assert out["tel_windows"].tolist() == [
            int(res.n_windows[0].sum()), 0]
        assert out["tel_auth"].dtype == torch.int32

    def test_server_harvests_exec_counters(self, fa):
        frames, pair = fa["frames"], motion_pair(fa["frames"], fa["base"])
        tel = Telemetry(enabled=True)
        srv = _server(fa["make"](telemetry=tel), telemetry=tel,
                      link=ETH_25G_LINK)
        reports = _drive(srv, frames, pair, ticks=4)
        done = [c for r in reports for c in r.completions]
        local = [c for c in done if c.sid == "b" and c.kind == "served"]
        assert local
        tot = tel.counters.totals()
        assert tot["exec.windows"] == sum(
            int(c.result["n_windows"].sum()) for c in local)
        assert tot["exec.auth"] == sum(
            int(c.result["n_auth"].sum()) for c in local)
        assert tot["serve.ticks"] == 4
        assert tot["serve.frames_delivered"] == sum(
            c.n_frames for c in done)
        assert tot["serve.dispatches"] == len(tel.trace.records("dispatch"))
        # the JAX server's counters on the same drive, but for the JAX
        # funnel's own tel_ harvest (its executor is not instrumented)
        jtel = jax_obs.Telemetry(enabled=True)
        jsrv = JaxServer(fa["jx"], link=JAX_ETH_25G, telemetry=jtel,
                         config=JaxServeConfig(chunk=2, capacity=2,
                                               tick_s=1.0,
                                               max_queue_s=100.0))
        _drive(jsrv, frames, pair, ticks=4)
        assert jtel.counters.totals() == {
            k: v for k, v in tot.items() if not k.startswith("exec.")}
        assert kind_counts(jtel.trace.records()) == \
            kind_counts(tel.trace.records())

    def test_vr_rig_counters(self):
        from repro_torch.camera.bssa import GridSpec
        from repro_torch.camera.pipelines import VRRigExecutor

        tel = Telemetry(enabled=True)
        rig = VRRigExecutor(GridSpec(sigma_spatial=8, sigma_range=16),
                            max_disp=4, n_iters=2, device="cpu",
                            telemetry=tel)
        rng = np.random.default_rng(0)
        lefts = rng.random((2, 24, 32), np.float32)
        rights = np.roll(lefts, 2, axis=-1)
        got = rig(lefts, rights)
        plain = VRRigExecutor(GridSpec(sigma_spatial=8, sigma_range=16),
                              max_disp=4, n_iters=2, device="cpu")(
                                  lefts, rights)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        assert tel.counters.totals() == {"vr.pairs": 2, "vr.views": 4}


# ---------------------------------------------------------------------------
# state round-trips: panel, telemetry, server checkpoint
# ---------------------------------------------------------------------------


class TestCounterConservation:
    def test_panel_state_roundtrip_exact(self):
        p = CounterPanel()
        p.bump("a", 3)
        p.add("a", torch.tensor(4, dtype=torch.int32))
        p.add("b", torch.tensor([3, 4], dtype=torch.int32))
        before = p.totals()
        assert before == {"a": 7, "b": 7}
        q = CounterPanel()
        q.load_state(p.state_dict())
        assert q.totals() == before
        q.bump("a")
        assert q.totals()["a"] == 8

    def test_panel_merge_conserves_sum(self):
        a, b = CounterPanel(), CounterPanel()
        a.bump("x", 2)
        b.bump("x", 5)
        b.bump("y", 1)
        a.merge(b)
        assert a.totals() == {"x": 7, "y": 1}

    def test_disabled_panel_stays_empty(self):
        p = CounterPanel(enabled=False)
        p.bump("a")
        p.add("b", torch.tensor(1, dtype=torch.int32))
        out = p.consume({"tel_c": torch.tensor(2), "real": 9})
        assert out == {"real": 9}
        assert p.totals() == {}

    def test_telemetry_state_roundtrip_and_jax_compatible(self):
        tel = Telemetry(enabled=True)
        tel.counters.bump("serve.dispatches", 11)
        tel.ledger.observe_latency("a", ("nn", 8), 0.5)
        tel.ledger.observe_auth("a", ("nn", 8), np.array([1, 0, 1]),
                                np.array([1, 1, 1]))
        tel2 = Telemetry(enabled=True)
        tel2.load_state(tel.state_dict())
        assert tel2.counters.totals() == tel.counters.totals()
        assert tel2.ledger.flip_counts() == (1, 3)
        (rst,) = tel2.trace.records("ckpt")
        assert rst.args["parent_run"] == tel.run_id
        assert tel2.run_id != tel.run_id
        # the state dict is the JAX package's: each restores the other's
        jtel = jax_obs.Telemetry(enabled=True)
        jtel.load_state(json.loads(json.dumps(tel.state_dict())))
        assert jtel.counters.totals() == tel.counters.totals()
        assert jtel.ledger.report() == tel.ledger.report()

    def test_server_counters_survive_restore(self, fa, tmp_path):
        frames = fa["frames"]
        tel = Telemetry(enabled=True)
        srv = _server(fa["tx"], telemetry=tel)
        srv.register("a", fps=1.0)
        for i in range(3):
            srv.enqueue("a", frames[i], t=float(i) * 0.1)
        srv.tick(1.0)
        before = tel.counters.totals()
        assert before.get("serve.dispatches", 0) >= 1
        srv.checkpoint(str(tmp_path))
        tel2 = Telemetry(enabled=True)
        srv2 = StreamingServer.restore(str(tmp_path), fa["tx"],
                                       config=srv.cfg, telemetry=tel2)
        assert tel2.counters.totals() == before
        assert tel2.ledger.keys() == tel.ledger.keys()
        srv2.enqueue("a", frames[3], t=1.5)
        srv2.tick(2.0)
        assert tel2.counters.totals()["serve.dispatches"] > \
            before["serve.dispatches"]
        assert srv2.seq_audit()["ok"]

    def test_restore_without_telemetry_key_is_fine(self, fa, tmp_path):
        frames = fa["frames"]
        srv = _server(fa["tx"])
        srv.register("a", fps=1.0)
        srv.enqueue("a", frames[0], t=0.0)
        srv.tick(1.0)
        srv.checkpoint(str(tmp_path))
        tel = Telemetry(enabled=True)
        srv2 = StreamingServer.restore(str(tmp_path), fa["tx"],
                                       config=srv.cfg, telemetry=tel)
        srv2.enqueue("a", frames[1], t=1.5)
        srv2.tick(2.0)
        assert tel.counters.totals().get("serve.dispatches", 0) >= 1


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class TestTrace:
    def test_eids_unique_and_monotone(self):
        tr = TraceRecorder()
        eids = [tr.emit("tick", f"t{i}", t=float(i)) for i in range(50)]
        assert eids == list(range(50))
        assert all(r.run_id == tr.run_id for r in tr.records())

    def test_run_ids_distinct_across_recorders(self):
        assert len({TraceRecorder().run_id for _ in range(8)}) == 8

    def test_jsonl_roundtrip_preserves_ids(self, tmp_path):
        tr = TraceRecorder()
        tr.emit("tick", "t0", t=0.0, dur=1.0, tick=0, sid="a", n=3)
        tr.emit("link", "send[nn@8]", t=0.5, sid="a", attempts=2)
        path = str(tmp_path / "trace.jsonl")
        assert tr.to_jsonl(path) == 2
        back = TraceRecorder.load_jsonl(path)
        assert back == tr.records()
        assert kind_counts(back) == {"link": 1, "tick": 1}
        # the JAX package reads the same file to the same records
        jback = jax_obs.TraceRecorder.load_jsonl(path)
        assert [r.to_json() for r in jback] == [r.to_json() for r in back]

    def test_ring_keeps_newest_and_counts_drops(self):
        tr = TraceRecorder(capacity=4)
        for i in range(10):
            tr.emit("tick", f"t{i}")
        assert len(tr) == 4 and tr.dropped == 6
        assert [r.eid for r in tr.records()] == [6, 7, 8, 9]

    def test_perfetto_export_equals_jax(self, tmp_path):
        tr = TraceRecorder(run_id="r0")
        tr.emit("tick", "t0", t=1.0, dur=0.5, tick=0)
        tr.emit("chaos", "device_kill", t=1.25, tick=0, device=1)
        path = str(tmp_path / "trace.json")
        assert tr.export_perfetto(path) == 2
        doc = json.load(open(path))
        evs = doc["traceEvents"]
        span = next(e for e in evs if e["cat"] == "tick")
        assert span["ph"] == "X" and span["dur"] == pytest.approx(0.5e6)
        inst = next(e for e in evs if e["cat"] == "chaos")
        assert inst["ph"] == "i" and span["tid"] != inst["tid"]
        jtr = jax_obs.TraceRecorder(run_id="r0")
        jtr.emit("tick", "t0", t=1.0, dur=0.5, tick=0)
        jtr.emit("chaos", "device_kill", t=1.25, tick=0, device=1)
        jtr.export_perfetto(str(tmp_path / "jax.json"))
        assert json.load(open(tmp_path / "jax.json")) == doc

    def test_disabled_telemetry_emit_is_noop(self):
        tel = Telemetry(enabled=False)
        assert tel.emit("tick", "t0") == -1
        assert len(tel.trace) == 0
        assert not telemetry_on(tel) and not telemetry_on(None)
        assert telemetry_on(Telemetry(enabled=True))

    def test_kill_chain_from_the_port_trace(self, fa, tmp_path):
        """A device kill on a two-device server is traceable from the
        JSONL alone: kill, failover at the same tick, a ladder descent, the
        restore, and a later tick that served work."""
        from benchmarks.serving_chaos import kill_chain

        frames, pair = fa["frames"], motion_pair(fa["frames"], fa["base"])
        tel = Telemetry(enabled=True)
        spec = ChaosSpec(loss=GilbertElliott(p_gb=1.0, p_bg=0.0,
                                             loss_bad=1.0, loss_good=1.0),
                         max_retries=0, seed=1,
                         device_events=((1, "kill", 1), (3, "restore", 1)))
        srv = _server(fa["tx"], chaos=spec, telemetry=tel,
                      devices=["cpu", "cpu"], link=ETH_25G_LINK)
        _drive(srv, frames, pair, ticks=5)
        path = str(tmp_path / "chain.jsonl")
        tel.trace.to_jsonl(path)
        chain = kill_chain(TraceRecorder.load_jsonl(path))
        assert chain["ok"], chain
        assert chain["kill_tick"] == chain["failover_tick"] == 1
        assert chain["restore_tick"] == 3


# ---------------------------------------------------------------------------
# sorted-sid shed and audit order
# ---------------------------------------------------------------------------


class TestSortedSidOrder:
    def test_shed_and_audit_sorted_regardless_of_registration(self, fa):
        frames = fa["frames"]
        srv = _server(fa["tx"], max_queue_frames=2)
        for sid in ("zeta", "alpha", "mid"):
            srv.register(sid, fps=1.0)
        for k in range(5):
            for sid in ("zeta", "alpha", "mid"):
                srv.enqueue(sid, frames[k % len(frames)], t=float(k))
        rep = srv.tick(1.0)
        assert [s.sid for s in rep.shed] == ["alpha", "mid", "zeta"]
        assert all(s.seqs == tuple(sorted(s.seqs)) for s in rep.shed)
        audit = srv.seq_audit()
        assert audit["ok"]
        assert list(audit["streams"]) == sorted(audit["streams"])

    def test_order_stable_after_churn_reregister(self, fa):
        frames = fa["frames"]
        srv = _server(fa["tx"], max_queue_frames=2)
        for sid in ("a", "b"):
            srv.register(sid, fps=1.0)
        srv.enqueue("a", frames[0], t=0.0)
        srv.unregister("a")
        srv.tick(1.0)
        srv.register("a", fps=1.0)
        for k in range(5):
            for sid in ("a", "b"):
                srv.enqueue(sid, frames[k % len(frames)], t=1.0 + k)
        assert [s.sid for s in srv.tick(2.0).shed] == ["a", "b"]
        assert srv.seq_audit()["ok"]


# ---------------------------------------------------------------------------
# the SLO ledger
# ---------------------------------------------------------------------------


class TestLedger:
    def test_rung_key_canonicalization(self):
        for rung in (("nn", 16), ("vj", None), ("on_node", None),
                     "on_node", (None, None), None):
            assert rung_key(rung) == jax_obs.rung_key(rung)
        assert rung_key(("nn", 16)) == "nn@16"
        assert rung_key((None, None)) == "local"

    def test_flip_attribution_by_rung(self):
        led = SLOLedger()
        ref = np.array([1, 1, 0, 1])
        led.observe_auth("a", ("nn", 16), ref, ref)
        led.observe_auth("a", ("nn", 8), np.array([1, 0, 0, 0]), ref)
        assert led.flip_counts(rung=("nn", 16)) == (0, 4)
        assert led.flip_counts(rung=("nn", 8)) == (2, 4)
        assert led.flip_counts(sid="a") == (2, 8)
        assert led.flip_rate(rung=("nn", 8)) == pytest.approx(0.5)

    def test_dropped_frame_counts_all_units_flipped(self):
        led = SLOLedger()
        led.observe_auth("a", "on_node", None, np.zeros(6, bool))
        assert led.flip_counts() == (6, 6) and led.flip_rate() == 1.0

    def test_latency_percentiles_and_slo(self):
        led = SLOLedger(slo_s=0.1)
        for i in range(10):
            led.observe_latency("a", ("nn", 8), 0.01 * (i + 1))
        assert led.latency_percentiles(sid="a")["p50"] == \
            pytest.approx(0.055)
        assert led.slo_violations() == 0
        led.observe_latency("a", "on_node", 0.5)
        assert led.slo_violations() == 1
        assert math.isnan(led.latency_percentiles(sid="ghost")["p50"])

    def test_report_rows_and_state_roundtrip(self):
        led = SLOLedger(slo_s=0.2)
        led.observe_latency("a", ("nn", 8), 0.05)
        led.observe_auth("a", ("nn", 8), np.array([1]), np.array([0]))
        led2 = SLOLedger()
        led2.load_state(led.state_dict())
        (row,) = led2.report()
        assert led2.slo_s == 0.2
        assert (row["sid"], row["rung"], row["flipped"], row["compared"]) \
            == ("a", "nn@8", 1, 1)


# ---------------------------------------------------------------------------
# counter primitives and the declaration registry
# ---------------------------------------------------------------------------


class TestCounterPrimitives:
    def test_graph_counter_dtype_law(self):
        assert graph_counter(3).dtype == torch.int32
        assert graph_counter(3, "uint32").dtype == torch.uint32
        assert graph_counter(torch.arange(3)).shape == (3,)
        with pytest.raises(ValueError, match="int32"):
            graph_counter(3, "int64")
        with pytest.raises(ValueError):
            graph_counter(3, "float32")

    def test_graph_counters_prefix_and_shape(self):
        aux = graph_counters(windows=torch.arange(3).sum(), auth=2)
        assert set(aux) == {"tel_windows", "tel_auth"}
        assert all(v.shape == () for v in aux.values())

    def test_registry_equals_jax(self):
        assert TELEMETRY_AUX == jax_obs.TELEMETRY_AUX
        assert ALLOWED_DTYPES == jax_obs.ALLOWED_DTYPES
        for name in ("face_auth.funnel", "fa_offload[nn,8].node",
                     "serve.batch_step[3x4]", "codec.roundtrip[b8]",
                     "rogue.target"):
            assert telemetry_decl(name) == jax_obs.telemetry_decl(name)

    def test_exports_equal_jax(self):
        assert sorted(obs.__all__) == sorted(jax_obs.__all__)


# ---------------------------------------------------------------------------
# bench.v1 and the command line
# ---------------------------------------------------------------------------


class TestBenchSchema:
    ROWS = [("fa", "speedup", "3.2", "vs loop"),
            ("fa", "parity", "identical", "")]

    def test_record_and_diff(self):
        a = bench_record("fa", self.ROWS, 1.5, smoke=True, generated_at=1.0)
        b = bench_record("fa", self.ROWS, 9.9, smoke=False, generated_at=2.0)
        assert a["schema"] == "bench.v1"
        assert diff_bench(a, b)["identical"]
        c = bench_record("fa", [("fa", "speedup", "2.9", "vs loop"),
                                ("fa", "new_metric", "1", "")], 1.0)
        d = diff_bench(a, c)
        assert d == jax_obs.diff_bench(a, c)
        assert format_diff(d) == jax_obs.format_diff(d)
        assert "~ fa/speedup: 3.2 -> 2.9" in format_diff(d)

    def test_load_upgrades_legacy_files(self, tmp_path):
        legacy = tmp_path / "BENCH_old.json"
        legacy.write_text(json.dumps(
            {"section": "fa", "wall_s": 2.0, "rows": self.ROWS}))
        rec = load_bench(str(legacy))
        assert rec == jax_obs.load_bench(str(legacy))
        write_bench(str(tmp_path / "BENCH_new.json"),
                    bench_record("fa", self.ROWS, 1.0))
        assert diff_bench(rec, load_bench(
            str(tmp_path / "BENCH_new.json")))["identical"]


BENCHES = sorted(str(p) for p in REPO.glob("BENCH_*.json"))


def _both_clis(argv, capsys):
    rc = cli(argv)
    port = capsys.readouterr().out
    jrc = jax_cli(argv)
    return (rc, port), (jrc, capsys.readouterr().out)


@pytest.mark.parametrize("path", BENCHES,
                         ids=[Path(p).name for p in BENCHES])
def test_cli_summary_equals_jax(path, capsys):
    port, jax = _both_clis(["summary", path], capsys)
    assert port == jax and port[0] == 0 and port[1]


def test_cli_diff_equals_jax(capsys, tmp_path):
    assert len(BENCHES) >= 2
    for a, b in ((BENCHES[0], BENCHES[0]), (BENCHES[0], BENCHES[1])):
        for extra in ([], ["--json"]):
            port, jax = _both_clis(["diff", a, b] + extra, capsys)
            assert port == jax
            assert port[0] == (0 if a == b else 1)


def test_cli_trace_and_dashboard_equal_jax(capsys, tmp_path):
    tel = Telemetry(enabled=True, run_id="run0")
    tel.emit("tick", "tick", t=0.0, dur=1.0, tick=0)
    tel.emit("link", "chunk_tx", t=0.5, tick=0, sid="a", attempts=2)
    jl = str(tmp_path / "t.jsonl")
    tel.trace.to_jsonl(jl)
    for cmd in (["trace", jl], ["dashboard", jl]):
        port, jax = _both_clis(cmd, capsys)
        assert port == jax and port[0] == 0
    pf = str(tmp_path / "t.perfetto.json")
    assert cli(["trace", jl, "--perfetto", pf]) == 0
    assert json.load(open(pf))["traceEvents"]


def test_python_m_repro_torch_obs(tmp_path):
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summary", BENCHES[0]],
        capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("BENCH ")


def test_fleet_dashboard_renders():
    tel = Telemetry(enabled=True, slo_s=0.2)
    tel.counters.bump("serve.dispatches", 4)
    tel.emit("tick", "tick", t=0.0, dur=1.0, tick=0)
    tel.ledger.observe_latency("a", ("nn", 8), 0.05)
    tel.ledger.observe_auth("a", ("nn", 8), np.array([1]), np.array([1]))
    txt = obs.fleet_dashboard(counters=tel.counters.totals(),
                              ledger=tel.ledger, records=tel.trace.records(),
                              run_id=tel.run_id)
    assert "serve.dispatches" in txt and "nn@8" in txt
    assert tel.run_id in txt
    jled = jax_obs.SLOLedger()
    jled.load_state(tel.ledger.state_dict())
    assert txt == jax_obs.fleet_dashboard(
        counters=tel.counters.totals(), ledger=jled,
        records=[jax_obs.TraceRecord.from_json(r.to_json())
                 for r in tel.trace.records()], run_id=tel.run_id)
    assert isinstance(tel.trace.records()[0], TraceRecord)
