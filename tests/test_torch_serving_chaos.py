"""The port's chaos-hardened serving fleet against the JAX package's.

Counterparts of tests/test_serving_chaos.py at its fixture (that of
tests/test_torch_serving.py): the named serving errors, bounded-queue fair
shedding and the DRR starvation bound (service ticks equal to the JAX
server's), the zero-fault pin (an inert ``ChaosSpec`` is bit-identical to
no chaos, and to the JAX server), loss cells whose ladder moves,
``n_failed_tx`` and whole tick reports equal the JAX server's, the fault
schedule per sid, failover over a device list (the CPU device listed 8
times stands for the reference's 8 fake host devices: re-sharding is
bit-identical), and checkpoints (a port checkpoint resumes bit-identical
and ``seq_audit`` holds; a checkpoint written by the JAX server restores
in the port's and both continue with equal tick reports).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.camera.offload.link import ETH_25G_LINK as JAX_ETH_25G
from repro.camera.offload.link import GilbertElliott as JaxGE
from repro.camera.serve import ChaosEngine as JaxChaosEngine
from repro.camera.serve import ChaosSpec as JaxChaosSpec
from repro.camera.serve import ServeConfig as JaxServeConfig
from repro.camera.serve import StreamingServer as JaxServer

from chip_smoke import reports_differ
from test_torch_serving import build_fa, motion_pair

from repro_torch.camera.offload.link import ETH_25G_LINK, GilbertElliott
from repro_torch.camera.serve import (
    ChaosEngine,
    ChaosSpec,
    ServeConfig,
    ServeError,
    StreamDrainingError,
    StreamingServer,
    UnknownStreamError,
)

torch.set_num_threads(1)

LOSS = {"always": dict(p_gb=1.0, p_bg=0.0, loss_bad=1.0, loss_good=1.0),
        "sometimes": dict(p_gb=0.3, p_bg=0.3, loss_bad=0.9,
                          loss_good=0.0)}
ALWAYS_LOST = GilbertElliott(**LOSS["always"])
SOMETIMES_LOST = GilbertElliott(**LOSS["sometimes"])


@pytest.fixture(scope="module")
def fa():
    return build_fa()


def _server(ex, *, chunk=2, capacity=2, chaos=None, link=None,
            devices=None, **kw):
    kw.setdefault("max_queue_s", 100.0)
    cfg = ServeConfig(chunk=chunk, capacity=capacity, tick_s=1.0, **kw)
    return StreamingServer(ex, link=link, config=cfg, chaos=chaos,
                           devices=devices)


def _both(fa, **spec_kw):
    """(JAX server, port server) with the same config and chaos spec."""
    out = []
    for srv_cls, cfg_cls, spec_cls, ge_cls, link, ex in (
            (JaxServer, JaxServeConfig, JaxChaosSpec, JaxGE, JAX_ETH_25G,
             fa["jx"]),
            (StreamingServer, ServeConfig, ChaosSpec, GilbertElliott,
             ETH_25G_LINK, fa["tx"])):
        kw = dict(spec_kw)
        if "loss" in kw:
            kw["loss"] = ge_cls(**LOSS[kw["loss"]])
        out.append(srv_cls(ex, link=link, chaos=spec_cls(**kw),
                           config=cfg_cls(chunk=2, capacity=2, tick_s=1.0,
                                          max_queue_s=100.0)))
    return out


class _ScriptedInjector:
    """Stands in for a FaultInjector: scripted attempt outcomes."""

    def __init__(self, outcomes):
        self.outcomes = list(outcomes)
        self.brownout = None

    def attempt(self, t):
        return self.outcomes.pop(0) if self.outcomes else "ok"


# ---------------------------------------------------------------------------
# the named error family
# ---------------------------------------------------------------------------


class TestServeErrors:
    def test_unknown_sid_lists_known_streams(self, fa):
        frames = fa["frames"]
        srv = _server(fa["tx"])
        srv.register("cam-a", fps=1.0)
        srv.register("cam-b", fps=1.0)
        with pytest.raises(UnknownStreamError, match="cam-a"):
            srv.enqueue("ghost", frames[0], t=0.0)
        with pytest.raises(UnknownStreamError, match="'ghost'"):
            srv.unregister("ghost")
        with pytest.raises(ValueError):
            srv.enqueue("ghost", frames[0], t=0.0)

    def test_enqueue_validates_shape_and_dtype(self, fa):
        frames, tx = fa["frames"], fa["tx"]
        srv = _server(tx)
        srv.register("a", fps=1.0)
        with pytest.raises(ServeError, match="shape"):
            srv.enqueue("a", frames[0][:-1], t=0.0)
        with pytest.raises(ServeError, match="castable"):
            srv.enqueue("a", np.array([["x"] * tx.det.grid.w]
                                      * tx.det.grid.h), t=0.0)
        assert srv.enqueue("a", frames[0].astype(np.float64), t=0.0) == 0

    def test_reregister_while_draining_is_named_error(self, fa):
        frames = fa["frames"]
        srv = _server(fa["tx"])
        srv.register("a", fps=1.0)
        srv.enqueue("a", frames[0], t=0.0)
        assert srv.unregister("a") == 1
        with pytest.raises(StreamDrainingError, match="draining"):
            srv.register("a", fps=1.0)
        with pytest.raises(StreamDrainingError):
            srv.enqueue("a", frames[1], t=0.5)
        srv.tick(1.0)
        assert "a" not in srv.streams
        srv.register("a", fps=1.0)
        assert "a" in srv.streams

    def test_enqueue_after_drain_completes_is_unknown_stream(self, fa):
        frames = fa["frames"]
        srv = _server(fa["tx"])
        srv.register("a", fps=1.0)
        srv.enqueue("a", frames[0], t=0.0)
        srv.unregister("a")
        srv.tick(1.0)
        with pytest.raises(UnknownStreamError, match="'a'"):
            srv.enqueue("a", frames[1], t=2.0)

    @pytest.mark.parametrize("n_devices", [1, 3])
    def test_kill_guard_rails(self, fa, n_devices):
        srv = _server(fa["tx"], devices=["cpu"] * n_devices)
        with pytest.raises(ServeError, match="out of range"):
            srv.kill_device(99)
        with pytest.raises(ServeError, match="last healthy"):
            for i in range(n_devices):
                srv.kill_device(i)
        assert srv._healthy_idx() == (n_devices - 1,)


# ---------------------------------------------------------------------------
# bounded queues + DRR fair shedding
# ---------------------------------------------------------------------------


class TestFairShedding:
    def test_bounded_queue_sheds_oldest_and_surfaces(self, fa):
        frames = fa["frames"]
        srv = _server(fa["tx"], max_queue_frames=4)
        srv.register("a", fps=1.0)
        for i in range(7):
            srv.enqueue("a", frames[i % len(frames)], t=i * 0.1)
        rep = srv.tick(1.0)
        (shed,) = rep.shed
        assert shed.sid == "a"
        assert shed.seqs == (0, 1, 2)
        assert shed.arrivals == (0.0, pytest.approx(0.1),
                                 pytest.approx(0.2))
        audit = srv.seq_audit()
        assert audit["ok"] and audit["shed"] == 3
        assert audit["enqueued"] == 7
        assert srv.tick(2.0).shed == ()

    def test_shed_order_deterministic(self, fa):
        frames = fa["frames"]

        def run():
            srv = _server(fa["tx"], max_queue_frames=2)
            for sid in ("a", "b"):
                srv.register(sid, fps=1.0)
            for k in range(6):
                for sid in ("a", "b"):
                    srv.enqueue(sid, frames[k % len(frames)], t=float(k))
            return ([(s.sid, s.seqs) for s in srv.tick(1.0).shed],
                    srv.seq_audit())

        (o1, a1), (o2, a2) = run(), run()
        assert o1 == o2 == [("a", (0, 1, 2, 3)), ("b", (0, 1, 2, 3))]
        assert a1 == a2 and a1["ok"]

    def test_drr_starvation_bound_equals_jax(self, fa):
        # 6 continuously-backlogged hot streams, capacity 2: every stream
        # is served once every ceil(6/2) = 3 ticks, on the JAX server's
        # ticks exactly
        frames = fa["frames"]
        pair = motion_pair(frames, fa["base"])
        sids = [f"s{k}" for k in range(6)]

        def run(srv):
            for sid in sids:
                assert srv.register(sid, fps=0.5).admitted
            served_at = {sid: [] for sid in sids}
            reports = []
            for tick in range(9):
                for sid in sids:
                    if len(srv.streams[sid].queue) < 2:
                        srv.enqueue(sid, pair[0], t=float(tick))
                        srv.enqueue(sid, pair[1], t=float(tick) + 0.5)
                rep = srv.tick(float(tick + 1))
                assert rep.n_served == 2 and rep.n_requeued == 4
                for c in rep.completions:
                    served_at[c.sid].append(tick)
                reports.append(rep)
            return served_at, reports

        jsrv = JaxServer(fa["jx"], config=JaxServeConfig(
            chunk=2, capacity=2, tick_s=1.0, max_queue_s=100.0))
        j_at, j_rep = run(jsrv)
        srv = _server(fa["tx"])
        t_at, t_rep = run(srv)
        assert t_at == j_at
        assert reports_differ(j_rep, t_rep) == []
        for sid in sids:
            ticks = t_at[sid]
            assert ticks and ticks[0] <= 2, (sid, ticks)
            assert all(b - a == 3 for a, b in zip(ticks, ticks[1:]))
        assert srv.seq_audit()["ok"]
        assert [s.deficit for s in srv.streams.values()] == \
            [s.deficit for s in jsrv.streams.values()]

    def test_uncontended_fleet_keeps_zero_deficits(self, fa):
        frames = fa["frames"]
        pair = motion_pair(frames, fa["base"])
        srv = _server(fa["tx"], chunk=2, capacity=4)
        for sid in ("a", "b", "c"):
            srv.register(sid, fps=1.0)
        for tick in range(3):
            for sid in ("a", "b", "c"):
                srv.enqueue(sid, pair[0], t=float(tick))
                srv.enqueue(sid, pair[1], t=float(tick))
            rep = srv.tick(float(tick + 1))
            assert [c.sid for c in rep.completions] == ["a", "b", "c"]
        assert all(st.deficit == 0.0 for st in srv.streams.values())


# ---------------------------------------------------------------------------
# the zero-fault pin
# ---------------------------------------------------------------------------


def _feed_two(srv, frames, ticks):
    """Stream "a" at the vj cut (8 bits) and "b" local, two frames each a
    tick; returns the tick reports."""
    dec = srv.register("a", fps=1.0, cut="vj", bits=8)
    assert dec.admitted and dec.cut == "vj", dec
    srv.register("b", fps=1.0)
    reports = []
    for tick in range(ticks):
        for sid in ("a", "b"):
            srv.enqueue(sid, frames[(2 * tick) % 8], t=float(tick))
            srv.enqueue(sid, frames[(2 * tick + 1) % 8],
                        t=float(tick) + 0.5)
        reports.append(srv.tick(float(tick + 1)))
    return reports


def test_inert_spec_is_bit_identical_to_no_chaos(fa):
    frames = fa["frames"]
    plain = _feed_two(_server(fa["tx"], link=ETH_25G_LINK), frames, 4)
    inert = _feed_two(_server(fa["tx"], link=ETH_25G_LINK,
                              chaos=ChaosSpec()), frames, 4)
    assert reports_differ(plain, inert) == []
    for r in inert:
        assert r.shed == () and r.n_failed_tx == 0
        assert r.ladder_moves == () and r.device_events == ()
    jax = _feed_two(JaxServer(fa["jx"], link=JAX_ETH_25G,
                              chaos=JaxChaosSpec(),
                              config=JaxServeConfig(
                                  chunk=2, capacity=2, tick_s=1.0,
                                  max_queue_s=100.0)), frames, 4)
    assert reports_differ(jax, inert) == []


# ---------------------------------------------------------------------------
# fault injection: loss cells equal to the JAX server's
# ---------------------------------------------------------------------------


def _drive_faulty(srv, frames, ticks):
    dec = srv.register("a", fps=1.0, cut="vj", bits=8)
    assert dec.admitted and dec.cut == "vj", dec
    reports = []
    for tick in range(ticks):
        if len(srv.streams["a"].queue) < 2:
            srv.enqueue("a", frames[2 * (tick % 4)], t=float(tick))
            srv.enqueue("a", frames[2 * (tick % 4) + 1],
                        t=float(tick) + 0.5)
        reports.append(srv.tick(float(tick + 1)))
    return reports


@pytest.mark.parametrize("loss,retries,seed,ticks",
                         [("always", 1, 3, 6), ("sometimes", 1, 5, 10),
                          ("sometimes", 0, 7, 10)])
def test_loss_cell_equals_jax(fa, loss, retries, seed, ticks):
    """A faulty stream's chunks transit its seeded injector: every tick
    report — ``n_failed_tx``, ladder moves, bytes on the air, the
    completions — equals the JAX server's."""
    frames = fa["frames"]
    jsrv, tsrv = _both(fa, loss=loss, max_retries=retries, seed=seed,
                       ladder_recover_after=2)
    jrep = _drive_faulty(jsrv, frames, ticks)
    trep = _drive_faulty(tsrv, frames, ticks)
    assert reports_differ(jrep, trep) == []
    assert sum(r.n_failed_tx for r in trep) >= 1
    assert any(r.ladder_moves for r in trep)
    st, jst = tsrv.streams["a"], jsrv.streams["a"]
    assert (st.ladder.level, st.tx_failures, st.ladder.transitions) == \
        (jst.ladder.level, jst.tx_failures, jst.ladder.transitions)
    assert tsrv.seq_audit() == jsrv.seq_audit()
    assert tsrv.seq_audit()["ok"]
    if loss == "always":
        # a perma-dead channel walks the ladder to all-on-node, where the
        # frames complete locally
        assert tuple(st.ladder.rung) == ("on_node", None)
        assert st.rung == (None, None)
        assert sum(c.n_frames for r in trep for c in r.completions) > 0


def test_ladder_descends_then_recovers_with_hysteresis(fa):
    frames = fa["frames"]
    spec = ChaosSpec(loss=SOMETIMES_LOST, max_retries=1, seed=5,
                     ladder_recover_after=2)
    srv = _server(fa["tx"], chaos=spec, link=ETH_25G_LINK)
    dec = srv.register("a", fps=1.0, cut="vj", bits=8)
    assert dec.admitted and dec.cut == "vj", dec
    srv._chaos._injectors["a"] = _ScriptedInjector(["lost"] * 4)
    levels = [0]
    for tick in range(8):
        if len(srv.streams["a"].queue) < 2:
            srv.enqueue("a", frames[2 * (tick % 4)], t=float(tick))
            srv.enqueue("a", frames[2 * (tick % 4) + 1],
                        t=float(tick) + 0.5)
        levels += [new for _sid, _old, new in
                   srv.tick(float(tick + 1)).ladder_moves]
    assert levels == [0, 1, 2, 1, 0]
    assert srv.streams["a"].ladder.level == 0
    assert srv.seq_audit()["ok"]


def test_retx_factor_inflates_admission(fa):
    spec = ChaosSpec(loss=SOMETIMES_LOST, max_retries=2, seed=1)
    d0 = _server(fa["tx"], link=ETH_25G_LINK).register(
        "a", fps=1.0, cut="vj", bits=8)
    d1 = _server(fa["tx"], chaos=spec, link=ETH_25G_LINK).register(
        "a", fps=1.0, cut="vj", bits=8)
    factor = ChaosEngine(spec).retx_factor("a")
    assert factor > 1.0
    assert factor == JaxChaosEngine(JaxChaosSpec(
        loss=JaxGE(**LOSS["sometimes"]), max_retries=2,
        seed=1)).retx_factor("a")
    assert d1.predicted_bps == pytest.approx(d0.predicted_bps * factor)


@pytest.mark.parametrize("seed", [0, 11])
def test_fault_schedule_equals_jax(seed):
    """The same spec gives each sid the JAX engine's fault process:
    faulty selection, fault ids, attempt outcomes and power windows."""
    from repro.camera.offload.link import BrownoutModel as JaxBrownout

    from repro_torch.camera.offload.link import BrownoutModel

    kw = dict(seed=seed, corrupt_fraction=0.2, faulty_fraction=0.5)
    bo = dict(harvest_w=15e-6, storage_j=3e-4, load_w=200e-6)
    eng = ChaosEngine(ChaosSpec(loss=SOMETIMES_LOST,
                                brownout=BrownoutModel(**bo), **kw))
    jeng = JaxChaosEngine(JaxChaosSpec(loss=JaxGE(**LOSS["sometimes"]),
                                       brownout=JaxBrownout(**bo), **kw))
    sids = [f"cam-{k}" for k in range(24)]
    assert [eng.is_faulty(s) for s in sids] == \
        [jeng.is_faulty(s) for s in sids]
    assert 0 < sum(eng.is_faulty(s) for s in sids) < len(sids)
    for sid in sids:
        assert eng.fault_id(sid) == jeng.fault_id(sid)
        if not eng.is_faulty(sid):
            assert eng.injector_for(sid) is None
            continue
        ts = [k * 0.1 for k in range(48)]
        assert [eng.node_powered(sid, t) for t in ts] == \
            [jeng.node_powered(sid, t) for t in ts]
        a, b = eng.injector_for(sid), jeng.injector_for(sid)
        assert [a.attempt(t) for t in ts] == [b.attempt(t) for t in ts]
    assert ChaosEngine(ChaosSpec(device_events=(
        (2, "kill", 1), (2, "restore", 0)))).events_at(2) == \
        [("kill", 1), ("restore", 0)]


def test_spec_validation():
    with pytest.raises(ValueError, match="faulty_fraction"):
        ChaosSpec(faulty_fraction=1.5)
    with pytest.raises(ValueError, match="max_retries"):
        ChaosSpec(max_retries=-1)
    with pytest.raises(ValueError, match="device_events"):
        ChaosSpec(device_events=((1, "melt", 0),))
    with pytest.raises(TypeError):
        ChaosEngine("not a spec")


# ---------------------------------------------------------------------------
# failover over a device list
# ---------------------------------------------------------------------------


def test_kill_resharding_is_bit_identical(fa):
    """8 local streams over 8 listed devices (one shard each); killing
    the last four before tick 1 re-shards onto four, restoring them at
    tick 3 re-shards back: every completion equals the healthy run's."""
    frames = fa["frames"]

    def run(spec):
        srv = _server(fa["tx"], chunk=2, capacity=8, chaos=spec,
                      devices=["cpu"] * 8)
        for k in range(8):
            assert srv.register(f"s{k}", fps=0.5).admitted
        srv.prewarm([(None, None)], device_counts=(4,))
        reports = []
        for tick in range(4):
            for k in range(8):
                srv.enqueue(f"s{k}", frames[2 * (tick % 4)], t=float(tick))
                srv.enqueue(f"s{k}", frames[2 * (tick % 4) + 1],
                            t=float(tick) + 0.5)
            reports.append(srv.tick(float(tick + 1)))
        return srv, reports

    healthy, hr = run(None)
    spec = ChaosSpec(device_events=tuple(
        [(1, "kill", d) for d in (7, 6, 5, 4)]
        + [(3, "restore", d) for d in (7, 6, 5, 4)]))
    degraded, dr = run(spec)
    assert dr[1].device_events == (("kill", 7), ("kill", 6), ("kill", 5),
                                   ("kill", 4))
    assert dr[3].device_events[0][0] == "restore"
    for rh, rd in zip(hr, dr):
        assert rh.n_served == rd.n_served and rh.n_quiet == rd.n_quiet
    assert sum(r.n_served for r in hr) >= 8
    assert reports_differ(
        hr, [dataclasses.replace(r, device_events=()) for r in dr]) == []
    keys = set(degraded._group_steps)
    assert ((None, None), None) in keys
    assert ((None, None), (0, 1, 2, 3)) in keys
    # the local step shards over 8, then over the 4 survivors
    steps = fa["tx"]._batch_steps
    assert (8, 2, ("cpu",) * 8) in steps and (8, 2, ("cpu",) * 4) in steps
    assert degraded.seq_audit()["ok"]


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------


def _feed(srv, pair, tick):
    for sid in ("a", "b", "c"):
        if sid in srv.streams and not srv.streams[sid].draining:
            srv.enqueue(sid, pair[0], t=float(tick))
            srv.enqueue(sid, pair[1], t=float(tick) + 0.5)


def _fleet(srv):
    dec = srv.register("a", fps=1.0, cut="vj", bits=8)
    assert dec.admitted and dec.cut == "vj", dec
    srv.register("b", fps=1.0)
    srv.register("c", fps=1.0)


def _state(srv):
    return {sid: (st.seq_next, st.delivered_n, st.last_served_seq,
                  st.shed_n, st.deficit, st.order, st.draining,
                  [e[2] for e in st.queue])
            for sid, st in srv.streams.items()}


def test_checkpoint_roundtrip_resumes_bit_identical(fa, tmp_path):
    pair = motion_pair(fa["frames"], fa["base"])
    srv = _server(fa["tx"], max_queue_frames=4, link=ETH_25G_LINK)
    _fleet(srv)
    for tick in range(3):
        _feed(srv, pair, tick)
        srv.tick(float(tick + 1))
    srv.enqueue("c", pair[0], t=3.0)        # mid-drain state survives
    srv.unregister("c")
    path = srv.checkpoint(str(tmp_path))
    assert path.endswith(f"step_{srv.tick_count:08d}")
    rest = StreamingServer.restore(str(tmp_path), fa["tx"], config=srv.cfg,
                                   link=ETH_25G_LINK)
    assert rest.seq_audit() == srv.seq_audit()
    assert rest.tick_count == srv.tick_count
    assert rest.streams["c"].draining
    assert _state(rest) == _state(srv)
    ro, rr = [], []
    for tick in range(3, 6):
        _feed(srv, pair, tick)
        _feed(rest, pair, tick)
        ro.append(srv.tick(float(tick + 1)))
        rr.append(rest.tick(float(tick + 1)))
    assert reports_differ(ro, rr) == []
    assert srv.seq_audit() == rest.seq_audit()
    assert rest.seq_audit()["ok"]


def test_jax_checkpoint_restores_in_port(fa, tmp_path):
    """A checkpoint the JAX server wrote restores in the port's server;
    both continue with equal tick reports and audits."""
    pair = motion_pair(fa["frames"], fa["base"])
    cfg = dict(chunk=2, capacity=2, tick_s=1.0, max_queue_s=100.0,
               max_queue_frames=4)
    jsrv = JaxServer(fa["jx"], link=JAX_ETH_25G,
                     config=JaxServeConfig(**cfg))
    _fleet(jsrv)
    for tick in range(3):
        _feed(jsrv, pair, tick)
        jsrv.tick(float(tick + 1))
    jsrv.enqueue("c", pair[0], t=3.0)
    jsrv.unregister("c")
    jsrv.checkpoint(str(tmp_path))
    rest = StreamingServer.restore(str(tmp_path), fa["tx"],
                                   config=ServeConfig(**cfg),
                                   link=ETH_25G_LINK)
    assert rest.seq_audit() == jsrv.seq_audit()
    assert _state(rest) == _state(jsrv)
    jr, tr = [], []
    for tick in range(3, 6):
        _feed(jsrv, pair, tick)
        _feed(rest, pair, tick)
        jr.append(jsrv.tick(float(tick + 1)))
        tr.append(rest.tick(float(tick + 1)))
    assert reports_differ(jr, tr) == []
    assert rest.seq_audit() == jsrv.seq_audit()
    assert rest.seq_audit()["ok"]
    # and the other way: the port's checkpoint restores in the JAX server
    rest.checkpoint(str(tmp_path / "port"))
    back = JaxServer.restore(str(tmp_path / "port"), fa["jx"],
                             config=JaxServeConfig(**cfg), link=JAX_ETH_25G)
    assert back.seq_audit() == rest.seq_audit()


def test_restore_preserves_ladder_and_chaos_state(fa, tmp_path):
    frames = fa["frames"]
    spec = ChaosSpec(loss=ALWAYS_LOST, max_retries=0, seed=9)
    srv = _server(fa["tx"], chaos=spec, link=ETH_25G_LINK)
    dec = srv.register("a", fps=1.0, cut="vj", bits=8)
    assert dec.admitted and dec.cut == "vj", dec
    for tick in range(3):
        if len(srv.streams["a"].queue) < 2:
            srv.enqueue("a", frames[0], t=float(tick))
            srv.enqueue("a", frames[1], t=float(tick) + 0.5)
        srv.tick(float(tick + 1))
    lad = srv.streams["a"].ladder
    assert lad.level > 0
    srv.checkpoint(str(tmp_path))
    rest = StreamingServer.restore(str(tmp_path), fa["tx"], config=srv.cfg,
                                   chaos=spec)
    rl = rest.streams["a"].ladder
    assert (rl.level, rl.rungs, rl.transitions) == \
        (lad.level, lad.rungs, lad.transitions)
    assert rest.seq_audit() == srv.seq_audit()
    assert rest.seq_audit()["ok"]


def test_restore_errors_are_named(fa, tmp_path):
    from repro_torch.ckpt.checkpoint import save_checkpoint

    with pytest.raises(ServeError, match="no complete checkpoint"):
        StreamingServer.restore(str(tmp_path), fa["tx"])
    save_checkpoint(str(tmp_path), 0, {"w": np.zeros(3)},
                    extra={"version": 99})
    with pytest.raises(ServeError, match="version"):
        StreamingServer.restore(str(tmp_path), fa["tx"])
