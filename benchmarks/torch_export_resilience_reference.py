"""Export the offload resilience reference for the PyTorch port.

Builds the full-width §III workload of ``torch_export_offload_reference.py``
(``benchmarks/fa_hotpath.py``'s 62 frames of 144x176, FULL_SCAN, the 10x33
cascade and the 400-8-1 NN, with the legacy threefry layout), checks that
the calibrated JAX ``FaceAuthExecutor`` gives the outputs stored in
``src/repro_torch/assets/fa_reference.npz``, then runs the JAX
``OffloadSession`` with the seeds and injector parameters of
``benchmarks/offload_resilience.py`` (``_SEED = 4321``) and writes
``src/repro_torch/assets/resilience_reference.npz``:

* the zero-fault payload CRC (``payload_checksum``) at every cut x bits
  (None, 16, 8, 4);
* every ``DeliveryRecord`` of: the determinism cell (Gilbert-Elliott
  0.2 / 0.4, corrupt fraction 0.3, 20 sends); the 12 sweep cells (loss
  0.02-0.2 x outage duty 0-0.2, 40 sends) over the nn-cut ladder (nn at
  16, 8, 4 bits, then on-node); two cells of the same ladder over the
  motion cut (loss 0.2 x duty 0 and 0.2); and the brownout run
  (``BrownoutModel(15e-6, 13e-6, 200e-6, 0.2)``, nn cut, 8 bits, 10 sends,
  with its stage counters);
* each ladder cell's flipped-auth fraction, retransmit overhead, energy
  ratio against its fault-free ladder, delivery fraction and final rung;
* the congestion fleet's p99 latencies, clean and with one faulty stream.

Each cell's injector parameters are stored beside its records, so the
port rebuilds the same fault process from the record alone.  The port's
tests and ``chip_smoke.py`` read it; nothing imports JAX at run time.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_resilience_reference.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "resilience_reference.npz")
FA_ASSET = os.path.join(REPO, "src", "repro_torch", "assets",
                        "fa_reference.npz")

SEED = 4321                      # benchmarks/offload_resilience.py:_SEED
N_SENDS = 40
CUTS = ("sensor", "motion", "vj", "nn")
BITS = (None, 16, 8, 4)
RECORD_CUTS = CUTS + ("on_node",)
LOSSES = (0.02, 0.05, 0.1, 0.2)
DUTIES = (0.0, 0.1, 0.2)


def cell_params() -> dict:
    """Every ladder cell: its injector's arguments, its ladder's cut and
    its number of sends, as ``benchmarks/offload_resilience.py`` draws
    them (mean burst ~2.2 attempts, p_bg 0.45, per-cell seed)."""
    cells = {"determinism": dict(p_gb=0.2, p_bg=0.4, corrupt_fraction=0.3,
                                 outage_period_s=None, outage_duty=0.0,
                                 seed=SEED, cut="nn", sends=N_SENDS // 2)}
    for cut, losses, duties in (("nn", LOSSES, DUTIES),
                                ("motion", (0.2,), (0.0, 0.2))):
        for loss in losses:
            p_bg = 0.45
            p_gb = loss * p_bg / (1.0 - loss)
            for duty in duties:
                tag = f"loss{int(loss * 100):02d}_duty{int(duty * 100):02d}"
                name = tag if cut == "nn" else f"motion_{tag}"
                cells[name] = dict(
                    p_gb=p_gb, p_bg=p_bg, corrupt_fraction=0.0,
                    outage_period_s=60.0 if duty else None, outage_duty=duty,
                    seed=SEED + int(loss * 1000) + int(duty * 10), cut=cut,
                    sends=N_SENDS)
    return cells


def record_row(rec) -> list:
    """A ``DeliveryRecord`` as float64s, exactly: the cut by its index in
    RECORD_CUTS, bits None as 0, booleans as 0 / 1."""
    t = dataclasses.astuple(rec)
    return [float(t[0]), float(RECORD_CUTS.index(t[1])),
            float(0 if t[2] is None else t[2])] + [float(v) for v in t[3:]]


def main(out: str = OUT, smoke: bool = False):
    """``smoke``: the toy workload of ``fa_hotpath._workload(smoke=True)``
    (10 frames, the smoke cascade), not held to ``fa_reference.npz``; a
    record to rehearse its readers on the CPU."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    # the NN that fa_reference.npz holds (see torch_export_fa_reference.py)
    jax.config.update("jax_threefry_partitionable", False)
    import jax.numpy as jnp

    from benchmarks.fa_hotpath import _workload
    from repro.camera.offload import (
        BACKSCATTER,
        ON_NODE,
        BrownoutModel,
        DegradationLadder,
        FaceAuthOffloadExecutor,
        FaultInjector,
        GilbertElliott,
        OffloadSession,
        fleet_link_report,
        payload_checksum,
    )
    from repro.camera.pipelines import FaceAuthExecutor

    frames, casc, nn, scan = _workload(smoke)
    ex = FaceAuthExecutor(casc, nn, frames.shape[1], frames.shape[2], **scan)
    ex.calibrate(frames)
    fj = jnp.asarray(frames)
    res = ex(fj)
    with np.load(FA_ASSET) as fa:
        for k in ("motion", "n_windows", "n_auth", "window_id",
                  "window_valid", "scores"):
            if not smoke and not np.array_equal(np.asarray(getattr(res, k)),
                                                fa[k]):
                raise RuntimeError(f"fused {k} differs from {FA_ASSET}")

    offs = {}

    def make(cut, bits):
        if (cut, bits) not in offs:
            offs[(cut, bits)] = FaceAuthOffloadExecutor(ex, cut, bits=bits)
        return offs[(cut, bits)]

    rec: dict = {}
    crc = np.zeros((len(CUTS), len(BITS)), np.int64)
    for i, cut in enumerate(CUTS):
        for j, bits in enumerate(BITS):
            _got, r = OffloadSession(make(cut, bits)).send(fj)
            crc[i, j] = payload_checksum(make(cut, bits).encode(fj))
            if not (r.delivered and r.attempts == 1):
                raise RuntimeError(f"zero-fault {cut} {bits} not delivered")
            print(f"zero-fault {cut:6s} bits={bits}: crc {crc[i, j]:#010x}, "
                  f"{r.payload_bytes} B", flush=True)

    def run(cell, injector):
        rungs = [(cell["cut"], b) for b in (16, 8, 4)] + [ON_NODE]
        sess = OffloadSession(
            make_executor=make, cut=cell["cut"], bits=16, link=BACKSCATTER,
            injector=injector, ladder=DegradationLadder(rungs),
            on_node_fn=lambda f: ex(f))
        auths = []
        for _ in range(cell["sends"]):
            got, _r = sess.send(fj)
            auths.append(None if got is None else np.asarray(got.auth))
        return sess, auths

    cells = cell_params()
    base = {cut: run(dict(cut=cut, sends=N_SENDS), None)
            for cut in ("nn", "motion")}
    metrics = {}
    for name, cell in cells.items():
        inj = FaultInjector(
            loss=GilbertElliott(p_gb=cell["p_gb"], p_bg=cell["p_bg"]),
            outage_period_s=cell["outage_period_s"],
            outage_duty=cell["outage_duty"],
            corrupt_fraction=cell["corrupt_fraction"], seed=cell["seed"])
        sess, auths = run(cell, inj)
        base_sess, base_auth = base[cell["cut"]]
        flips = [float(np.mean(a != b))
                 for a, b in zip(auths, base_auth) if a is not None]
        retx = sum(r.attempts - 1 for r in sess.records)
        att = sum(r.attempts for r in sess.records)
        metrics[name] = dict(
            flip=float(np.mean(flips)) if flips else 1.0,
            retx_overhead=retx / max(att - retx, 1),
            energy_ratio=sess.energy_j / base_sess.energy_j,
            delivered=float(np.mean([a is not None for a in auths])),
            final_rung=list(sess.ladder.rung))
        rec[f"records_{name}"] = np.array(
            [record_row(r) for r in sess.records])
        print(f"{name}: {metrics[name]}", flush=True)

    bo = BrownoutModel(harvest_w=15e-6, storage_j=13e-6, load_w=200e-6,
                       jitter=0.2)
    want, _ = make("nn", 8)(fj)
    with tempfile.TemporaryDirectory() as td:
        bsess = OffloadSession(make("nn", 8), link=BACKSCATTER,
                               injector=FaultInjector(brownout=bo, seed=SEED),
                               ckpt_dir=td, stage_cost_s=0.02)
        for _ in range(10):
            got, _r = bsess.send(fj)
            if not np.array_equal(np.asarray(got.scores),
                                  np.asarray(want.scores)):
                raise RuntimeError("brownout resume differs from the split "
                                   "executor")
    rec["records_brownout"] = np.array([record_row(r)
                                        for r in bsess.records])
    brownout = dict(stage_started=bsess.stage_started,
                    stage_completed=bsess.stage_completed,
                    params=dict(harvest_w=15e-6, storage_j=13e-6,
                                load_w=200e-6, jitter=0.2, seed=SEED,
                                cut="nn", bits=8, sends=10,
                                stage_cost_s=0.02))
    print(f"brownout: {sum(r.brownouts for r in bsess.records)} brownouts, "
          f"{brownout}", flush=True)

    def fleet(faulty):
        sessions = []
        for s in range(3):
            inj = (FaultInjector(loss=GilbertElliott(p_gb=0.5, p_bg=0.3),
                                 seed=SEED + s) if faulty and s == 0
                   else None)
            fs = OffloadSession(make("nn", 8), link=BACKSCATTER, injector=inj)
            for _ in range(12):
                fs.send(fj)
            sessions.append(fs)
        return fleet_link_report(sessions, BACKSCATTER, frame_period_s=1.0,
                                 stagger=False)

    clean, cong = fleet(False), fleet(True)
    congestion = dict(p99_clean_s=clean.p99_latency_s,
                      p99_congested_s=cong.p99_latency_s,
                      bytes_overhead=cong.bytes_total / clean.bytes_total,
                      sends=12, seed=SEED)
    print(f"congestion: {congestion}", flush=True)

    np.savez_compressed(
        out, crc_cuts=np.array(CUTS),
        crc_bits=np.array([0 if b is None else b for b in BITS]), crc=crc,
        record_cuts=np.array(RECORD_CUTS),
        cells=np.array(json.dumps(cells)),
        metrics=np.array(json.dumps(metrics)),
        brownout=np.array(json.dumps(brownout)),
        congestion=np.array(json.dumps(congestion)), **rec)
    print(f"wrote {out}: {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
