"""Export the streaming-serving reference for the PyTorch port.

Builds the full-width §III workload of ``torch_export_fa_reference.py``
(``benchmarks/fa_hotpath.py``'s 62 frames of 144x176, FULL_SCAN, the 10x33
cascade and the 400-8-1 NN, with the legacy threefry layout), checks that
the calibrated JAX ``FaceAuthExecutor`` gives the outputs stored in
``src/repro_torch/assets/fa_reference.npz``, then drives the JAX
``StreamingServer`` over a small fleet and writes
``src/repro_torch/assets/serving_reference.npz``:

* the fleet: 8 streams, two each at local, sensor-8, motion-8 and vj-8,
  one of each pair on a quiet video and one on a hot video of
  ``benchmarks/serving.py``'s pools at full width (quiet: 32 frames, 1
  motion frame, seeds 11-14; hot: 24 frames, 20 motion frames, seeds
  31-32); ``ServeConfig(chunk=4, capacity=4)``, the 25 GbE link, every
  stream fed 4 frames a tick for 8 ticks;
* the same fleet again under a Gilbert-Elliott ``ChaosSpec``;
* per run, every tick report (wall times aside) and every completion's
  fields and result arrays.

The enqueue script, the fleet, the config and the chaos spec are stored
beside the record, with each video's sha256, so the port replays the same
drive from the record alone.  The port's tests and ``chip_smoke.py`` read
it; nothing imports JAX at run time.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_serving_reference.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "serving_reference.npz")
FA_ASSET = os.path.join(REPO, "src", "repro_torch", "assets",
                        "fa_reference.npz")

H, W = 144, 176
# benchmarks/serving.py's video pools, at the full WISPCam frame
QUIET = [dict(n_frames=32, h=H, w=W, motion_frames=1, seed=11 + k)
         for k in range(4)]
HOT = [dict(n_frames=24, h=H, w=W, motion_frames=20, seed=31 + k)
       for k in range(2)]
KINDS = ((None, None), ("sensor", 8), ("motion", 8), ("vj", 8))
CONFIG = dict(chunk=4, capacity=4, tick_s=1.0, max_queue_s=8.0)
TICKS = 8
FRAMES_PER_TICK = 4
CHAOS = dict(loss=dict(p_gb=0.3, p_bg=0.3, loss_bad=0.9, loss_good=0.0),
             max_retries=1, seed=20)
FIELDS = ("motion", "n_windows", "n_auth", "scores", "window_id",
          "window_valid", "auth", "windows_dropped", "motion_dropped",
          "cascade_dropped")


def fleet():
    """[(sid, cut, bits, video index)]: the videos are QUIET + HOT."""
    out = []
    for j, (cut, bits) in enumerate(KINDS):
        name = cut or "local"
        out.append((f"{name}-q", cut, bits, j))
        out.append((f"{name}-h", cut, bits, len(QUIET) + j % len(HOT)))
    return out


def script(videos) -> list:
    """[(tick, stream index, video index, frame index, t)]: every stream
    fed FRAMES_PER_TICK frames a tick, phase-shifted into its video."""
    rows = []
    for tick in range(TICKS):
        for k, (_sid, _cut, _bits, v) in enumerate(fleet()):
            n = len(videos[v])
            for j in range(FRAMES_PER_TICK):
                rows.append((tick, k, v, (7 * k + FRAMES_PER_TICK * tick + j)
                             % n, tick + j / FRAMES_PER_TICK))
    return rows


def report_row(rep) -> dict:
    """A ``TickReport`` as JSON, the wall clock (``batch_s``) aside."""
    return dict(
        t=rep.t, n_ready=rep.n_ready, n_served=rep.n_served,
        n_quiet=rep.n_quiet, n_requeued=rep.n_requeued,
        bytes_sent=rep.bytes_sent, resolves_fired=rep.resolves_fired,
        cut_changes=[list(c) for c in rep.cut_changes],
        shed=[[s.sid, list(s.seqs), list(s.arrivals)] for s in rep.shed],
        n_failed_tx=rep.n_failed_tx,
        ladder_moves=[list(m) for m in rep.ladder_moves],
        device_events=[list(e) for e in rep.device_events],
        completions=[dict(sid=c.sid, t=c.t, n_frames=c.n_frames,
                          kind=c.kind, wire_bytes=c.wire_bytes,
                          seqs=list(c.seqs)) for c in rep.completions])


def main(out: str = OUT):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    # the NN that fa_reference.npz holds (see torch_export_fa_reference.py)
    jax.config.update("jax_threefry_partitionable", False)
    import jax.numpy as jnp

    from benchmarks.fa_hotpath import _workload
    from repro.camera.offload.link import ETH_25G_LINK, GilbertElliott
    from repro.camera.pipelines import FaceAuthExecutor
    from repro.camera.serve import ChaosSpec, ServeConfig, StreamingServer
    from repro.camera.synthetic import security_video

    frames, casc, nn, scan = _workload(False)
    ex = FaceAuthExecutor(casc, nn, frames.shape[1], frames.shape[2], **scan)
    ex.calibrate(frames)
    res = ex(jnp.asarray(frames))
    with np.load(FA_ASSET) as fa:
        for k in ("motion", "n_windows", "n_auth", "window_id",
                  "window_valid", "scores"):
            if not np.array_equal(np.asarray(getattr(res, k)), fa[k]):
                raise RuntimeError(f"fused {k} differs from {FA_ASSET}")

    videos = [security_video(**p)[0] for p in QUIET + HOT]
    rows = script(videos)
    streams = fleet()
    record = {}
    for run in ("clean", "chaos"):
        chaos = None
        if run == "chaos":
            chaos = ChaosSpec(loss=GilbertElliott(**CHAOS["loss"]),
                              max_retries=CHAOS["max_retries"],
                              seed=CHAOS["seed"])
        srv = StreamingServer(ex, link=ETH_25G_LINK, chaos=chaos,
                              config=ServeConfig(**CONFIG))
        for sid, cut, bits, _v in streams:
            dec = srv.register(sid, fps=float(FRAMES_PER_TICK), cut=cut,
                               bits=bits)
            if not (dec.admitted and dec.cut == cut):
                raise RuntimeError(f"{run}: {sid} not admitted at {cut}")
        reports = []
        for tick in range(TICKS):
            for tk, k, v, i, t in rows:
                if tk == tick:
                    srv.enqueue(streams[k][0], videos[v][i], t=t)
            reports.append(srv.tick(float(tick + 1)))
        comps = [c for r in reports for c in r.completions]
        record[f"{run}_reports"] = np.array(json.dumps(
            [report_row(r) for r in reports]))
        for f in FIELDS:
            parts = [np.asarray(c.result[f]) for c in comps]
            record[f"{run}_{f}"] = (np.stack(parts) if parts[0].ndim == 0
                                    else np.concatenate(parts))
        audit = srv.seq_audit()
        record[f"{run}_audit"] = np.array(json.dumps(audit))
        print(f"{run}: {len(comps)} completions, "
              f"{sum(r.n_served for r in reports)} served, "
              f"{sum(r.n_quiet for r in reports)} quiet, "
              f"{sum(r.n_failed_tx for r in reports)} failed tx, "
              f"{sum(len(r.ladder_moves) for r in reports)} ladder moves, "
              f"{sum(int(c.result['n_windows'].sum()) for c in comps)} "
              f"windows, audit ok {audit['ok']}", flush=True)
        if not audit["ok"]:
            raise RuntimeError(f"{run}: seq_audit failed")

    meta = dict(
        config=CONFIG, ticks=TICKS, frames_per_tick=FRAMES_PER_TICK,
        link="eth_25g", chaos=CHAOS, videos=QUIET + HOT,
        video_sha256=[hashlib.sha256(v.tobytes()).hexdigest()
                      for v in videos],
        streams=[list(s) for s in streams])
    np.savez_compressed(
        out, meta=np.array(json.dumps(meta)),
        script=np.array([r[:4] for r in rows], np.int32),
        script_t=np.array([r[4] for r in rows], np.float64), **record)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
