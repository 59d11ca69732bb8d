"""Export the §III face-auth reference for the PyTorch port.

Builds ``benchmarks/fa_hotpath.py``'s full-width workload with the JAX
package (the 10x33 Table-I cascade trained by ``workloads.fa_cascade`` and
the 400-8-1 NN from ``train_face_nn(steps=1500)``), runs the calibrated JAX
``FaceAuthExecutor`` on ``security_video()`` and writes
``src/repro_torch/assets/fa_reference.npz``: the trained parameters, the
scan parameters, the calibrated capacities and the executor's outputs.
Frames are not stored; ``repro_torch.camera.synthetic.security_video``
regenerates them array-equal from the same seed.

The port cannot train yet and must not import JAX, so this file is how
its main path gets real weights and a reference to be held against.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_fa_reference.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets", "fa_reference.npz")

# the security_video() call of fa_hotpath._workload: its defaults
VIDEO = dict(n_frames=62, h=144, w=176, motion_frames=12,
             faces_in_motion=0.66, seed=1)


def main(out: str = OUT):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    # JAX 0.5 made the partitionable threefry layout the default, which
    # changes the random batches train_face_nn draws.  The legacy layout
    # trains the NN that BENCH_fa_hotpath.json's counts were measured with
    # (108 auths); the new default trains one that authenticates 39.
    jax.config.update("jax_threefry_partitionable", False)
    from benchmarks.fa_hotpath import _workload
    from repro.camera.pipelines import FaceAuthExecutor
    from repro.camera.synthetic import security_video

    frames, casc, nn, scan = _workload()
    check, _ = security_video(**VIDEO)
    if not np.array_equal(frames, check):
        raise RuntimeError("VIDEO no longer matches fa_hotpath._workload")
    ex = FaceAuthExecutor(casc, nn, frames.shape[1], frames.shape[2], **scan)
    fcap, wcap, caps = ex.calibrate(frames)
    res = ex(frames)
    np.savez_compressed(
        out,
        feats=np.array([(f.kind, f.y, f.x, f.h, f.w) for f in casc.feats],
                       np.int32),
        thresholds=np.asarray(casc.thresholds),
        polarity=np.asarray(casc.polarity),
        alphas=np.asarray(casc.alphas),
        stage_sizes=np.array(casc.stage_sizes),
        stage_thresholds=np.asarray(casc.stage_thresholds),
        w1=np.asarray(nn.w1), b1=np.asarray(nn.b1),
        w2=np.asarray(nn.w2), b2=np.asarray(nn.b2),
        scan=np.array([scan["scale_factor"], scan["step"],
                       float(scan["adaptive"])]),
        video=np.array([VIDEO[k] for k in ("n_frames", "h", "w",
                                           "motion_frames", "seed")]),
        video_faces_in_motion=np.float64(VIDEO["faces_in_motion"]),
        frame_capacity=np.int64(fcap), window_capacity=np.int64(wcap),
        cascade_capacities=np.array(caps, np.int64),
        motion=np.asarray(res.motion), n_windows=np.asarray(res.n_windows),
        n_auth=np.asarray(res.n_auth), window_id=np.asarray(res.window_id),
        window_valid=np.asarray(res.window_valid),
        scores=np.asarray(res.scores),
        total_dropped=np.int64(res.total_dropped()))
    print(f"wrote {out}: {int(np.asarray(res.motion).sum())} motion, "
          f"{int(np.asarray(res.n_windows).sum())} windows, "
          f"{int(np.asarray(res.n_auth).sum())} auth, capacities "
          f"f={fcap} w={wcap} vj={caps}, {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
