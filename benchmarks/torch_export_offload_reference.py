"""Export the §III offload reference for the PyTorch port.

Builds the same full-width workload as ``torch_export_fa_reference.py``
(``benchmarks/fa_hotpath.py``'s 62 frames of 144x176, FULL_SCAN, the 10x33
cascade and the 400-8-1 NN, with the legacy threefry layout), checks that
the calibrated JAX ``FaceAuthExecutor`` gives the outputs stored in
``src/repro_torch/assets/fa_reference.npz``, then runs the JAX
``FaceAuthOffloadExecutor`` at every cut x bits (None, 16, 8, 4) and
writes ``src/repro_torch/assets/offload_reference.npz``:

* per cut x bits: the payload's ``nbytes()`` and ``capacity_bytes()``, and
  the result's total windows and auths;
* at the sensor and motion cuts, for 16, 8 and 4 bits: the sha256 of the
  codec field's packed bytes and of its scales (hashes only, no payload
  arrays);
* the analytic ``fa_pipeline`` bytes per frame at each cut and the
  ``calibrate_fa`` constants, for the funnel statistics of the fused run.

The port's tests and ``chip_smoke.py`` read it; nothing imports JAX at run
time.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_offload_reference.py
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "offload_reference.npz")
FA_ASSET = os.path.join(REPO, "src", "repro_torch", "assets",
                        "fa_reference.npz")

CUTS = ("sensor", "motion", "vj", "nn")
BITS = (None, 16, 8, 4)
HASH_CUTS = ("sensor", "motion")
HASH_BITS = (16, 8, 4)
CODEC_FIELD = {"sensor": "frames", "motion": "mframes"}


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()
                          ).hexdigest()


def main(out: str = OUT):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    # the NN that fa_reference.npz holds (see torch_export_fa_reference.py)
    jax.config.update("jax_threefry_partitionable", False)
    import jax.numpy as jnp

    from benchmarks.fa_hotpath import _workload
    from repro.camera.offload import FaceAuthOffloadExecutor
    from repro.camera.pipelines import (
        FAWorkloadStats,
        FaceAuthExecutor,
        calibrate_fa,
        fa_pipeline,
    )

    frames, casc, nn, scan = _workload()
    ex = FaceAuthExecutor(casc, nn, frames.shape[1], frames.shape[2], **scan)
    ex.calibrate(frames)
    fj = jnp.asarray(frames)
    res = ex(fj)
    with np.load(FA_ASSET) as fa:
        for k in ("motion", "n_windows", "n_auth", "window_id",
                  "window_valid", "scores"):
            if not np.array_equal(np.asarray(getattr(res, k)), fa[k]):
                raise RuntimeError(f"fused {k} differs from {FA_ASSET}")

    shape = (len(CUTS), len(BITS))
    nbytes, capacity = np.zeros(shape), np.zeros(shape)
    n_windows = np.zeros(shape, np.int64)
    n_auth = np.zeros(shape, np.int64)
    packed_sha = np.zeros((len(HASH_CUTS), len(HASH_BITS)), "U64")
    scales_sha = np.zeros((len(HASH_CUTS), len(HASH_BITS)), "U64")
    for i, cut in enumerate(CUTS):
        for j, bits in enumerate(BITS):
            r, payload = FaceAuthOffloadExecutor(ex, cut, bits=bits)(fj)
            nbytes[i, j] = payload.nbytes()
            capacity[i, j] = payload.capacity_bytes()
            n_windows[i, j] = int(np.asarray(r.n_windows).sum())
            n_auth[i, j] = int(np.asarray(r.n_auth).sum())
            if cut in HASH_CUTS and bits in HASH_BITS:
                a, b = HASH_CUTS.index(cut), HASH_BITS.index(bits)
                field = CODEC_FIELD[cut]
                packed_sha[a, b] = sha256(payload.arrays[field])
                scales_sha[a, b] = sha256(payload.arrays[field + "_scales"])
            print(f"{cut:6s} bits={bits}: {nbytes[i, j]:.3f} B on the wire, "
                  f"{capacity[i, j]:.3f} B padded, {n_windows[i, j]} windows,"
                  f" {n_auth[i, j]} auth", flush=True)

    stats = FAWorkloadStats(
        n_frames=len(frames),
        motion_frames=max(int(np.asarray(res.motion).sum()), 1),
        windows_to_nn=max(int(np.asarray(res.n_windows).sum()), 1))
    pipe = fa_pipeline(stats)
    cal = calibrate_fa(stats)
    np.savez_compressed(
        out,
        cuts=np.array(CUTS), bits=np.array([0 if b is None else b
                                            for b in BITS]),
        nbytes=nbytes, capacity_bytes=capacity, n_windows=n_windows,
        n_auth=n_auth, hash_cuts=np.array(HASH_CUTS),
        hash_bits=np.array(HASH_BITS), packed_sha256=packed_sha,
        scales_sha256=scales_sha,
        stats=np.array([stats.n_frames, stats.motion_frames,
                        stats.windows_to_nn]),
        analytic_bytes=np.array([pipe.cut_payload_bytes(pipe.index(c))
                                 for c in CUTS]),
        calibration=np.array([cal.rf_joules_per_byte, cal.nn_effective_w,
                              cal.base_compute_w]))
    print(f"wrote {out}: {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
