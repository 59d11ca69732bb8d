"""Export the §IV VR rig reference for the PyTorch port.

Runs the JAX ``VRRigExecutor`` and ``VROffloadExecutor`` on the CPU
(``use_pallas=False``, no ``rig_parallel``) with the rig's parameters
(``GridSpec(sigma_spatial=16)``, ``max_disp=32``, ``n_iters=8``,
``ipd_px=6.0``: ``VRWorkloadStats`` and ``benchmarks/vr_depth_hotpath.py``)
on 8 pairs ``stereo_pair(h, w, seed=s)``, s = 0..7, at two sizes, and
writes ``src/repro_torch/assets/vr_reference.npz``:

* working size, 8 pairs of 270x480: every pair's rough disparity (uint8)
  and its rounding error E (below), pair 0's depth, the left panorama at
  stride 4, and the ``VROffloadExecutor`` wire bytes at every cut x bits;
* full width, 8 pairs of 2160x3840: every pair's rough-disparity
  histogram; pair 0's rough disparity and E on four 256x256 crops
  (top-left, centre, bottom-left, bottom-right); pair 0's depth at stride
  16 and the left panorama at stride 32 (stride 16 would take the file
  past 1.5 MB: float32 texture samples do not compress); the wire bytes at
  every cut x bits, read from the JAX executor's rig half jitted for its
  ``wire_b`` alone (at the working size also equal to a full ``encode``'s);
  and the sha256 of the capture cut's packed bytes and scales at 16, 8
  and 4 bits.

E is the rounding error of the JAX cost volume: the largest
|SAD32 - SAD64| over the region's pixels and all 33 hypotheses, where
SAD32 is the JAX cost volume (the computation of ``bssa.rough_disparity``,
checked to give its winners) and SAD64 the float64 sum of the same
float32 pixel differences.  A port winner that differs from JAX's is a
near tie when |SAD64(d_port) - SAD64(d_jax)| <= 2 max(E_port, E_jax).

The port's tests and ``chip_smoke.py`` read the file; nothing imports JAX
at run time.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_vr_reference.py
"""

from __future__ import annotations

import functools
import hashlib
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets", "vr_reference.npz")

N_PAIRS = 8
FULL_H, FULL_W = 2160, 3840            # VR_H, VR_W
WORK_H, WORK_W = 270, 480              # benchmarks/vr_depth_hotpath.py:38
SIGMA = 16
MAX_DISP = 32
N_ITERS = 8
IPD_PX = 6.0
PATCH = 5
CHUNK = 8                              # bssa.rough_disparity's default
CROP = 256
CUTS = ("capture", "depth", "stitch")
BITS = (None, 16, 8, 4)
HASH_BITS = (16, 8, 4)
WORK_PANO_STRIDE = 4
FULL_STRIDE = 16
FULL_PANO_STRIDE = 32


def crop_origins(h: int, w: int):
    """Top-left, centre, bottom-left and bottom-right CROP x CROP crops."""
    return np.array([[0, 0], [h // 2 - CROP // 2, w // 2 - CROP // 2],
                     [h - CROP, 0], [h - CROP, w - CROP]])


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()
                          ).hexdigest()


def rig(h, w):
    from repro.camera.synthetic import stereo_pair

    pairs = [stereo_pair(h=h, w=w, seed=s)[:2] for s in range(N_PAIRS)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def jax_cost_volume(left, right, max_disp: int = MAX_DISP):
    """(h, w) x2 -> (max_disp + 1, h, w) f32: the SADs of
    ``bssa.rough_disparity``, chunk by chunk as it computes them (same
    shifts, pads and integrals)."""
    import jax
    import jax.numpy as jnp

    from repro.camera.integral import frame_integral

    h, w = left.shape
    pad = PATCH // 2

    @jax.jit
    def sad_chunk(left, right, ds):
        xs = jnp.clip(jnp.arange(w)[None, :] - ds[:, None], 0, w - 1)
        rstack = jnp.moveaxis(right[:, xs], 1, 0)
        diff = jnp.abs(left[None] - rstack)
        dp = jnp.pad(diff, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
        ii = frame_integral(dp)
        sad = (ii[:, PATCH:, PATCH:] - ii[:, :-PATCH, PATCH:]
               - ii[:, PATCH:, :-PATCH] + ii[:, :-PATCH, :-PATCH])
        return sad[:, :h, :w]

    chunk = min(CHUNK, max_disp + 1)
    out = np.empty((max_disp + 1, h, w), np.float32)
    for c in range(-(-(max_disp + 1) // chunk)):
        ds = np.minimum(c * chunk + np.arange(chunk), max_disp)
        sad = np.asarray(sad_chunk(left, right, jnp.asarray(ds)))
        for k, d in enumerate(ds):
            out[d] = sad[k]
    return out


def sad64(left, right, y0, x0, hh, ww, max_disp: int = MAX_DISP):
    """(max_disp + 1, hh, ww) float64 SADs at rows y0.., columns x0..,
    summing the float32 differences directly with edge replication."""
    h, w = left.shape
    pad = PATCH // 2
    ys = np.clip(np.arange(y0 - pad, y0 + hh + pad), 0, h - 1)
    xs = np.clip(np.arange(x0 - pad, x0 + ww + pad), 0, w - 1)
    out = np.empty((max_disp + 1, hh, ww))
    for d in range(max_disp + 1):
        xr = np.clip(xs - d, 0, w - 1)
        diff = np.abs(left[np.ix_(ys, xs)] - right[np.ix_(ys, xr)])
        diff = diff.astype(np.float64)
        s = np.zeros((hh, ww))
        for dy in range(PATCH):
            for dx in range(PATCH):
                s += diff[dy:dy + hh, dx:dx + ww]
        out[d] = s
    return out


def rounding_error(left, right, rough):
    """E of the JAX cost volume on a whole pair, after checking that the
    volume's first-minimum winners are ``rough``'s."""
    vol = jax_cost_volume(left, right)
    if not np.array_equal(vol.argmin(axis=0), rough):
        raise RuntimeError("the JAX cost volume does not give "
                           "rough_disparity's winners")
    return float(np.abs(vol - sad64(left, right, 0, 0, *left.shape)).max())


def executor_wire_b(base, cut, bits, lefts, rights):
    """``VROffloadExecutor``'s wire bytes (executors.py:346-368), read from
    its rig half: ``_node_fn``'s ``wire_b`` output jitted alone, so that
    XLA drops the depth, stitch and codec work it does not depend on."""
    import jax

    from repro.camera.offload import VROffloadExecutor

    off = VROffloadExecutor(base, cut, bits=bits)
    return np.float32(jax.jit(lambda l, r: off._node_fn(l, r)[1])(lefts,
                                                                     rights))


def main(out: str = OUT):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from repro.camera.bssa import GridSpec, rough_disparity
    from repro.camera.offload import VROffloadExecutor
    from repro.camera.pipelines import VRRigExecutor

    t0 = time.perf_counter()
    base = VRRigExecutor(GridSpec(sigma_spatial=SIGMA), max_disp=MAX_DISP,
                         n_iters=N_ITERS, ipd_px=IPD_PX, use_pallas=False,
                         rig_parallel=False)
    rough_fn = jax.jit(jax.vmap(functools.partial(
        rough_disparity, max_disp=MAX_DISP, use_pallas=False)))
    rec: dict = {}

    # -- working size -------------------------------------------------------
    lefts, rights = rig(WORK_H, WORK_W)
    lj, rj = jnp.asarray(lefts), jnp.asarray(rights)
    rough = np.asarray(rough_fn(lj, rj)).astype(np.uint8)
    rec["work_rough"] = rough
    rec["work_e_jax"] = np.array([
        rounding_error(lefts[p], rights[p], rough[p]) for p in range(N_PAIRS)])
    lp, rp, depths = base(lj, rj)
    rec["work_depth0"] = np.asarray(depths[0])
    rec["work_lpano"] = np.asarray(lp)[::WORK_PANO_STRIDE, ::WORK_PANO_STRIDE]
    wb = np.zeros((len(CUTS), len(BITS)), np.float32)
    for i, cut in enumerate(CUTS):
        for j, bits in enumerate(BITS):
            pay = VROffloadExecutor(base, cut, bits=bits).encode(lj, rj)
            wb[i, j] = np.float32(pay.wire_b)
            want = executor_wire_b(base, cut, bits, lj, rj)
            if wb[i, j] != want:
                raise RuntimeError(f"{cut} {bits}: wire_b {wb[i, j]} != "
                                   f"{want}")
    rec["work_wire_b"] = wb
    print(f"working size: E_jax {rec['work_e_jax']}, pano {lp.shape}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- full width ---------------------------------------------------------
    lefts, rights = rig(FULL_H, FULL_W)
    hist = np.zeros((N_PAIRS, MAX_DISP + 1), np.int64)
    for p in range(N_PAIRS):
        r = np.asarray(rough_fn(jnp.asarray(lefts[p:p + 1]),
                                jnp.asarray(rights[p:p + 1])))[0]
        hist[p] = np.bincount(r.astype(np.int64).reshape(-1),
                              minlength=MAX_DISP + 1)
        if p == 0:
            rough0 = r.astype(np.uint8)
    rec["full_hist"] = hist
    origins = crop_origins(FULL_H, FULL_W)
    vol = jax_cost_volume(lefts[0], rights[0])
    crops, e_jax = [], []
    for y0, x0 in origins:
        c = rough0[y0:y0 + CROP, x0:x0 + CROP]
        v = vol[:, y0:y0 + CROP, x0:x0 + CROP]
        if not np.array_equal(v.argmin(axis=0), c):
            raise RuntimeError("the JAX cost volume does not give "
                               "rough_disparity's winners at full width")
        e_jax.append(float(np.abs(
            v - sad64(lefts[0], rights[0], y0, x0, CROP, CROP)).max()))
        crops.append(c)
    del vol
    rec["full_crop_origins"] = origins
    rec["full_crops"] = np.stack(crops)
    rec["full_e_jax"] = np.array(e_jax)
    print(f"full width: rough + crops, E_jax {e_jax}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    d0 = base.depth_maps(jnp.asarray(lefts[:1]), jnp.asarray(rights[:1]))
    rec["full_depth0"] = np.asarray(d0)[0, ::FULL_STRIDE, ::FULL_STRIDE]
    lj, rj = jnp.asarray(lefts), jnp.asarray(rights)
    # the left panorama does not depend on depth
    lp, _rp = base.panorama(lj, rj, jnp.zeros_like(lj))
    rec["full_lpano"] = np.asarray(lp)[::FULL_PANO_STRIDE,
                                       ::FULL_PANO_STRIDE]
    rec["full_pano_shape"] = np.array(lp.shape)
    rec["full_wire_b"] = np.array(
        [[executor_wire_b(base, cut, bits, lj, rj) for bits in BITS]
         for cut in CUTS], np.float32)
    del lp, _rp
    sha = np.zeros((len(HASH_BITS), 4), "U64")
    for j, bits in enumerate(HASH_BITS):
        pay = VROffloadExecutor(base, "capture", bits=bits).encode(lj, rj)
        if np.float32(pay.wire_b) != rec["full_wire_b"][0, BITS.index(bits)]:
            raise RuntimeError(f"capture {bits}: wire_b {pay.wire_b}")
        for k, name in enumerate(("lefts", "lefts_scales", "rights",
                                  "rights_scales")):
            sha[j, k] = sha256(pay.arrays[name])
        del pay
    rec["full_capture_sha256"] = sha
    print(f"full width done, {time.perf_counter() - t0:.1f} s", flush=True)

    np.savez_compressed(
        out, **rec,
        n_pairs=N_PAIRS, full_hw=np.array([FULL_H, FULL_W]),
        work_hw=np.array([WORK_H, WORK_W]), sigma_spatial=SIGMA,
        max_disp=MAX_DISP, n_iters=N_ITERS, ipd_px=IPD_PX, patch=PATCH,
        seeds=np.arange(N_PAIRS), crop=CROP, cuts=np.array(CUTS),
        bits=np.array([0 if b is None else b for b in BITS]),
        hash_bits=np.array(HASH_BITS), work_pano_stride=WORK_PANO_STRIDE,
        full_stride=FULL_STRIDE, full_pano_stride=FULL_PANO_STRIDE)
    print(f"wrote {out}: {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
