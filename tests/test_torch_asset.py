"""The exported full-width reference (src/repro_torch/assets/fa_reference.npz,
written by benchmarks/torch_export_fa_reference.py) loads through the
bridge, holds the reference's funnel, and the port reproduces it.

The counts are those of the JAX ``FaceAuthExecutor`` with the JAX
installed here: 22 motion frames, 550 windows, 108 auths.
BENCH_fa_hotpath.json, measured with an earlier JAX, records 549 windows
for the same workload: one window of the 10x33 cascade sits within float32
rounding of a stage decision.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    VJ8_CODEC_ERR,
    cost_volume64,
    lm_record_check,
    near_integer_canvas,
    serving_record_check,
    serving_replay,
    serving_videos,
    vj8_codec_error,
)
from test_torch_pipeline import matched_scores

from repro_torch.bridge import (
    ASSET,
    OFFLOAD_ASSET,
    SERVING_ASSET,
    load_fa_reference,
    load_offload_reference,
    load_serving_reference,
)
from repro_torch.camera.offload import FaceAuthOffloadExecutor
from repro_torch.camera.pipelines import (
    FAWorkloadStats,
    FaceAuthExecutor,
    calibrate_fa,
    fa_pipeline,
)
from repro_torch.camera.synthetic import security_video

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

FULL_SCAN = dict(scale_factor=1.25, step=0.025, adaptive=True)


@pytest.fixture(scope="module")
def ref():
    return load_fa_reference(device="cpu")


def test_asset_is_small_and_loads(ref):
    assert os.path.getsize(ASSET) < 1 << 20
    assert ref.scan == FULL_SCAN
    assert ref.video["n_frames"] == 62 and ref.video["seed"] == 1
    assert ref.cascade.stage_sizes == [33, 33, 33]
    assert len(ref.cascade.feats) == 99
    assert tuple(ref.nn.w1.shape) == (400, 8) and tuple(ref.nn.w2.shape) == (8, 1)
    assert ref.nn.w1.device.type == "cpu"


def test_reference_counts(ref):
    o = ref.outputs
    assert int(o["motion"].sum()) == 22
    assert int(o["n_windows"].sum()) == 550
    assert int(o["n_auth"].sum()) == 108
    assert int(o["total_dropped"]) == 0
    assert (ref.frame_capacity, ref.window_capacity) == (28, 192)
    assert ref.cascade_capacities == [25853, 128, 128]
    assert o["scores"].shape == (62, 192) and o["scores"].dtype == np.float32


def test_port_reproduces_the_reference_at_full_width(ref):
    """The port on the CPU runs the same float32 arithmetic as its CUDA
    kernels, so this is what the card must give: the reference's
    capacities and motion frames, at most 2 window flips, bit-equal scores
    on the windows both find."""
    frames, _ = security_video(**ref.video)
    ex = FaceAuthExecutor(ref.cascade, ref.nn, 144, 176, device="cpu",
                          **ref.scan)
    caps = ex.calibrate(frames)
    assert caps == (ref.frame_capacity, ref.window_capacity,
                    ref.cascade_capacities)
    res = ex(frames)
    got = {k: getattr(res, k).numpy() for k in
           ("motion", "n_windows", "n_auth", "window_id", "window_valid",
            "scores")}
    o = ref.outputs
    np.testing.assert_array_equal(got["motion"], o["motion"])
    flips, pairs = matched_scores(o, got)
    assert flips <= 2
    assert abs(int(got["n_auth"].sum()) - int(o["n_auth"].sum())) <= flips
    assert len(pairs) >= int(o["n_windows"].sum()) - flips
    np.testing.assert_array_equal(pairs[:, 0].view(np.int32),
                                  pairs[:, 1].view(np.int32))
    assert res.total_dropped() == 0


# -- the offload reference (assets/offload_reference.npz) ---------------------


def test_offload_asset_is_small_and_consistent(ref):
    off = load_offload_reference()
    assert os.path.getsize(OFFLOAD_ASSET) < 1 << 16
    assert off.nbytes[("sensor", None)] == 62 * 144 * 176 * 4
    for cut in ("sensor", "motion", "vj", "nn"):
        # the raw split is the fused funnel: the fa_reference counts
        assert off.n_windows[(cut, None)] == 550
        assert off.n_auth[(cut, None)] == 108
        assert off.nbytes[(cut, 16)] > off.nbytes[(cut, 8)] > \
            off.nbytes[(cut, 4)]
    assert len(off.packed_sha256) == len(off.scales_sha256) == 6
    assert off.stats == dict(n_frames=62, motion_frames=22,
                             windows_to_nn=550)
    stats = FAWorkloadStats(**off.stats)
    pipe = fa_pipeline(stats)
    for cut, b in off.analytic_bytes.items():
        assert pipe.cut_payload_bytes(pipe.index(cut)) == b
    cal = calibrate_fa(stats)
    assert off.calibration == dict(
        rf_joules_per_byte=cal.rf_joules_per_byte,
        nn_effective_w=cal.nn_effective_w, base_compute_w=cal.base_compute_w)


@pytest.mark.parametrize("cut", ["sensor", "motion"])
def test_port_payloads_match_the_offload_asset(ref, cut):
    """At full width the sensor-cut and motion-cut payloads hash equal to
    the JAX executor's at 16, 8 and 4 bits, and their byte counts match:
    what chip_smoke.py holds the CUDA codec to."""
    off = load_offload_reference()
    ex = FaceAuthExecutor(ref.cascade, ref.nn, 144, 176, device="cpu",
                          capacities=ref.cascade_capacities,
                          frame_capacity=ref.frame_capacity,
                          window_capacity=ref.window_capacity, **ref.scan)
    frames, _ = security_video(**ref.video)
    field = {"sensor": "frames", "motion": "mframes"}[cut]
    for bits in (None, 16, 8, 4):
        payload = FaceAuthOffloadExecutor(ex, cut, bits=bits).encode(frames)
        assert payload.nbytes() == off.nbytes[(cut, bits)], bits
        assert payload.capacity_bytes() == off.capacity_bytes[(cut, bits)]
        if bits is None:
            continue
        for arr, want in ((field, off.packed_sha256),
                          (field + "_scales", off.scales_sha256)):
            got = hashlib.sha256(
                payload.arrays[arr].numpy().tobytes()).hexdigest()
            assert got == want[(cut, bits)], (arr, bits)


# -- the VR reference (assets/vr_reference.npz) -------------------------------


@pytest.fixture(scope="module")
def vr():
    from repro_torch.bridge import load_vr_reference
    return load_vr_reference()


def test_vr_asset_is_small_and_holds_the_rig_parameters(vr):
    from repro_torch.bridge import VR_ASSET
    from repro_torch.camera.pipelines import VR_H, VR_W, VRWorkloadStats

    assert os.path.getsize(VR_ASSET) <= 1.5e6
    stats = VRWorkloadStats()
    p = vr.params
    assert (p["n_pairs"], p["sigma_spatial"], p["max_disp"], p["n_iters"],
            p["ipd_px"], p["patch"]) == (8, stats.grid_sigma,
                                         stats.disp_range,
                                         stats.refine_iters, 6.0, 5)
    assert p["seeds"] == list(range(8))
    assert vr.full_hw == (VR_H, VR_W) and vr.work_hw == (270, 480)
    assert vr.work_rough.shape == (8, 270, 480)
    assert vr.work_rough.max() <= 32 and vr.work_depth0.shape == (270, 480)
    assert vr.full_crops.shape == (4, 256, 256)
    assert (vr.full_hist.sum(axis=1) == VR_H * VR_W).all()
    assert vr.full_pano_shape == (VR_H, 7 * (VR_W - 576) + VR_W)
    assert (vr.full_e_jax > 0).all() and (vr.work_e_jax > 0).all()
    assert len(vr.capture_sha256) == 12


def test_vr_asset_wire_bytes_are_the_port_formula(vr):
    """The asset's wire bytes are what the port's split executor charges:
    views and depths P*h*w values each, the panoramas' own sizes."""
    from repro_torch.kernels.wire_codec.ops import wire_bytes

    for (h, w), table in ((vr.work_hw, vr.work_wire_b),
                          (vr.full_hw, vr.full_wire_b)):
        pano = h * (7 * (w - int(w * 0.15)) + w)
        for bits in (None, 16, 8, 4):
            n = 8 * h * w
            want = {"capture": 2 * wire_bytes(n, bits),
                    "depth": 3 * wire_bytes(n, bits),
                    "stitch": 2 * wire_bytes(pano, bits)}
            for cut, b in want.items():
                assert table[(cut, bits)] == float(np.float32(b)), (cut, bits)


def test_port_matches_vr_asset_at_working_size(vr):
    """What chip_smoke.py holds the card to at the working size, on the
    CPU (the same float32 sums): rough disparity agrees with JAX on >= 99%
    of every pair and every disagreement is a near tie; with JAX's rough of
    pair 0 injected the depth is within 1e-5 of JAX's (XLA's FMA in
    slice_grid); the left panorama within 1e-6 of JAX's except where a
    float32 warp map may pick another pixel."""
    from repro_torch.camera import bssa
    from repro_torch.camera.pipelines import VRRigExecutor
    from repro_torch.camera.synthetic import stereo_pair
    from repro_torch.kernels.bilateral_blur.ops import refine_grid

    h, w = vr.work_hw
    md = vr.params["max_disp"]
    pairs = [stereo_pair(h=h, w=w, seed=s)[:2] for s in vr.params["seeds"]]
    lefts = torch.tensor(np.stack([p[0] for p in pairs]))
    rights = torch.tensor(np.stack([p[1] for p in pairs]))
    ex = VRRigExecutor(bssa.GridSpec(vr.params["sigma_spatial"]),
                       max_disp=md, n_iters=vr.params["n_iters"],
                       ipd_px=vr.params["ipd_px"], device="cpu")
    rough = bssa.rough_disparity(lefts, rights, md).numpy().astype(np.int64)
    for p in range(len(pairs)):
        vol = bssa.cost_volume(lefts[p], rights[p], md).numpy()
        vol64 = cost_volume64(lefts[p], rights[p], md, 5, 0, 0, h,
                              w).numpy()
        want = vr.work_rough[p].astype(np.int64)
        assert (rough[p] == want).mean() >= 0.99
        # E_jax from the asset stands in for the JAX cost volume
        e_jax = vr.work_e_jax[p]
        e_port = np.abs(vol - vol64).max()
        yy, xx = np.mgrid[0:h, 0:w]
        gap = np.abs(vol64[rough[p], yy, xx] - vol64[want, yy, xx])
        assert (gap <= 2 * max(e_port, e_jax)).all()
    spec = ex.spec
    gv, gw = bssa.splat(lefts[0], torch.tensor(vr.work_rough[0],
                                               dtype=torch.float32), spec)
    depth = bssa.slice_grid(*refine_grid(gv, gw, ex.n_iters), lefts[0], spec)
    np.testing.assert_allclose(depth.numpy(), vr.work_depth0, rtol=0,
                               atol=1e-5)
    lp, _rp = ex.panorama(lefts, rights, torch.zeros_like(lefts))
    s = vr.params["work_pano_stride"]
    near = near_integer_canvas(h, w, len(pairs))[::s, ::s]
    diff = np.abs(lp.numpy()[::s, ::s] - vr.work_lpano)
    assert (diff[~near] <= 1e-6).all()


@pytest.fixture(scope="module")
def lm():
    from repro_torch.bridge import load_lm_reference

    return load_lm_reference()


def test_lm_asset_is_small_and_holds_the_records(lm):
    from repro_torch.bridge import LM_ASSET

    assert os.path.getsize(LM_ASSET) < 1 << 20
    assert sorted(lm) == ["rwkv", "yi"]
    yi, rwkv = lm["yi"].cfg, lm["rwkv"].cfg
    assert (yi.name, yi.n_layers, yi.d_model, yi.n_heads, yi.n_kv,
            yi.d_head, yi.d_ff, yi.vocab) == ("yi-9b", 2, 256, 8, 1, 128,
                                              512, 512)
    assert (rwkv.mixer, rwkv.n_layers, rwkv.d_model) == ("rwkv", 3, 128)
    for rec in lm.values():
        assert rec.cfg.param_dtype == torch.float32
        assert rec.prompts.shape == (4, 650) and rec.teacher.shape == (4, 16)
        assert rec.decode_logits.shape == (4, 16, rec.cfg.vocab)
        assert rec.greedy.shape == (4, 16) and 0 < rec.sensitivity < 1e-3


@pytest.mark.parametrize("name", ["yi", "rwkv"])
def test_port_matches_lm_asset(lm, name):
    """What chip_smoke.py holds the card to, on the CPU: prefill and 16
    teacher-forced decode logits within max(1e-4, E) of JAX's, greedy
    tokens equal up to the first near tie."""
    from repro_torch.bridge import lm_params_from, numpy_lm_params

    rec = lm[name]
    model = lm_params_from(numpy_lm_params(rec.cfg, rec.seed), rec.cfg,
                           device="cpu")
    worst, tol, compared = lm_record_check(model, rec)
    assert worst < tol and compared >= 32


# -- the serving reference (assets/serving_reference.npz) ---------------------


@pytest.fixture(scope="module")
def serving():
    return load_serving_reference()


def test_serving_asset_is_small_and_holds_the_fleet(serving):
    assert os.path.getsize(SERVING_ASSET) < 1 << 20
    assert serving.config == dict(chunk=4, capacity=4, tick_s=1.0,
                                  max_queue_s=8.0)
    assert sorted({(c, b) for _s, c, b, _v in serving.streams},
                  key=str) == sorted({(None, None), ("sensor", 8),
                                      ("motion", 8), ("vj", 8)}, key=str)
    assert len(serving.streams) == 8 and serving.ticks == 8
    assert len(serving.script) == 8 * 8 * serving.frames_per_tick
    for run in ("clean", "chaos"):
        reps = serving.reports[run]
        n = sum(len(r["completions"]) for r in reps)
        assert len(serving.results[run]["motion_dropped"]) == n
        assert serving.results[run]["scores"].shape == (4 * n, 192)
        assert serving.audits[run]["ok"]
    chaos = serving.reports["chaos"]
    assert sum(r["n_failed_tx"] for r in chaos) > 0
    assert sum(len(r["ladder_moves"]) for r in chaos) > 0
    assert serving_videos(serving)          # regenerated, sha256 held


@pytest.mark.parametrize("run,ticks", [("clean", 3), ("chaos", 3)])
def test_port_replays_the_serving_record(ref, serving, run, ticks):
    """The record's fleet through the port on the CPU at full width, at a
    reduced depth: what chip_smoke holds the card to.  A few sensor,
    motion and vj chunks hold a window that the port's integral image
    moves across a stage decision against JAX's (ROADMAP queue 3); the
    check holds those by outcome and counts them."""
    frames, _ = security_video(**ref.video)
    ex = FaceAuthExecutor(ref.cascade, ref.nn, 144, 176, device="cpu",
                          **ref.scan)
    ex.calibrate(frames)
    srv, reports = serving_replay(ex, serving, run, serving_videos(serving),
                                  ticks=ticks)
    exact, outcome, flips, vj_diff = serving_record_check(run, serving, run,
                                                          reports)
    assert exact + outcome == sum(len(r.completions) for r in reports)
    assert (outcome, flips, vj_diff) == (1, 1, 0.0)    # sensor-h, third tick
    assert srv.seq_audit()["ok"]


def test_vj8_codec_error_is_the_bound_reading(ref, serving):
    """VJ8_CODEC_ERR, of which serving_record_check makes its bound on
    the vj scores of windows both sides find, is this reading: the 8-bit
    codec's largest score error on the record's videos, chunk by chunk."""
    frames, _ = security_video(**ref.video)
    ex = FaceAuthExecutor(ref.cascade, ref.nn, 144, 176, device="cpu",
                          **ref.scan)
    ex.calibrate(frames)
    err = vj8_codec_error(ex, serving_videos(serving),
                          serving.config["chunk"])
    assert VJ8_CODEC_ERR - 1e-4 < err <= VJ8_CODEC_ERR
