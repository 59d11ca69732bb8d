"""The port's Viola-Jones front-end against the JAX package's.

Geometry and tables are plain numpy on both sides and must be equal.
Detections come from float32 integral images summed in different orders
(sequential rows-then-columns in the port, XLA's cumsum in the reference),
so they are held by the reference's own borderline rule
(tests/test_detect.py:91): any window found by one side only must be
fp-ambiguous, and there may be at most 2 of them.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.camera import viola_jones as jvj
from repro.camera.synthetic import security_video

from repro_torch.bridge import cascade_from, load_fa_reference
from repro_torch.camera import viola_jones as tvj

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

SCAN = dict(scale_factor=1.4, step=4.0, adaptive=False)   # coarse: fast
FULL_SCAN = dict(scale_factor=1.25, step=0.025, adaptive=True)


def borderline(cascade, frame, pos, tol=1e-4):
    """The reference's rule: some stump response or stage score of the
    window within ``tol`` of its threshold (JAX golden-oracle features)."""
    y, x, win = pos
    patch = jnp.asarray(frame[y:y + win, x:x + win][None])
    F = np.asarray(jvj.eval_features_scaled(patch, win, cascade.feats))[0]
    if np.min(np.abs(F - cascade.thresholds)) < tol:
        return True
    pred = cascade.polarity * np.sign(F - cascade.thresholds)
    pred[pred == 0] = 1.0
    weighted = cascade.alphas * pred
    off = 0
    for si, size in enumerate(cascade.stage_sizes):
        score = weighted[off:off + size].sum()
        if abs(score - cascade.stage_thresholds[si]) < tol:
            return True
        if score < cascade.stage_thresholds[si]:
            break
        off += size
    return False


def jax_cascade(c):
    """The JAX package's Cascade with the same parameters."""
    return jvj.Cascade(
        feats=[jvj.HaarFeature(f.kind, f.y, f.x, f.h, f.w) for f in c.feats],
        thresholds=np.asarray(c.thresholds), polarity=np.asarray(c.polarity),
        alphas=np.asarray(c.alphas), stage_sizes=list(c.stage_sizes),
        stage_thresholds=np.asarray(c.stage_thresholds))


@pytest.fixture(scope="module")
def cascades():
    port = load_fa_reference(device="cpu").cascade
    return port, jax_cascade(port)


@pytest.fixture(scope="module")
def video():
    frames, _ = security_video(n_frames=6, motion_frames=4, seed=1)
    return frames


class TestGeometry:
    def test_feature_pool_and_scaling(self):
        pool_j = jvj.make_feature_pool(seed=2, n=80)
        pool_t = tvj.make_feature_pool(seed=2, n=80)
        assert [tuple(vars(f).values()) for f in pool_j] == [
            tuple(vars(f).values()) for f in pool_t]
        for fj, ft in zip(pool_j, pool_t):
            for win in (20, 25, 31, 49, 95, 119):
                gj, gt = jvj.scale_feature(fj, win), tvj.scale_feature(ft, win)
                assert tuple(vars(gj).values()) == tuple(vars(gt).values())
                assert jvj.feature_corners(gj) == tvj.feature_corners(gt)

    @pytest.mark.parametrize("scan", [SCAN, FULL_SCAN], ids=["coarse", "full"])
    def test_scan_grid_and_gather_tables_equal(self, cascades, scan):
        port, ref = cascades
        gj = jvj.build_scan_grid(144, 176, **scan)
        gt = tvj.build_scan_grid(144, 176, **scan)
        assert gj.positions == gt.positions and gj.scales == gt.scales
        np.testing.assert_array_equal(gj.bases, gt.bases)
        np.testing.assert_array_equal(gj.scale_id, gt.scale_id)
        tj = jvj.build_gather_tables(ref, gj)
        tt = tvj.build_gather_tables(port, gt)
        for name in ("offsets", "weights", "norm_offsets", "areas",
                     "thresholds", "polarity", "alphas", "stage_thresholds"):
            a, b = getattr(tj, name), getattr(tt, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert tj.stage_sizes == tt.stage_sizes
        if scan is FULL_SCAN:
            assert len(gt.positions) == 25853 and len(gt.scales) == 9

    def test_extract_windows_equal(self, video):
        pos = tvj.scan_positions(144, 176, **SCAN)[::37]
        np.testing.assert_array_equal(jvj.extract_windows(video[1], pos),
                                      tvj.extract_windows(video[1], pos))


class TestFusedDetector:
    def test_detections_and_capacities_match_jax(self, cascades, video):
        port, ref = cascades
        h, w = video.shape[1:]
        dj = jvj.FusedDetector(ref, h, w, **SCAN)
        dt = tvj.FusedDetector(port, h, w, device="cpu", **SCAN)
        assert dj.calibrate(video[:2]) == dt.calibrate(video[:2])
        dets_j, stats_j = dj.detect(video)
        dets_t, stats_t = dt.detect(video)
        for key in ("n_windows", "n_invocations", "static_stage_evals",
                    "dropped", "capacities"):
            assert stats_j[key] == stats_t[key], key
        n_diff = 0
        for i in range(len(video)):
            diff = set(dets_j[i]) ^ set(dets_t[i])
            for pos in diff:
                assert borderline(ref, video[i], pos), (
                    f"frame {i}: non-borderline mismatch at {pos}")
            n_diff += len(diff)
        assert n_diff <= 2
        assert sum(map(len, dets_t)) > 0

    def test_full_scan_detections_match_jax(self, cascades, video):
        """The paper's scan (25,853 windows, 9 scales) on two frames."""
        port, ref = cascades
        frames = video[1:3]
        dj = jvj.FusedDetector(ref, 144, 176, **FULL_SCAN)
        dt = tvj.FusedDetector(port, 144, 176, device="cpu", **FULL_SCAN)
        dets_j, _ = dj.detect(frames)
        dets_t, stats = dt.detect(frames)
        assert stats["dropped"] == 0
        n_diff = sum(len(set(a) ^ set(b)) for a, b in zip(dets_j, dets_t))
        assert n_diff <= 2

    def test_capacity_overflow_drops_are_counted(self, cascades, video):
        port, ref = cascades
        h, w = video.shape[1:]
        n = len(tvj.build_scan_grid(h, w, **SCAN).positions)
        tight = [n] + [1] * (len(port.stage_sizes) - 1)
        mj, sj, dj = (np.asarray(a) for a in jvj.FusedDetector(
            ref, h, w, capacities=tight, **SCAN)(video[:3]))
        mt, st, dt = (a.numpy() for a in tvj.FusedDetector(
            port, h, w, capacities=tight, device="cpu", **SCAN)(video[:3]))
        np.testing.assert_array_equal(sj, st)
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(mj, mt)

    def test_detect_faces_batch(self, cascades, video):
        port, _ref = cascades
        dets, stats = tvj.detect_faces_batch(port, video[:3], device="cpu",
                                             **SCAN)
        det = tvj.FusedDetector(port, 144, 176, device="cpu", **SCAN)
        det.calibrate(video[:3])
        assert stats["capacities"] == det.capacities
        assert dets == det.detect(video[:3])[0]
        empty, st = tvj.detect_faces_batch(port, video[:0], device="cpu")
        assert empty == [] and st["n_windows"] == 0

    def test_cascade_bridge_takes_reference_objects(self, cascades):
        port, ref = cascades
        again = cascade_from(ref)
        assert again.feats == port.feats
        assert again.stage_sizes == port.stage_sizes
        np.testing.assert_array_equal(again.alphas, port.alphas)

    def test_f32_exact_base_guard(self, cascades):
        port, _ = cascades
        with pytest.raises(ValueError, match="f32-exact"):
            tvj.FusedDetector(port, 4096, 4096, device="cpu")
