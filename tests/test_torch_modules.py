"""The port's camera and core modules (integral image, motion gate,
cascades, face NN, quantizer) against the JAX package's, on the same
numpy inputs."""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.camera import face_nn as jnn
from repro.camera import integral as jint
from repro.camera import motion as jmo
from repro.camera.synthetic import security_video
from repro.core import cascade as jcc
from repro.core.reduction import quantize_bits as jax_quantize_bits

from repro_torch.camera import face_nn as tnn
from repro_torch.camera import integral as tint
from repro_torch.camera import motion as tmo
from repro_torch.core import cascade as tcc
from repro_torch.core.reduction import quantize_bits

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestIntegral:
    def test_integral_and_window_sum(self):
        img = np.random.default_rng(0).random((2, 30, 41), dtype=np.float32)
        want = np.asarray(jint.integral_image(jnp.asarray(img)))
        got = tint.integral_image(_t(img))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-3)
        np.testing.assert_allclose(tint.frame_integral(_t(img)).numpy(),
                                   want, rtol=2e-5, atol=2e-3)
        ys, xs = np.array([0, 3, 10]), np.array([1, 7, 20])
        np.testing.assert_allclose(
            tint.window_sum(got, _t(ys), _t(xs), 12, 9).numpy(),
            np.asarray(jint.window_sum(jnp.asarray(want), ys, xs, 12, 9)),
            rtol=2e-5, atol=2e-3)

    def test_streaming_rows_equal_integral(self):
        img = np.random.default_rng(1).random((3, 17, 23), dtype=np.float32)
        want = np.asarray(jint.streaming_integral_rows(jnp.asarray(img)))
        got = tint.streaming_integral_rows(_t(img)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)


class TestMotion:
    @pytest.mark.parametrize("factor", [4, 8])
    def test_motion_mask_equal(self, factor):
        frames, _ = security_video(n_frames=16, motion_frames=6, seed=5)
        mj, sj = jmo.motion_mask(jnp.asarray(frames), 0.004, factor)
        mt, st = tmo.motion_mask(frames, 0.004, factor, device="cpu")
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
        np.testing.assert_allclose(
            tmo.downsample(_t(frames), factor).numpy(),
            np.asarray(jmo.downsample(jnp.asarray(frames), factor)),
            rtol=1e-5, atol=1e-6)


def _stages(lib, thresholds):
    if lib is jcc:
        return [jcc.Stage(lambda it, i=i: it[:, i], thr)
                for i, thr in enumerate(thresholds)]
    return [tcc.Stage(lambda it, i=i: it[..., i], thr)
            for i, thr in enumerate(thresholds)]


class TestCascade:
    @pytest.mark.parametrize("caps", [None, (1000, 512, 256, 256),
                                      (1000, 300, 20, 20)])
    def test_matches_jax(self, caps):
        """Compaction keeps original order (stable) and drops and counts
        overflow exactly as the reference."""
        items = np.random.default_rng(2).random((1000, 4), dtype=np.float32)
        thr = [0.3, 0.5, 0.2, 0.6]
        if caps is None:
            rj = jcc.masked_cascade(_stages(jcc, thr), jnp.asarray(items))
            rt = tcc.masked_cascade(_stages(tcc, thr), _t(items[None]))
        else:
            rj = jcc.compacting_cascade(_stages(jcc, thr), jnp.asarray(items),
                                        list(caps))
            rt = tcc.compacting_cascade(_stages(tcc, thr), _t(items[None]),
                                        list(caps))
        for name in ("mask", "scores", "n_survivors", "dropped"):
            np.testing.assert_array_equal(getattr(rt, name)[0].numpy(),
                                          np.asarray(getattr(rj, name)),
                                          err_msg=name)

    def test_rows_are_independent_cascades(self):
        items = np.random.default_rng(3).random((3, 200, 2), dtype=np.float32)
        thr, caps = [0.4, 0.7], [200, 64]
        rt = tcc.compacting_cascade(_stages(tcc, thr), _t(items), caps)
        for r in range(3):
            rj = jcc.compacting_cascade(_stages(jcc, thr),
                                        jnp.asarray(items[r]), caps)
            np.testing.assert_array_equal(rt.mask[r].numpy(),
                                          np.asarray(rj.mask))
            np.testing.assert_array_equal(rt.n_survivors[r].numpy(),
                                          np.asarray(rj.n_survivors))

    def test_capacity_argument_checks(self):
        st = _stages(tcc, [0.5])
        with pytest.raises(ValueError):
            tcc.compacting_cascade(st, torch.zeros(1, 10), [10, 5])
        with pytest.raises(ValueError):
            tcc.compacting_cascade(st, torch.zeros(1, 10), [5])

    def test_accounting_helpers_equal(self):
        assert tcc.capacities_from_counts(10000, [900, 40, 7]) == \
            jcc.capacities_from_counts(10000, [900, 40, 7])
        assert tcc.capacities_from_counts(25853, [41, 3], 2.0, 128) == \
            jcc.capacities_from_counts(25853, [41, 3], 2.0, 128)
        assert tcc.compaction_work([330, 330], 1000, [1000, 128]) == \
            jcc.compaction_work([330, 330], 1000, [1000, 128])
        assert tcc.compaction_work([1.0], 5) == jcc.compaction_work([1.0], 5)
        assert math.isclose(
            tcc.cascade_flops([10, 20, 30], [0.5, 0.1, 1.0], [1.0, 0.3, 0.1]),
            jcc.cascade_flops([10, 20, 30], [0.5, 0.1, 1.0], [1.0, 0.3, 0.1]))


class TestFaceNN:
    @pytest.fixture(scope="class")
    def nets(self):
        nn = jnn.init_face_nn(jax.random.PRNGKey(4))
        port = tnn.FaceNN(*(torch.from_numpy(np.array(a)) for a in
                            (nn.w1, nn.b1, nn.w2, nn.b2)))
        x = np.random.default_rng(4).random((300, 400), dtype=np.float32)
        return nn, port, x

    def test_lut_equal(self):
        lut_j, meta_j = jnn.make_sigmoid_lut(entries=128, lo=-6.0, hi=6.0)
        lut_t, meta_t = tnn.make_sigmoid_lut(entries=128, lo=-6.0, hi=6.0,
                                             device="cpu")
        np.testing.assert_array_equal(lut_t.numpy(), np.asarray(lut_j))
        assert meta_t == meta_j
        x = np.linspace(-10, 10, 5001, dtype=np.float32)
        lut_j, meta = jnn.make_sigmoid_lut()
        lut_t, _ = tnn.make_sigmoid_lut(device="cpu")
        np.testing.assert_array_equal(
            tnn.sigmoid_lut(_t(x), lut_t, meta).numpy(),
            np.asarray(jnn.sigmoid_lut(jnp.asarray(x), lut_j, meta)))

    def test_forward_paths_close(self, nets):
        """Float matmuls sum in another order than XLA's; after the LUT a
        rare score may step one LUT entry (~0.016 apart at the steepest)."""
        nn, port, x = nets
        lut_j, meta = jnn.make_sigmoid_lut()
        lut_t, _ = tnn.make_sigmoid_lut(device="cpu")
        xj, xt = jnp.asarray(x), _t(x)
        np.testing.assert_allclose(tnn.forward_float(port, xt).numpy(),
                                   np.asarray(jnn.forward_float(nn, xj)),
                                   atol=1e-5)
        for fj, ft in ((jnn.forward_lut(nn, xj, lut_j, meta),
                        tnn.forward_lut(port, xt, lut_t, meta)),
                       (jnn.forward_quantized(nn, xj, 8, lut_j, meta),
                        tnn.forward_quantized(port, xt, 8, lut_t, meta))):
            diff = np.abs(ft.numpy() - np.asarray(fj))
            assert diff.max() <= 0.02 and np.mean(diff == 0) > 0.95

    def test_quantize_bits_matches_jitted(self):
        x = np.random.default_rng(6).normal(size=(7, 300)).astype(np.float32)
        for bits in (16, 8, 4):
            f = jax.jit(lambda a, b=bits: jax_quantize_bits(a, b, block=128))
            np.testing.assert_array_equal(
                quantize_bits(_t(x), bits, block=128).numpy(),
                np.asarray(f(jnp.asarray(x))))
