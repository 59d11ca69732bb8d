"""The port's kernel modules against the JAX package's.

Each plain PyTorch version (what a CPU tensor runs, and what the CUDA
kernel is held against on the card) is compared with the JAX ``ref`` and
with the JAX Pallas kernel in interpret mode, on the same numpy inputs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.camera.face_nn import make_sigmoid_lut as jax_lut
from repro.kernels.haar_frontend.kernel import haar_stage_scores_pallas
from repro.kernels.haar_frontend.ref import haar_stage_scores_ref
from repro.kernels.integral_image.ops import integral_image as jax_integral
from repro.kernels.integral_image.ref import integral_ref
from repro.kernels.quant_matmul import ops as jops
from repro.kernels.quant_matmul.ref import quant_matmul_ref as jax_qmm_ref

from repro_torch.kernels import _build
from repro_torch.kernels.haar_frontend.ops import haar_stage_scores
from repro_torch.kernels.haar_frontend.ref import haar_stage_ref
from repro_torch.kernels.integral_image.ops import integral_image
from repro_torch.kernels.integral_image.ref import integral_image_ref
from repro_torch.kernels.quant_matmul import ops as tops
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _seq_integral(img):
    """numpy float32: sequential row prefix, then sequential column prefix."""
    out = np.array(img, np.float32)
    for j in range(1, out.shape[-1]):
        out[..., j] = out[..., j] + out[..., j - 1]
    for i in range(1, out.shape[-2]):
        out[..., i, :] = out[..., i, :] + out[..., i - 1, :]
    return np.pad(out, [(0, 0), (1, 0), (1, 0)])


class TestIntegralImage:
    @pytest.mark.parametrize("shape", [(1, 32, 64), (3, 144, 176),
                                       (2, 37, 53)])
    def test_matches_jax_ref_and_pallas(self, shape):
        """Same tolerance the JAX package holds its own Pallas kernel to
        (tests/test_kernels.py:94): the three sum float32 values in
        different orders (sequential rows-then-columns here; XLA's
        cumsum; the Pallas kernel's blocked carry)."""
        img = np.random.default_rng(0).random(shape, dtype=np.float32)
        got = integral_image(_t(img)).numpy()
        assert got.shape == (shape[0], shape[1] + 1, shape[2] + 1)
        np.testing.assert_array_equal(got[:, 0], 0)
        np.testing.assert_array_equal(got[:, :, 0], 0)
        want = np.asarray(integral_ref(jnp.asarray(img)))
        np.testing.assert_allclose(got[:, 1:, 1:], want, rtol=2e-5, atol=2e-3)
        pallas = np.asarray(jax_integral(jnp.asarray(img), interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-3)

    def test_plain_version_is_the_kernels_association(self):
        """Bit-equal to sequential float32 sums, rows then columns — the
        order csrc/integral_image.cu sums in."""
        img = np.random.default_rng(1).random((2, 40, 56), dtype=np.float32)
        np.testing.assert_array_equal(integral_image_ref(_t(img)).numpy(),
                                      _seq_integral(img))

    def test_leading_dims_and_cpu_routing(self):
        img = np.random.default_rng(2).random((2, 3, 9, 11), dtype=np.float32)
        before = dict(_build.launches)
        got = integral_image(_t(img))
        assert dict(_build.launches) == before       # no kernel on the CPU
        assert got.device.type == "cpu" and got.shape == (2, 3, 10, 12)
        np.testing.assert_array_equal(
            got.reshape(6, 10, 12).numpy(), _seq_integral(img.reshape(6, 9, 11)))


def _random_stage(seed, rows, cap, n_scales, sz, K=8, L=500):
    rng = np.random.default_rng(seed)
    return dict(
        ii=rng.random((rows, L), dtype=np.float32),
        base=rng.integers(0, L // 2, (rows, cap)).astype(np.int32),
        sid=rng.integers(0, n_scales, (rows, cap)).astype(np.int32),
        inv=rng.random((rows, cap), dtype=np.float32),
        offsets=rng.integers(0, L // 2, (n_scales, sz, K)).astype(np.int32),
        weights=rng.normal(size=(sz, K)).astype(np.float32),
        thresholds=rng.normal(size=sz).astype(np.float32),
        polarity=np.where(rng.random(sz) < 0.5, -1.0, 1.0).astype(np.float32),
        alphas=rng.random(sz, dtype=np.float32))


def _items(s):
    return np.stack([s["base"].astype(np.float32),
                     s["sid"].astype(np.float32), s["inv"]], axis=-1)


def _clear_of_thresholds(s, row, tol=1e-4):
    """Windows whose every stump response is more than ``tol`` from its
    threshold (float64 responses)."""
    off = s["offsets"][s["sid"][row]]                        # (cap, sz, K)
    vals = s["ii"][row][s["base"][row][:, None, None] + off]
    resp = (vals.astype(np.float64) * s["weights"]).sum(-1) \
        * s["inv"][row][:, None]
    return np.abs(resp - s["thresholds"]).min(-1) > tol


def _jax_stage(s, row, pallas):
    kw = dict(ii_flat=jnp.asarray(s["ii"][row]),
              base=jnp.asarray(s["base"][row]),
              sid=jnp.asarray(s["sid"][row]),
              inv_norm=jnp.asarray(s["inv"][row]),
              offsets=jnp.asarray(s["offsets"]),
              weights=jnp.asarray(s["weights"]),
              thresholds=jnp.asarray(s["thresholds"]),
              polarity=jnp.asarray(s["polarity"]),
              alphas=jnp.asarray(s["alphas"]))
    if pallas:
        return np.asarray(haar_stage_scores_pallas(**kw, block_n=128,
                                                   interpret=True))
    return np.asarray(haar_stage_scores_ref(**kw))


class TestHaarStage:
    @pytest.mark.parametrize("rows,cap,n_scales,sz", [
        (2, 64, 1, 8), (3, 37, 3, 5), (2, 200, 4, 20), (1, 130, 9, 33)])
    def test_matches_jax_ref_and_pallas(self, rows, cap, n_scales, sz):
        """Scores equal on every window whose responses are clear of every
        stump threshold by 1e-4, up to the order of the stage sum: the port
        adds the sz votes in stump order, XLA in an order of its own, so
        the two may differ by float32 rounding of a sz-term sum (a flipped
        vote would move the score by 2 * alpha, far more)."""
        s = _random_stage(rows * cap + sz, rows, cap, n_scales, sz)
        got = haar_stage_scores(
            _t(s["ii"]), _t(_items(s)), _t(s["offsets"]), _t(s["weights"]),
            _t(s["thresholds"]), _t(s["polarity"]), _t(s["alphas"])).numpy()
        assert got.shape == (rows, cap)
        atol = sz * np.finfo(np.float32).eps * float(s["alphas"].sum())
        checked = 0
        for row in range(rows):
            clear = _clear_of_thresholds(s, row)
            for pallas in (False, True):
                want = _jax_stage(s, row, pallas)
                np.testing.assert_allclose(got[row][clear], want[clear],
                                           rtol=0, atol=atol)
            checked += int(clear.sum())
        assert checked >= 0.9 * rows * cap

    def test_dead_slots_clamp_in_bounds(self):
        """Item bases and scale ids outside the table are clamped in float
        before the int cast, and every tap index into [0, L-1]."""
        s = _random_stage(5, 1, 16, 2, 4, L=64)
        items = _items(s)
        items[0, :4, 0] = [-5.0, 1e9, np.nan, 63.9]
        items[0, 4:8, 1] = [-1.0, 7.0, 1e9, 1.5]
        got = haar_stage_ref(_t(s["ii"]), _t(items), _t(s["offsets"]),
                             _t(s["weights"]), _t(s["thresholds"]),
                             _t(s["polarity"]), _t(s["alphas"]))
        assert got.shape == (1, 16)
        clamped = items.copy()
        clamped[0, :4, 0] = [0.0, 63.0, 0.0, 63.0]
        clamped[0, 4:8, 1] = [0.0, 1.0, 1.0, 1.0]
        want = haar_stage_ref(_t(s["ii"]), _t(clamped), _t(s["offsets"]),
                              _t(s["weights"]), _t(s["thresholds"]),
                              _t(s["polarity"]), _t(s["alphas"]))
        torch.testing.assert_close(got, want, rtol=0, atol=0)


    def test_nan_pixel_poisons_exactly_its_windows(self):
        """A NaN pixel makes its frame's integral image NaN below and right
        of it; a window's score is NaN exactly when one of its taps reads
        such an entry, a zero-weight tap included (ii * 0 is NaN), in the
        port's plain version and in the JAX reference alike."""
        h, w = 40, 50
        L = (h + 1) * (w + 1)
        rng = np.random.default_rng(11)
        img = rng.random((h, w), dtype=np.float32)
        img[23, 31] = np.nan
        ii = np.zeros((h + 1, w + 1), np.float32)
        ii[1:, 1:] = np.cumsum(np.cumsum(img, 0, dtype=np.float32), 1,
                               dtype=np.float32)
        ii = ii.reshape(1, L)
        s = _random_stage(12, 1, 300, 3, 6, L=L)
        s["ii"] = ii
        s["base"] = rng.integers(0, L - (12 * (w + 1) + 12), (1, 300)) \
            .astype(np.int32)
        # slots 6 and 7 weigh 0 and reach farther than the others
        reach = np.array([0] * 6 + [7] * 2)
        s["offsets"] = ((rng.integers(0, 6, (3, 6, 8)) + reach) * (w + 1)
                        + rng.integers(0, 6, (3, 6, 8)) + reach
                        ).astype(np.int32)
        s["weights"][:, 6:] = 0.0
        idx = s["base"][0][:, None, None] + s["offsets"][s["sid"][0]]
        nan_tap = np.isnan(ii[0][idx])                       # (cap, sz, 8)
        want = nan_tap.any(axis=(1, 2))
        only_zero_weight = nan_tap[..., 6:].any((1, 2)) \
            & ~nan_tap[..., :6].any((1, 2))
        assert want.any() and (~want).any() and only_zero_weight.any()
        got = haar_stage_ref(_t(ii), _t(_items(s)), _t(s["offsets"]),
                             _t(s["weights"]), _t(s["thresholds"]),
                             _t(s["polarity"]), _t(s["alphas"])).numpy()
        np.testing.assert_array_equal(np.isnan(got[0]), want)
        jax_scores = _jax_stage(s, 0, pallas=False)
        np.testing.assert_array_equal(np.isnan(jax_scores), want)

    @pytest.mark.parametrize("h,w,table_path", [
        (144, 176, True),      # the paper's scan: stage 0 takes the table
        (240, 320, False),     # a QVGA frame's table: the global path
    ])
    def test_table_path_fits_shared_memory(self, h, w, table_path):
        """The table path's shared memory, by the arithmetic of
        csrc/haar_stage.cu's ``table_half`` and ``table_layout`` at 9
        scales and 33 stumps: the de-interleaved halves hold the frame's
        table and start 16 banks apart, every region is 16-byte aligned,
        and the whole fits a block's 227 KB, with the 1 KB each block
        reserves, as many times a SM as ``__launch_bounds__`` claims,
        exactly where the table path is meant to run."""
        k = _cu_constants("haar_stage.cu")
        L = (h + 1) * (w + 1)
        half, lay = _cu_table_layout(L, 9, 33)
        assert half % 32 == 16 and 2 * half >= L + 1
        assert all(v % 16 == 0 for v in lay.values())
        fits = lay["bytes"] <= 227 * 1024
        assert fits == table_path
        if table_path:
            blocks = k["table_blocks_per_sm"]
            assert blocks * (lay["bytes"] + 1024) <= 228 * 1024
            assert (blocks + 1) * (lay["bytes"] + 1024) > 228 * 1024
            assert blocks * k["kTableThreads"] <= 2048
            assert k["kTableMinCap"] <= 25_853    # stage 0's 25,853 slots


def _cu_source(name):
    import pathlib

    return (pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "csrc" / name).read_text()


def _cu_table_layout(L, n_scales, sz):
    """``table_half(L)`` and the byte offsets of ``table_layout`` in
    csrc/haar_stage.cu, evaluated from the source's own expressions (C's
    int division of non-negative ints is Python's ``//``)."""
    import re

    text = _cu_source("haar_stage.cu")
    k = _cu_constants("haar_stage.cu")

    def ev(expr, env):
        expr = expr.replace("static_cast<int>(sizeof(Taps))",
                            str(4 * k["kSlots"]))
        expr = expr.replace("table_half(L)", "half").replace("l.", "")
        return eval(expr.replace("/", "//"), {}, env)

    half_expr = re.search(r"int table_half\(int L\) \{\s*return (.+?);",
                          text, re.S)[1]
    env = {"L": L, "n_scales": n_scales, "sz": sz}
    env["half"] = ev(half_expr, env)
    body = re.search(r"Layout table_layout\(int L, int n_scales, int sz\) "
                     r"\{(.+?)return l;", text, re.S)[1]
    lay = {}
    for name, expr in re.findall(r"l\.(\w+) = (.+?);", body, re.S):
        lay[name] = env[name] = ev(" ".join(expr.split()), env)
    assert set(lay) == {"taps", "weights", "params", "range", "table",
                        "bytes"}
    return env["half"], lay


def _cu_constants(name):
    """The ``constexpr int`` constants of a source in src/repro_torch/csrc,
    and the blocks a SM of the table path's ``__launch_bounds__``."""
    import re

    text = _cu_source(name)
    out = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}
    bounds = re.search(r"__launch_bounds__\(kTableThreads, (\d+)\)", text)
    if bounds:
        out["table_blocks_per_sm"] = int(bounds[1])
    return out


# ---------------------------------------------------------------------------
# int8 GEMM and the quantized NN
# ---------------------------------------------------------------------------


def _qmm_inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (m, k)).astype(np.int8),
            rng.integers(-127, 128, (k, n)).astype(np.int8),
            rng.normal(size=n).astype(np.float32))


class TestQuantMatmul:
    @pytest.mark.parametrize("m,k,n,apply_lut,scale", [
        (512, 400, 8, True, (1 / 127, 0.0123)),     # layer 1
        (512, 8, 1, True, (1 / 127, 0.0451)),       # layer 2
        (256, 256, 256, False, (0.01, 0.02)),
    ])
    def test_static_bit_exact(self, m, k, n, apply_lut, scale):
        x_q, w_q, bias = _qmm_inputs(m + k + n, m, k, n)
        lut, meta = jax_lut()
        sx, sw = scale
        got = tops.quant_matmul_static(
            _t(x_q), _t(w_q), _t(lut), scale_x=sx, scale_w=sw,
            bias=_t(bias), meta=meta, apply_lut=apply_lut).numpy()
        want = np.asarray(jax_qmm_ref(
            jnp.asarray(x_q), jnp.asarray(w_q), lut, scale_x=sx, scale_w=sw,
            bias=jnp.asarray(bias), apply_lut=apply_lut))
        np.testing.assert_array_equal(got, want)
        pallas = np.asarray(jops.quant_matmul_static(
            jnp.asarray(x_q), jnp.asarray(w_q), lut, scale_x=sx, scale_w=sw,
            bias=jnp.asarray(bias), meta=meta, apply_lut=apply_lut,
            interpret=True))
        if apply_lut:
            np.testing.assert_array_equal(got, pallas)
        else:
            # under jit XLA fuses the epilogue's acc * scale + bias into one
            # FMA; the port (and the reference's ref.py) round the product
            # first: the two differ by at most an ulp of the product plus
            # an ulp of the result
            bound = (np.spacing(np.abs(got - bias[None, :]))
                     + np.spacing(np.abs(got)))
            assert np.all(np.abs(got - pallas) <= bound)

    @pytest.mark.parametrize("m,k,n", [(64, 400, 8), (128, 128, 128)])
    def test_dynamic_bit_exact(self, m, k, n):
        """Per-call quantization: the scale ``max|x| / 127`` is a division
        by a constant, which XLA turns into a reciprocal multiply."""
        rng = np.random.default_rng(m * n)
        x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
        w = (rng.normal(size=(k, n)) * 0.2).astype(np.float32)
        lut, meta = jax_lut()
        got = tops.quant_matmul(_t(x), _t(w), _t(lut), meta=meta).numpy()
        want = np.asarray(jops.quant_matmul(jnp.asarray(x), jnp.asarray(w),
                                            lut, meta=meta, interpret=True))
        np.testing.assert_array_equal(got, want)

    def test_custom_lut_meta_and_mismatch(self):
        lut, meta = jax_lut(entries=128, lo=-4.0, hi=4.0)
        x_q, w_q, bias = _qmm_inputs(9, 24, 96, 16)
        got = tops.quant_matmul_static(
            _t(x_q), _t(w_q), _t(lut), scale_x=0.01, scale_w=0.02,
            bias=_t(bias), meta=meta).numpy()
        want = np.asarray(jax_qmm_ref(
            jnp.asarray(x_q), jnp.asarray(w_q), lut, scale_x=0.01,
            scale_w=0.02, bias=jnp.asarray(bias), lut_lo=-4.0, lut_hi=4.0))
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError):
            tops.quant_matmul_static(_t(x_q), _t(w_q), _t(lut), scale_x=1.0,
                                     scale_w=1.0, meta=(-8.0, 8.0, 256))

    def test_cpu_routing(self):
        x_q, w_q, bias = _qmm_inputs(3, 16, 32, 4)
        lut, _ = jax_lut()
        before = dict(_build.launches)
        got = tops.quant_matmul_static(_t(x_q), _t(w_q), _t(lut),
                                       scale_x=0.1, scale_w=0.1, bias=_t(bias))
        assert dict(_build.launches) == before
        want = quant_matmul_ref(_t(x_q), _t(w_q), _t(np.asarray(lut)),
                                scale=float(np.float32(0.1 * 0.1)),
                                bias=_t(bias))
        torch.testing.assert_close(got, want, rtol=0, atol=0)


class TestNNForwardQuantized:
    def _nn(self, seed):
        from repro.camera.face_nn import init_face_nn
        return init_face_nn(jax.random.PRNGKey(seed))

    @pytest.mark.parametrize("m", [37, 512])
    def test_bit_exact_vs_jitted_reference(self, m):
        """The reference's executor runs nn_forward_quantized under jit;
        the port gives those bits, ties of the input quantizer included."""
        nn = self._nn(m)
        lut, meta = jax_lut()
        qj = jops.quantize_nn(nn)
        qt = tops.quantize_nn(nn, device="cpu")
        np.testing.assert_array_equal(qt.w1_q.numpy(), np.asarray(qj.w1_q))
        np.testing.assert_array_equal(qt.w2_q.numpy(), np.asarray(qj.w2_q))
        assert (qt.scale_x, qt.scale_w1, qt.scale_h, qt.scale_w2) == (
            qj.scale_x, qj.scale_w1, qj.scale_h, qj.scale_w2)
        rng = np.random.default_rng(m)
        x = rng.random((m, 400), dtype=np.float32)
        # pixel values next to the quantizer's round-half points
        ties = ((np.arange(m * 400) % 127) + 0.5).astype(np.float32) \
            / np.float32(127)
        ties = np.nextafter(ties, rng.choice([0.0, 2.0], ties.shape)
                            .astype(np.float32)).reshape(m, 400)
        x[: m // 2] = ties[: m // 2]
        f = jax.jit(lambda a: jops.nn_forward_quantized(
            qj, a, lut, meta, use_pallas=False))
        got = tops.nn_forward_quantized(qt, _t(x), _t(lut), meta).numpy()
        np.testing.assert_array_equal(got, np.asarray(f(jnp.asarray(x))))
        pallas = jax.jit(lambda a: jops.nn_forward_quantized(
            qj, a, lut, meta, use_pallas=True, interpret=True))
        np.testing.assert_array_equal(got, np.asarray(pallas(jnp.asarray(x))))

    def test_quantizer_is_the_jitted_division(self):
        """``x / scale`` under jit is ``x * f32(1 / f32(scale))``; on some
        ties that rounds differently from a true division, and the port
        follows the jitted form."""
        k = np.arange(128, dtype=np.float32)
        mid = (k + 0.5) / np.float32(127)
        x = np.concatenate([mid, np.nextafter(mid, 2), np.nextafter(mid, -2),
                            np.random.default_rng(0).random(200_000,
                                                            np.float32)])
        f = jax.jit(lambda a: jops._quantize_static(a, 1.0 / 127, 127))
        got = tops.quantize_static(_t(x), 1.0 / 127, 127).numpy()
        np.testing.assert_array_equal(got, np.asarray(f(jnp.asarray(x))))


class TestNoCard:
    """Entry points ask for the card by default and never fall back."""

    def test_default_device_raises_without_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        from repro_torch.camera.face_nn import make_sigmoid_lut
        from repro_torch.camera.pipelines import FaceAuthExecutor
        from repro_torch.camera.viola_jones import Cascade, FusedDetector
        casc = Cascade([], np.zeros(0), np.zeros(0), np.zeros(0), [],
                       np.zeros(0))
        img = np.zeros((1, 8, 8), np.float32)
        for call in (lambda: integral_image(img),
                     lambda: make_sigmoid_lut(),
                     lambda: FusedDetector(casc, 24, 24),
                     lambda: FaceAuthExecutor(casc, None, 24, 24)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        from repro_torch.kernels.haar_frontend.cuda import haar_stage_cuda
        from repro_torch.kernels.integral_image.cuda import integral_image_cuda
        from repro_torch.kernels.quant_matmul.cuda import quant_matmul_cuda
        z = torch.zeros((1, 4, 4))
        with pytest.raises(ValueError):
            integral_image_cuda(z)
        with pytest.raises(ValueError):
            haar_stage_cuda(z[0], z, None, None, None, None, None)
        with pytest.raises(ValueError):
            quant_matmul_cuda(z[0].to(torch.int8), z[0].to(torch.int8),
                              z[0, 0], scale=1.0)
