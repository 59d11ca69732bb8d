"""The port's §III training path against the JAX package's, on the CPU.

Features: the port's tables come from the integral-image kernel's plain
version (sequential rows-then-columns), the reference's from XLA's cumsum,
so features agree within float32 rounding of the tables; with the
reference's tables injected, the port's feature arithmetic is bit-equal.
Boosting is the reference's numpy code, so a cascade trained on the
reference's feature matrix is bit-equal, and one trained on the port's
picks the same stumps.  The NN: ``jax.random`` cannot be reproduced, so
the port's Adam fit is driven by the reference's initial weights and
batch schedule; the port's own seeded training is held by the reference's
outcome rules (tests/test_camera_pipeline.py:58-86).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_detect import borderline
from test_torch_pipeline import matched_scores

from benchmarks.workloads import SMOKE_SCAN
from repro.camera import face_nn as jnn
from repro.camera import integral as jint
from repro.camera import viola_jones as jvj
from repro.camera.pipelines import FaceAuthExecutor as JaxExecutor
from repro.camera.synthetic import face_dataset, security_video

from repro_torch.bridge import cascade_from
from repro_torch.camera import face_nn as tnn
from repro_torch.camera import viola_jones as tvj
from repro_torch.camera.pipelines import FaceAuthExecutor

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

FEATURE_ATOL = 1e-5     # port tables vs XLA's: 2.7e-6 here, 8.5e-6 at 400/class
NN_ATOL = 1e-5          # the fit vs train_face_nn: 6e-8 at 60 steps
SCAN = dict(zip(("scale_factor", "step", "adaptive"), SMOKE_SCAN))
FIELDS = ("feats", "thresholds", "polarity", "alphas", "stage_thresholds")


def features(c):
    return [(f.kind, f.y, f.x, f.h, f.w) for f in c.feats]


@pytest.fixture(scope="module")
def data():
    """``workloads.fa_cascade(smoke=True)``'s training set and pool."""
    X, y, _ = face_dataset(n_per_class=80, seed=3)
    return X, y, jvj.make_feature_pool(n=60), tvj.make_feature_pool(n=60)


@pytest.fixture(scope="module")
def jax_cascade(data):
    X, y, pool, _ = data
    return jvj.train_cascade(X, y, pool, n_stages=2, per_stage=6, seed=0)


@pytest.fixture(scope="module")
def port_cascade(data):
    X, y, _, pool = data
    return tvj.train_cascade(X, y, pool, n_stages=2, per_stage=6, seed=0,
                             device="cpu")


@pytest.fixture()
def jax_tables(monkeypatch):
    """The port's feature evaluation reads XLA's integral tables."""
    def tables(x):
        return torch.from_numpy(np.array(jint.integral_image(
            jnp.asarray(x.numpy()))))
    monkeypatch.setattr(tvj, "integral_image", tables)


def _patches(n, win, seed):
    return np.random.default_rng(seed).random((n, win, win), np.float32)


# -- features -------------------------------------------------------------


def test_eval_features_within_rounding_of_the_tables(data):
    X, _, pool_j, pool_t = data
    W = X.reshape(-1, 20, 20)
    want = np.asarray(jvj.eval_features(jnp.asarray(W), pool_j))
    got = tvj.eval_features(W, pool_t, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEATURE_ATOL)


@pytest.mark.parametrize("win", [20, 31])
def test_eval_features_scaled_within_rounding_of_the_tables(data, win):
    _, _, pool_j, pool_t = data
    P = _patches(40, win, win)
    want = np.asarray(jvj.eval_features_scaled(jnp.asarray(P), win, pool_j))
    got = tvj.eval_features_scaled(P, win, pool_t, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_ATOL)


@pytest.mark.parametrize("win", [20, 31])
def test_eval_features_scaled_bit_equal_on_jax_tables(data, jax_tables, win):
    _, _, pool_j, pool_t = data
    P = _patches(40, win, win + 1)
    want = np.asarray(jvj.eval_features_scaled(jnp.asarray(P), win, pool_j))
    got = tvj.eval_features_scaled(P, win, pool_t, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_eval_features_bit_equal_on_jax_tables_at_full_width(jax_tables):
    """The full-width face set (800 windows, pool 250), where a float32
    square root of the variance would differ in 4 windows: the port's
    float64 root rounded once is the correctly rounded one, as XLA's."""
    X, _, _ = face_dataset(n_per_class=400, seed=3)
    W = X.reshape(-1, 20, 20)
    want = np.asarray(jvj.eval_features(jnp.asarray(W),
                                        jvj.make_feature_pool(n=250)))
    got = tvj.eval_features(W, tvj.make_feature_pool(n=250),
                            device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_eval_features_scaled_is_eval_features_at_base(data):
    _, _, _, pool = data
    P = _patches(16, 20, 1)
    np.testing.assert_array_equal(
        tvj.eval_features(P, pool, device="cpu").numpy(),
        tvj.eval_features_scaled(P, 20, pool, device="cpu").numpy())


def test_eval_features_launch_the_integral_once(data, monkeypatch):
    """One integral-image call a feature evaluation: the windows and their
    squares in one batch."""
    calls = []
    real = tvj.integral_image

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(tvj, "integral_image", counted)
    X, _, _, pool = data
    tvj.eval_features(X.reshape(-1, 20, 20), pool, device="cpu")
    assert calls == [(2 * len(X), 20, 20)]


# -- the cascade ----------------------------------------------------------


def test_boost_on_jax_features_is_bit_equal(data, jax_cascade):
    X, y, pool_j, pool_t = data
    F = np.asarray(jvj.eval_features(jnp.asarray(X.reshape(-1, 20, 20)),
                                     pool_j))
    got = tvj._boost(F, y, pool_t, n_stages=2, per_stage=6, seed=0)
    assert features(got) == features(jax_cascade)
    assert got.stage_sizes == jax_cascade.stage_sizes == [6, 6]
    for k in FIELDS[1:]:
        a, b = getattr(got, k), getattr(jax_cascade, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_train_cascade_picks_the_same_stumps(port_cascade, jax_cascade):
    assert features(port_cascade) == features(jax_cascade)
    assert port_cascade.stage_sizes == jax_cascade.stage_sizes
    np.testing.assert_array_equal(port_cascade.polarity,
                                  jax_cascade.polarity)
    np.testing.assert_allclose(port_cascade.thresholds,
                               jax_cascade.thresholds, rtol=0,
                               atol=FEATURE_ATOL)
    np.testing.assert_allclose(port_cascade.alphas, jax_cascade.alphas,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(port_cascade.stage_thresholds,
                               jax_cascade.stage_thresholds, rtol=0,
                               atol=1e-9)


def test_harvest_hard_negatives_array_equal():
    frames, truth = security_video(n_frames=6, motion_frames=4, seed=1)
    want = jvj.harvest_hard_negatives(frames, truth)
    got = tvj.harvest_hard_negatives(frames, truth)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strictness", [0.0, 0.3])
def test_run_stages_equal_on_equal_features(data, jax_cascade, strictness):
    X, _, pool_j, _ = data
    cols = [pool_j.index(f) for f in jax_cascade.feats]
    F = np.asarray(jvj.eval_features(jnp.asarray(X.reshape(-1, 20, 20)),
                                     pool_j))[:, cols]
    a_j, e_j = jvj._run_stages(jax_cascade, jnp.asarray(F), strictness)
    a_t, e_t = tvj._run_stages(cascade_from(jax_cascade),
                               torch.from_numpy(F), strictness)
    assert a_t.dtype == torch.bool and e_t.dtype == torch.int32
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    assert 0 < int(a_t.sum()) < len(F)


def test_cascade_apply_equal_on_jax_tables(data, jax_cascade, jax_tables):
    X, _, _, _ = data
    W = np.concatenate([X, _patches(60, 20, 7).reshape(60, -1)])
    W = W.reshape(-1, 20, 20)
    a_j, e_j = jvj.cascade_apply(jax_cascade, jnp.asarray(W))
    a_t, e_t = tvj.cascade_apply(cascade_from(jax_cascade), W, device="cpu")
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))


# -- the golden detector -------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    return security_video(n_frames=6, motion_frames=4, seed=1)[0]


COARSE = dict(scale_factor=1.4, step=4.0, adaptive=False)


def test_detect_faces_against_jax_by_the_borderline_rule(jax_cascade, frames):
    port = cascade_from(jax_cascade)
    n_diff = 0
    for i in (1, 2):
        want, n_j, ev_j = jvj.detect_faces(jax_cascade, frames[i], **COARSE)
        got, n_t, ev_t = tvj.detect_faces(port, frames[i], device="cpu",
                                          **COARSE)
        assert n_t == n_j > 0
        diff = set(got) ^ set(want)
        for pos in diff:
            assert borderline(jax_cascade, frames[i], pos), (i, pos)
        n_diff += len(diff)
        if not diff:
            assert ev_t == ev_j
    assert n_diff <= 2


def test_fused_detector_against_the_port_oracle(jax_cascade, frames):
    """tests/test_detect.py:130 on the port alone: the fused detector and
    the golden per-window detector find the same windows, up to 2
    borderline flips."""
    port = cascade_from(jax_cascade)
    det = tvj.FusedDetector(port, 144, 176, device="cpu", **COARSE)
    det.calibrate(frames[:2])
    dets, stats = det.detect(frames)
    assert stats["dropped"] == 0
    n_diff = found = 0
    for i in range(len(frames)):
        ref, n_inv, _ = tvj.detect_faces(port, frames[i], device="cpu",
                                         **COARSE)
        assert n_inv == stats["n_windows"]
        diff = set(ref) ^ set(dets[i])
        for pos in diff:
            assert borderline(jax_cascade, frames[i], pos), (i, pos)
        n_diff += len(diff)
        found += len(ref)
    assert n_diff <= 2 and found > 0


def test_detect_faces_empty_scan():
    c = tvj.Cascade([], np.zeros(0), np.zeros(0), np.zeros(0), [],
                    np.zeros(0))
    assert tvj.detect_faces(c, np.zeros((10, 10), np.float32),
                            device="cpu") == ([], 0, 0)


# -- the NN ---------------------------------------------------------------


def jax_schedule(steps, n, seed=0):
    """The batch indices ``train_face_nn(seed=seed)`` draws, under the
    process's threefry layout."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (128,), 0, n)))
    return np.stack(out)


def port_nn(nn):
    return tnn.FaceNN(*(torch.as_tensor(np.array(getattr(nn, k)))
                        for k in ("w1", "b1", "w2", "b2")))


@pytest.fixture(scope="module")
def fitted(data):
    """JAX's ``train_face_nn(steps=60)`` and the port's fit from the same
    initial weights over the same schedule."""
    X, y, _, _ = data
    ref = jnn.train_face_nn(X, y, steps=60)
    init = port_nn(jnn.init_face_nn(jax.random.PRNGKey(0), 400, 8))
    got = tnn.fit_face_nn(init, X, y, jax_schedule(60, len(X)))
    return ref, got


@pytest.mark.parametrize("name", ["w1", "b1", "w2", "b2"])
def test_fit_from_jax_draws_matches_train_face_nn(fitted, name):
    ref, got = fitted
    want = np.asarray(getattr(ref, name))
    have = getattr(got, name)
    assert have.dtype == torch.float32 and tuple(have.shape) == want.shape
    np.testing.assert_allclose(have.numpy(), want, rtol=0, atol=NN_ATOL)


def test_fit_from_jax_draws_classifies_as_jax(data, fitted):
    X, y, _, _ = data
    ref, got = fitted
    e_j = jnn.classification_error(jnn.forward_float(ref, jnp.asarray(X)), y)
    e_t = tnn.classification_error(tnn.forward_float(got, torch.from_numpy(X)),
                                   y)
    assert e_t == e_j
    lut_j, meta_j = jnn.make_sigmoid_lut()
    lut_t, meta_t = tnn.make_sigmoid_lut(device="cpu")
    q_j = np.asarray(jnn.forward_quantized(ref, jnp.asarray(X), 8, lut_j,
                                           meta_j))
    q_t = tnn.forward_quantized(got, torch.from_numpy(X), 8, lut_t,
                                meta_t).numpy()
    np.testing.assert_array_equal(q_t, q_j)


def test_init_face_nn_shapes_and_scale():
    nn = tnn.init_face_nn(torch.Generator().manual_seed(0), 400, 8,
                          device="cpu")
    assert nn.topology == (400, 8, 1) and nn.macs == 3208
    assert not nn.b1.any() and not nn.b2.any()
    assert abs(float(nn.w1.std()) - 0.05) < 0.005
    again = tnn.init_face_nn(torch.Generator().manual_seed(0), 400, 8,
                             device="cpu")
    assert torch.equal(nn.w1, again.w1) and torch.equal(nn.w2, again.w2)


def test_draw_batches():
    b = tnn.draw_batches(torch.Generator().manual_seed(1), 50, 160)
    assert b.shape == (50, 128) and b.dtype == torch.int64
    assert int(b.min()) >= 0 and int(b.max()) < 160
    assert torch.equal(b, tnn.draw_batches(torch.Generator().manual_seed(1),
                                           50, 160))


@pytest.fixture(scope="module")
def seeded():
    """tests/test_camera_pipeline.py's TestFaceNN fixture, trained by the
    port with its own generator."""
    X, y, _ = face_dataset(n_per_class=250, seed=1)
    ntr = int(0.9 * len(X))
    nn = tnn.train_face_nn(X[:ntr], y[:ntr], steps=1500, device="cpu")
    return nn, torch.from_numpy(X[ntr:]), y[ntr:]


def test_seeded_training_lut_negligible(seeded):
    nn, Xte, yte = seeded
    assert nn.topology == (400, 8, 1)
    lut, meta = tnn.make_sigmoid_lut(device="cpu")
    e_f = tnn.classification_error(tnn.forward_float(nn, Xte), yte)
    e_l = tnn.classification_error(tnn.forward_lut(nn, Xte, lut, meta), yte)
    assert abs(e_f - e_l) <= 0.01


def test_seeded_training_bit_knee(seeded):
    nn, Xte, yte = seeded
    lut, meta = tnn.make_sigmoid_lut(device="cpu")
    errs = {b: tnn.classification_error(
        tnn.forward_quantized(nn, Xte, b, lut, meta), yte)
        for b in (16, 8, 4)}
    e_f = tnn.classification_error(tnn.forward_float(nn, Xte), yte)
    assert errs[8] - e_f <= 0.015
    assert errs[4] >= errs[8]
    assert e_f < 0.2


def test_classification_error():
    s = torch.tensor([0.1, 0.5, 0.9, 0.4])
    y = np.array([0, 0, 1, 1])
    assert tnn.classification_error(s, y) == 0.5
    assert tnn.classification_error(s, y, threshold=0.35) == 0.25


# -- the §III ASIC model -------------------------------------------------


@pytest.mark.parametrize("bits", range(4, 17))
def test_asic_model_equals_jax(bits):
    for n_pes in (1, 2, 4, 7, 8, 9, 16, 32):
        for macs in (25, 408, 3208, 12_345):
            for fn, args in (("nn_time_per_window", (macs, n_pes)),
                             ("nn_power", (bits, n_pes)),
                             ("nn_energy_per_window", (macs, bits, n_pes))):
                a, b = getattr(tnn, fn)(*args), getattr(jnn, fn)(*args)
                assert a == pytest.approx(b, rel=1e-12, abs=0), (fn, args)


def test_asic_model_pins():
    for k in ("NN_POWER_8PE_8BIT_W", "NN_FREQ_HZ", "NN_PES"):
        assert getattr(tnn, k) == getattr(jnn, k)
    assert tnn.nn_power(8) == pytest.approx(393e-6, rel=1e-6)
    assert 1 - tnn.nn_power(8) / tnn.nn_power(16) == pytest.approx(0.41,
                                                                   abs=0.02)
    assert tnn.nn_time_per_window(3208, n_hidden=8) == tnn.nn_time_per_window(
        3208, n_pes=16, n_hidden=8)


# -- the slice ------------------------------------------------------------


def test_port_trained_models_drive_the_executor_like_jax(
        data, jax_cascade, port_cascade, fitted):
    """``fa_hotpath._workload(smoke=True)``: the port-trained cascade and
    NN in the port's executor against the JAX-trained ones in JAX's."""
    ref_nn, got_nn = fitted
    video, _ = security_video(n_frames=10, motion_frames=5, seed=1)
    jx = JaxExecutor(jax_cascade, ref_nn, 144, 176, **SCAN)
    tx = FaceAuthExecutor(port_cascade, got_nn, 144, 176, device="cpu",
                          **SCAN)
    assert tx.calibrate(video) == jx.calibrate(video)
    keys = ("motion", "n_windows", "n_auth", "window_id", "window_valid",
            "scores")
    j = {k: np.asarray(getattr(jx(video), k)) for k in keys}
    res = tx(video)
    t = {k: getattr(res, k).numpy() for k in keys}
    np.testing.assert_array_equal(t["motion"], j["motion"])
    flips, pairs = matched_scores(j, t)
    assert flips <= 2
    assert abs(int(t["n_auth"].sum()) - int(j["n_auth"].sum())) <= flips
    assert int(j["n_windows"].sum()) > 0
    assert len(pairs) >= int(j["n_windows"].sum()) - flips
    assert res.total_dropped() == 0
