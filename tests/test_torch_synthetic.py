"""The port's synthetic workloads are array-equal to the JAX package's
(both are numpy generators with the same seeds)."""

import numpy as np
import pytest

from repro.camera import synthetic as ref
from repro_torch.camera import synthetic as port


@pytest.mark.parametrize("kw", [dict(n_per_class=40, seed=0),
                                dict(n_per_class=25, n_identities=6,
                                     target_identity=2, seed=3)])
def test_face_dataset_array_equal(kw):
    X, y, meta = ref.face_dataset(**kw)
    X2, y2, meta2 = port.face_dataset(**kw)
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(y, y2)
    np.testing.assert_array_equal(meta["identities"], meta2["identities"])
    assert meta["target"] == meta2["target"]
    assert X2.dtype == np.float32 and y2.dtype == np.int32


@pytest.mark.parametrize("kw", [dict(), dict(n_frames=10, motion_frames=5,
                                             faces_in_motion=0.9, seed=4)])
def test_security_video_array_equal(kw):
    frames, truth = ref.security_video(**kw)
    frames2, truth2 = port.security_video(**kw)
    np.testing.assert_array_equal(frames, frames2)
    assert frames2.dtype == np.float32
    assert truth == truth2


@pytest.mark.parametrize("kw", [dict(h=64, w=80, seed=1), dict()])
def test_stereo_pair_array_equal(kw):
    for a, b in zip(ref.stereo_pair(**kw), port.stereo_pair(**kw)):
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.float32
