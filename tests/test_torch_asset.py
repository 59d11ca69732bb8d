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

from test_torch_pipeline import matched_scores

from repro_torch.bridge import (
    ASSET,
    OFFLOAD_ASSET,
    load_fa_reference,
    load_offload_reference,
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
