"""The port's §IV VR rig (``camera/stitch.py``, ``VRRigExecutor``,
``VROffloadExecutor``, the §IV cost model and the cut controller in the
throughput regime) against the JAX package's.

Stitch.  The port computes the warp's source maps once per shape in
float64; the reference computes them in float32 under ``jit``.  The
truncated indices may differ only where the float64 coordinate lies
within 1e-3 of an integer or of the valid range's border (float32
rounding of a coordinate of at most ~4000 is below 5e-4).  With equal
maps the panoramas are held within 1e-6, tests/test_stitch.py's own
tolerance: the falling feather ramp can differ from XLA's by 2^-24 (XLA's
linspace loop uses an FMA in its vector body and not in its tail), and
the rising ramp and everything else is equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.camera import stitch as js
from repro.camera.bssa import GridSpec as JaxGridSpec
from repro.camera.offload import CutController as JaxController
from repro.camera.offload import CutMeasurement as JaxMeasurement
from repro.camera.offload import ETH_25G_LINK as JAX_ETH_25G_LINK
from repro.camera.offload import VROffloadExecutor as JaxVROffload
from repro.camera.pipelines import VRRigExecutor as JaxRig
from repro.camera.pipelines import VRWorkloadStats as JaxStats
from repro.camera.pipelines import vr_pipeline as jax_vr_pipeline
from repro.camera.pipelines import vr_profiles as jax_vr_profiles
from repro.camera.synthetic import stereo_pair
from repro.core import costmodel as jcm

from chip_smoke import near_integer_canvas

from repro_torch.camera import stitch as ts
from repro_torch.camera.bssa import GridSpec, bssa_depth
from repro_torch.camera.offload import (
    ETH_25G_LINK,
    CutController,
    CutMeasurement,
    VROffloadExecutor,
)
from repro_torch.camera.pipelines import (
    VR_CAMS,
    VR_FPS_TARGET,
    VR_H,
    VR_W,
    VRRigExecutor,
    VRWorkloadStats,
    vr_pipeline,
    vr_profiles,
)
from repro_torch.core import costmodel as tcm

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

VR_CUTS = ("capture", "depth", "stitch")


@pytest.mark.parametrize("h,w", [(48, 64), (270, 480), (2160, 3840)])
def test_warp_maps_differ_only_at_near_integer_coordinates(h, w):
    """The JAX warp of an image whose pixels hold their own index + 1
    gives the reference's source map (0 = invalid)."""
    f = 0.8 * w
    ids = (np.arange(h * w, dtype=np.float32) + 1).reshape(h, w)
    want = np.asarray(jax.jit(lambda a: js.cylindrical_warp(a, f))(
        jnp.asarray(ids)))
    src, valid = ts.warp_maps(h, w, f, "cpu")
    got = np.where(valid.numpy(), src.numpy() + 1, 0).reshape(h, w)
    differ = got != want
    # one view with no overlap: the canvas is the view
    near = near_integer_canvas(h, w, 1, overlap_frac=0.0)
    assert not (differ & ~near).any()
    # a coordinate that is an integer in exact arithmetic rounds either
    # way: one column of x at 270x480, scattered y at 2160x3840
    assert differ.mean() < 0.01
    np.testing.assert_array_equal(
        ts.cylindrical_warp(torch.tensor(ids), f).numpy(), got)


@pytest.mark.parametrize("w,overlap", [(64, 9), (480, 72), (3840, 576)])
def test_feather_ramp_within_one_ulp(w, overlap):
    """Rising ramp and flat part equal; the falling ramp within 2^-24, one
    float32 ulp of values in [0.5, 1) (the FMA and non-FMA forms of
    1 - step differ by one rounding of an exact product)."""
    want = np.asarray(jax.jit(lambda: js.feather_ramp(w, overlap))())
    got = ts.feather_ramp(w, overlap).numpy()
    np.testing.assert_array_equal(got[:w - overlap], want[:w - overlap])
    assert np.abs(got - want).max() <= 2.0 ** -24


def test_feather_blend_and_stitch_ring_against_jax():
    rng = np.random.default_rng(1)
    tiles = rng.random((3, 24, 48), np.float32)
    np.testing.assert_allclose(
        ts.feather_blend(torch.tensor(tiles), 7).numpy(),
        np.asarray(js.feather_blend(jnp.asarray(tiles), 7)), rtol=0,
        atol=1e-6)
    views = np.stack([stereo_pair(h=48, w=64, seed=s)[0] for s in range(4)])
    np.testing.assert_allclose(
        ts.stitch_ring(torch.tensor(views)).numpy(),
        np.asarray(js.stitch_ring(jnp.asarray(views))), rtol=0, atol=1e-6)


def test_stereo_panorama_against_jax():
    views = [stereo_pair(h=40, w=56, seed=s) for s in range(3)]
    L = np.stack([v[0] for v in views])
    R = np.stack([v[1] for v in views])
    D = np.stack([v[2] for v in views])
    want = js.stereo_panorama(jnp.asarray(L), jnp.asarray(R), jnp.asarray(D))
    got = ts.stereo_panorama(torch.tensor(L), torch.tensor(R),
                             torch.tensor(D))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


# -- the rig (the fixture of tests/test_offload.py:133-145) ------------------


@pytest.fixture(scope="module")
def rig():
    views = [stereo_pair(h=48, w=64, max_disp=4, seed=2 + s)[:2]
             for s in range(2)]
    lefts = np.stack([v[0] for v in views])
    rights = np.stack([v[1] for v in views])
    jbase = JaxRig(JaxGridSpec(sigma_spatial=8), max_disp=4, n_iters=2,
                   rig_parallel=False)
    base = VRRigExecutor(GridSpec(sigma_spatial=8), max_disp=4, n_iters=2,
                         device="cpu")
    return base, jbase, lefts, rights


def test_rig_executor_against_jax(rig):
    """The left panorama within 1e-6 of JAX's; the depths are the port's
    BSSA per pair (held against JAX in test_torch_bssa.py); the JAX
    panorama function on the port's depths gives the port's right
    panorama within 1e-6."""
    base, jbase, lefts, rights = rig
    lp, rp, depths = base(lefts, rights)
    jlp, _jrp, _jd = jbase(jnp.asarray(lefts), jnp.asarray(rights))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
                               atol=1e-6)
    for p in range(2):
        assert torch.equal(depths[p], bssa_depth(
            torch.tensor(lefts[p]), torch.tensor(rights[p]),
            GridSpec(sigma_spatial=8), max_disp=4, n_iters=2))
    _, want_rp = jax.jit(jbase.pano_fn)(jnp.asarray(lefts),
                                        jnp.asarray(rights),
                                        jnp.asarray(depths.numpy()))
    np.testing.assert_allclose(rp.numpy(), np.asarray(want_rp), rtol=0,
                               atol=1e-6)
    assert np.isfinite(lp.numpy()).all() and np.isfinite(rp.numpy()).all()


@pytest.mark.parametrize("cut", VR_CUTS)
def test_raw_split_is_bitexact(rig, cut):
    base, _jbase, lefts, rights = rig
    lp0, rp0, _d = base(lefts, rights)
    (lp, rp), pay = VROffloadExecutor(base, cut, bits=None)(lefts, rights)
    assert torch.equal(lp, lp0) and torch.equal(rp, rp0)
    assert pay.nbytes() > 0


@pytest.mark.parametrize("cut", VR_CUTS)
def test_wire_bytes_equal_jax(rig, cut):
    base, jbase, lefts, rights = rig
    for bits in (None, 16, 8, 4):
        got = VROffloadExecutor(base, cut, bits=bits).encode(lefts, rights)
        want = JaxVROffload(jbase, cut, bits=bits).encode(
            jnp.asarray(lefts), jnp.asarray(rights))
        assert got.wire_b.dtype == torch.float32 and got.wire_b.dim() == 0
        assert got.nbytes() == want.nbytes(), bits
        assert got.capacity_bytes() == want.capacity_bytes(), bits
        assert set(got.arrays) == set(want.arrays) == \
            VROffloadExecutor.PAYLOAD_SCHEMA[cut].declared(bits)
        assert got.meta["view_shape"] == tuple(want.meta["view_shape"])


def test_capture_payload_bytes_equal_jax(rig):
    base, jbase, lefts, rights = rig
    for bits in (16, 8, 4):
        got = VROffloadExecutor(base, "capture", bits=bits).encode(
            lefts, rights)
        want = JaxVROffload(jbase, "capture", bits=bits).encode(
            jnp.asarray(lefts), jnp.asarray(rights))
        assert set(got.arrays) == set(want.arrays)
        for name, arr in want.arrays.items():
            a = np.asarray(arr)
            b = got.arrays[name].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), (bits, name)


def test_knee_on_panorama(rig):
    base, _jbase, lefts, rights = rig
    lp0, _rp0, _d = base(lefts, rights)
    err = {}
    for bits in (8, 4):
        (lp, _rp), _ = VROffloadExecutor(base, "capture", bits=bits)(
            lefts, rights)
        err[bits] = float((lp - lp0).abs().max())
    assert err[8] < 0.02               # 8-bit views: sub-1% panorama
    assert err[4] > err[8]             # 4-bit is past the knee


def test_depth_cut_ships_more_than_capture(rig):
    base, _jbase, lefts, rights = rig
    b_cap = VROffloadExecutor(base, "capture", bits=8).encode(
        lefts, rights).nbytes()
    b_dep = VROffloadExecutor(base, "depth", bits=8).encode(
        lefts, rights).nbytes()
    assert b_dep > b_cap


def test_offload_rejects_unknown_cut(rig):
    with pytest.raises(ValueError):
        VROffloadExecutor(rig[0], "isp")


# -- the §IV cost model and the controller's throughput regime ---------------


def test_vr_constants_pipeline_and_profiles_equal_jax():
    from repro.camera import pipelines as jp

    assert (VR_CAMS, VR_W, VR_H, VR_FPS_TARGET) == (
        jp.VR_CAMS, jp.VR_W, jp.VR_H, jp.VR_FPS_TARGET)
    stats, jstats = VRWorkloadStats(), JaxStats()
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    for name in ("pixels",):
        assert getattr(stats, name) == getattr(jstats, name)
    for name in ("grid_vertices", "rough_flops", "refine_flops"):
        assert getattr(stats, name)() == getattr(jstats, name)()
    got, want = vr_pipeline(stats), jax_vr_pipeline(jstats)
    assert got.name == want.name
    assert len(got.blocks) == len(want.blocks)
    for a, b in zip(got.blocks, want.blocks):
        for field in ("name", "flops", "bytes_in", "bytes_out",
                      "selectivity", "requires", "meta"):
            assert getattr(a, field) == getattr(b, field), (a.name, field)
        assert a.kind.name == b.kind.name
    for dev in ("ARM_A9", "QUADRO_GPU", "ZYNQ_FPGA", "VIRTEX_FPGA",
                "ETH_25G", "ETH_400G"):
        assert dataclasses.asdict(getattr(tcm, dev)) == dataclasses.asdict(
            getattr(jcm, dev)), dev
    assert tcm._FPGA_UNIT_FLOPS == jcm._FPGA_UNIT_FLOPS
    p, q = vr_profiles(tcm.VIRTEX_FPGA), jax_vr_profiles(jcm.VIRTEX_FPGA)
    assert {k: dataclasses.asdict(v) for k, v in p.items()} == {
        k: dataclasses.asdict(v) for k, v in q.items()}


@pytest.mark.parametrize("seed", range(6))
def test_throughput_controller_chooses_what_jax_chooses(seed):
    """Both controllers get the same measurements (per rig frame, units=1
    as at native scale) and must choose the same cut with the same
    objectives; the choice is the measured optimum on both sides."""
    rng = np.random.default_rng(seed)
    node = np.cumsum(rng.uniform(0.001, 0.4, 3))
    cloud = rng.uniform(0.001, 0.2, 3)[::-1]
    wire = rng.uniform(1e7, 5e8, 3)

    def run(ctl_cls, meas_cls, pipe, profiles, link):
        ctl = ctl_cls(lambda cut: None, cuts=VR_CUTS, template=pipe,
                      profiles=profiles, link=link, regime="throughput")
        ctl.measurements = [
            meas_cls(cut=c, node_s=float(node[i]), cloud_s=float(cloud[i]),
                     wire_bytes=float(wire[i]), capacity_bytes=float(wire[i]),
                     units=1) for i, c in enumerate(VR_CUTS)]
        return ctl.report()

    got = run(CutController, CutMeasurement, vr_pipeline(VRWorkloadStats()),
              vr_profiles(tcm.VIRTEX_FPGA), ETH_25G_LINK)
    want = run(JaxController, JaxMeasurement,
               jax_vr_pipeline(JaxStats()), jax_vr_profiles(jcm.VIRTEX_FPGA),
               JAX_ETH_25G_LINK)
    assert got.chosen_cut == want.chosen_cut
    assert got.measured_best_cut == want.measured_best_cut
    assert got.agrees and want.agrees
    assert got.measured_objectives == pytest.approx(
        want.measured_objectives, rel=1e-12)
    assert got.predicted_objectives == pytest.approx(
        want.predicted_objectives, rel=1e-12)


def test_vr_entry_points_ask_for_the_card():
    """Without ``device="cpu"`` (or a CPU tensor) the VR entry points ask
    for the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.camera import bssa

    img = np.zeros((2, 16, 24), np.float32)
    for call in (lambda: VRRigExecutor(GridSpec(8)),
                 lambda: bssa.rough_disparity(img, img, 4),
                 lambda: bssa.splat(img, img, GridSpec(8)),
                 lambda: ts.stitch_ring(img)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
