"""The port's BSSA depth (``camera/bssa.py``) against the JAX package's, at
the fixtures of tests/test_camera_pipeline.py's ``TestBSSAFusedParity``.

Rough disparity.  The cost volume's box sums are differences of float32
summed-area tables, and the port sums them in another order than XLA's
cumsum, so a winner can differ where two hypotheses' SADs lie within
rounding of each other.  The rule (the one ``chip_smoke.py`` applies on
the card): every pixel where the two winners differ must be a near tie,
|SAD64(d_port) - SAD64(d_jax)| <= 2 max(E_port, E_jax), with SAD64 the
float64 sum of the same float32 pixel differences and E each side's
largest |SAD32 - SAD64| over the image and every hypothesis, measured
here from each side's own cost volume.  The synthetic texture is constant
on 4x4 blocks, so 6-12% of the fixtures' pixels have two hypotheses with
exactly equal SADs; there the winner is a matter of rounding order alone.
Agreement is therefore required at >= 0.999 on the pixels whose float64
minimum is unique, and over all pixels at the measured 0.99 (72x96) and
0.98 (48x64).

Everything after the rough disparity is held with JAX's rough injected:
splat array-equal (integer sums), blur array-equal, slice within 1e-5 of
the jitted reference (XLA fuses ``num += wv * v`` into an FMA; the port
rounds twice: 1.9e-6 at these fixtures) and equal to the eager one.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.camera import bssa as jb
from repro.camera.synthetic import stereo_pair

from benchmarks.torch_export_vr_reference import jax_cost_volume, sad64
from chip_smoke import cost_volume64

from repro_torch.camera import bssa as tb

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

FIXTURES = {"72x96": (72, 96, 4), "48x64": (48, 64, 5)}
# agreement over all pixels, exact ties included (measured: 99.2% and
# 98.6%), so that a change on the tied pixels still shows
OVERALL_AGREEMENT = {(72, 96): 0.99, (48, 64): 0.98}


def near_ties(d_port, d_jax, vol_port, vol_jax, vol64):
    """(agreement off exact ties, agreement overall, n near ties, E_port,
    E_jax); asserts that every disagreement is a near tie."""
    e_port = float(np.abs(vol_port - vol64).max())
    e_jax = float(np.abs(vol_jax - vol64).max())
    tau = 2 * max(e_port, e_jax)
    h, w = d_port.shape
    yy, xx = np.mgrid[0:h, 0:w]
    gap = np.abs(vol64[d_port, yy, xx] - vol64[d_jax, yy, xx])
    dis = d_port != d_jax
    assert (gap[dis] <= tau).all(), (gap[dis].max(), tau)
    unique = (vol64 == vol64.min(axis=0)).sum(axis=0) == 1
    return ((d_port == d_jax)[unique].mean(), 1.0 - dis.mean(),
            int(dis.sum()), e_port, e_jax)


@pytest.fixture(scope="module", params=list(FIXTURES))
def pair(request):
    h, w, seed = FIXTURES[request.param]
    left, right, _ = stereo_pair(h=h, w=w, seed=seed)
    return left, right


@pytest.mark.parametrize("chunk", [1, 4, 8, 64])
def test_rough_disparity_against_jax(pair, chunk):
    left, right = pair
    md = 12
    jr = np.asarray(jb.rough_disparity(jnp.asarray(left), jnp.asarray(right),
                                       md)).astype(np.int64)
    got = tb.rough_disparity(torch.tensor(left), torch.tensor(right), md,
                             hypothesis_chunk=chunk)
    # the chunked running minimum is the seed loop's single argmin
    np.testing.assert_array_equal(
        got.numpy(), tb.rough_disparity_ref(torch.tensor(left),
                                            torch.tensor(right), md).numpy())
    vol_port = tb.cost_volume(torch.tensor(left), torch.tensor(right),
                              md).numpy()
    vol_jax = jax_cost_volume(left, right, md)
    vol64 = sad64(left, right, 0, 0, *left.shape, max_disp=md)
    np.testing.assert_array_equal(vol_jax.argmin(axis=0), jr)
    np.testing.assert_array_equal(vol_port.argmin(axis=0), got.numpy())
    agree, overall, _n, e_port, e_jax = near_ties(
        got.numpy().astype(np.int64), jr, vol_port, vol_jax, vol64)
    assert agree >= 0.999
    assert overall >= OVERALL_AGREEMENT[left.shape]
    assert 0 < e_port < 1e-3 and 0 < e_jax < 1e-3


def test_cost_volume64_is_the_float64_sum(pair):
    left, right = pair
    got = cost_volume64(torch.tensor(left), torch.tensor(right), 12, 5,
                        10, 20, 16, 24).numpy()
    np.testing.assert_array_equal(got, sad64(left, right, 10, 20, 16, 24,
                                             max_disp=12))


def test_grid_coords_and_splat_equal_jax(pair):
    left, right = pair
    rough = np.asarray(jb.rough_disparity(jnp.asarray(left),
                                          jnp.asarray(right), 12))
    for sigma in (8, 16, 12):            # 12: the reciprocal multiply matters
        spec, tspec = jb.GridSpec(sigma), tb.GridSpec(sigma)
        assert spec.dims(*left.shape) == tspec.dims(*left.shape)
        want = jax.jit(lambda img: jb._grid_coords(img, spec))(
            jnp.asarray(left))
        got = tb._grid_coords(torch.tensor(left), tspec)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        gv, gw = jax.jit(lambda i, v: jb.splat(i, v, spec))(
            jnp.asarray(left), jnp.asarray(rough))
        tv, tw = tb.splat(torch.tensor(left), torch.tensor(rough), tspec)
        np.testing.assert_array_equal(np.asarray(gv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(gw), tw.numpy())


def test_tail_with_jax_rough_injected(pair):
    """splat -> refine_grid -> slice on JAX's rough: equal to eager JAX,
    within 1e-5 of jitted JAX (the FMA XLA forms in slice_grid)."""
    left, right = pair
    spec, tspec = jb.GridSpec(8), tb.GridSpec(8)
    rough = jb.rough_disparity(jnp.asarray(left), jnp.asarray(right), 12)

    def jax_tail(img, r):
        gv, gw = jb.splat(img, r, spec)
        return jb.slice_grid(*jb.refine(gv, gw, 6), img, spec)

    from repro_torch.kernels.bilateral_blur.ops import refine_grid
    tv, tw = tb.splat(torch.tensor(left), torch.tensor(np.asarray(rough)),
                      tspec)
    got = tb.slice_grid(*refine_grid(tv, tw, 6), torch.tensor(left),
                        tspec).numpy()
    np.testing.assert_array_equal(
        np.asarray(jax_tail(jnp.asarray(left), rough)), got)
    jitted = np.asarray(jax.jit(jax_tail)(jnp.asarray(left), rough))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-5)


def test_bssa_depth_at_the_reference_fixture():
    """64x80 seed 6 (tests/test_camera_pipeline.py:308-315): the fused
    depth within the reference's own 1e-4 of the port's loop oracle, and,
    against JAX, exactly the JAX tail applied to the port's rough (so any
    difference from JAX's ``bssa_depth`` comes from near-tie winners,
    held by ``test_rough_disparity_against_jax``)."""
    left, right, _ = stereo_pair(h=64, w=80, seed=6)
    L, R = torch.tensor(left), torch.tensor(right)
    spec, tspec = jb.GridSpec(8), tb.GridSpec(8)
    got = tb.bssa_depth(L, R, tspec, max_disp=10, n_iters=6).numpy()
    ref = tb.bssa_depth_ref(L, R, tspec, max_disp=10, n_iters=6).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    rough = jnp.asarray(tb.rough_disparity(L, R, 10).numpy())
    gv, gw = jb.splat(jnp.asarray(left), rough, spec)
    want = jb.slice_grid(*jb.refine(gv, gw, 6), jnp.asarray(left), spec)
    np.testing.assert_array_equal(np.asarray(want), got)


def test_batched_pairs_equal_single_pairs():
    views = [stereo_pair(h=40, w=56, seed=s)[:2] for s in range(3)]
    L = torch.tensor(np.stack([v[0] for v in views]))
    R = torch.tensor(np.stack([v[1] for v in views]))
    spec = tb.GridSpec(8)
    both = tb.bssa_depth(L, R, spec, max_disp=8, n_iters=3)
    for p in range(3):
        assert torch.equal(both[p], tb.bssa_depth(L[p], R[p], spec,
                                                  max_disp=8, n_iters=3))


def test_ms_ssim_against_jax():
    rng = np.random.default_rng(0)
    a = rng.random((64, 64), np.float32)
    b = (a + 0.1 * rng.random((64, 64), np.float32)).astype(np.float32)
    for x, y in ((a, a), (a, b)):
        want = jb.ms_ssim(jnp.asarray(x), jnp.asarray(y))
        got = tb.ms_ssim(torch.tensor(x), torch.tensor(y))
        assert abs(got - want) <= 1e-5
