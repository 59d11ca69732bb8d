"""The port's bilateral-grid blur (``kernels/bilateral_blur``) against the
JAX package's ``blur_121``, ``refine`` and the Pallas kernel in interpret
mode, over the shapes of tests/test_kernels.py's ``TestBilateralBlur``;
and the CUDA kernel's schedule (several steps a launch on tiles with a
halo), emulated in torch ops, against iterated plain steps.

Tolerance: none.  Every axis pass is ``(0.25*lo + 0.5*g) + 0.25*hi`` in
float32 on both sides, and the products by 0.25 and 0.5 are exact, so an
FMA that XLA forms cannot change a sum: the results are array-equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.camera.bssa import blur_121 as jax_blur_121
from repro.camera.bssa import refine as jax_refine
from repro.kernels.bilateral_blur.kernel import bilateral_blur_pallas
from repro.kernels.bilateral_blur.ops import refine_grid as jax_refine_grid

from repro_torch.kernels.bilateral_blur import cuda as bcuda
from repro_torch.kernels.bilateral_blur.ops import refine_grid
from repro_torch.kernels.bilateral_blur.ref import blur_121, blur_ref

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


def grids(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.random(shape).astype(np.float32))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape,bgy", [((32, 24, 17), 16), ((16, 16, 9), 16),
                                       ((64, 30, 17), 32)])
def test_one_step_equals_pallas_interpret_and_blur_121(shape, bgy):
    v, w = grids(shape, 0)
    va, wa = bilateral_blur_pallas(jnp.asarray(v), jnp.asarray(w),
                                   block_gy=bgy, interpret=True)
    vb, wb = blur_ref(torch.tensor(v), torch.tensor(w))
    eq(va, vb)
    eq(wa, wb)
    eq(jax_blur_121(jnp.asarray(v)), blur_121(torch.tensor(v)))


@pytest.mark.parametrize("shape,n_iters", [
    ((32, 24, 17), 2),      # gy divisible by 16
    ((30, 12, 9), 3),       # 30 % 16 != 0
    ((17, 10, 9), 2),       # prime gy
    ((20, 16, 9), 1),       # 20 % 16 != 0
    ((17, 21, 17), 8),      # KERNEL_SHAPES' 256x320 case, the rig's n_iters
    ((18, 31, 17), 8),      # the rig's working size, 270x480 at sigma 16
])
def test_refine_grid_equals_refine_and_pallas(shape, n_iters):
    v, w = grids(shape, 1)
    got_v, got_w = refine_grid(torch.tensor(v), torch.tensor(w), n_iters)
    ref_v, ref_w = jax_refine(jnp.asarray(v), jnp.asarray(w), n_iters)
    eq(ref_v, got_v)
    eq(ref_w, got_w)
    pal_v, pal_w = jax_refine_grid(jnp.asarray(v), jnp.asarray(w),
                                   n_iters=n_iters, block_gy=16,
                                   interpret=True)
    eq(pal_v, got_v)
    eq(pal_w, got_w)
    jit_v, _ = jax.jit(lambda a, b: jax_refine(a, b, n_iters))(
        jnp.asarray(v), jnp.asarray(w))
    eq(jit_v, got_v)


def test_leading_pair_axis_is_a_batch():
    """(P, gy, gx, gr): each pair blurs as the reference blurs it alone."""
    v, w = grids((3, 18, 31, 17), 2)
    got_v, got_w = refine_grid(torch.tensor(v), torch.tensor(w), 4)
    for p in range(3):
        ref_v, ref_w = jax_refine(jnp.asarray(v[p]), jnp.asarray(w[p]), 4)
        eq(ref_v, got_v[p])
        eq(ref_w, got_w[p])


def test_plain_version_on_random_and_constant_grids():
    """The plain version against a numpy transcription of the stencil on a
    random grid, and a constant grid stays constant (DC gain 1)."""
    v, _ = grids((9, 7, 5), 3)
    want = v.copy()
    for axis in range(3):
        n = want.shape[axis]
        lo = np.take(want, np.r_[0, 0:n - 1], axis=axis)
        hi = np.take(want, np.r_[1:n, n - 1], axis=axis)
        want = ((np.float32(0.25) * lo + np.float32(0.5) * want)
                + np.float32(0.25) * hi).astype(np.float32)
    np.testing.assert_array_equal(blur_121(torch.tensor(v)).numpy(), want)
    c = torch.full((16, 8, 9), 3.5)
    out_v, out_w = refine_grid(c, c.clone(), 5)
    assert torch.equal(out_v, c) and torch.equal(out_w, c)


def test_cuda_wrapper_refuses_cpu_tensors():
    v = torch.zeros((1, 4, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        bcuda.bilateral_blur_cuda(v, v)
    assert bcuda.SOURCE.endswith("csrc/bilateral_blur.cu")
    assert bcuda.REPLACES == "src/repro/kernels/bilateral_blur/kernel.py:53"


def test_refine_grid_rejects_mismatched_grids():
    with pytest.raises(ValueError):
        refine_grid(torch.zeros((4, 4, 3)), torch.zeros((4, 5, 3)), 1)


# -- the fused kernel's tile schedule ---------------------------------------
#
# csrc/bilateral_blur.cu runs up to kMaxSteps steps in one launch: a block
# stages an interior tile plus a halo of n_steps vertices (clipped to the
# grid), runs every step in shared memory on a region that shrinks by one
# vertex a step on each side with a halo, clamps neighbours to the grid's
# own border at every step, and writes the interior.  The emulation below
# follows that schedule in plain PyTorch, with the tile choice the wrapper
# passes to the kernel (``cuda.tile_shape``).

K_TILE_Y, K_TILE_X = bcuda.TILE_Y, bcuda.TILE_X
K_MAX_STEPS, K_SMEM = bcuda.MAX_STEPS, bcuda.SMEM_LIMIT
tile_shape = bcuda.tile_shape


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("gy,gx,gr,n_steps", [
    (136, 241, 17, 8), (136, 241, 17, 1), (37, 53, 9, 3), (1, 13, 4, 8),
    (270, 480, 17, 8), (136, 241, 64, 8), (5, 3, 200, 2)])
def test_tile_shape_fits_and_covers_the_grid(gy, gx, gr, n_steps):
    """Tiles no larger than the largest tile, as even as their number
    allows; the staged region fits the shared memory a block may have, in
    rows padded to gr modulo 32 banks (what the kernel's entry point
    checks)."""
    ty, tx, rs, smem = tile_shape(gy, gx, gr, n_steps)
    assert 1 <= ty <= min(gy, K_TILE_Y) and 1 <= tx <= min(gx, K_TILE_X)
    assert ty == _cdiv(gy, _cdiv(gy, ty)) and tx == _cdiv(gx, _cdiv(gx, tx))
    sy, sx = min(gy, ty + 2 * n_steps), min(gx, tx + 2 * n_steps)
    assert sx * gr <= rs < sx * gr + 32 and rs % 32 == gr % 32
    assert smem == 4 * sy * rs <= K_SMEM


def _pass(v, axis, rows, cols):
    """One axis pass of ``blur_121`` over v[:, rows, cols] (local slices);
    neighbour indices clamped to the staged region, which stops at the
    grid's borders."""
    n = v.shape[axis]
    idx = torch.arange(n)
    lo_i, hi_i = (idx - 1).clamp(min=0), (idx + 1).clamp(max=n - 1)
    a = v.index_select(axis, lo_i)
    c = v.index_select(axis, hi_i)
    out = (0.25 * a + 0.5 * v) + 0.25 * c
    v[:, rows, cols] = out[:, rows, cols]


def fused_emulation(g, n_steps, max_y=K_TILE_Y, max_x=K_TILE_X):
    """(P, gy, gx, gr) -> n_steps blur steps by the kernel's schedule."""
    P, gy, gx, gr = g.shape
    ty, tx, _rs, _smem = tile_shape(gy, gx, gr, n_steps, max_y, max_x)
    out = torch.empty_like(g)
    for y0 in range(0, gy, ty):
        for x0 in range(0, gx, tx):
            y1, x1 = min(gy, y0 + ty), min(gx, x0 + tx)
            sy0, sy1 = max(0, y0 - n_steps), min(gy, y1 + n_steps)
            sx0, sx1 = max(0, x0 - n_steps), min(gx, x1 + n_steps)
            top, bottom, left, right = sy0 == 0, sy1 == gy, sx0 == 0, sx1 == gx
            v = g[:, sy0:sy1, sx0:sx1].clone()
            SY, SX = sy1 - sy0, sx1 - sx0
            for s in range(1, n_steps + 1):
                rows = slice(0 if top else s, SY if bottom else SY - s)
                cols = slice(0 if left else s, SX if right else SX - s)
                pcols = slice(0 if left else s - 1,
                              SX if right else SX - s + 1)
                _pass(v, 1, rows, pcols)
                _pass(v, 2, rows, cols)
                _pass(v, 3, rows, cols)
            out[:, y0:y1, x0:x1] = v[:, y0 - sy0:y1 - sy0, x0 - sx0:x1 - sx0]
    return out


def clamped_staging_control(g, n_steps, max_y, max_x):
    """The wrong schedule: stage replicated copies of the input beyond the
    grid's borders once (edge padding), then blur them as vertices."""
    P, gy, gx, gr = g.shape
    h = n_steps
    yi = (torch.arange(-h, gy + h)).clamp(0, gy - 1)
    xi = (torch.arange(-h, gx + h)).clamp(0, gx - 1)
    padded = g[:, yi][:, :, xi]
    v = padded.clone()
    for _ in range(n_steps):
        v = blur_121(v)          # interior blurs, halo copies blurred too
    return v[:, h:h + gy, h:h + gx]


def iterated(g, n):
    for _ in range(n):
        g = blur_121(g)
    return g


TILE_CASES = [
    ((1, 9, 11, 17), (4, 5)),     # ragged against the tile in both axes
    ((2, 8, 10, 5), (8, 10)),     # the grid equal to one tile
    ((1, 6, 7, 3), (40, 40)),     # the grid smaller than the tile
    ((1, 1, 13, 4), (4, 5)),      # a 1-vertex gy axis
    ((1, 12, 1, 4), (4, 5)),      # a 1-vertex gx axis
    ((1, 13, 9, 1), (3, 4)),      # a 1-bin gr axis
    ((1, 37, 53, 17), None),      # the kernel's own tile, ragged
]


@pytest.mark.parametrize("n_steps", range(1, 9))
@pytest.mark.parametrize("shape,tile", TILE_CASES)
def test_tile_schedule_equals_iterated_blur(shape, tile, n_steps):
    g = torch.tensor(grids(shape, 5)[0])
    got = fused_emulation(g, n_steps, *(tile or (K_TILE_Y, K_TILE_X)))
    assert torch.equal(got.view(torch.int32),
                       iterated(g, n_steps).view(torch.int32))


def test_tile_schedule_at_the_rig_grid():
    """136 x 241 x 17 (one pair of the rig at sigma 16): 4 x 8 tiles of
    34 x 31, 163,400 bytes of shared memory (one block a SM), and the
    fused 8 steps equal 8 plain steps."""
    assert K_MAX_STEPS == 8
    ty, tx, rs, smem = tile_shape(136, 241, 17, 8)
    assert (ty, tx, _cdiv(136, ty), _cdiv(241, tx)) == (34, 31, 4, 8)
    assert rs % 32 == 17 and smem == 163_400 <= K_SMEM
    v, w = grids((1, 136, 241, 17), 6)
    for g in (torch.tensor(v), torch.tensor(w)):
        assert torch.equal(fused_emulation(g, 8).view(torch.int32),
                           iterated(g, 8).view(torch.int32))


@pytest.mark.parametrize("n_steps", [1, 2, 3, 8])
def test_clamped_copies_staged_once_are_wrong_from_step_two(n_steps):
    """Control on the border rule: clamped copies staged once equal the
    plain steps for one step only."""
    g = torch.tensor(grids((1, 9, 11, 5), 7)[0])
    got = clamped_staging_control(g, n_steps, 4, 5)
    same = torch.equal(got, iterated(g, n_steps))
    assert same == (n_steps == 1)


def test_tile_schedule_equals_jax_refine_grid_pallas():
    """The emulation against the JAX refinement with the Pallas blur in
    interpret mode, at a grid ragged against a small tile."""
    v, w = grids((18, 31, 17), 8)
    pal_v, pal_w = jax_refine_grid(jnp.asarray(v), jnp.asarray(w),
                                   n_iters=8, block_gy=16, interpret=True)
    eq(pal_v, fused_emulation(torch.tensor(v)[None], 8, 5, 7)[0])
    eq(pal_w, fused_emulation(torch.tensor(w)[None], 8, 5, 7)[0])


def test_smem_budget_halves_the_tile_where_it_must():
    """At 64 bins the rig's 34 x 31 tile would need 601,600 bytes: the
    tile is halved until the staged region fits the 227 KB a block may
    have."""
    assert 4 * (34 + 16) * (31 + 16) * 64 > K_SMEM
    ty, tx, _rs, smem = tile_shape(136, 241, 64, 8)
    assert smem <= K_SMEM and ty * tx < 34 * 31
