"""The port's bilateral-grid blur (``kernels/bilateral_blur``) against the
JAX package's ``blur_121``, ``refine`` and the Pallas kernel in interpret
mode, over the shapes of tests/test_kernels.py's ``TestBilateralBlur``.

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
