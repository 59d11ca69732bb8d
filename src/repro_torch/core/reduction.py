"""Early data reduction before the slow link — the port's copy of the JAX
package's ``core/reduction.py``.

"We find that an early data reduction step, either before complex
processing or offloading, is the most critical optimization for in-camera
systems."  At pod scale the slow link is the pod-to-pod interconnect, and
the bytes crossing it are gradients (training) or boundary activations:

* the quantization primitives: :func:`quantize_blocks` and, over it,
  :func:`quantize_bits`, :func:`quantize_int8` and :func:`dequantize_int8`
  (without the reference's stochastic-rounding ``key``, which nothing on
  the port's paths passes);
* int8 block-scaled quantization with error feedback
  (:func:`ef_compress_int8`; on a CUDA tensor through the wire codec's
  kernels) and top-k sparsification with error feedback
  (:func:`ef_compress_topk`);
* :func:`compressed_pod_allreduce`: a full-precision sum inside the pod,
  then int8 codes and float32 scales across pods, "filter before you
  transmit".  The pod axis is a ``torch.distributed`` process group;
* :func:`compress_boundary`: straight-through fake quantization of an
  activation crossing a cut.

Division by a constant follows the reference as XLA compiles it: inside
``jit`` (where the reference's executor runs) XLA rewrites ``x / c`` for a
compile-time constant ``c`` into ``x * float32(1 / float32(c))``, which can
round a tie the other way than a true division.  :func:`div_const` is that
rewrite, and every place where the reference divides by a Python number
uses it, so the port gives the executor's bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, computed as XLA computes it under
    ``jit``: a float32 multiply by the float32 reciprocal of ``c``."""
    return x * float(np.float32(1.0) / np.float32(c))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA computes it.  On
    the card PyTorch's float32 root is correctly rounded; on the CPU it is
    not, so there the float64 root is rounded once."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def flat_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened and zero-padded to (ceil(n/block), block)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def quantize_blocks(blocks: torch.Tensor, qmax: int):
    """Symmetric absmax quantization of each row of ``blocks``: (q, scales)
    with q rounded half to even and clamped to [-qmax, qmax] (still in the
    input dtype) and scales (n_blocks, 1); an all-zero block gets scale 1.
    The one quantizer of the port: :func:`quantize_int8`,
    :func:`quantize_bits` and the wire codec's plain version call it."""
    scale = div_const(blocks.abs().amax(dim=1, keepdim=True), qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.round(blocks / scale).clamp(-qmax, qmax), scale


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Block-scaled symmetric int8 quantization: (q, scales) with q int8
    of shape (ceil(n/block), block) and scales f32 (ceil(n/block), 1),
    one per flat block; an all-zero block gets scale 1."""
    q, scale = quantize_blocks(flat_blocks(x, block), 127)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` back to ``shape``."""
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def quantize_bits(x: torch.Tensor, bits: int, block: int = 256) -> torch.Tensor:
    """General b-bit symmetric fake-quantizer, per flat block of ``block``."""
    q, scale = quantize_blocks(flat_blocks(x, block), 2 ** (bits - 1) - 1)
    deq = (q * scale).reshape(-1)[:x.numel()].reshape(x.shape)
    return deq.to(x.dtype)


# ---------------------------------------------------------------------------
# Error-feedback compression state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EFState:
    """Per-tensor error-feedback residual, float32."""

    residual: torch.Tensor

    @staticmethod
    def init(x: torch.Tensor) -> "EFState":
        return EFState(residual=torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device))


# elements a pass of :func:`sub_products` takes: its float64 temporaries
# are then 512 MiB each, whatever the tensor's size
SLICE = 1 << 26


def sub_products(target: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``target - q * scale`` rounded once, flat block by flat block (q
    (n_blocks, block), scale (n_blocks, 1)), in ``target``'s shape: XLA
    fuses the reference's ``target - dequantize(q, scale)`` into an FMA.
    An int8 code times a float32 scale is exact in float64, and so is its
    difference from the target where the code is nonzero (the two are
    within a factor of two: Sterbenz) or zero, so rounding the float64
    difference once gives the FMA's bits."""
    flat = target.reshape(-1)
    n, block = flat.numel(), q.shape[1]
    out = torch.empty_like(flat)
    step = SLICE - SLICE % block
    for i in range(0, n, step):
        j = min(i + step, n)
        b = slice(i // block, -(-j // block))
        prod = (q[b].to(torch.float64) * scale[b].to(torch.float64))
        out[i:j] = (flat[i:j].to(torch.float64)
                    - prod.reshape(-1)[:j - i]).to(torch.float32)
        del prod
    return out.reshape(target.shape)


def ef_compress_int8(x: torch.Tensor, state: EFState, block: int = 256):
    """Quantize x + residual to int8; new residual = that target - dequant,
    rounded once (:func:`sub_products`).  Returns ((q, scales),
    dequantized x, new state), q int8 (n_blocks, block) and scales float32
    (n_blocks, 1) as :func:`quantize_int8`'s.

    A CUDA tensor goes to the wire codec's kernels at 8 bits (its packed
    bytes are the codes, one a value), a CPU tensor to
    :func:`quantize_int8` / :func:`dequantize_int8`; both give the same
    bits."""
    target = x.to(torch.float32) + state.residual
    if target.is_cuda:
        # imported here: the codec's ops import this module
        from repro_torch.kernels.wire_codec import ops as codec

        q, scale = codec.wire_encode(target, bits=8, block=block)
        deq = codec.wire_decode(q, scale, tuple(x.shape), bits=8,
                                block=block)
    else:
        q, scale = quantize_int8(target, block=block)
        deq = dequantize_int8(q, scale, x.shape)
    return (q, scale), deq, EFState(residual=sub_products(target, q, scale))


def ef_compress_topk(x: torch.Tensor, state: EFState,
                     k_fraction: float = 0.01):
    """Top-|k| sparsification with error feedback.  Returns ((values,
    indices), dense decompressed tensor, new state).  Among equal
    magnitudes the lower index comes first, as ``lax.top_k`` orders them:
    a stable descending sort (``torch.topk``'s order among ties is
    unspecified)."""
    target = (x.to(torch.float32) + state.residual).reshape(-1)
    n = target.shape[0]
    k = max(1, int(n * k_fraction))
    idx = torch.sort(target.abs(), descending=True, stable=True).indices[:k]
    vals = target[idx]
    dense = torch.zeros_like(target)
    dense[idx] = vals
    new_state = EFState(residual=(target - dense).reshape(x.shape))
    return (vals, idx), dense.reshape(x.shape), new_state


# ---------------------------------------------------------------------------
# Hierarchical compressed all-reduce over the pod axis
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, group) -> list:
    """The group's members' ``x``, in the group's rank order; ``[x]`` for
    ``group`` None (an axis of one member)."""
    if group is None:
        return [x]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA's fused multiply-add,
    for ``a * b`` exact in float64 (an int8 code times a float32 scale)
    and ``c`` float32.  The float64 sum is made round-to-odd from its exact
    error (TwoSum), so rounding it to float32 rounds as once."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    away = torch.nextafter(s, torch.where(err > 0, math.inf, -math.inf)
                           .to(torch.float64))
    return torch.where(fix, away, s).to(torch.float32)


def psum(x: torch.Tensor, groups=()) -> torch.Tensor:
    """The sum of ``x`` over the members of every group of ``groups`` (None
    entries skipped), gathered in the order of the groups' ranks, the
    first group's the slowest, then summed from the left: the order in
    which the reference's ``psum`` over the same mesh axes, listed in the
    same order, sums on the CPU, so that every member gets its bits."""
    parts = [x]
    for g in groups:
        if g is not None:
            parts = [p for q in parts for p in all_gather(q, g)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def pod_count(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def compressed_pod_allreduce(grad: torch.Tensor, state: EFState, *,
                             pod_group=None, inner_group=None,
                             block: int = 256):
    """All-reduce ``grad`` over ``inner_group`` and ``pod_group`` with int8
    on the pod hop.  Returns (the sum, in ``grad``'s dtype; new state).

      1. a full-precision sum over ``inner_group`` (the fast link inside
         the pod);
      2. int8 codes and float32 scales gathered over ``pod_group`` (the
         slow link): one byte a value and 4 bytes a block, against 2 x 4
         bytes a value for a float32 ring all-reduce;
      3. each pod's codes dequantized and summed in pod order; error
         feedback carries the quantization error into the next step.

    None stands for an axis of one member (the one card)."""
    if inner_group is not None:
        grad = psum(grad, (inner_group,))
    (q, scale), deq, new_state = ef_compress_int8(grad, state, block=block)
    if pod_group is None:
        total = deq                     # q * scale of the one pod
    else:
        # the reference's sum over the gathered pods, as XLA fuses it: the
        # first pod's product rounded, each next one added by an FMA
        pods = list(zip(all_gather(q, pod_group),
                        all_gather(scale, pod_group)))
        total = pods[0][0].to(torch.float32) * pods[0][1]
        for qp, sp in pods[1:]:
            total = fma32(qp, sp, total)
        total = total.reshape(-1)[:grad.numel()].reshape(grad.shape)
    return total.to(grad.dtype), new_state


def uncompressed_pod_allreduce(grad: torch.Tensor, *, pod_group=None,
                               inner_group=None) -> torch.Tensor:
    """Baseline: a plain sum over every data axis."""
    return psum(grad, (inner_group, pod_group))


# ---------------------------------------------------------------------------
# Activation-boundary reduction (cut-point payload compression)
# ---------------------------------------------------------------------------


def compress_boundary(x: torch.Tensor, bits: int = 8,
                      block: int = 256) -> torch.Tensor:
    """Fake-quantize an activation crossing a placement cut
    (straight-through): the value is ``x + (deq - x)``, rounded twice as
    the reference's, and the gradient is the identity."""
    deq = quantize_bits(x.detach(), bits=bits, block=block)
    return x + (deq - x).detach()
