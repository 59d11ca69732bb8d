#!/usr/bin/env python3
"""A/B of design variants of the hand-written CUDA kernels, on one card.

    python3 benchmarks/torch_kernel_variants.py [--only SECTION ...] [--json OUT]
        [--parent DIR]

Builds variants of ``src/repro_torch/csrc/integral_image.cu`` (rows per
strip ``RS`` and the blocks per SM of its ``__launch_bounds__``; section
``integral``), of the bf16 kernel of
``src/repro_torch/csrc/flash_attention.cu`` (P V from one bf16 term of P,
FlashAttention's P, instead of the committed hi + lo pair; ``flash``) and
of its float32 kernel (masks on every tile or on cut tiles only, blocks
of 64 or 128 queries, the order of the q k^T fragment loads and the
unrolling of P V; ``flash_f32``), of the bf16 kernels of
``src/repro_torch/csrc/flash_attention_bwd.cu`` (tile sizes, ring depth,
P and dS as one bf16 term; ``flash_bwd``, which also prints the
per-kernel device times) and of its float32 kernels (ring depth, tiles
of 16, 32 and 64, P and dS through shared memory, the sums split into
more chains, the loop over d unrolled, one score product at a time, the
high parts cut instead of rounded, and the parent's first draft with
``--parent``; ``flash_bwd_f32``, beside SDPA's efficient backward), the
rate of ``mma.sync`` in TF32 alone (``mma_tf32``), of
``src/repro_torch/csrc/rwkv_scan.cu``
(the products as one TF32 term instead of 3xTF32, and three blocks an SM
instead of four; ``wkv``), of ``src/repro_torch/csrc/rwkv_scan_bwd.cu``
(its cluster barrier with release semantics, its first pass's ring three
chunks deep, and the parent's kernel; ``wkv_bwd``) and of
``src/repro_torch/csrc/haar_stage.cu``
(windows a thread scores together, slot blocks a frame, the table path
for the small stages or the global path for every stage; ``haar``) and
of ``src/repro_torch/csrc/bilateral_blur.cu`` (tile shapes, threads and
blocks a SM, the unrolling of the line walks, steps a launch; ``blur``)
by text substitution of the committed sources, each with ``nvcc`` into a
library of its own under ``build/variants/``, and of the decode of
``src/repro_torch/csrc/wire_codec.cu`` (plain or streaming stores;
``codec``).  ``blur`` and ``codec`` also build the parent commit's kernel
from the tree that ``--parent`` names.  Each
variant is checked against the plain PyTorch version on the same inputs
(a WKV variant's error is reported, the committed kernel's held to the
bound), then all are timed with CUDA events in turns (A, B, ..., B, A)
on one card (``blur`` and ``codec`` add each call's device time by
``torch.profiler``).  Prints one line per
shape and, with ``--json``, writes the readings.  Needs a CUDA card and
the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

# (RS, blocks per SM); the first is the committed kernel
INTEGRAL = {"rs64_3blocks": (64, 3), "rs32_4blocks": (32, 4),
            "rs32_8blocks": (32, 8), "rs64_4blocks": (64, 4)}
FLASH_ONE_P = ("        wgmma_rs<DV>(acc, hi, vd);\n"
               "        wgmma_rs<DV>(acc, lo, vd);\n")


def build(name, source, nvcc, flags):
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, name + ".cu")
    with open(src, "w") as f:
        f.write(source)
    lib = os.path.join(out_dir, name + ".so")
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-I", CSRC,
                           "-shared", src, "-o", lib], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = [line.split("ptxas info    :")[-1].strip()
            for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line
            or "Performance Loss" in line]
    print(f"{name}: {'; '.join(regs)}", flush=True)
    return ctypes.CDLL(lib)


def device_ms(fn, reps, warm=2):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(calls, reps):
    """{name: [ms, ms]}: every call timed twice, in the order A..Z, Z..A."""
    order = list(calls) + list(calls)[::-1]
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(device_ms(calls[name], reps))
    return times


def integral_variants(nvcc, flags):
    import torch

    from repro_torch.kernels.integral_image.ref import integral_image_ref

    text = open(os.path.join(ROOT, "src/repro_torch/csrc/integral_image.cu")
                ).read()
    fns = {}
    for name, (rs, blocks) in INTEGRAL.items():
        src = text.replace("constexpr int RS = 64;",
                           f"constexpr int RS = {rs};").replace(
            "__launch_bounds__(TW, 3)", f"__launch_bounds__(TW, {blocks})")
        fn = build(f"integral_{name}", src, nvcc, flags).repro_integral_image
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, rs)

    def call(name, x):
        fn, rs = fns[name]
        n, h, w = x.shape
        out = torch.empty((n, h + 1, w + 1), device=x.device)
        scratch = torch.empty(1 + n * -(-h // rs), dtype=torch.int32,
                              device=x.device)
        rc = fn(x.data_ptr(), out.data_ptr(), n, h, w, scratch.data_ptr(),
                scratch.numel(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"integral {name}: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for shape in ((56, 144, 176), (64, 2164, 3844)):
        x = 255 * torch.rand(shape, device="cuda", generator=gen)
        want = integral_image_ref(x)
        for name in fns:
            if not torch.equal(call(name, x), want):
                raise AssertionError(f"integral {name} {shape} differs")
        del want
        reps = 5 if shape[0] == 64 else 50
        times = in_turns({name: (lambda n=name: call(n, x)) for name in fns},
                         reps)
        times["cumsum(cumsum)"] = [device_ms(
            lambda: torch.cumsum(torch.cumsum(x, -2), -1), reps)]
        label = "x".join(map(str, shape))
        print(f"integral_image {label}: ms " + ", ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
            for k, v in times.items()), flush=True)
        result[label] = times
        del x
        torch.cuda.empty_cache()
    return result


def flash_variants(nvcc, flags):
    import torch

    from repro_torch.kernels.flash_attention.ops import expand_kv
    from repro_torch.kernels.flash_attention.ref import mha_streaming
    from repro_torch.models.layers import pin_matmul_precision

    pin_matmul_precision()
    text = open(os.path.join(ROOT, "src/repro_torch/csrc/flash_attention.cu")
                ).read()
    if FLASH_ONE_P not in text:
        raise RuntimeError("flash_attention.cu no longer has the hi + lo "
                           "P V lines this script edits")
    fns = {}
    for name, src in (("p_hi_lo", text),
                      ("p_one_bf16", text.replace(
                          FLASH_ONE_P, "        wgmma_rs<DV>(acc, hi, vd);\n"))):
        fn = build(f"flash_{name}", src, nvcc, flags).repro_flash_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, q, k, v):
        b, s, H, d = q.shape
        o = torch.empty_like(q)
        rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       None,
                       1, b, s, k.shape[1], H, k.shape[2], d, d,
                       ctypes.c_float(d ** -0.5), 0,
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash {name}: CUDA error {rc}")
        return o

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    # yi-9b's prefill shape; q and k at the random-weight models' ~30x
    # unit scale and v at the ~9x its full-width prefill gives
    for qk, vs, atol, rtol in ((30.0, 9.0, 2e-2, 2e-2),
                               (1.0, 1.0, 4e-3, 2.0 ** -7)):
        b, s, H, KV, d = 8, 4096, 32, 4, 128
        q = (qk * torch.randn((b, s, H, d), device="cuda", generator=gen)
             ).bfloat16()
        k = (qk * torch.randn((b, s, KV, d), device="cuda", generator=gen)
             ).bfloat16()
        v = (vs * torch.randn((b, s, KV, d), device="cuda", generator=gen)
             ).bfloat16()
        pos = torch.arange(s, device="cuda")
        want = mha_streaming(q, expand_kv(k, H), expand_kv(v, H), pos, pos,
                             d ** -0.5).double()
        label = f"{b}x{s}x{H}/{KV}x{d} q,k x{qk:g} v x{vs:g}"
        entry = {}
        for name in fns:
            err = (call(name, q, k, v).double() - want).abs()
            ratio = float((err / (atol + rtol * want.abs())).max())
            entry[name] = {"max_abs_err": float(err.max()),
                           "worst_over_bound": ratio}
        del want, err
        times = in_turns({name: (lambda n=name: call(n, q, k, v))
                          for name in fns}, 10)
        for name in fns:
            entry[name]["ms"] = times[name]
        print(f"flash_attention {label} (bound {atol:g} + {rtol:g} |x|): "
              + ", ".join(f"{n} max |err| {e['max_abs_err']:g}, "
                          f"{e['worst_over_bound']:.3g} of the bound, ms "
                          f"{' / '.join(f'{t:.4f}' for t in e['ms'])}"
                          for n, e in entry.items()), flush=True)
        result[label] = entry
        del q, k, v
        torch.cuda.empty_cache()
    return result

# the bf16 backward's constants (csrc/flash_attention_bwd.cu, tensor_core)
# that its variants change: {variant: {constant: value}}
FLASH_BWD = {"committed": {},
             "dq_bk64": {"kDqBK": 64},
             "kv_stages3": {"kKvStages": 3},
             "one_bf16": {"kPTerms": 1, "kDsTerms": 1}}


def kernel_device_ms(fn, reps):
    """{"dq": ms, "dkdv": ms}: each backward kernel's mean device time per
    launch over ``reps`` calls of ``fn`` (torch.profiler, after the
    events; the profiler now and then drops a record, so the mean is over
    the launches it saw)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for part in ("dq", "dkdv"):
            if f"flash_attention_bwd_{part}_kernel" in e.key:
                out[part] = e.self_device_time_total / 1e3 / e.count
    return out


def set_constants(text, values, label):
    """``text`` with the first ``constexpr int <name> = <n>;`` of each of
    ``values`` set to its value: a namespace's constant, or a tile of its
    primary ``Tiles`` (the backward's equal (d, dv) pairs; MLA's
    specialization, which follows it, keeps its own)."""
    import re

    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text, count=1)
        if n != 1:
            raise RuntimeError(f"{label}: {name} is not a constant of the "
                               "source")
    return text


def bwd_argtypes(source):
    """The argtypes of ``repro_flash_attention_bwd`` in ``source``: since
    MLA's pair was built it takes the value width after the query-key
    width (``bwd_call_widths``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ints = 8 if "int KV, int D, int DV," in source else 7
    return [p] * 10 + [i] * ints + [ctypes.c_float, i, p]


def bwd_call_widths(fn, d, dv):
    """The width arguments ``fn`` (bound by ``bwd_argtypes``) takes."""
    return (d, dv) if len(fn.argtypes) == 21 else (d,)


def flash_bwd_variants(nvcc, flags):
    """The bf16 backward at yi-9b's training step (8 x 2048 x 32/4 x 128,
    causal) with q and k at unit scale and at the random-weight models'
    ~30x (v at 9x), and on the inputs of the CPU emulation's test at yi's
    scale (tests/test_torch_flash_attention.py ``yi_scale_bwd``: 2 x 2048
    x 8/2 x 128, numpy seeds 1 and 2).  Each variant of ``FLASH_BWD`` (the
    committed kernels; dq's key tiles of 64; the dkdv ring three stages
    deep; P and dS as one bf16 term, FlashAttention's rounding) is held to
    ``flash_attention_bwd_ref`` given the plain forward's O and lse (each
    output's max |err| over its max |plain|, beside the card's 2^-7 bound,
    also in bf16 steps of max |plain|'s binade; the worst |err| over the
    card's elementwise 2e-2 + 2e-2 |plain|; two runs bit-equal) twice:
    given the forward kernel's O and lse, as
    the training step runs it, and given the plain forward's, which leaves
    the backward's own rounding alone.  At the training shape each variant
    is then timed with CUDA events in turns, and each of its two kernels
    by torch.profiler."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as fcuda
    from repro_torch.kernels.flash_attention.ops import expand_kv
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        mha_streaming,
    )
    from repro_torch.models.layers import pin_matmul_precision

    pin_matmul_precision()
    text = open(os.path.join(CSRC, "flash_attention_bwd.cu")).read()
    fns, scratch_fns = {}, {}
    for name, values in FLASH_BWD.items():
        src = set_constants(text, values, name)
        lib = build(f"flash_bwd_{name}", src, nvcc, flags)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.repro_flash_attention_bwd
        fn.argtypes = bwd_argtypes(src)
        fn.restype = ctypes.c_int
        fns[name] = fn
        fn = lib.repro_flash_attention_bwd_scratch
        fn.argtypes = [i, i, i]
        fn.restype = ctypes.c_longlong
        scratch_fns[name] = fn

    def call(name, q, k, v, o, dout, lse):
        b, s, H, d = q.shape
        out = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
        scratch = torch.empty(scratch_fns[name](b, H, s), device=q.device)
        rc = fns[name](*(t.data_ptr() for t in (q, k, v, o, dout, lse, scratch,
                                                *out)),
                       1, b, s, k.shape[1], H, k.shape[2],
                       *bwd_call_widths(fns[name], d, v.shape[-1]),
                       ctypes.c_float(d ** -0.5), 0,
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash bwd {name}: CUDA error {rc}")
        return out

    def draw_like_the_test(b, s, H, KV, d, seed, qk=1.0, vs=1.0):
        """tests/test_torch_flash_attention.py's ``bf16_qkv``."""
        import numpy as np

        rng = np.random.default_rng(seed)
        return [torch.tensor(amp * rng.standard_normal(shape)).bfloat16()
                .cuda() for shape, amp in (((b, s, H, d), qk),
                                           ((b, s, KV, d), qk),
                                           ((b, s, KV, d), vs))]

    def inputs():
        gen = torch.Generator(device="cuda").manual_seed(0)
        b, s, H, KV, d = 8, 2048, 32, 4, 128
        for qk, vs in ((1.0, 1.0), (30.0, 9.0)):
            q, k, v, dout = (
                (amp * torch.randn(shape, device="cuda", generator=gen)
                 ).bfloat16() for shape, amp in (
                    ((b, s, H, d), qk), ((b, s, KV, d), qk),
                    ((b, s, KV, d), vs), ((b, s, H, d), 1.0)))
            yield f"{b}x{s}x{H}/{KV}x{d} q,k x{qk:g} v x{vs:g}", True, (
                q, k, v, dout)
        q, k, v = draw_like_the_test(2, 2048, 8, 2, 128, 1, 30.0, 9.0)
        dout = draw_like_the_test(2, 2048, 8, 2, 128, 2)[0]
        yield "2x2048x8/2x128 q,k x30 v x9 (the emulation's inputs)", False, (
            q, k, v, dout)

    def rel_err(got, want):
        """Per output: max |err| / max |plain|; the same max |err| in bf16
        steps of max |plain|'s binade (the card's 2^-7 bound is 1 to 2 such
        steps: one step there always passes it, two always fail); and the
        worst |err| / (2e-2 + 2e-2 |plain|), the card's elementwise bound."""
        import math

        out = {"rel": [], "top_steps": [], "elem": []}
        for a, w in zip(got, want):
            err = (a.double() - w.double()).abs()
            top = float(w.double().abs().max())
            out["rel"].append(float(err.max()) / top)
            out["top_steps"].append(float(err.max()) / 2.0 ** (
                math.floor(math.log2(top)) - 7))
            out["elem"].append(float((err / (2e-2 + 2e-2 * w.double().abs()))
                                     .max()))
        return out

    result = {}
    for label, timed, (q, k, v, dout) in inputs():
        H, s, d = q.shape[2], q.shape[1], q.shape[3]
        o, lse = fcuda.flash_attention_cuda(q, k, v, return_lse=True)
        pos = torch.arange(s, device="cuda")
        o_ref, lse_ref = mha_streaming(q, expand_kv(k, H), expand_kv(v, H),
                                       pos, pos, d ** -0.5, return_lse=True)
        want = flash_attention_bwd_ref(q, k, v, o_ref, dout, lse_ref)
        entry = {}
        for name in fns:
            got = call(name, q, k, v, o, dout, lse)
            again = call(name, q, k, v, o, dout, lse)
            r = rel_err(got, want)
            entry[name] = {
                "rel_err": r["rel"], "top_steps": r["top_steps"],
                "elem": r["elem"],
                "bit_equal_runs": all(torch.equal(a, x)
                                      for a, x in zip(got, again))}
            del got, again
            got = call(name, q, k, v, o_ref.contiguous(), dout,
                       lse_ref.contiguous())
            r = rel_err(got, want)
            entry[name].update({"rel_err_plain_forward": r["rel"],
                                "top_steps_plain_forward": r["top_steps"],
                                "elem_plain_forward": r["elem"]})
            del got
        del want, o_ref, lse_ref
        if timed:
            times = in_turns({name: (lambda n=name: call(n, q, k, v, o, dout,
                                                         lse))
                              for name in fns}, 10)
            for name in fns:
                entry[name]["ms"] = times[name]
                entry[name]["device_ms"] = kernel_device_ms(
                    lambda n=name: call(n, q, k, v, o, dout, lse), 5)

        def line(e):
            def three(key):
                return "/".join(f"{x:.3g}" for x in e[key])

            out = (f"dq/dk/dv {three('rel_err')}, top steps "
                   f"{three('top_steps')}, elementwise {three('elem')} "
                   f"(plain forward's O, lse: {three('rel_err_plain_forward')}"
                   f", top steps {three('top_steps_plain_forward')}, "
                   f"elementwise {three('elem_plain_forward')}), bit-equal "
                   f"{e['bit_equal_runs']}")
            if "ms" in e:
                out += (", ms " + " / ".join(f"{t:.4f}" for t in e["ms"])
                        + ", device " + ", ".join(
                            f"{k} {t:.4f}" for k, t in e["device_ms"].items()))
            return out

        print(f"flash_attention_bwd {label} (bound 2^-7 = {2.0 ** -7:.4g} of "
              "max |plain|): " + "; ".join(f"{n} {line(e)}"
                                           for n, e in entry.items()),
              flush=True)
        result[label] = entry
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    return result


# mma.sync m16n8k8 TF32 alone: each warp runs rounds of `chains`
# independent accumulators, so that the tensor cores' rate and one product's
# latency show apart from any kernel's loads and splits
MMA_PEAK_SOURCE = r"""
#include <cuda_runtime.h>
template <int CH>
__global__ void peak(float* out, int iters) {
  float c[CH][4] = {};
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, 7u};
  unsigned b0 = threadIdx.x * 11u, b1 = 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CH; ++k)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CH; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(float* out, int chains, int blocks, int threads,
                        int iters, cudaStream_t stream) {
  switch (chains) {
    case 1: peak<1><<<blocks, threads, 0, stream>>>(out, iters); break;
    case 2: peak<2><<<blocks, threads, 0, stream>>>(out, iters); break;
    case 4: peak<4><<<blocks, threads, 0, stream>>>(out, iters); break;
    case 8: peak<8><<<blocks, threads, 0, stream>>>(out, iters); break;
    default: return 1;
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_tf32_peak(nvcc, flags):
    """The rate of ``mma.sync.m16n8k8`` in TF32 on this card: one block of
    256 threads an SM (2 warps a scheduler, as the float32 flash backward
    runs) with 1, 2, 4 and 8 independent accumulators a warp, and two blocks
    an SM with 4; TFLOP/s and clocks a product a scheduler at the SM clock
    ``nvidia-smi`` reads (clocks.sm) after the runs."""
    import torch

    fn = build("mma_tf32_peak", MMA_PEAK_SOURCE, nvcc, flags).mma_peak
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, device="cuda")
    result = {}
    for chains, blocks in ((1, sms), (2, sms), (4, sms), (8, sms),
                           (4, 2 * sms)):
        iters = 20000 // chains

        def run():
            rc = fn(out.data_ptr(), chains, blocks, 256, iters,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"mma_peak: CUDA error {rc}")
        ms = device_ms(run, 3)
        result[f"{chains} chains, {blocks // sms} block(s) an SM"] = {
            "ms": ms, "tflops": blocks * 8 * iters * chains * 2048 / ms / 1e9,
            "mma_per_scheduler": blocks * 8 * iters * chains / (4 * sms)}
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    for label, r in result.items():
        r["clocks_per_mma"] = r["ms"] * 1e-3 * clock * 1e6 / r["mma_per_scheduler"]
        print(f"mma.sync m16n8k8 tf32, {label}: {r['tflops']:.1f} TFLOP/s, "
              f"{r['clocks_per_mma']:.2f} clocks a product a scheduler at "
              f"{clock:.0f} MHz", flush=True)
    return result


# accumulate's A fragments as committed, from the registers as they stand
F32_A_SPLIT = """  unsigned ah[N / 8][4], al[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split_rn(a[j][0], ah[j][0], al[j][0]);
    split_rn(a[j][2], ah[j][1], al[j][1]);
    split_rn(a[j][1], ah[j][2], al[j][2]);
    split_rn(a[j][3], ah[j][3], al[j][3]);
  }
"""
# the same through shared memory, read back in the natural k order
F32_A_TRIP = """  __shared__ float trip[8][16][N + 4];
  float(*tw)[N + 4] = trip[(threadIdx.x >> 5) & 7];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    tw[g][8 * j + 2 * q] = a[j][0];
    tw[g][8 * j + 2 * q + 1] = a[j][1];
    tw[g + 8][8 * j + 2 * q] = a[j][2];
    tw[g + 8][8 * j + 2 * q + 1] = a[j][3];
  }
  __syncwarp();
  unsigned ah[N / 8][4], al[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split_rn(tw[g][8 * j + q], ah[j][0], al[j][0]);
    split_rn(tw[g + 8][8 * j + q], ah[j][1], al[j][1]);
    split_rn(tw[g][8 * j + q + 4], ah[j][2], al[j][2]);
    split_rn(tw[g + 8][8 * j + q + 4], ah[j][3], al[j][3]);
  }
"""
# two_scores' products of one 16-d block as committed: a sum for each of
# the two products, three dependent mma a step
F32_SCORE_CHAINS = """      float bs[4], bt[4];
      mma_zero(bs, xl[0], yh[0], yh[1]);
      mma_zero(bt, ul[0], wh[0], wh[1]);
      mma_acc(bs, xh[0], yl[0], yl[1]);
      mma_acc(bt, uh[0], wl[0], wl[1]);
      mma_acc(bs, xh[0], yh[0], yh[1]);
      mma_acc(bt, uh[0], wh[0], wh[1]);
      mma_acc(bs, xl[1], yh[2], yh[3]);
      mma_acc(bt, ul[1], wh[2], wh[3]);
      mma_acc(bs, xh[1], yl[2], yl[3]);
      mma_acc(bt, uh[1], wl[2], wl[3]);
      mma_acc(bs, xh[1], yh[2], yh[3]);
      mma_acc(bt, uh[1], wh[2], wh[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fadd_rn(s[j][e], bs[e]);
        t[j][e] = __fadd_rn(t[j][e], bt[e]);
      }
"""
# the same with hi hi and the cross terms in sums of their own: four
# chains of two and four mma instead of two of six
F32_SCORE_4CHAINS = """      float bs[4], bt[4], cs[4], ct[4];
      mma_zero(bs, xh[0], yh[0], yh[1]);
      mma_zero(bt, uh[0], wh[0], wh[1]);
      mma_zero(cs, xl[0], yh[0], yh[1]);
      mma_zero(ct, ul[0], wh[0], wh[1]);
      mma_acc(bs, xh[1], yh[2], yh[3]);
      mma_acc(bt, uh[1], wh[2], wh[3]);
      mma_acc(cs, xh[0], yl[0], yl[1]);
      mma_acc(ct, uh[0], wl[0], wl[1]);
      mma_acc(cs, xl[1], yh[2], yh[3]);
      mma_acc(ct, ul[1], wh[2], wh[3]);
      mma_acc(cs, xh[1], yl[2], yl[3]);
      mma_acc(ct, uh[1], wl[2], wl[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fadd_rn(s[j][e], __fadd_rn(bs[e], cs[e]));
        t[j][e] = __fadd_rn(t[j][e], __fadd_rn(bt[e], ct[e]));
      }
"""
# one score product alone, put before ``accumulate`` for the variants that
# take S and dP one after the other
F32_SCORE_FN = """// s = X Y^T alone, as two_scores computes it
template <int D, int N>
__device__ __forceinline__ void score(const float* X, const float* Y, int x0,
                                      float (&s)[N / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = 16 * kk + 4 * q;
    unsigned xh[2][4], xl[2][4];
    {
      unsigned h0[4], l0[4], h8[4], l8[4];
      split4(ld4(X + at<D>(x0 + g, col)), h0, l0);
      split4(ld4(X + at<D>(x0 + g + 8, col)), h8, l8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xh[h][0] = h0[2 * h], xh[h][1] = h8[2 * h];
        xh[h][2] = h0[2 * h + 1], xh[h][3] = h8[2 * h + 1];
        xl[h][0] = l0[2 * h], xl[h][1] = l8[2 * h];
        xl[h][2] = l0[2 * h + 1], xl[h][3] = l8[2 * h + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      unsigned yh[4], yl[4];
      split4(ld4(Y + at<D>(8 * j + g, col)), yh, yl);
      float bs[4];
      mma_zero(bs, xl[0], yh[0], yh[1]);
      mma_acc(bs, xh[0], yl[0], yl[1]);
      mma_acc(bs, xh[0], yh[0], yh[1]);
      mma_acc(bs, xl[1], yh[2], yh[3]);
      mma_acc(bs, xh[1], yl[2], yl[3]);
      mma_acc(bs, xh[1], yh[2], yh[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(s[j][e], bs[e]);
    }
  }
}

"""
F32_ACC_HEAD = "// acc += A Z over N rows of Z, A (16 x N) in two_scores' accumulator"
# in_order's loop head as committed
F32_IN_ORDER_LOOP = "  for (int c = 1; c <= DU / 4; ++c) {\n    const int n = c < DX / 4"
# in_order's loop as committed (4 d an iteration), and the same 8 d an
# iteration (the same FMAs in the same order)
F32_IN_ORDER_BODY4 = """  // the next 4 d's loads issued before this 4's FMAs
  float4 a = ld4(q + (sq << 2)), b = ld4(k + (sk << 2));
  float4 u = ld4(g + (sq << 2)), w = ld4(v + (sk << 2));
  for (int c = 1; c <= DU / 4; ++c) {
    const int n = c < DX / 4 ? c : 0;
    const int m = c < DU / 4 ? c : 0;
    const float4 a1 = ld4(q + ((n ^ sq) << 2)), b1 = ld4(k + ((n ^ sk) << 2));
    const float4 u1 = ld4(g + ((m ^ sq) << 2)), w1 = ld4(v + ((m ^ sk) << 2));
    s = __fmaf_rn(a.x, b.x, s);
    s = __fmaf_rn(a.y, b.y, s);
    s = __fmaf_rn(a.z, b.z, s);
    s = __fmaf_rn(a.w, b.w, s);
    d = __fmaf_rn(u.x, w.x, d);
    d = __fmaf_rn(u.y, w.y, d);
    d = __fmaf_rn(u.z, w.z, d);
    d = __fmaf_rn(u.w, w.w, d);
    a = a1, b = b1, u = u1, w = w1;
  }
  for (int c = DU / 4 + 1; c <= DX / 4; ++c) {
    const int n = c < DX / 4 ? c : 0;
    const float4 a1 = ld4(q + ((n ^ sq) << 2)), b1 = ld4(k + ((n ^ sk) << 2));
    s = __fmaf_rn(a.x, b.x, s);
    s = __fmaf_rn(a.y, b.y, s);
    s = __fmaf_rn(a.z, b.z, s);
    s = __fmaf_rn(a.w, b.w, s);
    a = a1, b = b1;
  }
"""
F32_IN_ORDER_BODY8 = """  float4 a[2], b[2], u[2], w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = ld4(q + ((h ^ sq) << 2)), b[h] = ld4(k + ((h ^ sk) << 2));
    u[h] = ld4(g + ((h ^ sq) << 2)), w[h] = ld4(v + ((h ^ sk) << 2));
  }
  for (int c = 2; c <= DX / 4; c += 2) {
    const int n = c < DX / 4 ? c : 0;
    const int m = c < DU / 4 ? c : 0;
    const bool on = c <= DU / 4;          // these 8 d lie below DU
    float4 a1[2], b1[2], u1[2], w1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a1[h] = ld4(q + (((n + h) ^ sq) << 2));
      b1[h] = ld4(k + (((n + h) ^ sk) << 2));
      u1[h] = ld4(g + (((m + h) ^ sq) << 2));
      w1[h] = ld4(v + (((m + h) ^ sk) << 2));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s = __fmaf_rn(a[h].x, b[h].x, s);
      s = __fmaf_rn(a[h].y, b[h].y, s);
      s = __fmaf_rn(a[h].z, b[h].z, s);
      s = __fmaf_rn(a[h].w, b[h].w, s);
      if (on) {
        d = __fmaf_rn(u[h].x, w[h].x, d);
        d = __fmaf_rn(u[h].y, w[h].y, d);
        d = __fmaf_rn(u[h].z, w[h].z, d);
        d = __fmaf_rn(u[h].w, w[h].w, d);
      }
      a[h] = a1[h], b[h] = b1[h], u[h] = u1[h], w[h] = w1[h];
    }
  }
"""
# the float32 backward's variants (csrc/flash_attention_bwd.cu, tf32x3):
# {variant: ({constant: value}, [(committed text, replacement), ...])}
FLASH_BWD_F32 = {
    "committed": ({}, []),
    "ring2": ({"kDqRing": 2, "kKvRing": 2}, []),
    "kv_rows16": ({"kKvRows": 16}, []),
    "dq_64x64": ({"kDqRows": 64, "kDqKeys": 64, "kDqRing": 2}, []),
    "kv_64x64": ({"kKvKeys": 64, "kKvRows": 64, "kKvRing": 2}, []),
    "kk_unrolled": ({}, [("#pragma unroll 1\n  for (int kk = 0; kk < DU / 16; ++kk) {\n    const int col = 16 * kk + 4 * q;\n    // A of step h",
                          "#pragma unroll\n  for (int kk = 0; kk < DU / 16; ++kk) {\n    const int col = 16 * kk + 4 * q;\n    // A of step h")]),
    "kk_unroll2": ({}, [("#pragma unroll 1\n  for (int kk = 0; kk < DU / 16; ++kk) {\n    const int col = 16 * kk + 4 * q;\n    // A of step h",
                         "#pragma unroll 2\n  for (int kk = 0; kk < DU / 16; ++kk) {\n    const int col = 16 * kk + 4 * q;\n    // A of step h")]),
    # P and dS through shared memory (a warp's 16 rows, 18 KB a block, so
    # with a ring of two: compare with ring2) and back as the A fragment,
    # with B's rows in their natural order (k = q row q, k = q + 4 row q +
    # 4), where the committed kernel permutes the contraction and reads the
    # registers as they stand
    "smem_trip": ({"kDqRing": 2, "kKvRing": 2}, [(F32_A_SPLIT, F32_A_TRIP),
                       ("at<D>(8 * j + 2 * q, 32 * cg", "at<D>(8 * j + q, 32 * cg"),
                       ("at<D>(8 * j + 2 * q + 1, 32 * cg",
                        "at<D>(8 * j + q + 4, 32 * cg")]),
    # the score products' sums split likewise: four chains of two and four
    "score_4chains": ({}, [(F32_SCORE_CHAINS, F32_SCORE_4CHAINS)]),
    # accumulate's hi hi apart from the cross terms (kApart) in dq too, or
    # in neither kernel
    "dq_apart": ({}, [("accumulate<DQK, kDqKeys, false>",
                       "accumulate<DQK, kDqKeys, true>")]),
    "none_apart": ({}, [("accumulate<DV, kKvRows, true>",
                         "accumulate<DV, kKvRows, false>"),
                        ("accumulate<DQK, kKvRows, true>",
                         "accumulate<DQK, kKvRows, false>")]),
    # S and dP (S^T and dP^T) one after the other, each its own pass over D
    "dq_one_score": ({}, [(F32_ACC_HEAD, F32_SCORE_FN + F32_ACC_HEAD), (
        "two_scores<DQK, DV, kDqKeys>(Qs, kt, Gs, Vs + st * kVTile, x0, sc, dp);",
        "score<DQK, kDqKeys>(Qs, kt, x0, sc);\n"
        "    score<DV, kDqKeys>(Gs, Vs + st * kVTile, x0, dp);")]),
    "kv_one_score": ({}, [(F32_ACC_HEAD, F32_SCORE_FN + F32_ACC_HEAD), (
        "two_scores<DQK, DV, kKvRows>(Ks, qt, Vs, gt, x0, sc, dp);",
        "score<DQK, kKvRows>(Ks, qt, x0, sc);\n"
        "    score<DV, kKvRows>(Vs, gt, x0, dp);")]),
    # the large P's S and dP summed again in order: out of line (a call a
    # lane), never (no check, no loop: wrong at the random-weight scale),
    # above 4 instead of 1; dkdv summing its own again, not taking dq's
    # slot; 8 d an iteration instead of 4
    "redo_call": ({}, [("__device__ __forceinline__ float2 in_order(",
                        "__device__ __noinline__ float2 in_order(")]),
    "no_redo": ({}, [(
        "        if (p * fabsf(x) > kRedo) redo |= 1u << (4 * j + e);\n",
        "")]),
    "redo4": ({}, [("constexpr float kRedo = 1.f;",
                    "constexpr float kRedo = 4.f;")]),
    "kv_no_slot": ({}, [("__float_as_int(rs[2 * kKvRows + c]) == k0 + kr",
                         "false")]),
    "in_order_8d": ({}, [(F32_IN_ORDER_BODY4, F32_IN_ORDER_BODY8)]),
    # diagnostics, wrong where a pair is summed again (held to nothing):
    # in_order's loop left out, or over half of d
    "diag_no_chain": ({}, [(F32_IN_ORDER_LOOP,
                            "  for (int c = 1; c <= 0; ++c) {\n"
                            "    const int n = c < DX / 4")]),
    "diag_half_chain": ({}, [(F32_IN_ORDER_LOOP,
                              "  for (int c = 1; c <= DU / 8; ++c) {\n"
                              "    const int n = c < DX / 4")]),
    # the high parts cut (tf32::split) instead of rounded: one IADD less a
    # value, about twice the error at the random-weight models' scale
    "cut_split": ({}, [("  split_rn(v.x", "  tf32::split(v.x"),
                       ("  split_rn(v.y", "  tf32::split(v.y"),
                       ("  split_rn(v.z", "  tf32::split(v.z"),
                       ("  split_rn(v.w", "  tf32::split(v.w"),
                       ("    split_rn(a[j]", "    tf32::split(a[j]")]),
}


def flash_bwd_f32_variants(nvcc, flags):
    """The float32 backward at yi-9b's training shape (8 x 2048 x 32/4 x
    128, causal) on two input sets from a seed: unit scale, and bf16 values
    with q and k at 30x and v at 9x (layer 0's float32 check takes the
    training run's bf16 values at the random-weight scale, where each
    row's largest P takes its S summed in order again).  Each variant of
    ``FLASH_BWD_F32`` and, with ``--parent``, the parent commit's kernels,
    against the plain backward given the plain forward's O and lse (each
    output's max |err| over its max |plain|; within 1e-4 with two runs
    bit-equal on unit inputs, and the committed kernel on both), then timed
    with CUDA events in turns beside SDPA's efficient backward (forward +
    backward less forward, kv heads repeated), and each of its two kernels
    by torch.profiler.  A variant that does not build (its tiles past the
    227 KB of shared memory) is reported and left out."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import cuda as fcuda
    from repro_torch.kernels.flash_attention.ops import expand_kv
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        mha_streaming,
    )
    from repro_torch.models.layers import pin_matmul_precision

    pin_matmul_precision()
    text = open(os.path.join(CSRC, "flash_attention_bwd.cu")).read()
    sources = {name: _substitute(set_constants(text, values, name), edits,
                                 "flash_attention_bwd.cu")
               for name, (values, edits) in FLASH_BWD_F32.items()}
    if PARENT:
        sources["parent"] = parent_source(
            "src/repro_torch/csrc/flash_attention_bwd.cu")
    fns, scratch_fns = {}, {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, src in sources.items():
        try:
            lib = build(f"flash_bwd_f32_{name}", src, nvcc, flags)
        except RuntimeError as e:
            if name == "committed":
                raise
            print(f"{name}: not built ({str(e).splitlines()[-1]})",
                  flush=True)
            continue
        fns[name] = lib.repro_flash_attention_bwd
        fns[name].argtypes = bwd_argtypes(src)
        fns[name].restype = ctypes.c_int
        scratch_fns[name] = lib.repro_flash_attention_bwd_scratch
        scratch_fns[name].argtypes = [i, i, i]
        scratch_fns[name].restype = ctypes.c_longlong

    def call(name, q, k, v, o, dout, lse):
        b, s, H, d = q.shape
        out = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
        scratch = torch.empty(scratch_fns[name](b, H, s), device=q.device)
        rc = fns[name](*(t.data_ptr() for t in (q, k, v, o, dout, lse, scratch,
                                                *out)),
                       0, b, s, k.shape[1], H, k.shape[2],
                       *bwd_call_widths(fns[name], d, v.shape[-1]),
                       ctypes.c_float(d ** -0.5), 0,
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash bwd f32 {name}: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, H, KV, d = 8, 2048, 32, 4, 128
    pos = torch.arange(s, device="cuda")
    out = {}
    for label, qk, vs, bf16 in (("unit", 1.0, 1.0, False),
                                ("bf16 values, q k x30, v x9", 30.0, 9.0,
                                 True)):
        q, k, v, dout = (
            amp * torch.randn(shape, device="cuda", generator=gen)
            for shape, amp in (((b, s, H, d), qk), ((b, s, KV, d), qk),
                               ((b, s, KV, d), vs), ((b, s, H, d), 1.0)))
        if bf16:            # as layer 0's float32 check takes them
            q, k, v, dout = (x.bfloat16().float() for x in (q, k, v, dout))
        o, lse = fcuda.flash_attention_cuda(q, k, v, return_lse=True)
        o_ref, lse_ref = mha_streaming(q, expand_kv(k, H), expand_kv(v, H),
                                       pos, pos, d ** -0.5, return_lse=True)
        want = flash_attention_bwd_ref(q, k, v, o_ref, dout, lse_ref)
        result = {}
        for name in fns:
            got = call(name, q, k, v, o, dout, lse)
            again = call(name, q, k, v, o, dout, lse)
            rel = [float((a - w).abs().max() / w.abs().max())
                   for a, w in zip(got, want)]
            equal = all(torch.equal(a, x) for a, x in zip(got, again))
            held = name == "committed" or (label == "unit"
                                           and not name.startswith("diag_"))
            if held and (max(rel) > 1e-4 or not equal):
                raise AssertionError(f"flash bwd f32 {name} ({label}): "
                                     f"dq/dk/dv {rel} of max |plain|, "
                                     f"bit-equal runs {equal}")
            result[name] = {"rel_err": rel}
            del got, again
        del want, o_ref, lse_ref
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, expand_kv(k, H), expand_kv(v, H))]
        grad = dout.transpose(1, 2)

        def sdpa_forward():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(*leaves, is_causal=True)

        def sdpa_forward_backward():
            sdpa_forward().backward(grad)
            for x in leaves:
                x.grad = None

        calls = {name: (lambda n=name: call(n, q, k, v, o, dout, lse))
                 for name in fns}
        calls["sdpa_forward_backward"] = sdpa_forward_backward
        times = in_turns(calls, 5)
        with torch.no_grad():
            forward_ms = device_ms(sdpa_forward, 5)
        for name in fns:
            result[name]["ms"] = times[name]
            result[name]["device_ms"] = kernel_device_ms(calls[name], 5)
        result["sdpa_efficient"] = {
            "ms": [t - forward_ms for t in times["sdpa_forward_backward"]]}
        print(f"flash_attention_bwd float32 {b}x{s}x{H}/{KV}x{d} causal, "
              f"{label}: " + "; ".join(
                  f"{n} ms {' / '.join(f'{x:.4f}' for x in e['ms'])}"
                  + (f" (device {', '.join(f'{k} {x:.4f}' for k, x in e['device_ms'].items())}; "
                     f"dq/dk/dv {'/'.join(f'{x:.3g}' for x in e['rel_err'])} "
                     "of max |plain|)" if "device_ms" in e
                     else " (backward alone)")
                  for n, e in result.items()), flush=True)
        out[label] = result
        del q, k, v, dout, o, lse, leaves, grad, calls
        torch.cuda.empty_cache()
    return out


# the float32 kernel's q k^T loop and loop heads as committed
F32_QK = """#pragma unroll 2
    for (int d4 = 0; d4 < DQK; d4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load4(Qs + (ty * 8 + i) * DQK + d4);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 kk =
            load4(Kt + (tx + 16 * j) * DQK + (((d4 >> 2) ^ sw) << 2));
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = __fmaf_rn(comp(a[i], e), comp(kk, e), s[i][j]);
      }
    }
"""
# the same products with the KJ k float4 loaded first, then one q float4
# at a time: 4 KJ + 4 fragment registers instead of 32 + 4
F32_QK_K_FIRST = """#pragma unroll 2
    for (int d4 = 0; d4 < DQK; d4 += 4) {
      float4 kf[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kf[j] = load4(Kt + (tx + 16 * j) * DQK + (((d4 >> 2) ^ sw) << 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = load4(Qs + (ty * 8 + i) * DQK + d4);
#pragma unroll
        for (int j = 0; j < KJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = __fmaf_rn(comp(a, e), comp(kf[j], e), s[i][j]);
      }
    }
"""
F32_PV = "#pragma unroll 8\n    for (int kk = 0; kk < BK; ++kk) {"
F32_MASK = """        const int col = k0 + tx + 16 * j;
        bool valid = col < Tk && col <= row;
        if (window > 0) valid = valid && col > row - window;
        if (!valid) s[i][j] = kNegInf;
"""
# the mask only in tiles that the key end, the diagonal or the window's
# edge cut
F32_MASK_CUT = """        if (k0 + BK > Tk || k0 + BK - 1 > q0 ||
            (window > 0 && k0 <= q0 + BQ - 1 - window)) {
""" + F32_MASK + "        }\n"
F32_TILE = "constexpr int BQ = 128;             // queries of a block\n"


def flash_f32_variants(nvcc, flags):
    """The float32 kernel at prefill_32k (8 x 32768 x 128, causal and a
    4096 window), each variant held to the plain streaming form within
    2e-5, timed in turns beside SDPA's efficient backend."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention.ref import mha_streaming
    from repro_torch.models.layers import pin_matmul_precision

    pin_matmul_precision()
    text = open(os.path.join(ROOT, "src/repro_torch/csrc/flash_attention.cu")
                ).read()
    if not all(t in text for t in (F32_QK, F32_PV, F32_TILE, F32_MASK)):
        raise RuntimeError("flash_attention.cu no longer has the float32 "
                           "loops this script edits")

    k_first = text.replace(F32_QK, F32_QK_K_FIRST)
    variants = {
        "committed": text,
        "mask_cut_tiles": text.replace(F32_MASK, F32_MASK_CUT),
        "k_first": text.replace(F32_QK, F32_QK_K_FIRST),
        # blocks of 64 queries (4 warps), 132 KB of shared memory: one SM
        # holds one of them all the same
        "bq64": text.replace(F32_TILE, F32_TILE.replace("128;", "64; ")),
        "pv_unroll4": text.replace(F32_PV, F32_PV.replace("unroll 8",
                                                          "unroll 4")),
    }
    fns = {}
    for name, src in variants.items():
        fn = build(f"flash_f32_{name}", src, nvcc, flags).repro_flash_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, q, k, v, window):
        b, s, H, d = q.shape
        o = torch.empty_like(q)
        rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       None,
                       0, b, s, k.shape[1], H, k.shape[2], d, d,
                       ctypes.c_float(d ** -0.5), window or 0,
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash f32 {name}: CUDA error {rc}")
        return o

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, d = 8, 32768, 128
    q, k, v = (torch.randn((b, s, 1, d), device="cuda", generator=gen)
               for _ in range(3))
    pos = torch.arange(s, device="cuda")
    result = {}
    for window in (None, 4096):
        want = mha_streaming(q, k, v, pos, pos, d ** -0.5, window=window)
        label = f"{b}x{s}x1x{d}" + (f" window {window}" if window else "")
        entry = {}
        for name in fns:
            err = float((call(name, q, k, v, window) - want).abs().max())
            if err > 2e-5:
                raise AssertionError(f"flash f32 {name} {label}: max |err| "
                                     f"{err:g}")
            entry[name] = {"max_abs_err": err}
        del want
        times = in_turns({name: (lambda n=name: call(n, q, k, v, window))
                          for name in fns}, 2)
        for name in fns:
            entry[name]["ms"] = times[name]
        if window is None:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
            entry["sdpa_efficient"] = {"ms": [device_ms(sdpa, 2)]}
        print(f"flash_attention float32 {label}: ms " + ", ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in e['ms'])}"
            for n, e in entry.items()), flush=True)
        result[label] = entry
    return result


def _substitute(text, edits, what):
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{what} no longer has {old!r}")
        text = text.replace(old, new)
    return text


def wkv_variants(nvcc, flags):
    """The chunked WKV kernel at the rwkv6-7b prefill (8 x 4096 x 64 heads
    of 64) and at a ragged T: each variant's relative error on outputs and
    final state against the plain recurrence's largest entry, on drawn
    inputs with w = 0 in some channels (the committed kernel must stay
    within 2e-4; a variant's error is reported beside its time); timed in
    turns.  (Chunks of 8 and 32, a V split over two blocks and the
    products on CUDA cores lost to this design: PERF.md has their times,
    the history of rwkv_scan.cu their code.)"""
    import torch

    from repro_torch.kernels.rwkv_scan.ref import wkv_ref

    text = open(os.path.join(ROOT, "src/repro_torch/csrc/rwkv_scan.cu")
                ).read()
    variants = {
        "committed": [],
        "tf32_one": [("  mma_tf32(c, al, bh0, bh1);\n"
                      "  mma_tf32(c, ah, bl0, bl1);\n", "")],
        "min_blocks3": [("kMinBlocks = 4;", "kMinBlocks = 3;")],
    }
    fns = {}
    for name, edits in variants.items():
        src = _substitute(text, edits, "rwkv_scan.cu")
        fn = build(f"wkv_{name}", src, nvcc, flags).repro_rwkv_wkv
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, r, k, v, w, u):
        B, T, H, K = r.shape
        out = torch.empty_like(v)
        state = torch.empty((B, H, K, K), device=r.device)
        rc = fns[name](r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                       u.data_ptr(), out.data_ptr(), state.data_ptr(), B, T,
                       H, K, K, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"wkv {name}: CUDA error {rc}")
        return out, state

    def plain(r, k, v, w, u):
        B, T, H, K = r.shape
        heads = [t.transpose(1, 2).reshape(B * H, T, K) for t in (r, k, v, w)]
        out, state = wkv_ref(*heads, u.expand(B, H, K).reshape(B * H, K))
        return (out.reshape(B, H, T, K).transpose(1, 2),
                state.reshape(B, H, K, K))

    gen = torch.Generator(device="cuda").manual_seed(5)

    def draw(shape, std):
        return std * torch.randn(shape, device="cuda", generator=gen)

    result = {}
    for B, T, H in ((8, 4096, 64), (2, 650, 4)):
        r, k, v = (draw((B, T, H, 64), 0.5) for _ in range(3))
        w = torch.sigmoid(draw((B, T, H, 64), 2.0))
        w[:, ::7, :, ::5] = 0.0                  # exp(-exp(x)) underflows
        u = draw((H, 64), 0.3)
        want_out, want_state = plain(r, k, v, w, u)
        label = f"{B}x{T}x{H}x64"
        entry = {}
        for name in fns:
            out, state = call(name, r, k, v, w, u)
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in ((out, want_out), (state, want_state))]
            if name == "committed" and max(errs) >= 2e-4:
                raise AssertionError(f"wkv {name} {label}: relative errors "
                                     f"{errs}")
            entry[name] = {"rel_err_out": errs[0], "rel_err_state": errs[1]}
        del want_out, want_state
        times = in_turns({name: (lambda n=name: call(n, r, k, v, w, u))
                          for name in fns}, 10 if T == 4096 else 50)
        for name in fns:
            entry[name]["ms"] = times[name]
        print(f"rwkv_wkv {label}: " + ", ".join(
            f"{n} ms {' / '.join(f'{t:.4f}' for t in e['ms'])} (errors "
            f"{e['rel_err_out']:.3g}, {e['rel_err_state']:.3g})"
            for n, e in entry.items()), flush=True)
        result[label] = entry
        del r, k, v, w
        torch.cuda.empty_cache()
    return result


def wkv_bwd_variants(nvcc, flags):
    """The WKV backward (``src/repro_torch/csrc/rwkv_scan_bwd.cu``) at the
    rwkv6-7b training step (8 x 2048 x 64 heads of 64): the committed
    kernel, its cluster barrier with release semantics (a release waits
    for every outstanding global store and copy; the committed design
    orders only buffer reuse with it and sends dv's partials by st.async),
    its first pass with a ring of three chunks instead of two, and, with
    ``--parent``, the parent commit's kernel.  Each against the plain
    reverse recurrence on drawn inputs (2 x 650 x 4, w = 0 in some
    channels; the committed kernel within 2e-4 of each output's max
    |plain|), then all timed in turns."""
    import torch

    from repro_torch.kernels.rwkv_scan.ref import wkv_bwd_ref

    text = open(os.path.join(CSRC, "rwkv_scan_bwd.cu")).read()
    variants = {
        "committed": text,
        "release_arrive": _substitute(
            text, [("barrier.cluster.arrive.relaxed.aligned",
                    "barrier.cluster.arrive.release.aligned")],
            "rwkv_scan_bwd.cu"),
        "states_ring3": _substitute(
            text, [("kStatesStages = 2;", "kStatesStages = 3;")],
            "rwkv_scan_bwd.cu"),
    }
    if PARENT:
        variants["parent"] = parent_source(
            "src/repro_torch/csrc/rwkv_scan_bwd.cu")
    fns = {}
    for name, src in variants.items():
        fn = build(f"wkv_bwd_{name}", src, nvcc, flags).repro_rwkv_wkv_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, r, k, v, w, u, dout):
        B, T, H, K = r.shape
        ckpt = torch.empty((B * H * -(-T // 16), K, K), device=r.device)
        du_part = torch.empty((B, H, K), device=r.device)
        grads = [torch.empty_like(r) for _ in range(4)]
        du = torch.empty_like(u)
        rc = fns[name](*(t.data_ptr() for t in (r, k, v, w, u, dout, ckpt,
                                                du_part, *grads, du)),
                       B, T, H, K, K, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"wkv_bwd {name}: CUDA error {rc}")
        return (*grads, du)

    def plain(r, k, v, w, u, dout):
        B, T, H, K = r.shape

        def hf(x):
            return x.transpose(1, 2).reshape(B * H, T, K)

        out = wkv_bwd_ref(*(hf(x) for x in (r, k, v, w)),
                          u.expand(B, H, K).reshape(B * H, K), hf(dout))
        return (*(x.reshape(B, H, T, K).transpose(1, 2) for x in out[:4]),
                out[4].reshape(B, H, K).sum(0))

    gen = torch.Generator(device="cuda").manual_seed(7)

    def inputs(B, T, H):
        def draw(std):
            return std * torch.randn((B, T, H, 64), device="cuda",
                                     generator=gen)
        w = torch.sigmoid(draw(3.0))
        w[:, ::3, :, ::2] = 0.0
        u = 0.3 * torch.randn((H, 64), device="cuda", generator=gen)
        return draw(0.5), draw(0.5), draw(0.5), w, u, draw(1.0)

    args = inputs(2, 650, 4)
    want = plain(*args)
    result = {}
    for name in fns:
        got = call(name, *args)
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
        if name == "committed" and err >= 2e-4:
            raise AssertionError(f"wkv_bwd {name}: relative error {err}")
        result[name] = {"rel_err": err}
    args = inputs(8, 2048, 64)
    times = in_turns({name: (lambda n=name: call(n, *args)) for name in fns},
                     5)
    for name in fns:
        result[name]["ms"] = times[name]
    print("rwkv_wkv_bwd 8x2048x64x64: " + ", ".join(
        f"{n} ms {' / '.join(f'{t:.4f}' for t in e['ms'])} (error "
        f"{e['rel_err']:.3g})" for n, e in result.items()), flush=True)
    return result


def haar_variants(nvcc, flags):
    """The Haar stage at the funnel's shapes (the full-width executor of
    ``assets/fa_reference.npz``: stage 0 at S = 1 and S = 64, stage 1 at
    S = 1), each variant bit-equal to the plain version, timed in turns;
    the ``global_path`` variant is the one-thread-a-slot kernel of every
    stage before the table path."""
    import torch

    from repro_torch.bridge import load_fa_reference
    from repro_torch.camera.pipelines import FaceAuthExecutor
    from repro_torch.camera.synthetic import security_video
    from repro_torch.kernels.haar_frontend.ref import haar_stage_ref

    text = open(os.path.join(ROOT, "src/repro_torch/csrc/haar_stage.cu")
                ).read()
    variants = {
        "committed": [],
        "windows2": [("kWindows = 4;", "kWindows = 2;")],
        "windows1": [("kWindows = 4;", "kWindows = 1;")],
        "one_block_a_frame": [("int split = sms / rows;", "int split = 1;")],
        "table_small_caps": [("kTableMinCap = 2048;", "kTableMinCap = 1;")],
        "global_path": [("kTableMinCap = 2048;", "kTableMinCap = 1 << 30;")],
    }
    fns = {}
    for name, edits in variants.items():
        src = _substitute(text, edits, "haar_stage.cu")
        fn = build(f"haar_{name}", src, nvcc, flags).repro_haar_stage
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, i, p, i, p, p, p, p, i, p, p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, ii, items, offsets, weights, thresholds, polarity,
             alphas):
        rows, L = ii.shape
        n_scales, sz, _ = offsets.shape
        out = torch.empty(items.shape[:2], device=ii.device)
        rc = fns[name](ii.data_ptr(), L, items.data_ptr(), rows,
                       items.shape[1], offsets.data_ptr(), n_scales,
                       weights.data_ptr(), thresholds.data_ptr(),
                       polarity.data_ptr(), alphas.data_ptr(), sz,
                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"haar {name}: CUDA error {rc}")
        return out

    ref = load_fa_reference(device="cuda")
    frames_np, _truth = security_video(**ref.video)
    frames = torch.as_tensor(frames_np, device="cuda")
    ex = FaceAuthExecutor(ref.cascade, ref.nn, frames.shape[1],
                          frames.shape[2], device="cuda", **ref.scan)
    ex.calibrate(frames)
    det = ex.det
    result = {}
    for streams, stage in ((1, 0), (64, 0), (1, 1)):
        feeds = torch.stack([torch.roll(frames, 5 * s, dims=0)
                             for s in range(streams)])
        mframes = ex.stages.motion(feeds)[0]
        ii, ii2 = det.integrals(mframes.reshape(-1, *mframes.shape[-2:]))
        items = det.items(ii, ii2)[:, :det.capacities[stage]].contiguous()
        tables = det.stage_tables[stage]
        want = haar_stage_ref(ii, items, *tables).view(torch.int32)
        label = f"S={streams} stage {stage} {tuple(items.shape[:2])}"
        for name in fns:
            got = call(name, ii, items, *tables).view(torch.int32)
            if not torch.equal(got, want):
                raise AssertionError(f"haar {name} {label} differs from "
                                     "plain")
        times = in_turns({name: (lambda n=name: call(n, ii, items, *tables))
                          for name in fns}, 5 if streams > 1 else 50)
        print(f"haar_stage {label}, bit-equal to plain: ms " + ", ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in v)}"
            for n, v in times.items()), flush=True)
        result[label] = times
        del ii, ii2, items, want
        torch.cuda.empty_cache()
    return result


def parent_source(rel):
    """A source file of the parent tree given by ``--parent`` (``git
    archive <parent> | tar -x -C DIR``)."""
    if PARENT is None:
        raise RuntimeError("this section needs --parent DIR, the parent "
                           "commit's tree")
    with open(os.path.join(PARENT, rel)) as f:
        return f.read()


def profiled_ms(fn, reps, tries=3):
    """Device milliseconds of one call, all its CUDA kernels
    (torch.profiler over ``reps`` calls).  The profiler now and then drops
    a kernel's record: a session that does not see ``reps`` times the
    launches of one call is taken again, and after ``tries`` the reading
    is NaN."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def session(n):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        return (sum(e.count for e in events),
                sum(e.self_device_time_total for e in events))

    per_call, _ = session(1)
    for _ in range(tries):
        count, total = session(reps)
        if count == per_call * reps:
            return total / 1e3 / reps
    return float("nan")


def report(label, fns, times, dev):
    print(f"{label}: " + ", ".join(
        f"{n} ms {' / '.join(f'{t:.4f}' for t in times[n])} (device "
        f"{dev[n]:.4f})" for n in fns), flush=True)
    return {n: {"ms": times[n], "device_ms": dev[n]} for n in fns}


BLUR = "src/repro_torch/csrc/bilateral_blur.cu"
BLUR_STEPS = "for (int s = 1; s <= steps; ++s)"
BLUR_GY = "blur_line<0>(v + ya * rs + pxa * gr + l, ny, rs, top, bottom);"
BLUR_GX = "blur_line<0>(v + (ya + y) * rs + xa * gr + r, nx, gr, left, right);"
BLUR_GR = ("blur_line<GR>(v + (ya + y) * rs + (xa + x) * gr, gr, 1, true, "
           "true);")


def blur_variants(nvcc, flags):
    """The bilateral-grid blur's 8 refinement steps at the rig's grid (8
    pairs x 136x241x17, random grids from a seed): the parent's one-step
    kernel launched 8 times, the committed kernel at 8, 4, 2 and 1 steps a
    launch, a 46 x 22 tile, two blocks of 512 threads a SM on 17 x 32
    tiles, and the line walks unrolled by 4 instead of 8; each bit-equal
    to 8 steps of the plain version (and 3 steps on a ragged 37 x 53 x 17
    grid), timed in turns, with 8 x (``F.pad`` + cuDNN ``conv3d``, TF32
    off) beside them.  The ``diag_`` variants leave out one phase of the
    committed kernel (the steps, or one pass of every step): they compute
    no blur and are timed only, to split the kernel's time.  (Passes from
    one buffer to another, one thread a value; 17 x 16 tiles at two
    blocks of 1024 threads a SM; and each value's quarter recomputed for
    every output instead of carried lost to the committed design: PERF.md
    has their times, git history their code.)"""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.bilateral_blur.cuda import (
        TILE_X,
        TILE_Y,
        tile_shape,
    )
    from repro_torch.kernels.bilateral_blur.ref import blur_ref

    text = open(os.path.join(ROOT, BLUR)).read()
    tile = (TILE_Y, TILE_X)
    variants = {                      # name: (source edits, largest tile)
        "committed": ([], tile),
        "tile_46x22": ([], (46, 22)),
        "512_threads_2_a_sm": ([("kThreads = 1024;", "kThreads = 512;"),
                                ("kBlocksPerSm = 1;", "kBlocksPerSm = 2;")],
                               (17, TILE_X)),
        "unroll_4": ([("#pragma unroll 8", "#pragma unroll 4")], tile),
        # timing only, not the blur: the committed kernel without a phase
        "diag_stage_and_store": (
            [(BLUR_STEPS, "for (int s = 1; s <= 0; ++s)")], tile),
        "diag_no_gy_pass": ([(BLUR_GY, "(void)l;")], tile),
        "diag_no_gx_pass": ([(BLUR_GX, "(void)r;")], tile),
        "diag_no_gr_pass": ([(BLUR_GR, "(void)x;")], tile),
    }
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (edits, max_tile) in variants.items():
        fn = build(f"blur_{name}", _substitute(text, edits, "blur"), nvcc,
                   flags).repro_bilateral_blur
        fn.argtypes = [p] * 4 + [i] * 9 + [p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, max_tile)
    parent = build("blur_parent", parent_source(BLUR), nvcc,
                   flags).repro_bilateral_blur
    parent.argtypes = [p] * 4 + [i] * 4 + [p]
    parent.restype = ctypes.c_int

    def launch(fn, val, wt, *args):
        vo, wo = torch.empty_like(val), torch.empty_like(wt)
        rc = fn(val.data_ptr(), wt.data_ptr(), vo.data_ptr(), wo.data_ptr(),
                *val.shape, *args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"blur: CUDA error {rc}")
        return vo, wo

    def steps_of(name, per_launch, n):
        fn, max_tile = libs[name]

        def run(val, wt):
            for k in range(0, n, per_launch):
                steps = min(per_launch, n - k)
                val, wt = launch(fn, val, wt, steps,
                                 *tile_shape(*val.shape[1:], steps, *max_tile))
            return val, wt
        return run

    def parent_run(n):
        def run(val, wt):
            for _ in range(n):
                val, wt = launch(parent, val, wt)
            return val, wt
        return run

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for shape, n in (((8, 136, 241, 17), 8), ((3, 37, 53, 17), 3)):
        val = torch.randn(shape, device="cuda", generator=gen)
        wt = torch.rand(shape, device="cuda", generator=gen)
        calls = {"parent_x8": parent_run(n)}
        for per in (8, 4, 2, 1):
            if per <= n or per == 8:
                calls[f"committed_{min(per, n)}_a_launch"] = steps_of(
                    "committed", per, n)
        for name in libs:
            if name != "committed":
                calls[name] = steps_of(name, 8, n)
        want = (val, wt)
        for _ in range(n):
            want = blur_ref(*want)
        for name, run in calls.items():
            if name.startswith("diag_"):
                continue
            got = run(val, wt)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want)):
                raise AssertionError(f"blur {name} {shape} differs from "
                                     f"{n} plain steps")
        label = f"bilateral_blur {n} steps at {'x'.join(map(str, shape))}"
        fns = {k: (lambda r=r: r(val, wt)) for k, r in calls.items()}
        both = torch.stack([val, wt]).reshape(-1, 1, *shape[1:])
        weight = torch.tensor([0.25, 0.5, 0.25], device="cuda")
        weight = (weight[:, None, None] * weight[None, :, None]
                  * weight[None, None, :])[None, None]

        def library(x=both, n=n):
            torch.backends.cudnn.allow_tf32 = False
            for _ in range(n):
                x = F.conv3d(F.pad(x, (1, 1, 1, 1, 1, 1), mode="replicate"),
                             weight)
            return x
        fns[f"library_x{n}"] = library
        times = in_turns(fns, 20)
        dev = {k: profiled_ms(f, 20) for k, f in fns.items()}
        result[label] = report(label + ", each variant but diag_ bit-equal "
                               "to plain", fns,
                               times, dev)
        del val, wt, want, both
        torch.cuda.empty_cache()
    return result


CODEC = "src/repro_torch/csrc/wire_codec.cu"
CODEC_STORE = "  *p = v;\n"
CODEC_STCS = "  __stcs(p, v);\n"
CODEC_CHUNKS = "constexpr int kDecodeChunks = "
CODEC_LOOP = ("  for (int b = warp; b < n_blocks; b += n_warps) {\n"
              "    const uint8_t* row = packed")
CODEC_LOOP_END = "\n  }\n}\n\nint units_per_row_of"
# two payload blocks a warp in flight: both blocks' loads issued first
CODEC_TWO_BLOCKS = """  for (int b0 = 2 * warp; b0 < n_blocks; b0 += 2 * n_warps) {
    uint4 w[2][kDecodeChunks];
    float scale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = b0 + i < n_blocks ? b0 + i : b0;
      const uint8_t* row = packed + static_cast<size_t>(b) * kRowBytes;
#pragma unroll
      for (int c = 0; c < kDecodeChunks; ++c) {
        w[i][c] = load_run<kRunBytes>(row + (c * kChunkValues + kRun * lane) *
                                                BITS / 8);
      }
      scale[i] = lane == 0 ? scales[b] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (b0 + i >= n_blocks) break;
      const float s = __shfl_sync(0xffffffffu, scale[i], 0);
      float4* dst = out + static_cast<size_t>(b0 + i) * (kVecBlock / 4);
#pragma unroll
      for (int c = 0; c < kDecodeChunks; ++c) {
#pragma unroll
        for (int k = 0; k < kRun / 4; ++k) {
          store_out(dst + (c * kChunkValues + kRun * lane) / 4 + k,
                    make_float4(unpack<BITS>(w[i][c], 4 * k, s),
                                unpack<BITS>(w[i][c], 4 * k + 1, s),
                                unpack<BITS>(w[i][c], 4 * k + 2, s),
                                unpack<BITS>(w[i][c], 4 * k + 3, s)));
        }
      }
    }"""


def codec_variants(nvcc, flags):
    """``wire_decode`` at the sensor cut (6,138 x 256) and one VR capture
    field (259,200 x 256), payloads encoded from random blocks of a seed:
    the parent's kernel (a thread per packed byte) and the warp-per-block
    kernel with each lane on 8 consecutive values (``lanes8``: one load,
    two adjacent float4 stores) or on 4 values in each half of the block
    (``chunks2``: two loads, each float4 store 512 contiguous bytes a
    warp), each with plain and with streaming stores (``_stcs``, the
    committed: the output is written once and a capture field's 265 MB
    never fits in L2; the committed kernel is ``chunks2_stcs``), and
    ``chunks2_stcs`` with two payload blocks a warp in flight
    (``_two_blocks``: both blocks' loads issued before either's stores);
    each
    bit-equal to the plain version at 4, 8 and 16 bits, timed at each
    width in turns."""
    import torch

    from repro_torch.kernels.wire_codec.ref import (
        wire_decode_ref,
        wire_encode_ref,
    )

    text = open(os.path.join(ROOT, CODEC)).read()
    line = next(ln for ln in text.splitlines()
                if ln.startswith(CODEC_CHUNKS))    # the committed mapping
    p, i = ctypes.c_void_p, ctypes.c_int
    sources = {"parent": parent_source(CODEC)}
    for name, chunks in (("lanes8", 1), ("chunks2", 2)):
        src = _substitute(text, [(line, f"{CODEC_CHUNKS}{chunks};")],
                          "wire_codec.cu")
        sources[name + "_stcs"] = src
        sources[name] = _substitute(src, [(CODEC_STCS, CODEC_STORE)],
                                    "wire_codec.cu")
    a = text.index(CODEC_LOOP)
    b = text.index(CODEC_LOOP_END, a)
    sources["chunks2_stcs_two_blocks"] = _substitute(
        text, [(line, f"{CODEC_CHUNKS}2;"), (text[a:b], CODEC_TWO_BLOCKS)],
        "wire_codec.cu")
    dec = {}
    for name, src in sources.items():
        fn = build(f"codec_{name}", src, nvcc, flags).repro_wire_decode
        # the parent's entry point has no route argument
        fn.argtypes = [p, p, p, i, i, i, p] if name == "parent" else \
            [p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        dec[name] = fn

    def decode(name, packed, scales, bits):
        nb = packed.shape[0]
        out = torch.empty((nb, packed.shape[1] * 8 // bits), device="cuda")
        route = () if name == "parent" else (1,)
        rc = dec[name](packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
                       nb, out.shape[1], bits, *route,
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"wire_decode {name}: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for nb in (6138, 259200):
        blocks = 11.0 * torch.randn((nb, 256), device="cuda", generator=gen)
        blocks[::7] = 0.0                      # scale-1 blocks
        for bits in (4, 8, 16):
            packed, scales = wire_encode_ref(blocks, bits=bits)
            want = wire_decode_ref(packed, scales, bits=bits)
            for name in dec:
                got = decode(name, packed, scales, bits)
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"wire_decode {name} {nb} x 256 "
                                         f"{bits}-bit differs from plain")
            del want, got
            fns = {name: (lambda n=name: decode(n, packed, scales, bits))
                   for name in dec}
            reps = 200 if nb < 10000 else 20
            times = in_turns(fns, reps)
            dev = {k: profiled_ms(fn, reps) for k, fn in fns.items()}
            label = f"wire_decode {nb}x256 {bits}-bit"
            result[label] = report(label + " (bit-equal to plain)", fns,
                                   times, dev)
            del packed, scales
        del blocks
        torch.cuda.empty_cache()
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="write the readings here")
    parser.add_argument("--only", nargs="+", default=list(SECTIONS),
                        choices=list(SECTIONS), help="sections to run")
    parser.add_argument("--parent", help="the parent commit's tree, for "
                        "the blur and codec sections' parent kernels")
    args = parser.parse_args()
    global PARENT
    PARENT = args.parent
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    out = {"card": card}
    for section in args.only:
        out[section] = SECTIONS[section](nvcc, flags)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


PARENT = None
SECTIONS = {"integral": integral_variants, "flash": flash_variants,
            "flash_f32": flash_f32_variants, "flash_bwd": flash_bwd_variants,
            "flash_bwd_f32": flash_bwd_f32_variants,
            "mma_tf32": mma_tf32_peak,
            "wkv": wkv_variants, "wkv_bwd": wkv_bwd_variants,
            "haar": haar_variants, "blur": blur_variants,
            "codec": codec_variants}

if __name__ == "__main__":
    sys.exit(main())
