#!/usr/bin/env python3
"""A/B of design variants of two hand-written CUDA kernels, on one card.

    python3 benchmarks/torch_kernel_variants.py [--only SECTION ...] [--json OUT]

Builds variants of ``src/repro_torch/csrc/integral_image.cu`` (rows per
strip ``RS`` and the blocks per SM of its ``__launch_bounds__``; section
``integral``), of the bf16 kernel of
``src/repro_torch/csrc/flash_attention.cu`` (P V from one bf16 term of P,
FlashAttention's P, instead of the committed hi + lo pair; ``flash``) and
of its float32 kernel (masks on every tile or on cut tiles only, blocks
of 64 or 128 queries, the order of the q k^T fragment loads and the
unrolling of P V; ``flash_f32``) by text substitution of
the committed sources, each with ``nvcc`` into a library
of its own under ``build/variants/``.  Each variant is checked against
the plain PyTorch version on the same inputs, then all are timed with CUDA
events in turns (A, B, ..., B, A) on one card.  Prints one line per
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

# (RS, blocks per SM); the first is the committed kernel
INTEGRAL = {"rs64_3blocks": (64, 3), "rs32_4blocks": (32, 4),
            "rs32_8blocks": (32, 8), "rs64_4blocks": (64, 4)}
FLASH_ONE_P = ("        wgmma_pv<D>(acc, hi, vd);\n"
               "        wgmma_pv<D>(acc, lo, vd);\n")


def build(name, source, nvcc, flags):
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, name + ".cu")
    with open(src, "w") as f:
        f.write(source)
    lib = os.path.join(out_dir, name + ".so")
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-shared", src,
                           "-o", lib], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = [line.split("ptxas info    :")[-1].strip()
            for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line]
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
                          FLASH_ONE_P, "        wgmma_pv<D>(acc, hi, vd);\n"))):
        fn = build(f"flash_{name}", src, nvcc, flags).repro_flash_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, q, k, v):
        b, s, H, d = q.shape
        o = torch.empty_like(q)
        rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       1, b, s, k.shape[1], H, k.shape[2], d,
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

# the float32 kernel's q k^T loop and loop heads as committed
F32_QK = """#pragma unroll 2
    for (int d4 = 0; d4 < D; d4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load4(Qs + (ty * 8 + i) * D + d4);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 kk =
            load4(Kt + (tx + 16 * j) * D + (((d4 >> 2) ^ sw) << 2));
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
    for (int d4 = 0; d4 < D; d4 += 4) {
      float4 kf[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kf[j] = load4(Kt + (tx + 16 * j) * D + (((d4 >> 2) ^ sw) << 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = load4(Qs + (ty * 8 + i) * D + d4);
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
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(name, q, k, v, window):
        b, s, H, d = q.shape
        o = torch.empty_like(q)
        rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       0, b, s, k.shape[1], H, k.shape[2], d,
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="write the readings here")
    parser.add_argument("--only", nargs="+", default=list(SECTIONS),
                        choices=list(SECTIONS), help="sections to run")
    args = parser.parse_args()
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


SECTIONS = {"integral": integral_variants, "flash": flash_variants,
            "flash_f32": flash_f32_variants}

if __name__ == "__main__":
    sys.exit(main())
