#!/usr/bin/env python3
"""A/B of design variants of two hand-written CUDA kernels, on one card.

    python3 benchmarks/torch_kernel_variants.py [--json OUT]

Builds variants of ``src/repro_torch/csrc/integral_image.cu`` (rows per
strip ``RS`` and the blocks per SM of its ``__launch_bounds__``) and of
``src/repro_torch/csrc/flash_attention.cu`` (P V from one bf16 term of P,
FlashAttention's P, instead of the committed hi + lo pair) by text
substitution of the committed sources, each with ``nvcc`` into a library
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
            if "registers" in line]
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="write the readings here")
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
    out = {"card": card, "integral_image": integral_variants(nvcc, flags),
           "flash_attention": flash_variants(nvcc, flags)}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
