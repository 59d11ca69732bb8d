#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (at
first use, into ``build/repro_torch``), then:

1. main-path phase — builds ``FaceAuthExecutor`` at full width (62 frames
   of 144x176, the paper's scan, the 10x33-trained cascade and the
   400-8-1 NN from ``assets/fa_reference.npz``), calibrates it, sets every
   launch counter to 0, runs the 62 frames once, reads the counters, and
   checks the result against the JAX executor's (same capacities, same
   motion frames, at most 2 window flips, bit-equal scores on the windows
   both found);
2. kernel phase — at the shapes the funnel gives them, runs each kernel
   and its plain PyTorch version on the card on the same inputs and holds
   them together (``quant_matmul`` and ``haar_stage`` bit-exact,
   ``integral_image`` within an rtol of 1e-6 of the table's largest entry;
   both run the same sequential float32 sums, so 0 is expected), and
   times the kernel, the plain version and a PyTorch library call where
   one computes the same function;
3. timing phase — the funnel's time per frame, ``run_streams`` at S = 1
   and S = 64 streams, and a profile of one call of each that splits its
   device time by kernel.

Any failed check raises.  The last lines of standard output are one JSON
object with a line per kernel, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits with a non-zero code.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM, NVIDIA's data sheet (dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12          # float32 outside the tensor cores
PEAK_INT8_OPS_S = 1979e12       # int8 tensor cores

INTEGRAL_RTOL = 1e-6            # of max |table|: same sums in the same order
MAX_WINDOW_FLIPS = 2            # tests/test_detect.py:130 borderline allowance
STREAMS = 64


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
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


def host_ms(fn, reps: int = 7) -> float:
    """Median wall milliseconds of a call that ends in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """Least time the card needs for the work (ms from bytes, ms from
    operations), and what sets it."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * n_ops / peak_ops
    return t_bytes, t_ops, "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_row(name, module, launches, err, ms, plain_ms, library_ms,
               n_bytes, n_ops, peak_ops):
    t_bytes, t_ops, b_by = bound(n_bytes, n_ops, peak_ops)
    row = {"name": name, "route": "cuda", "source": module.SOURCE,
           "replaces": module.REPLACES, "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": b_by,
           "library_ms": library_ms}
    lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
    print(f"kernel {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib} bound_ms={max(t_bytes, t_ops):.4f} "
          f"(bytes {t_bytes:.4f}, operations {t_ops:.4f}) "
          f"launches_per_batch={launches} max_abs_err={err:g}", flush=True)
    return row


def kernel_phase(ex, frames, launches):
    """Each kernel against its plain version at the main path's shapes;
    ``launches`` are the main path's counts."""
    import torch

    from repro_torch.kernels.haar_frontend import cuda as hcuda
    from repro_torch.kernels.haar_frontend.ref import haar_stage_ref
    from repro_torch.kernels.integral_image import cuda as icuda
    from repro_torch.kernels.integral_image.ref import integral_image_ref
    from repro_torch.kernels.quant_matmul import cuda as qcuda
    from repro_torch.kernels.quant_matmul.ops import quantize_static
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    rows = []
    st = ex.stages
    mframes, _fidx, fvalid, _motion, _md = st.motion(frames[None])
    mf = mframes[0]

    # -- integral_image: frames and frames^2 of the motion batch, one launch
    x = torch.cat([mf, mf * mf]).contiguous()
    got = icuda.integral_image_cuda(x)
    want = integral_image_ref(x)
    err = max_abs_err(got, want)
    if err > INTEGRAL_RTOL * float(want.abs().max()):
        raise AssertionError(f"integral_image: max |err| {err}")
    rows.append(kernel_row(
        "integral_image", icuda, launches["integral_image"], err,
        device_ms(lambda: icuda.integral_image_cuda(x)),
        device_ms(lambda: integral_image_ref(x), reps=3, warm=1),
        device_ms(lambda: torch.cumsum(torch.cumsum(x, -2), -1)),
        4 * (x.numel() + got.numel()), 2 * x.numel(), PEAK_F32_OPS_S))
    # the VR slice's 4K eye frame must run right too (speed is later work)
    big = torch.rand((1, 2160, 3840), device=x.device,
                     generator=torch.Generator(device=x.device).manual_seed(0))
    got_big, want_big = icuda.integral_image_cuda(big), integral_image_ref(big)
    err_big = max_abs_err(got_big, want_big)
    if err_big > INTEGRAL_RTOL * float(want_big.abs().max()):
        raise AssertionError(f"integral_image 2160x3840: max |err| {err_big}")
    print(f"integral_image 1x2160x3840: kernel_ms="
          f"{device_ms(lambda: icuda.integral_image_cuda(big), reps=5):.3f} "
          f"max_abs_err={err_big:g}", flush=True)

    # -- haar_stage: stage 0 over every window of every motion frame
    det = ex.det
    ii, ii2 = det.integrals(mf)
    items = det.items(ii, ii2).contiguous()
    for si, tables in enumerate(det.stage_tables):
        cap = det.capacities[si]
        it = items[:, :cap].contiguous()
        got = hcuda.haar_stage_cuda(ii, it, *tables)
        want = haar_stage_ref(ii, it, *tables)
        if not torch.equal(got, want):
            raise AssertionError(f"haar_stage {si}: max |err| "
                                 f"{max_abs_err(got, want)}")
    tables = det.stage_tables[0]
    offsets = tables[0]
    n_scales, sz, _k = offsets.shape
    rows_, cap = items.shape[:2]
    n_bytes = 4 * (ii.numel() + items.numel() + rows_ * cap
                   + offsets.numel() + sz * 8 + 3 * sz)
    n_ops = rows_ * cap * sz * 21      # 8 mul + 8 add, scale, sub, sign, 2 mul, add
    rows.append(kernel_row(
        "haar_stage", hcuda, launches["haar_stage"], 0.0,
        device_ms(lambda: hcuda.haar_stage_cuda(ii, items, *tables)),
        device_ms(lambda: haar_stage_ref(ii, items, *tables), reps=3,
                  warm=1),
        None, n_bytes, n_ops, PEAK_F32_OPS_S))

    # -- quant_matmul: both NN layers on the main path's windows
    dmask, n_win_m, _cd = st.detect(mframes, fvalid)
    patches, _wsel, _wv, _wd = st.gather(mframes, dmask, n_win_m)
    xw = patches.reshape(-1, 400)
    q, lut = ex.qnn, ex.lut
    lo, hi, _entries = ex.lut_meta
    x_q = quantize_static(xw, q.scale_x, q.qmax)
    x_q_host = quantize_static(xw.cpu(), q.scale_x, q.qmax)
    if not torch.equal(x_q.cpu(), x_q_host):
        raise AssertionError("quantize_static differs between card and host")
    scale1 = float(np.float32(q.scale_x * q.scale_w1))
    kw1 = dict(scale=scale1, bias=q.b1, lut_lo=lo, lut_hi=hi)
    h = qcuda.quant_matmul_cuda(x_q, q.w1_q, lut, **kw1)
    if not torch.equal(h, quant_matmul_ref(x_q, q.w1_q, lut, **kw1)):
        raise AssertionError("quant_matmul layer 1 differs from plain")
    h_q = quantize_static(h, q.scale_h, q.qmax)
    kw2 = dict(scale=float(np.float32(q.scale_h * q.scale_w2)), bias=q.b2,
               lut_lo=lo, lut_hi=hi)
    y = qcuda.quant_matmul_cuda(h_q, q.w2_q, lut, **kw2)
    if not torch.equal(y, quant_matmul_ref(h_q, q.w2_q, lut, **kw2)):
        raise AssertionError("quant_matmul layer 2 differs from plain")
    gen = torch.Generator(device=x.device).manual_seed(1)
    a = torch.randint(-127, 128, (1024, 1024), dtype=torch.int8,
                      device=x.device, generator=gen)
    b = torch.randint(-127, 128, (1024, 1024), dtype=torch.int8,
                      device=x.device, generator=gen)
    kw_big = dict(scale=1.0, apply_lut=False)
    if not torch.equal(qcuda.quant_matmul_cuda(a, b, lut, **kw_big),
                       quant_matmul_ref(a, b, lut, **kw_big)):
        raise AssertionError("quant_matmul 1024^3 differs from plain")
    try:
        lib_ms = device_ms(lambda: torch._int_mm(x_q, q.w1_q))
    except RuntimeError as e:             # shape rules of _int_mm
        print(f"torch._int_mm not timed: {e}", flush=True)
        lib_ms = None
    m, k = x_q.shape
    n = q.w1_q.shape[1]
    rows.append(kernel_row(
        "quant_matmul", qcuda, launches["quant_matmul"], 0.0,
        device_ms(lambda: qcuda.quant_matmul_cuda(x_q, q.w1_q, lut, **kw1)),
        device_ms(lambda: quant_matmul_ref(x_q, q.w1_q, lut, **kw1)),
        lib_ms, m * k + k * n + 4 * (n + lut.numel() + m * n),
        2 * m * k * n, PEAK_INT8_OPS_S))
    return rows


def main_phase(ex, frames, ref):
    """Run the funnel once with counted launches and hold it to the JAX
    executor's outputs; returns the launch counts."""
    import torch

    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    res = ex(frames)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    print(f"main path launches: {counts}", flush=True)
    for name in ("integral_image", "haar_stage", "quant_matmul"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"main path never launched {name}")

    out = {k: getattr(res, k).cpu().numpy()
           for k in ("motion", "n_windows", "n_auth", "window_id",
                     "window_valid", "scores")}
    o = ref.outputs
    if out["scores"].shape != o["scores"].shape:
        raise AssertionError(f"scores shape {out['scores'].shape}")
    if not np.isfinite(out["scores"]).all():
        raise AssertionError("non-finite scores")
    if not np.array_equal(out["motion"], o["motion"]):
        raise AssertionError("motion frames differ from the reference")
    if res.total_dropped() != 0:
        raise AssertionError(f"{res.total_dropped()} capacity drops")
    flips = matched = 0
    for i in range(len(out["motion"])):
        mine = dict(zip(out["window_id"][i][out["window_valid"][i]],
                        out["scores"][i][out["window_valid"][i]]))
        theirs = dict(zip(o["window_id"][i][o["window_valid"][i]],
                          o["scores"][i][o["window_valid"][i]]))
        flips += len(set(mine) ^ set(theirs))
        for wid in set(mine) & set(theirs):
            matched += 1
            if mine[wid].view(np.int32) != theirs[wid].view(np.int32):
                raise AssertionError(f"frame {i} window {wid}: score "
                                     f"{mine[wid]} != {theirs[wid]}")
    n_win, n_auth = int(out["n_windows"].sum()), int(out["n_auth"].sum())
    print(f"main path: {int(out['motion'].sum())} motion frames, {n_win} "
          f"windows, {n_auth} auth (reference {int(o['motion'].sum())}, "
          f"{int(o['n_windows'].sum())}, {int(o['n_auth'].sum())}); "
          f"{flips} window flips, {matched} matched windows bit-equal",
          flush=True)
    if flips > MAX_WINDOW_FLIPS:
        raise AssertionError(f"{flips} window flips > {MAX_WINDOW_FLIPS}")
    if abs(n_auth - int(o["n_auth"].sum())) > flips:
        raise AssertionError("auth count differs beyond the window flips")
    return counts, res


def profile_phase(label, fn, wall_ms):
    """Device time by kernel over one call (torch.profiler), against the
    call's unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label}: {len(kernels)} kernel names, {sum(e.count for e in kernels)} "
          f"launches, device busy {busy:.4f} ms of {wall_ms:.4f} ms wall "
          f"({100 * busy / wall_ms:.1f}%)", flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)


def timing_phase(ex, frames, res):
    import torch

    B = frames.shape[0]
    ms = host_ms(lambda: ex(frames))
    print(f"funnel: {ms / B:.4f} ms per frame ({ms:.3f} ms per {B}-frame "
          f"batch, median of 7)", flush=True)
    one = frames[None]
    ms1 = host_ms(lambda: ex.run_streams(one))
    streams = torch.stack([torch.roll(frames, 5 * s, dims=0)
                           for s in range(STREAMS)])
    torch.cuda.reset_peak_memory_stats()
    many = ex.run_streams(streams)
    torch.cuda.synchronize()
    if not (torch.equal(many.scores[0], res.scores)
            and torch.equal(many.window_id[0], res.window_id)):
        raise AssertionError("stream 0 of run_streams differs from a "
                             "single call")
    msS = host_ms(lambda: ex.run_streams(streams), reps=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"run_streams: S=1 {1e3 * B / ms1:.1f} frames/s, S={STREAMS} "
          f"{1e3 * STREAMS * B / msS:.1f} frames/s ({msS:.3f} ms per batch, "
          f"peak {peak:.2f} GiB)", flush=True)
    profile_phase("S=1", lambda: ex(frames), ms)
    profile_phase(f"S={STREAMS}", lambda: ex.run_streams(streams), msS)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.bridge import load_fa_reference
        from repro_torch.camera.pipelines import FaceAuthExecutor
        from repro_torch.camera.synthetic import security_video
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}",
              file=sys.stderr)
        return 1

    card = gpu_name_and_power()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    ref = load_fa_reference(device="cuda")
    frames_np, _truth = security_video(**ref.video)
    frames = torch.as_tensor(frames_np, device="cuda")
    ex = FaceAuthExecutor(ref.cascade, ref.nn, frames.shape[1],
                          frames.shape[2], device="cuda", **ref.scan)
    caps = ex.calibrate(frames)
    want = (ref.frame_capacity, ref.window_capacity, ref.cascade_capacities)
    print(f"capacities f={caps[0]} w={caps[1]} vj={caps[2]}", flush=True)
    if caps != want:
        raise AssertionError(f"capacities {caps} != reference {want}")

    counts, res = main_phase(ex, frames, ref)
    rows = kernel_phase(ex, frames, counts)
    timing_phase(ex, frames, res)

    print(json.dumps({"kernels": rows}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
