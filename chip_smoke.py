#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (at
first use, into ``build/repro_torch``) and checks with ``cuobjdump -sass``
that the bf16 flash kernel is a ``wgmma`` kernel (HGMMA in its SASS) and
that the float32 one holds no tensor-core instruction, then:

1. main-path phase — builds ``FaceAuthExecutor`` at full width (62 frames
   of 144x176, the paper's scan, the 10x33-trained cascade and the
   400-8-1 NN from ``assets/fa_reference.npz``), calibrates it, sets every
   launch counter to 0, runs the 62 frames once, reads the counters, and
   checks the result against the JAX executor's (same capacities, same
   motion frames, at most 2 window flips, bit-equal scores on the windows
   both found);
2. timing phase — the funnel's time per frame and ``run_streams`` at
   S = 1 and S = 64 streams, by the host clock, before any profiler
   session has run;
3. offload phase — splits the calibrated executor at every cut (sensor,
   motion, vj, nn) at every codec width (None, 16, 8, 4 bits) with
   ``FaceAuthOffloadExecutor`` and runs the 62 frames through each, with
   the launch counters set to 0 before each run: the raw split must equal
   the fused result field for field; every run's windows and auths must
   lie within 2 of the JAX split executor's at the same cut and width
   (``assets/offload_reference.npz``); sensor-cut and motion-cut payloads
   must hash equal to the JAX record with the same wire bytes; vj and nn
   bytes may differ by the flipped windows only; the 8-bit nn cut keeps
   every auth decision; bytes shrink down the funnel; every coded run
   launches ``wire_encode`` and ``wire_decode``.  Then a ``CutController``
   calibrates all four cuts on the card (8 bits, energy regime, the
   backscatter link at the calibrated J/B), solves, checks that its choice
   is the measured optimum, executes the chosen cut, holds the result to
   the sweep's run of that cut and to the JAX record, and times it;
4. kernel phase — at the shapes the funnel gives them, runs each kernel
   and its plain PyTorch version on the card on the same inputs and holds
   them together (``quant_nn``, ``quant_matmul``, ``haar_stage``,
   ``wire_encode``, ``wire_decode`` and ``integral_image`` bit-exact;
   ``haar_stage`` at every stage at S = 1, at stage 0 of S = 64 streams
   (1,792 frames) and on frames with NaN pixels, with a row at S = 64 whose
   bound also counts the taps as shared-memory loads;
   ``integral_image`` also on a 4K eye frame and two shapes ragged against
   its strips and tiles; ``quant_nn``, the whole NN in one launch, also on
   the S = 64 windows and at 1, 17 and 5,377 rows; ``quant_matmul``, the
   general GEMM, at both NN layers, 1024^3 and 1000 x 1000 x 24), and
   times the kernel, the plain version and a PyTorch library call where
   one computes the same function (CUDA events around back-to-back calls;
   the library call's device time, all its kernels, in the profile
   phase);
5. VR phase — the §IV rig at full width (8 pairs ``stereo_pair(2160,
   3840, seed=s)``, sigma 16, max_disp 32, 8 refinement steps,
   ``assets/vr_reference.npz``): one rig frame with the launch counters
   set to 0 (5 ``integral_image`` launches and 1 ``bilateral_blur``, its
   8 refinement steps in one launch),
   its depth, panorama and frame times (host clock, median of 5) and
   peak memory; pair 0 on the card against the port on the CPU (rough
   disparity equal, splatted grids bit-equal, depth and panoramas within
   DEPTH_ATOL / PANO_ATOL); the card against the JAX record on four
   256x256 crops of pair 0 (every differing winner a near tie, below) and
   on the left panorama; the working size (8 pairs of 270x480): >= 99%
   rough agreement per pair and near ties only, depth with JAX's rough
   injected within INJECTED_ATOL, left panorama.  Then every cut x bits
   of ``VROffloadExecutor`` at full width (raw split == fused, wire bytes
   == the record, every coded field's bytes, scales and decode == the
   plain codec's on the same card tensors, capture payload hashes ==
   JAX's at 16/8/4 bits, the left panorama within the code's half step,
   the 8-bit knee, codec launched) and a ``CutController`` in the
   throughput regime that must pick the measured optimum; then the
   ``bilateral_blur`` row (the fused 8 steps at 8 x 136x241x17 bit-equal
   to 8 plain steps, one step bit-equal to one, 3 steps on ragged 37 x
   53 x 17 and x 9 grids; its bound also counts the design's
   shared-memory loads; 8 x cuDNN ``conv3d`` as the library call), an
   ``integral_image`` row at the cost volume's shape (64 x 2164x3844,
   bit-exact) and the codec's rows at one capture field (259,200 x 256
   blocks, 4/8/16 bits bit-exact, timed at each width); the codec's
   decode also on packed bytes one byte off 16-byte alignment and on
   blocks of 128 and 512, which take its scalar kernel;
6. resilience phase — the offload resilience layer on the card at full
   width against the JAX record ``assets/resilience_reference.npz``: (a)
   ``OffloadSession`` with no faults at every cut x None/16/8/4 equal to
   the split executor field for field, payload CRCs equal to JAX's at the
   sensor and motion cuts; (b) two laddered cells over the motion cut
   (16 -> 8 -> 4 bits -> on-node, burst loss 0.2 at outage duty 0 and
   0.2, 40 sends) whose delivery records equal JAX's tuple for tuple; (c)
   the 12 loss x duty cells of ``benchmarks/offload_resilience.py`` over
   the nn cut and its determinism cell, each send's outcome equal to
   JAX's where there is no outage, the delivery fraction within 1/40 of
   JAX's where there is (the port's nn payload carries one window fewer);
   (d) the brownout run (10 sends, commit points in a temporary
   directory): every result equal to the 8-bit split executor's, no
   upstream stage completed twice for a send; (e) the congestion fleet,
   its p99 above the clean one's; (f) VR sessions at 16 x 4K at every cut
   x 16/8/4 equal to the split executor, and one brownout send at the
   stitch cut resumed from its commits (bytes written and seconds
   printed); (g) every delivered coded send launched ``wire_decode`` and
   no other send did;
7. serving phase — ``StreamingServer`` on the card at full width: (a)
   one 62-frame stream served as one chunk equals ``FaceAuthExecutor``
   (local, every cut raw) and the split executor (every cut at 16/8/4
   bits), bit for bit, with its wire bytes; (b) the JAX record
   ``assets/serving_reference.npz`` (8 streams, two each at local,
   sensor-8, motion-8 and vj-8, ``chunk=4, capacity=4``, 8 ticks, clean
   and under Gilbert-Elliott loss): every scheduling field of every tick
   report equal (failed deliveries and ladder moves included), each
   completion's results bit-equal or, where the port's integral image
   moves a window across a stage decision, held by outcome (at most 2
   window flips, matched scores bit-equal off the vj cut and within two
   8-bit codec errors on it, auths within the flips, each tick's bytes
   off by exactly the vj streams'), and ``seq_audit`` equal; the 8-bit
   codec's score error on the record's videos no more than the reading
   the bound is made of; (c) an inert ``ChaosSpec`` bit-identical to no
   chaos; checkpoints at tick 4 of both runs, the clean one continuing
   equal to the uninterrupted server; (d) telemetry off equal to none in
   reports and launches, on with counters equal to the outputs; (e) the
   fleet of ``benchmarks/serving.py`` (904 quiet streams, every 32nd
   local and the rest vj-8, for 24 ticks; then 120 hot streams at 2 fps
   for 24 more; ``capacity=96``, the backscatter link provisioned from
   the measured vj-8 bytes, a ``CutController`` over the four cuts),
   with the launch counters set to 0 before the 48 ticks and read after:
   streams sustained, p99 tick wall against the 2.5 s SLO, simulated
   throughput, re-solves, cut changes, requeues, link p99 per phase; every
   group dispatch of the 48 ticks counted with its own launches (one
   dispatch a placement group a tick, the same launches at every dispatch
   of a rung, and their sum the counters' totals); then one local and one
   vj-8 dispatch of 96 slots x 4 hot frames, launching what the fleet's
   dispatches of the rung launched, each kernel call in it held to its
   plain version on its own inputs bit for bit, and the dispatch with the
   plain versions in the kernels' place equal to it bit for bit;
8. LM phase — serving at full width, yi-9b and then rwkv6-7b in bf16,
   weights drawn on the card (seed 0): a ``generate`` call (the function
   ``repro_torch.launch.serve`` calls) on 8 prompts of 4096 tokens (numpy
   seed 1) for 32 greedy tokens, with the launch counters set to 0, must
   launch ``flash_attention`` 48 times (yi) or ``rwkv_wkv`` 32 times
   (rwkv), all in prefill; prefill ms, decode ms per token, generated
   tokens/s (host clock, median of 3), peak memory, every logit finite.
   Each kernel is held to its plain version on the inputs it got in that
   prefill (flash atol = rtol = 2e-2 in bf16; WKV outputs and final state
   within 2e-4 of the plain version's largest entry, with the path's zero
   u and again with a seeded nonzero u, and on drawn inputs at a T ragged
   against the kernel's chunk with w = 0 in some channels; beside each,
   the error of the kernel's chunked arithmetic in plain PyTorch).  Then
   each model at full width, 4 layers deep, in float32: the full forward
   against prefill + 4 decode steps (B 2, S 1000), within 7e-4 of the
   largest |logit| (E, the model's own one-ulp sensitivity, printed beside
   it); the JAX record
   (``assets/lm_reference.npz``) on the card; and ``flash_attention`` on
   random inputs at ``KERNEL_SHAPES``' prefill_32k (8 x 32768 x 128,
   causal, and with a window of 4096; bf16 within 4e-3 + 2^-7 |x|, and
   float32 within atol = rtol = 2e-5) and at yi's heads with S = 4000
   (ragged against the kernel's 128-row tiles; bf16), each timed beside
   SDPA (the window as a dense boolean mask).  bf16 runs the ``wgmma``
   kernel and float32 the CUDA-core one; each flash row names the kernel
   that ran;
9. profile phase — every torch.profiler session of the run: each kernel's
   device time per launch, the device time by kernel of one call at S = 1,
   S = 64, the VR rig frame, a steady-state serving tick (its device-busy
   share), the executed offload cut and one serve call of each LM, the
   serving dispatches' kernel launches by the profiler's names (held to
   the wrappers' counts), with the funnel's host time just before and
   just after the sessions.

One-ulp sensitivity E: how far a model's logits move, relative to the
largest |logit|, when every weight moves by one ulp up or down at random.
These random-weight models amplify float32 rounding layer by layer, so
the port and XLA, two float32 computations of the same function that
round differently, are held to max(1e-4, E): no further apart than one
model moves under a one-ulp move of its weights.

Near tie: a rough-disparity winner d_port that differs from JAX's d_jax
must satisfy |SAD64(d_port) - SAD64(d_jax)| <= 2 max(E_port, E_jax),
SAD64 the float64 sum of the same float32 pixel differences and E each
side's largest |SAD32 - SAD64| over the region and all hypotheses.  A
winner picked on float32 SADs with error at most E is within 2E of every
other hypothesis in float64, so the rule needs no a-priori bound.
Panoramas are held within PANO_ATOL except at pixels whose float64 warp
coordinate lies within NEAR_TOL of an integer or of the valid range's
border, where the reference's float32 map may take another pixel.

Any failed check raises.  The last lines of standard output are one JSON
object with a line per kernel, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits with a non-zero code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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
PEAK_BF16_OPS_S = 989e12        # bf16 tensor cores, dense
PEAK_INT8_OPS_S = 1979e12       # int8 tensor cores

MAX_WINDOW_FLIPS = 2            # tests/test_detect.py:130 borderline allowance
STREAMS = 64
CUTS = ("sensor", "motion", "vj", "nn")
# the node duties of examples/camera_offload.py (vj at leakage only)
DUTIES = {"sensor": 1.0, "motion": 1.0, "vj": 0.0, "nn": 1.0}
FA_FIELDS = ("motion", "n_windows", "n_auth", "scores", "window_id",
             "window_valid", "auth", "windows_dropped", "motion_dropped",
             "cascade_dropped")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wgmma_check():
    """The bf16 flash kernel is a ``wgmma`` kernel: the SASS of the built
    library (``cuobjdump -sass``) holds HGMMA, the ``wgmma`` instruction,
    in both its head sizes (24 at D 128, 20 at D 64); the float32 kernel
    holds no tensor-core instruction (HGMMA or HMMA): its products stay
    float32 FMAs, never TF32.  The int8 kernels' IMMA counts are printed."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops = ("HGMMA", "HMMA", "IMMA")
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                counts[fn][op] += f" {op}" in line
    for name, n in sorted(counts.items()):
        if "flash_attention_kernel" in name or "quant_" in name:
            print(f"SASS {name}: " + ", ".join(f"{n[op]} {op}" for op in ops),
                  flush=True)
    flash = {k: v for k, v in counts.items() if "flash_attention_kernel" in k}
    bf16 = sorted(n["HGMMA"] for name, n in flash.items()
                  if "tensor_core" in name)
    f32 = [n["HGMMA"] + n["HMMA"] for name, n in flash.items()
           if "cuda_core" in name]
    if bf16 != [20, 24] or len(f32) != 2 or any(f32):
        raise AssertionError("expected 24 and 20 HGMMA in the bf16 flash "
                             "kernels and no tensor-core instruction in the "
                             f"float32 ones: {bf16}, {f32}")
    print("flash_attention: the bf16 kernel's SASS holds HGMMA (wgmma), 24 "
          "and 20; the float32 kernel's no HGMMA or HMMA", flush=True)


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


def launch_device_ms(fn, kernel: str, reps: int = 20, tries: int = 3) -> float:
    """Device milliseconds of one launch of the CUDA kernel named
    ``kernel``, by torch.profiler over ``reps`` calls of ``fn``: the
    kernel alone, without the host time between launches that CUDA events
    around back-to-back calls also count.  The profiler now and then drops
    a kernel's record; a session that does not see exactly ``reps``
    launches is taken again, and after ``tries`` such sessions the call
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and kernel in e.key]
        count = sum(e.count for e in events)
        if count == reps:
            return sum(e.self_device_time_total for e in events) / 1e3 / count
        print(f"profiler saw {count} launches of {kernel}, expected {reps}: "
              "profiling again", flush=True)
    raise AssertionError(f"profiler saw {count} launches of {kernel}, "
                         f"expected {reps}, in each of {tries} sessions")


def call_device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one call of ``fn``, summed over every CUDA
    kernel it launches (torch.profiler over ``reps`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    if not events:
        raise AssertionError("profiler saw no CUDA kernel")
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def kernel_row(probes, name, module, launches, err, fn, plain_ms,
               library_ms, n_bytes, n_ops, peak_ops, reps=20, shape=None,
               library_fn=None, shared_ms=None, kernel=None):
    """One line of the kernels JSON; ``fn`` launches the kernel once and
    goes into ``probes`` for the profile phase, with ``library_fn`` (the
    library call timed as ``library_ms``), which fills the row's
    ``device_ms`` and ``library_device_ms`` there.  ``shared_ms``, where
    given, is a third bound term: the kernel's shared-memory loads at 32
    a clock on every SM.  The row's ``bound_term`` names the largest term;
    ``bound_by`` counts shared loads as operations (of the load pipe), so
    it stays "bytes" or "operations".  ``kernel``: the name the profiler
    knows the launched kernel by (``<name>_kernel``)."""
    ms = device_ms(fn, reps=reps)
    t_bytes, t_ops, _ = bound(n_bytes, n_ops, peak_ops)
    terms = {"bytes": t_bytes, "operations": t_ops}
    if shared_ms is not None:
        terms["shared_loads"] = shared_ms
    b_term = max(terms, key=terms.get)
    b_by = "bytes" if b_term == "bytes" else "operations"
    replaces = module.REPLACES
    if isinstance(replaces, dict):          # one source, several kernels
        replaces = replaces[name]
    row = {"name": name, "route": "cuda", "source": module.SOURCE,
           "replaces": replaces, "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(terms.values()), "bound_by": b_by,
           "library_ms": library_ms}
    if shared_ms is not None:
        row["bound_terms_ms"] = terms
        row["bound_term"] = b_term
    if shape is not None:
        row["shape"] = shape
    probes.append((name if shape is None else f"{name} {shape}", fn, row,
                   library_fn, kernel or f"{name}_kernel"))
    lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
    print(f"kernel {probes[-1][0]}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib} bound_ms={row['bound_ms']:.4f} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
          + f") launches_per_batch={launches} max_abs_err={err:g}",
          flush=True)
    return row


def kernel_phase(ex, frames, launches):
    """Each kernel against its plain version at the main path's shapes;
    ``launches`` are the main path's counts.  Returns the JSON rows and
    (name, launch-once function) pairs for the profile phase."""
    import torch

    from repro_torch.kernels.integral_image import cuda as icuda
    from repro_torch.kernels.integral_image.ref import integral_image_ref

    rows, probes = [], []
    st = ex.stages
    mframes, _fidx, fvalid, _motion, _md = st.motion(frames[None])
    mf = mframes[0]

    # -- integral_image: frames and frames^2 of the motion batch, one launch
    x = torch.cat([mf, mf * mf]).contiguous()
    got = icuda.integral_image_cuda(x)
    if not torch.equal(got, integral_image_ref(x)):
        raise AssertionError("integral_image at the funnel's shape differs "
                             "from plain")
    rows.append(kernel_row(
        probes, "integral_image", icuda, launches["integral_image"], 0.0,
        lambda: icuda.integral_image_cuda(x),
        device_ms(lambda: integral_image_ref(x), reps=3, warm=1),
        device_ms(lambda: torch.cumsum(torch.cumsum(x, -2), -1)),
        4 * (x.numel() + got.numel()), 2 * x.numel(), PEAK_F32_OPS_S,
        shape="x".join(map(str, x.shape)),
        library_fn=lambda: torch.cumsum(torch.cumsum(x, -2), -1)))
    # the VR slice's 4K eye frame, and shapes ragged against the kernel's
    # strips (64 rows) and tiles (128 columns), with values up to 1e6
    gen = torch.Generator(device=x.device).manual_seed(0)
    for shape, top in (((1, 2160, 3840), 1.0), ((3, 1000, 1001), 1e6),
                       ((2, 65, 4097), 1e6)):
        img = top * torch.rand(shape, device=x.device, generator=gen)
        if not torch.equal(icuda.integral_image_cuda(img),
                           integral_image_ref(img)):
            raise AssertionError(f"integral_image {shape} differs from "
                                 "plain")
    print(f"integral_image {tuple(x.shape)}, 1x2160x3840, 3x1000x1001, "
          "2x65x4097: kernel == plain bit for bit", flush=True)
    del img

    rows += haar_rows(probes, ex, frames, mf, launches)

    # -- the NN kernel: the whole 400-8-1 NN on the main path's windows
    dmask, n_win_m, _cd = st.detect(mframes, fvalid)
    patches, _wsel, _wv, _wd = st.gather(mframes, dmask, n_win_m)
    xw = patches.reshape(-1, 400)
    rows += nn_rows(probes, ex, frames, xw, launches)
    rows += gemm_rows(probes, ex, xw, launches)
    rows += codec_rows(probes, ex, frames, launches)
    return rows, probes


def sm_clock_hz() -> float:
    """The card's largest SM clock (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def haar_rows(probes, ex, frames, mf, launches):
    """``haar_stage`` bit for bit against its plain version: every stage
    at S = 1 (the table path for stage 0, the global path for the small
    stages), stage 0 at S = 64 streams (1,792 frames x 25,853 windows),
    and stage 0 on the S = 1 frames with three NaN pixels (NaN scores in
    the same windows, with the same bits).  Rows for stage 0 at S = 1 and
    at S = 64, each with three bound terms: bytes, float32 operations and
    the taps as shared-memory loads (32 a clock on every SM at the card's
    largest SM clock); launches per S = 64 batch from a counted
    ``run_streams`` call."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.haar_frontend import cuda as hcuda
    from repro_torch.kernels.haar_frontend.ref import haar_stage_ref

    det = ex.det
    ii, ii2 = det.integrals(mf)
    items = det.items(ii, ii2).contiguous()
    for si, tables in enumerate(det.stage_tables):
        it = items[:, :det.capacities[si]].contiguous()
        got = hcuda.haar_stage_cuda(ii, it, *tables)
        want = haar_stage_ref(ii, it, *tables)
        if not _bits_equal(got, want):
            raise AssertionError(f"haar_stage {si} {tuple(it.shape)}: max "
                                 f"|err| {max_abs_err(got, want)}")
    tables = det.stage_tables[0]
    bad = mf.clone()
    for f, y, x in ((3, 50, 60), (7, 0, 0), (9, 143, 175)):
        bad[f, y, x] = float("nan")
    nan_ii, nan_ii2 = det.integrals(bad)
    nan_items = det.items(nan_ii, nan_ii2).contiguous()
    got = hcuda.haar_stage_cuda(nan_ii, nan_items, *tables)
    n_nan = int(torch.isnan(got).sum())
    if not _bits_equal(got, haar_stage_ref(nan_ii, nan_items, *tables)) \
            or n_nan == 0:
        raise AssertionError(f"haar_stage with NaN pixels differs from "
                             f"plain ({n_nan} NaN scores)")
    del bad, nan_ii, nan_ii2, nan_items

    streams = torch.stack([torch.roll(frames, 5 * s, dims=0)
                           for s in range(STREAMS)])
    _build.reset_launches()
    ex.run_streams(streams)
    torch.cuda.synchronize()
    launches64 = _build.launches["haar_stage"]
    m64 = ex.stages.motion(streams)[0]
    ii64, ii64_2 = det.integrals(m64.reshape(-1, *m64.shape[-2:]))
    items64 = det.items(ii64, ii64_2).contiguous()
    del streams, m64, ii64_2
    got = hcuda.haar_stage_cuda(ii64, items64, *tables)
    if not _bits_equal(got, haar_stage_ref(ii64, items64, *tables)):
        raise AssertionError(f"haar_stage at S={STREAMS} "
                             f"{tuple(items64.shape)} differs from plain")
    del got
    print(f"haar_stage: stages 0-2 at S=1 {tuple(items.shape[:2])}, stage 0 "
          f"at S={STREAMS} {tuple(items64.shape[:2])} and with 3 NaN pixels "
          f"({n_nan} NaN scores): kernel == plain bit for bit", flush=True)

    offsets = tables[0]
    n_scales, sz, k_slots = offsets.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    rows = []
    for table, it, n, shape in (
            (ii, items, launches["haar_stage"], None),
            (ii64, items64, launches64, f"S={STREAMS} stage 0")):
        n_rows, cap = it.shape[:2]
        taps = n_rows * cap * sz * k_slots
        n_bytes = 4 * (table.numel() + it.numel() + n_rows * cap
                       + offsets.numel() + sz * k_slots + 3 * sz)
        n_ops = n_rows * cap * sz * 21   # 8 mul + 8 add, scale, sub, sign, 2 mul, add
        reps = 3 if shape is None else 1
        rows.append(kernel_row(
            probes, "haar_stage", hcuda, n, 0.0,
            lambda t=table, i=it: hcuda.haar_stage_cuda(t, i, *tables),
            device_ms(lambda t=table, i=it: haar_stage_ref(t, i, *tables),
                      reps=reps, warm=1),
            None, n_bytes, n_ops, PEAK_F32_OPS_S, shape=shape,
            shared_ms=1e3 * taps / (sms * 32 * clock),
            kernel="haar_stage_table_kernel",
            reps=20 if shape is None else 5))
    return rows


def nn_rows(probes, ex, frames, xw, launches):
    """The NN kernel (``quant_nn``) against its plain version, the
    two-layer path of ``ref.nn_forward_ref`` on the same card tensors, bit
    for bit: on the funnel's own windows at S = 1 and at S = 64 streams,
    and on seeded pixels at m = 1, 17 and 5,377 (ragged against its 16-row
    tiles); timed on the S = 1 windows."""
    import torch

    from repro_torch.kernels.quant_matmul import cuda as qcuda
    from repro_torch.kernels.quant_matmul.ref import nn_forward_ref

    q, lut = ex.qnn, ex.lut
    lo, hi, _entries = ex.lut_meta
    args = q.kernel_args(lut, lo, hi)

    def plain(x):
        return nn_forward_ref(x, q.w1_q, q.b1, q.w2_q, q.b2, lut, lut_lo=lo,
                              lut_hi=hi, **q.scales())

    st = ex.stages
    streams = torch.stack([torch.roll(frames, 5 * s, dims=0)
                           for s in range(STREAMS)])
    mf, _fidx, fv, _motion, _md = st.motion(streams)
    dm, n_win, _cd = st.detect(mf, fv)
    x64 = st.gather(mf, dm, n_win)[0].reshape(-1, 400)
    del streams, mf, dm
    gen = torch.Generator(device=xw.device).manual_seed(5)
    cases = [("S=1 windows", xw), (f"S={STREAMS} windows", x64)] + [
        (f"m={m}", torch.rand((m, 400), device=xw.device, generator=gen))
        for m in (1, 17, 5377)]
    for label, x in cases:
        if not _bits_equal(qcuda.quant_nn_cuda(x, args), plain(x)):
            raise AssertionError(f"quant_nn {label} {tuple(x.shape)} differs "
                                 "from plain")
    print("quant_nn: kernel == plain two-layer path bit for bit on "
          + ", ".join(f"{label} ({x.shape[0]} rows)" for label, x in cases),
          flush=True)
    del x64, cases
    m = xw.shape[0]
    n_bytes = 4 * m * 400 + 400 * 8 + 8 + 4 * (8 + 1 + lut.numel() + m)
    n_ops = 2 * m * 400 * 8 + 2 * m * 8
    return [kernel_row(
        probes, "quant_nn", qcuda, launches["quant_nn"], 0.0,
        lambda: qcuda.quant_nn_cuda(xw, args), device_ms(lambda: plain(xw)),
        None, n_bytes, n_ops, PEAK_INT8_OPS_S, shape=f"{m}x400 S=1")]


def gemm_rows(probes, ex, xw, launches):
    """The general int8 GEMM (``quant_matmul``) against
    ``quant_matmul_ref`` bit for bit: both NN layers on the funnel's
    windows, 1024^3, and 1000 x 1000 x 24 (ragged against its tiles, rows
    not 16-byte multiples), each with and without bias and LUT.  Rows at
    the NN's layer-1 shape and at 1024^3, beside ``torch._int_mm``."""
    import torch

    from repro_torch.kernels.quant_matmul import cuda as qcuda
    from repro_torch.kernels.quant_matmul.ref import (
        quant_matmul_ref,
        quantize_static,
    )

    q, lut = ex.qnn, ex.lut
    lo, hi, _entries = ex.lut_meta
    x_q = quantize_static(xw, q.scale_x, q.qmax)
    if not torch.equal(x_q.cpu(), quantize_static(xw.cpu(), q.scale_x,
                                                  q.qmax)):
        raise AssertionError("quantize_static differs between card and host")
    kw1 = dict(scale=float(np.float32(q.scale_x * q.scale_w1)), bias=q.b1,
               lut_lo=lo, lut_hi=hi)
    h = qcuda.quant_matmul_cuda(x_q, q.w1_q, lut, **kw1)
    if not _bits_equal(h, quant_matmul_ref(x_q, q.w1_q, lut, **kw1)):
        raise AssertionError("quant_matmul layer 1 differs from plain")
    h_q = quantize_static(h, q.scale_h, q.qmax)
    kw2 = dict(scale=float(np.float32(q.scale_h * q.scale_w2)), bias=q.b2,
               lut_lo=lo, lut_hi=hi)
    if not _bits_equal(qcuda.quant_matmul_cuda(h_q, q.w2_q, lut, **kw2),
                       quant_matmul_ref(h_q, q.w2_q, lut, **kw2)):
        raise AssertionError("quant_matmul layer 2 differs from plain")
    gen = torch.Generator(device=xw.device).manual_seed(1)
    cases = {}
    for m, k, n in ((1024, 1024, 1024), (1000, 1000, 24)):
        a, b = (torch.randint(-127, 128, shape, dtype=torch.int8,
                              device=xw.device, generator=gen)
                for shape in ((m, k), (k, n)))
        bias = torch.randn((n,), device=xw.device, generator=gen)
        for kw in (dict(scale=1.0, apply_lut=False),
                   dict(scale=2e-6, bias=bias, lut_lo=lo, lut_hi=hi)):
            if not _bits_equal(qcuda.quant_matmul_cuda(a, b, lut, **kw),
                               quant_matmul_ref(a, b, lut, **kw)):
                raise AssertionError(f"quant_matmul {m}x{k}x{n} differs from "
                                     "plain")
        cases[(m, k, n)] = (a, b, dict(scale=1.0, apply_lut=False))
    print(f"quant_matmul: kernel == plain bit for bit at {tuple(x_q.shape)} x "
          f"{tuple(q.w1_q.shape)}, {tuple(h_q.shape)} x {tuple(q.w2_q.shape)}"
          ", 1024^3, 1000x1000x24", flush=True)
    rows = []
    for a, b, kw in ((x_q, q.w1_q, kw1), cases[(1024, 1024, 1024)]):
        m, k = a.shape
        n = b.shape[1]

        def library(a=a, b=b):
            return torch._int_mm(a, b)

        try:
            lib_ms = device_ms(library)
        except RuntimeError as e:             # shape rules of _int_mm
            print(f"torch._int_mm not timed: {e}", flush=True)
            lib_ms, library = None, None
        epi_bytes = 4 * (n + lut.numel()) if "bias" in kw else 0
        rows.append(kernel_row(
            probes, "quant_matmul", qcuda, launches.get("quant_matmul", 0),
            0.0, lambda a=a, b=b, kw=kw: qcuda.quant_matmul_cuda(a, b, lut,
                                                                 **kw),
            device_ms(lambda: quant_matmul_ref(a, b, lut, **kw)), lib_ms,
            m * k + k * n + 4 * m * n + epi_bytes, 2 * m * k * n,
            PEAK_INT8_OPS_S, shape=f"{m}x{k}x{n}", library_fn=library))
    return rows


def _bits_equal(a, b) -> bool:
    """Bit-for-bit equality (float tensors compared as int32 words)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def codec_check(label, blocks, bits_list=(4, 8, 16)):
    """``wire_encode`` and ``wire_decode`` against their plain versions on
    ``blocks`` at each width, bit for bit."""
    from repro_torch.kernels.wire_codec import cuda as wcuda
    from repro_torch.kernels.wire_codec.ref import (
        wire_decode_ref,
        wire_encode_ref,
    )

    for bits in bits_list:
        packed, scales = wcuda.wire_encode_cuda(blocks, bits)
        want_p, want_s = wire_encode_ref(blocks, bits=bits)
        if not (_bits_equal(packed, want_p) and _bits_equal(scales, want_s)):
            raise AssertionError(f"wire_encode {label} {bits}-bit differs "
                                 "from plain")
        del want_p, want_s
        got = wcuda.wire_decode_cuda(packed, scales, bits)
        if not _bits_equal(got, wire_decode_ref(packed, scales, bits=bits)):
            raise AssertionError(f"wire_decode {label} {bits}-bit differs "
                                 "from plain")
    print(f"wire codec {label} {tuple(blocks.shape)} "
          f"{'/'.join(map(str, bits_list))}-bit: kernels == plain bit for "
          "bit", flush=True)


# the profiler's names of the codec's kernels: aligned 256-value blocks
# (every block on the paths) take the vector kernels, any other the scalar
ENCODE_VEC, ENCODE_SCALAR = "wire_encode_vec_kernel", "wire_encode_kernel"
DECODE_VEC, DECODE_SCALAR = "wire_decode_vec_kernel", "wire_decode_kernel"


def codec_kernel_rows(probes, blocks, launches, shape=None, plain_reps=20,
                      bits=8, label=""):
    """The ``wire_encode`` and ``wire_decode`` rows at ``bits`` on
    ``blocks``: bytes in and out at the card's memory rate, or the float
    operations per value (abs, max, div, round, clamp to encode)."""
    from repro_torch.kernels.wire_codec import cuda as wcuda
    from repro_torch.kernels.wire_codec.ops import SCALE_BYTES
    from repro_torch.kernels.wire_codec.ref import (
        wire_decode_ref,
        wire_encode_ref,
    )

    n, nb = blocks.numel(), blocks.shape[0]
    packed, scales = wcuda.wire_encode_cuda(blocks, bits)
    wire = n * bits // 8 + SCALE_BYTES * nb       # packed bytes + scales
    shape = shape and f"{shape}{label}"
    return [
        kernel_row(
            probes, "wire_encode", wcuda, launches["wire_encode"], 0.0,
            lambda: wcuda.wire_encode_cuda(blocks, bits),
            device_ms(lambda: wire_encode_ref(blocks, bits=bits),
                      reps=plain_reps), None,
            4 * n + wire, 5 * n, PEAK_F32_OPS_S, shape=shape,
            kernel=ENCODE_VEC),
        kernel_row(
            probes, "wire_decode", wcuda, launches["wire_decode"], 0.0,
            lambda: wcuda.wire_decode_cuda(packed, scales, bits),
            device_ms(lambda: wire_decode_ref(packed, scales, bits=bits),
                      reps=plain_reps), None,
            wire + 4 * n, n, PEAK_F32_OPS_S, shape=shape,
            kernel=DECODE_VEC),
    ]


def decode_offset_check(label, blocks, probes):
    """``wire_decode`` on packed bytes one byte off 16-byte alignment,
    which take the scalar kernel, against the plain decode at each width;
    the profile phase checks which kernel ran."""
    import torch

    from repro_torch.kernels.wire_codec import cuda as wcuda
    from repro_torch.kernels.wire_codec.ref import (
        wire_decode_ref,
        wire_encode_ref,
    )

    for bits in (4, 8, 16):
        packed, scales = wire_encode_ref(blocks, bits=bits)
        flat = torch.empty(packed.numel() + 1, dtype=torch.int8,
                           device=packed.device)
        shifted = flat[1:].view(packed.shape)
        shifted.copy_(packed)
        if not _bits_equal(wcuda.wire_decode_cuda(shifted, scales, bits),
                           wire_decode_ref(packed, scales, bits=bits)):
            raise AssertionError(f"wire_decode {label} {bits}-bit one byte "
                                 "off alignment differs from plain")
        if bits == 8:
            probes.append((f"wire_decode {label} one byte off alignment",
                           lambda p=shifted, s=scales:
                           wcuda.wire_decode_cuda(p, s, 8), None, None,
                           DECODE_SCALAR))
    print(f"wire codec {label} packed one byte off alignment, 4/8/16-bit: "
          "decode == plain bit for bit", flush=True)


def codec_rows(probes, ex, frames, launches):
    """``wire_encode`` / ``wire_decode`` against their plain versions at
    the sensor cut (4, 8 and 16 bits) and the vj cut (4 bits), and on
    inputs that take the scalar kernels; timed at the sensor cut's 8-bit
    shape; ``launches`` are the offload path's counts (one of each per
    batch and cut)."""
    import torch

    from repro_torch.kernels.wire_codec import cuda as wcuda
    from repro_torch.kernels.wire_codec.ops import BLOCK

    def blocks_of(x):
        return x.reshape(-1, BLOCK).contiguous()

    st = ex.stages
    mframes, _fidx, fvalid, _motion, _md = st.motion(frames[None])
    dmask, n_win_m, _cd = st.detect(mframes, fvalid)
    patches, _wsel, wvalid, _wd = st.gather(mframes, dmask, n_win_m)
    sensor = blocks_of(frames)
    vj = blocks_of(torch.where(wvalid[0, :, :, None, None], patches[0], 0.0))
    codec_check("sensor cut", sensor)
    codec_check("vj cut", vj, (4,))
    # the scalar kernels: blocks of 128 and 512 (both kernels), the
    # sensor's blocks one float off 16-byte alignment (encode) and their
    # packed bytes one byte off (decode); the profile phase checks that
    # each took its scalar kernel
    flat = torch.empty(sensor.numel() + 1, device=sensor.device)
    shifted = flat[1:].view(sensor.shape)
    shifted.copy_(sensor)
    scalar = {"sensor cut as 128-value blocks": sensor.reshape(-1, 128),
              "sensor cut as 512-value blocks": sensor.reshape(-1, 512),
              "sensor cut one float off alignment": shifted}
    for label, blocks in scalar.items():
        codec_check(label, blocks)
        probes.append((f"wire_encode {label}",
                       lambda b=blocks: wcuda.wire_encode_cuda(b, 8), None,
                       None, ENCODE_SCALAR))
        if blocks.shape[1] != BLOCK:
            packed, scales = wcuda.wire_encode_cuda(blocks, 8)
            probes.append((f"wire_decode {label}",
                           lambda p=packed, s=scales:
                           wcuda.wire_decode_cuda(p, s, 8), None, None,
                           DECODE_SCALAR))
    decode_offset_check("sensor cut", sensor, probes)
    return codec_kernel_rows(probes, sensor, launches)


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
    for name in ("integral_image", "haar_stage", "quant_nn"):
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
    return counts, res, flips


def check_counts(label, r, off, key):
    """Windows and auths of a split run against the JAX split executor's
    at the same cut and width: each within the borderline allowance (the
    record holds counts, so a flip is seen only as a count)."""
    n_win, n_auth = int(r.n_windows.sum()), int(r.n_auth.sum())
    ref_win, ref_auth = off.n_windows[key], off.n_auth[key]
    if (abs(n_win - ref_win) > MAX_WINDOW_FLIPS
            or abs(n_auth - ref_auth) > MAX_WINDOW_FLIPS):
        raise AssertionError(
            f"{label}: {n_win} windows, {n_auth} auth; reference {ref_win}, "
            f"{ref_auth}: more than {MAX_WINDOW_FLIPS} apart")
    return n_win, n_auth


def offload_phase(ex, frames, res, flips):
    """Every cut at every codec width against the fused result and the JAX
    split executor's record, then the cut controller on the card.  Returns
    the launch counts of the controller's executed cut and its profile
    target (label, call, wall ms)."""
    import torch

    from repro_torch.bridge import load_offload_reference
    from repro_torch.camera.offload import (
        BACKSCATTER,
        CutController,
        FaceAuthOffloadExecutor,
    )
    from repro_torch.camera.pipelines import (
        FAWorkloadStats,
        calibrate_fa,
        fa_pipeline,
        fa_profiles,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels.wire_codec.ops import wire_bytes

    fields = FA_FIELDS
    codec_field = {"sensor": "frames", "motion": "mframes"}
    off = load_offload_reference()
    offs, nbytes, results = {}, {}, {}
    for cut in CUTS:
        for bits in (None, 16, 8, 4):
            split = offs[(cut, bits)] = FaceAuthOffloadExecutor(
                ex, cut, bits=bits)
            torch.cuda.synchronize()
            _build.reset_launches()
            r, payload = split(frames)
            results[(cut, bits)] = r
            torch.cuda.synchronize()
            counts = dict(_build.launches)
            nb = nbytes[(cut, bits)] = payload.nbytes()
            want = off.nbytes[(cut, bits)]
            n_win, n_auth = check_counts(f"{cut} {bits}", r, off, (cut, bits))
            print(f"offload {cut:6s} bits={bits}: {nb:.3f} B on the wire "
                  f"(reference {want:.3f}), {payload.capacity_bytes():.3f} B "
                  f"padded, {n_win} windows, {n_auth} auth (reference "
                  f"{off.n_windows[(cut, bits)]}, {off.n_auth[(cut, bits)]});"
                  f" launches {counts}", flush=True)
            if not torch.isfinite(r.scores).all():
                raise AssertionError(f"{cut} {bits}: non-finite scores")
            if bits is None:
                for f in fields:
                    if not torch.equal(getattr(r, f), getattr(res, f)):
                        raise AssertionError(f"{cut} raw split: {f} differs "
                                             "from the fused funnel")
            elif (counts.get("wire_encode", 0) < 1
                  or counts.get("wire_decode", 0) < 1):
                raise AssertionError(f"{cut} {bits}: wire codec not launched")
            if cut in codec_field:
                if nb != want:
                    raise AssertionError(f"{cut} {bits}: {nb} wire bytes != "
                                         f"reference {want}")
                if bits is not None:
                    name = codec_field[cut]
                    for arr, ref_sha in ((name, off.packed_sha256),
                                         (name + "_scales", off.scales_sha256)):
                        got = hashlib.sha256(
                            payload.arrays[arr].cpu().numpy().tobytes()
                        ).hexdigest()
                        if got != ref_sha[(cut, bits)]:
                            raise AssertionError(f"{cut} {bits}: {arr} hash "
                                                 "differs from the reference")
            else:
                per_window = 400 if cut == "vj" else 1
                window_b = (wire_bytes(per_window, bits) + 4.0
                            + (0.125 if cut == "nn" else 0.0))
                if abs(nb - want) > flips * window_b:
                    raise AssertionError(
                        f"{cut} {bits}: {nb} wire bytes, reference {want}: "
                        f"more than {flips} flipped windows' worth")
            if cut == "nn" and bits == 8:
                for f in ("motion", "n_windows", "n_auth", "auth",
                          "window_id", "window_valid"):
                    if not torch.equal(getattr(r, f), getattr(res, f)):
                        raise AssertionError(f"8-bit nn cut changed {f}")
                d = float((r.scores - res.scores).abs().max())
                if d >= 1.0 / 127:
                    raise AssertionError(f"8-bit nn cut moved a score by {d}")
    print("offload: raw splits == fused at every cut; sensor/motion payload "
          "hashes and bytes == reference at 16/8/4 bits; windows and auths "
          f"within {MAX_WINDOW_FLIPS} of the reference at every cut and "
          "width", flush=True)
    for bits in (None, 16, 8, 4):
        b = [nbytes[(cut, bits)] for cut in CUTS]
        if not b[0] > b[1] > b[2] > b[3]:
            raise AssertionError(f"bits={bits}: bytes do not shrink down "
                                 f"the funnel: {b}")

    B = frames.shape[0]
    stats = FAWorkloadStats(
        n_frames=B, motion_frames=max(int(res.motion.sum()), 1),
        windows_to_nn=max(int(res.n_windows.sum()), 1))
    cal = calibrate_fa(stats)
    profiles = fa_profiles()
    profiles["nn"] = cal.nn_profile()
    link = dataclasses.replace(BACKSCATTER,
                               joules_per_byte=cal.rf_joules_per_byte)
    ctl = CutController(
        lambda cut: offs[(cut, 8)], cuts=CUTS, template=fa_pipeline(stats),
        profiles=profiles, link=link, regime="energy", unit_rate_hz=1.0,
        duties=DUTIES)
    for m in ctl.calibrate(frames, reps=10):
        print(f"controller cut={m.cut:6s} node={1e3 * m.node_s / B:.5f} ms "
              f"cloud={1e3 * m.cloud_s / B:.5f} ms per frame "
              f"(node {1e3 * m.node_s:.4f} ms, cloud {1e3 * m.cloud_s:.4f} ms"
              f" per {B}-frame batch), wire {m.bytes_per_unit:.3f} B/frame "
              f"(padded {m.capacity_bytes / B:.3f})", flush=True)
    rep = ctl.report()
    for cut in CUTS:
        print(f"controller objective {cut:6s} measured "
              f"{1e6 * rep.measured_objectives[cut]:.4f} uW, predicted "
              f"{1e6 * rep.predicted_objectives[cut]:.4f} uW", flush=True)
    print(f"controller: chosen={rep.chosen_cut} measured_best="
          f"{rep.measured_best_cut} agrees={rep.agrees} rank_agreement="
          f"{rep.rank_agreement:.2f}", flush=True)
    if not rep.agrees:
        raise AssertionError("the controller's choice is not the measured "
                             "optimum")
    torch.cuda.synchronize()
    _build.reset_launches()
    result, payload, sol = ctl.execute(frames)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    print(f"offload path (controller executes cut={sol.cut_after}, 8-bit): "
          f"{payload.nbytes() / B:.3f} B/frame, launches {counts}",
          flush=True)
    for name in ("integral_image", "haar_stage", "quant_nn",
                 "wire_encode", "wire_decode"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"offload path never launched {name}")
    # the executed cut is the sweep's run of the same cut and width, which
    # was held to the JAX record above; hold the executed result to both
    check_counts(f"executed {sol.cut_after} 8", result, off,
                 (sol.cut_after, 8))
    swept = results[(sol.cut_after, 8)]
    for f in fields:
        if not torch.equal(getattr(result, f), getattr(swept, f)):
            raise AssertionError(f"executed cut: {f} differs from the sweep")
    chosen = offs[(sol.cut_after, 8)]
    wall = host_ms(lambda: chosen(frames))
    print(f"offload cut={sol.cut_after} 8-bit: {wall:.4f} ms per {B}-frame "
          "batch, node and cloud (median of 7)", flush=True)
    return counts, (f"offload cut={sol.cut_after} 8-bit",
                    lambda: chosen(frames), wall)


# -- §IV VR rig ---------------------------------------------------------------

VR_CUTS = ("capture", "depth", "stitch")
DEPTH_ATOL = 1e-5     # card vs CPU port: same IEEE operations, 0 expected
PANO_ATOL = 1e-6      # tests/test_stitch.py's own tolerance
INJECTED_ATOL = 1e-5  # XLA's FMA in slice_grid; 1.9e-6 at the CPU fixtures
NEAR_TOL = 1e-3       # float32 warp coordinates at 4K are off by < 5e-4
CODEC_SLACK = 1e-6    # float32 rounding of the scale, x / scale and blend


def vr_rig(h, w, seeds, device):
    from repro_torch.camera.synthetic import stereo_pair

    import torch
    pairs = [stereo_pair(h=h, w=w, seed=s)[:2] for s in seeds]
    return (torch.as_tensor(np.stack([p[0] for p in pairs]), device=device),
            torch.as_tensor(np.stack([p[1] for p in pairs]), device=device))


def cost_volume64(left, right, max_disp: int, patch: int, y0: int, x0: int,
                  hh: int, ww: int):
    """(max_disp + 1, hh, ww) float64 SADs at rows y0.., columns x0..: the
    same float32 pixel differences as ``bssa.cost_volume``, summed directly
    in float64 with edge replication.  ``cost_volume - cost_volume64`` is
    the rounding of the float32 box sums, which decides the near-tie rule
    for winners that differ between two float32 implementations."""
    import torch

    h, w = left.shape
    pad = patch // 2
    dev = left.device
    ys = torch.arange(y0 - pad, y0 + hh + pad, device=dev).clamp(0, h - 1)
    xs = torch.arange(x0 - pad, x0 + ww + pad, device=dev).clamp(0, w - 1)
    lw = left[ys][:, xs]
    out = torch.empty((max_disp + 1, hh, ww), dtype=torch.float64,
                      device=dev)
    for d in range(max_disp + 1):
        diff = (lw - right[ys][:, (xs - d).clamp(0, w - 1)]).abs().double()
        s = torch.zeros((hh, ww), dtype=torch.float64, device=dev)
        for dy in range(patch):
            for dx in range(patch):
                s += diff[dy:dy + hh, dx:dx + ww]
        out[d] = s
    return out


def near_integer_canvas(h: int, w: int, n: int, focal: float | None = None,
                        overlap_frac: float = 0.15,
                        tol: float = NEAR_TOL) -> np.ndarray:
    """(h, total_w) bool over the canvas of ``stitch_ring`` on n views of
    (h, w): the pixels fed by a view pixel whose float64 source coordinate
    lies within ``tol`` of an integer or of the valid range's border.
    Only there may a float32 map (the reference's) pick another source
    pixel than the port's."""
    from repro_torch.camera.stitch import warp_coords

    f = focal or 0.8 * w
    x, y = warp_coords(h, w, f)

    def near(c, hi):
        return ((np.abs(c - np.round(c)) < tol) | (np.abs(c) < tol)
                | (np.abs(c - hi) < tol))

    view = near(x, w) | near(y, h)
    step = w - int(w * overlap_frac)
    canvas = np.zeros((h, step * (n - 1) + w), bool)
    for i in range(n):
        canvas[:, i * step:i * step + w] |= view
    return canvas


def near_tie_check(label, left, right, d_port, d_jax, e_jax, y0, x0, md):
    """Every pixel where the card's winner differs from JAX's is a near
    tie: |SAD64(d_port) - SAD64(d_jax)| <= 2 max(E_port, E_jax), E_port
    measured here from the card's own cost volume.  Returns (agreement,
    near ties, E_port)."""
    import torch

    from repro_torch.camera.bssa import cost_volume

    hh, ww = d_jax.shape
    vol = cost_volume(left, right, md)[:, y0:y0 + hh, x0:x0 + ww]
    if not torch.equal(vol.argmin(dim=0), d_port):
        raise AssertionError(f"{label}: cost volume does not give the "
                             "rough disparity's winners")
    vol64 = cost_volume64(left, right, md, 5, y0, x0, hh, ww)
    e_port = float((vol.double() - vol64).abs().max())
    tau = 2 * max(e_port, float(e_jax))
    dis = d_port != d_jax
    gap = (vol64.gather(0, d_port[None]) - vol64.gather(0, d_jax[None]))[0]
    worst = float(gap.abs()[dis].max()) if bool(dis.any()) else 0.0
    if worst > tau:
        raise AssertionError(f"{label}: a disagreement {worst} exceeds "
                             f"tau = {tau}")
    return 1.0 - float(dis.double().mean()), int(dis.sum()), e_port


def pano_check(label, got, want, near):
    """Panorama samples against JAX's within PANO_ATOL, except where a
    float32 warp map may pick another source pixel."""
    diff = np.abs(got - want)
    bad = int(((diff > PANO_ATOL) & ~near).sum())
    at_near = float(diff[near].max()) if near.any() else 0.0
    print(f"{label}: {got.size} samples, {int((diff == 0).sum())} bit-equal,"
          f" max |diff| {float(diff[~near].max()):g} off {int(near.sum())} "
          f"near-integer samples (max there {at_near:g})", flush=True)
    if bad:
        raise AssertionError(f"{label}: {bad} samples off by more than "
                             f"{PANO_ATOL}")


def vr_phase(vr):
    """§IV VR rig at full width: one counted rig frame, timings, the card
    against the port on the CPU and against the JAX record, the working
    size against the JAX record.  Returns (executor, views, launch
    counts, rig-frame wall ms)."""
    import torch

    from repro_torch.camera import bssa
    from repro_torch.camera.pipelines import VR_FPS_TARGET, VRRigExecutor
    from repro_torch.kernels import _build
    from repro_torch.kernels.bilateral_blur.cuda import MAX_STEPS
    from repro_torch.kernels.bilateral_blur.ops import refine_grid

    p = vr.params
    H, W = vr.full_hw
    md = p["max_disp"]
    spec = bssa.GridSpec(p["sigma_spatial"])
    kw = dict(max_disp=md, n_iters=p["n_iters"], ipd_px=p["ipd_px"])
    ex = VRRigExecutor(spec, device="cuda", **kw)
    if ((ex.spec.sigma_spatial, ex.max_disp, ex.n_iters, ex.ipd_px)
            != (p["sigma_spatial"], md, p["n_iters"], p["ipd_px"])
            or p["n_pairs"] != len(p["seeds"])):
        raise AssertionError(f"rig parameters differ from the record {p}")
    t0 = time.perf_counter()
    lefts, rights = vr_rig(H, W, p["seeds"], "cuda")
    print(f"VR rig: {len(p['seeds'])} pairs of {H}x{W}, sigma "
          f"{p['sigma_spatial']}, max_disp {md}, n_iters {p['n_iters']}, "
          f"ipd {p['ipd_px']} (views made in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # 1. one counted rig frame
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    lp, rp, depths = ex(lefts, rights)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_chunks = -(-(md + 1) // 8)
    n_blur = -(-p["n_iters"] // MAX_STEPS)        # 1: 8 steps a launch
    print(f"VR path launches: {counts} (expected integral_image "
          f"{n_chunks}, bilateral_blur {n_blur}); peak "
          f"{peak:.2f} GiB", flush=True)
    if (counts.get("integral_image", 0) != n_chunks
            or counts.get("bilateral_blur", 0) != n_blur):
        raise AssertionError(f"VR path launches {counts}")
    if tuple(lp.shape) != vr.full_pano_shape or depths.shape != lefts.shape:
        raise AssertionError(f"VR shapes {tuple(lp.shape)} "
                             f"{tuple(depths.shape)}")
    for name, t in (("left pano", lp), ("right pano", rp), ("depth", depths)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"VR {name} is not finite")
    ms_depth = host_ms(lambda: ex.depth_maps(lefts, rights), reps=5)
    ms_pano = host_ms(lambda: ex.panorama(lefts, rights, depths), reps=5)
    ms_frame = host_ms(lambda: ex(lefts, rights), reps=5)
    print(f"VR rig frame: depth {ms_depth:.3f} ms, panorama {ms_pano:.3f} ms"
          f", whole frame {ms_frame:.3f} ms = {1e3 / ms_frame:.2f} FPS "
          f"(target {VR_FPS_TARGET:g}; host clock, synchronised, median of "
          "5)", flush=True)

    # 2. the card against the port on the CPU, pair 0, full width
    t0 = time.perf_counter()
    cpu = VRRigExecutor(spec, device="cpu", **kw)
    l0, r0 = lefts[:1], rights[:1]
    rough_c = bssa.rough_disparity(l0, r0, md)
    rough_h = bssa.rough_disparity(l0.cpu(), r0.cpu(), md)
    if not torch.equal(rough_c.cpu(), rough_h):
        raise AssertionError("pair 0 rough disparity: card != CPU")
    gc = bssa.splat(l0, rough_c, spec)
    gh = bssa.splat(l0.cpu(), rough_h, spec)
    for a, b in zip(gc, gh):
        if not _bits_equal(a.cpu(), b):
            raise AssertionError("pair 0 splatted grids: card != CPU")
    d_c = ex.depth_maps(l0, r0)
    d_h = cpu.depth_maps(l0.cpu(), r0.cpu())
    pc, ph = ex.panorama(l0, r0, d_c), cpu.panorama(l0.cpu(), r0.cpu(), d_h)
    errs = [max_abs_err(d_c.cpu(), d_h)] + [max_abs_err(a.cpu(), b)
                                             for a, b in zip(pc, ph)]
    print(f"VR pair 0 card vs CPU port: rough equal, grids bit-equal, "
          f"depth max |diff| {errs[0]:g}, panoramas {errs[1]:g} "
          f"{errs[2]:g} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if errs[0] > DEPTH_ATOL or max(errs[1:]) > PANO_ATOL:
        raise AssertionError(f"pair 0 card vs CPU: {errs}")

    # 3. the card against JAX at full width: the four crops, the panorama
    crop = p["crop"]
    rough0 = bssa.rough_disparity(lefts[0], rights[0], md).to(torch.int64)
    for (y0, x0), want, e_jax in zip(vr.full_crop_origins, vr.full_crops,
                                     vr.full_e_jax):
        y0, x0 = int(y0), int(x0)
        d_jax = torch.as_tensor(want.astype(np.int64), device="cuda")
        agree, n_tie, e_port = near_tie_check(
            f"4K crop ({y0}, {x0})", lefts[0], rights[0],
            rough0[y0:y0 + crop, x0:x0 + crop], d_jax, e_jax, y0, x0, md)
        print(f"VR 4K crop ({y0},{x0}): agreement {agree:.5f}, {n_tie} near "
              f"ties, E_port {e_port:g}, E_jax {float(e_jax):g}", flush=True)
    s = p["full_pano_stride"]
    near = near_integer_canvas(H, W, len(p["seeds"]))
    pano_check("VR 4K left panorama vs JAX", lp.cpu().numpy()[::s, ::s],
               vr.full_lpano, near[::s, ::s])
    s = p["full_stride"]
    dd = np.abs(depths[0].cpu().numpy()[::s, ::s] - vr.full_depth0)
    hist = np.stack([np.bincount(
        bssa.rough_disparity(lefts[i], rights[i], md).to(torch.int64)
        .reshape(-1).cpu().numpy(), minlength=md + 1)
        for i in range(len(p["seeds"]))])
    print(f"VR 4K pair 0 depth vs JAX at stride {s}: max |diff| "
          f"{float(dd.max()):g}, mean {float(dd.mean()):g}; rough histograms"
          f": {int(np.abs(hist - vr.full_hist).sum()) // 2} of "
          f"{int(vr.full_hist.sum())} pixels moved between bins", flush=True)

    # 4. the card against JAX at the working size
    h, w = vr.work_hw
    wl, wr = vr_rig(h, w, p["seeds"], "cuda")
    wrough = bssa.rough_disparity(wl, wr, md).to(torch.int64)
    for i in range(len(p["seeds"])):
        d_jax = torch.as_tensor(vr.work_rough[i].astype(np.int64),
                                device="cuda")
        agree, n_tie, e_port = near_tie_check(
            f"working pair {i}", wl[i], wr[i], wrough[i], d_jax,
            vr.work_e_jax[i], 0, 0, md)
        print(f"VR {h}x{w} pair {i}: agreement {agree:.5f}, {n_tie} near "
              f"ties, E_port {e_port:g}, E_jax {float(vr.work_e_jax[i]):g}",
              flush=True)
        if agree < 0.99:
            raise AssertionError(f"working pair {i}: agreement {agree}")
    injected = torch.as_tensor(vr.work_rough[0].astype(np.float32),
                               device="cuda")
    gv, gw = bssa.splat(wl[0], injected, spec)
    dep = bssa.slice_grid(*refine_grid(gv, gw, p["n_iters"]), wl[0], spec)
    err = max_abs_err(dep.cpu(), torch.as_tensor(vr.work_depth0))
    print(f"VR {h}x{w} pair 0 with JAX's rough injected: depth max |diff| "
          f"{err:g} (atol {INJECTED_ATOL:g})", flush=True)
    if err > INJECTED_ATOL:
        raise AssertionError(f"injected-rough depth differs by {err}")
    wlp, _ = ex.panorama(wl, wr, torch.zeros_like(wl))
    s = p["work_pano_stride"]
    pano_check(f"VR {h}x{w} left panorama vs JAX",
               wlp.cpu().numpy()[::s, ::s], vr.work_lpano,
               near_integer_canvas(h, w, len(p["seeds"]))[::s, ::s])
    return ex, (lefts, rights), (lp, rp, depths), counts, ms_frame


def codec_fields_check(label, split, pay, sources):
    """Each codec field of a VR payload against the plain codec on the
    same card tensors, bit for bit: the kernel's bytes and scales against
    the plain encode of the field's source, and the executor's decode of
    them (the kernel) against the plain decode."""
    from repro_torch.core.reduction import flat_blocks
    from repro_torch.kernels.wire_codec.ref import (
        wire_decode_ref,
        wire_encode_ref,
    )

    cdc = split.codec
    for field, src in sources.items():
        packed, scales = pay.arrays[field], pay.arrays[field + "_scales"]
        want_p, want_s = wire_encode_ref(
            flat_blocks(src, cdc.block).contiguous(), bits=cdc.bits)
        if not (_bits_equal(packed, want_p) and _bits_equal(scales, want_s)):
            raise AssertionError(f"{label}: wire_encode of {field} "
                                 f"{tuple(packed.shape)} differs from plain")
        del want_p, want_s
        got = cdc.dec(pay.arrays, field, tuple(src.shape))
        want = wire_decode_ref(packed, scales, bits=cdc.bits).reshape(-1)[
            :src.numel()].reshape(src.shape)
        if not _bits_equal(got, want):
            raise AssertionError(f"{label}: wire_decode of {field} "
                                 f"{tuple(packed.shape)} differs from plain")


def vr_offload_phase(vr, ex, views, fused):
    """Every cut x bits of ``VROffloadExecutor`` at full width against the
    fused rig frame, the JAX record and the plain codec, then the cut
    controller in the throughput regime.  Returns the launch counts of
    the capture runs by codec width."""
    import torch

    from repro_torch.camera.offload import (
        ETH_25G_LINK,
        CutController,
        VROffloadExecutor,
    )
    from repro_torch.camera.pipelines import (
        VRWorkloadStats,
        vr_pipeline,
        vr_profiles,
    )
    from repro_torch.core.costmodel import VIRTEX_FPGA
    from repro_torch.kernels import _build

    lefts, rights = views
    lp0, rp0, depths = fused
    # what each cut's rig half encodes, from the fused rig frame; the raw
    # split's payload must hold exactly these tensors
    sources = {"lefts": lefts, "rights": rights, "depths": depths,
               "left_pano": lp0, "right_pano": rp0}
    amax = float(lefts.abs().max())
    offs, err, codec_counts, swept = {}, {}, {}, {}
    for cut in VR_CUTS:
        fields = {f: sources[f]
                  for f in VROffloadExecutor.PAYLOAD_SCHEMA[cut].codec}
        for bits in (None, 16, 8, 4):
            split = offs[(cut, bits)] = VROffloadExecutor(ex, cut, bits=bits)
            torch.cuda.synchronize()
            _build.reset_launches()
            (lp, rp), pay = split(lefts, rights)
            torch.cuda.synchronize()
            counts = dict(_build.launches)
            nb, want = pay.nbytes(), vr.full_wire_b[(cut, bits)]
            err[(cut, bits)] = max_abs_err(lp, lp0)
            print(f"VR offload {cut:7s} bits={bits}: {nb:.1f} B on the wire "
                  f"(reference {want:.1f}), left pano max |diff| "
                  f"{err[(cut, bits)]:g}; launches {counts}", flush=True)
            if nb != want:
                raise AssertionError(f"VR {cut} {bits}: wire bytes {nb} != "
                                     f"{want}")
            if bits is None:
                if not (torch.equal(lp, lp0) and torch.equal(rp, rp0)):
                    raise AssertionError(f"VR {cut} raw split differs from "
                                         "the fused rig frame")
                for f, src in fields.items():
                    if not torch.equal(pay.arrays[f].reshape(src.shape),
                                       src):
                        raise AssertionError(f"VR {cut} raw payload {f} is "
                                             "not the fused frame's")
            elif (counts.get("wire_encode", 0) < 1
                  or counts.get("wire_decode", 0) < 1):
                raise AssertionError(f"VR {cut} {bits}: codec not launched")
            else:
                if cut == "capture":
                    codec_counts[bits] = counts
                codec_fields_check(f"VR {cut} {bits}-bit", split, pay,
                                   fields)
                # the left panorama depends on no coded field but the
                # left views (or is coded itself), and blends values with
                # weights summing to 1: its error is at most the code's
                # half step, amax / (2 qmax), plus float32 rounding
                half = amax / (2 * (2 ** (bits - 1) - 1))
                if err[(cut, bits)] > half + CODEC_SLACK:
                    raise AssertionError(
                        f"VR {cut} {bits}-bit: left pano error "
                        f"{err[(cut, bits)]} above the half step {half}")
            if bits == 8:
                swept[cut] = lp
            if cut == "capture" and bits is not None:
                for field in ("lefts", "lefts_scales", "rights",
                              "rights_scales"):
                    got = hashlib.sha256(
                        pay.arrays[field].cpu().numpy().tobytes()).hexdigest()
                    if got != vr.capture_sha256[(bits, field)]:
                        raise AssertionError(f"VR capture {bits}: {field} "
                                             "hash differs from JAX's")
            del pay, lp, rp
    if not (err[("capture", 8)] < 0.02
            and err[("capture", 4)] > err[("capture", 8)]):
        raise AssertionError(f"VR knee: 8-bit {err[('capture', 8)]}, 4-bit "
                             f"{err[('capture', 4)]}")
    print("VR offload: raw splits == fused at every cut; wire bytes == JAX "
          "record at every cut x bits; codec kernels == plain bit for bit on "
          "every coded field; capture payload hashes == JAX at 16/8/4 bits; "
          "left pano within the code's half step at every coded run (views'"
          f" max |x| {amax:g}); knee: 8-bit {err[('capture', 8)]:g} < 0.02, "
          f"4-bit {err[('capture', 4)]:g} above it", flush=True)

    ctl = CutController(
        lambda cut: offs[(cut, 8)], cuts=VR_CUTS,
        template=vr_pipeline(VRWorkloadStats()),
        profiles=vr_profiles(VIRTEX_FPGA), link=ETH_25G_LINK,
        regime="throughput")
    for m in ctl.calibrate(lefts, rights, units=1, reps=3):
        print(f"VR controller cut={m.cut:7s} node {1e3 * m.node_s:.3f} ms, "
              f"cloud {1e3 * m.cloud_s:.3f} ms, wire {m.wire_bytes:.1f} B "
              "per rig frame", flush=True)
    rep = ctl.report()
    print("VR controller FPS per cut (measured, predicted): " + ", ".join(
        f"{c} {-rep.measured_objectives[c]:.2f} "
        f"{-rep.predicted_objectives[c]:.2f}" for c in VR_CUTS), flush=True)
    print(f"VR controller: chosen={rep.chosen_cut} measured_best="
          f"{rep.measured_best_cut} agrees={rep.agrees}", flush=True)
    if not rep.agrees:
        raise AssertionError("VR controller's choice is not the measured "
                             "optimum")
    (lp, _rp), _pay, sol = ctl.execute(lefts, rights)
    if not torch.equal(lp, swept[sol.cut_after]):
        raise AssertionError(f"VR executed cut {sol.cut_after} differs from "
                             "the sweep's run of it")
    print(f"VR controller executed cut={sol.cut_after} 8-bit: left panorama "
          "equal to the sweep's run of that cut", flush=True)
    return codec_counts


# -- offload resilience -------------------------------------------------------

def _same_result(a, b) -> bool:
    import torch
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FA_FIELDS)


def _decodes():
    from repro_torch.kernels import _build
    return _build.launches["wire_decode"]


def counted_sends(sess, inputs, n):
    """``n`` sends of ``inputs`` through ``sess``; returns the results and
    the ``wire_decode`` launches of each send, and checks that every send
    whose payload was delivered (not the on-node fallback) launched the
    decode kernel and that no other send did."""
    import torch

    results, launches = [], []
    for _ in range(n):
        before = _decodes()
        got, rec = sess.send(*inputs)
        torch.cuda.synchronize()
        moved = _decodes() - before
        if (moved > 0) != (rec.delivered and not rec.fallback
                           and rec.bits is not None):
            raise AssertionError(f"send {rec.seq} ({rec.cut}, {rec.bits}, "
                                 f"delivered {rec.delivered}, fallback "
                                 f"{rec.fallback}): {moved} decode launches")
        results.append(got)
        launches.append(moved)
    return results, launches


def _injector(cell):
    from repro_torch.camera.offload import FaultInjector, GilbertElliott

    return FaultInjector(
        loss=GilbertElliott(p_gb=cell["p_gb"], p_bg=cell["p_bg"]),
        outage_period_s=cell["outage_period_s"],
        outage_duty=cell["outage_duty"],
        corrupt_fraction=cell["corrupt_fraction"], seed=cell["seed"])


def ladder_cell(ex, frames, make, cell, injector):
    """One laddered session (cut at 16, 8, 4 bits, then on-node) of
    ``cell["sends"]`` sends; returns the session, each send's auth
    decisions (None when undelivered) and its decode launches."""
    from repro_torch.camera.offload import (
        ON_NODE,
        DegradationLadder,
        OffloadSession,
    )

    rungs = [(cell["cut"], b) for b in (16, 8, 4)] + [ON_NODE]
    sess = OffloadSession(make_executor=make, cut=cell["cut"], bits=16,
                          injector=injector,
                          ladder=DegradationLadder(rungs),
                          on_node_fn=lambda f: ex(f))
    results, launches = counted_sends(sess, (frames,), cell["sends"])
    auths = [None if r is None else r.auth for r in results]
    return sess, auths, launches


def cell_metrics(sess, auths, base_sess, base_auths) -> dict:
    """benchmarks/offload_resilience.py's numbers of one ladder cell."""
    flips = [float((a != b).float().mean())
             for a, b in zip(auths, base_auths) if a is not None]
    retx = sum(r.attempts - 1 for r in sess.records)
    att = sum(r.attempts for r in sess.records)
    return dict(flip=float(np.mean(flips)) if flips else 1.0,
                retx_overhead=retx / max(att - retx, 1),
                energy_ratio=sess.energy_j / base_sess.energy_j,
                delivered=float(np.mean([a is not None for a in auths])),
                final_rung=tuple(sess.ladder.rung))


class _CountingSaves:
    """Counts the bytes the session's commit points write (wraps the
    resilience module's ``save_checkpoint`` while in use)."""

    def __enter__(self):
        from repro_torch.camera.offload import resilience

        self.module, self.saved = resilience, resilience.save_checkpoint
        self.bytes = self.saves = 0

        def save(ckpt_dir, step, tree, **kw):
            path = self.saved(ckpt_dir, step, tree, **kw)
            self.saves += 1
            self.bytes += sum(os.path.getsize(os.path.join(path, f))
                              for f in os.listdir(path))
            return path

        resilience.save_checkpoint = save
        return self

    def __exit__(self, *exc):
        self.module.save_checkpoint = self.saved


def resilience_phase(ex, frames, vr_ex, views):
    """The offload resilience layer on the card at full width, against the
    JAX record ``assets/resilience_reference.npz``: (a) zero-fault
    sessions at every cut x bits, (b) the motion-ladder cells, (c) the 12
    nn-ladder cells and the determinism cell, (d) the brownout run, (e)
    congestion, (f) VR sessions at 16 x 4K, (g) decode launches per
    send."""
    import shutil
    import tempfile

    import torch

    from repro_torch.bridge import load_resilience_reference
    from repro_torch.camera.offload import (
        BACKSCATTER,
        BrownoutModel,
        FaceAuthOffloadExecutor,
        FaultInjector,
        GilbertElliott,
        OffloadSession,
        VROffloadExecutor,
        fleet_link_report,
        payload_checksum,
    )
    from repro_torch.kernels import _build

    ref = load_resilience_reference()
    offs = {}

    def make(cut, bits):
        if (cut, bits) not in offs:
            offs[(cut, bits)] = FaceAuthOffloadExecutor(ex, cut, bits=bits)
        return offs[(cut, bits)]

    # (a) zero-fault pin, with (g) the decode launches of each send
    per_send = {}
    for cut in CUTS:
        for bits in (None, 16, 8, 4):
            want, payload = make(cut, bits)(frames)
            crc = payload_checksum(payload)
            sess = OffloadSession(make(cut, bits))
            (got,), (moved,) = counted_sends(sess, (frames,), 1)
            rec = sess.records[0]
            ref_crc = ref.crc[(cut, bits)]
            per_send[(cut, bits)] = moved
            print(f"resilience zero-fault {cut:6s} bits={bits}: crc "
                  f"{crc:#010x} (JAX {ref_crc:#010x}), {rec.payload_bytes} B,"
                  f" {moved} decode launches", flush=True)
            if not (_same_result(got, want) and rec.delivered
                    and rec.attempts == 1):
                raise AssertionError(f"zero-fault session {cut} {bits} "
                                     "differs from the split executor")
            if int(sess.received[0]["crc"]) != crc:
                raise AssertionError(f"{cut} {bits}: receiver's crc differs")
            if cut in ("sensor", "motion") and crc != ref_crc:
                raise AssertionError(f"{cut} {bits}: payload crc differs "
                                     "from JAX's")
            if moved != (0 if bits is None else 1):
                raise AssertionError(f"{cut} {bits}: {moved} decode launches "
                                     "in one send")
    print("resilience (a): zero-fault sessions == split executor bit for bit"
          " at 4 cuts x None/16/8/4; sensor and motion payload crcs == "
          "JAX's", flush=True)

    # (b) motion-ladder cells: the record's, tuple for tuple
    base = {}
    for cut in ("motion", "nn"):
        sess, auths, _l = ladder_cell(ex, frames, make,
                                      dict(cut=cut, sends=40), None)
        base[cut] = (sess, auths)
    launches_by_bits: dict = {}
    for name, cell in ref.cells.items():
        if not name.startswith("motion_"):
            continue
        sess, auths, launches = ladder_cell(ex, frames, make, cell,
                                            _injector(cell))
        got = [dataclasses.astuple(r) for r in sess.records]
        m = cell_metrics(sess, auths, *base["motion"])
        print(f"resilience {name}: {m} (JAX {ref.metrics[name]})",
              flush=True)
        if got != ref.records[name]:
            bad = next(i for i, (a, b) in enumerate(
                zip(got, ref.records[name])) if a != b)
            raise AssertionError(f"{name}: send {bad} {got[bad]} != JAX "
                                 f"{ref.records[name][bad]}")
        for rec, n in zip(sess.records, launches):
            launches_by_bits.setdefault(rec.bits, set()).add(n)
    print("resilience (b): the motion-ladder cells' delivery records == "
          "JAX's, tuple for tuple", flush=True)

    # (c) the 12 nn-ladder cells
    for name, cell in ref.cells.items():
        if name.startswith("motion_"):
            continue
        sess, auths, launches = ladder_cell(ex, frames, make, cell,
                                            _injector(cell))
        m = cell_metrics(sess, auths, *base["nn"])
        want = ref.metrics[name]
        print(f"resilience {name}: delivered {m['delivered']:.4f} (JAX "
              f"{want['delivered']:.4f}), retx {m['retx_overhead']:.4f} "
              f"({want['retx_overhead']:.4f}), energy ratio "
              f"{m['energy_ratio']:.4f} ({want['energy_ratio']:.4f}), flip "
              f"{m['flip']:.4f} ({want['flip']:.4f}), final rung "
              f"{m['final_rung']} ({want['final_rung']})", flush=True)
        if cell["outage_duty"] == 0.0:
            keys = (5, 6, 7, 3, 4, 1, 2)   # attempts, lost, corrupt,
            #                                delivered, fallback, cut, bits
            got = [tuple(dataclasses.astuple(r)[k] for k in keys)
                   for r in sess.records]
            want_r = [tuple(r[k] for k in keys) for r in ref.records[name]]
            if got != want_r:
                raise AssertionError(f"{name}: outcomes differ from JAX's")
        elif abs(m["delivered"] - want["delivered"]) > 1.0 / cell["sends"]:
            raise AssertionError(f"{name}: delivery fraction "
                                 f"{m['delivered']} vs JAX "
                                 f"{want['delivered']}")
        for rec, n in zip(sess.records, launches):
            launches_by_bits.setdefault(rec.bits, set()).add(n)
    print("resilience (c): outcomes == JAX's send for send in the duty-0 "
          "cells and the determinism cell; delivery within 1/40 of JAX's in "
          "the duty > 0 cells", flush=True)

    # (d) the brownout run
    bp = ref.brownout["params"]
    off8 = make("nn", 8)
    want, _ = off8(frames)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        bsess = OffloadSession(
            off8, injector=FaultInjector(brownout=BrownoutModel(
                harvest_w=bp["harvest_w"], storage_j=bp["storage_j"],
                load_w=bp["load_w"], jitter=bp["jitter"]), seed=bp["seed"]),
            ckpt_dir=ckpt, stage_cost_s=bp["stage_cost_s"])
        results, _l = counted_sends(bsess, (frames,), bp["sends"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if not all(_same_result(r, want) for r in results):
        raise AssertionError("brownout resume differs from the fused 8-bit "
                             "split executor")
    if any(bsess.stage_completed.get(s, 0) > bp["sends"]
           for s in ("motion", "detect", "gather")):
        raise AssertionError(f"an upstream stage re-ran: "
                             f"{bsess.stage_completed}")
    jrec = ref.records["brownout"]
    recs = bsess.records
    print(f"resilience (d) brownout: {sum(r.brownouts for r in recs)} "
          f"brownouts, {sum(r.restores for r in recs)} restores, mean "
          f"recovery {np.mean([r.recovery_s for r in recs]):.4f} s (JAX "
          f"{sum(r[13] for r in jrec)}, {sum(r[14] for r in jrec)}, "
          f"{np.mean([r[15] for r in jrec]):.4f}); stages started "
          f"{bsess.stage_started} completed {bsess.stage_completed} (JAX "
          f"{ref.brownout['stage_started']}, "
          f"{ref.brownout['stage_completed']}); every result == the split "
          "executor's", flush=True)

    # (e) congestion
    cg = ref.congestion

    def fleet(faulty):
        sessions = []
        for s in range(3):
            inj = (FaultInjector(loss=GilbertElliott(p_gb=0.5, p_bg=0.3),
                                 seed=cg["seed"] + s)
                   if faulty and s == 0 else None)
            fs = OffloadSession(off8, injector=inj)
            counted_sends(fs, (frames,), cg["sends"])
            sessions.append(fs)
        return fleet_link_report(sessions, BACKSCATTER, frame_period_s=1.0,
                                 stagger=False)

    clean, cong = fleet(False), fleet(True)
    print(f"resilience (e) congestion: p99 clean {clean.p99_latency_s:.4f} s"
          f" (JAX {cg['p99_clean_s']:.4f}), congested "
          f"{cong.p99_latency_s:.4f} s (JAX {cg['p99_congested_s']:.4f}), "
          f"bytes x{cong.bytes_total / clean.bytes_total:.4f} (JAX "
          f"x{cg['bytes_overhead']:.4f})", flush=True)
    if not cong.p99_latency_s > clean.p99_latency_s:
        raise AssertionError("congested p99 not above the clean one")

    # (f) VR sessions at 16 x 4K
    lefts, rights = views
    for cut in VR_CUTS:
        for bits in (16, 8, 4):
            split = VROffloadExecutor(vr_ex, cut, bits=bits)
            (lp0, rp0), _pay = split(lefts, rights)
            sess = OffloadSession(split)
            ((lp, rp),), (moved,) = counted_sends(sess, views, 1)
            per_send[(cut, bits)] = moved
            if not (torch.equal(lp, lp0) and torch.equal(rp, rp0)):
                raise AssertionError(f"VR session {cut} {bits} differs from "
                                     "the split executor")
            del lp0, rp0, lp, rp, _pay
    split = VROffloadExecutor(vr_ex, "stitch", bits=8)
    (lp0, rp0), _pay = split(lefts, rights)
    del _pay
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_vr_ckpt_")
    try:
        sess = OffloadSession(
            split, injector=FaultInjector(brownout=BrownoutModel(
                harvest_w=15e-6, storage_j=9e-6, load_w=200e-6, jitter=0.0),
                seed=6),
            ckpt_dir=ckpt, stage_cost_s=0.02, keep_ckpts=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _CountingSaves() as saves:
            ((lp, rp),), _l = counted_sends(sess, views, 1)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rec = sess.records[0]
    print(f"resilience (f) VR: zero-fault sessions == split executor at "
          f"capture/depth/stitch x 16/8/4; stitch brownout send: "
          f"{rec.brownouts} brownouts, {rec.restores} restores, "
          f"{saves.saves} commits, {saves.bytes / 1e9:.3f} GB of "
          f"checkpoints written, {secs:.1f} s; stages "
          f"{sess.stage_completed}", flush=True)
    if not (rec.brownouts >= 1 and rec.restores >= 1
            and sess.stage_completed["depth"] == 1
            and torch.equal(lp, lp0) and torch.equal(rp, rp0)):
        raise AssertionError("VR brownout send differs from the split "
                             "executor or did not resume from a commit")
    del lp, rp, lp0, rp0

    # (g) decode launches per send
    print("resilience (g) wire_decode launches per delivered send: " +
          ", ".join(f"{c}@{b}: {n}" for (c, b), n in per_send.items())
          + "; in the ladder cells by width: " +
          ", ".join(f"{b}: {sorted(v)}" for b, v in sorted(
              launches_by_bits.items(), key=lambda kv: kv[0] or 0)),
          flush=True)
    for bits in (16, 8, 4):
        if per_send[("capture", bits)] != 2 or per_send[("depth", bits)] != 3:
            raise AssertionError("VR decode launches per send")
    if _build.launches["wire_decode"] < 1:
        raise AssertionError("the resilience phase never launched "
                             "wire_decode")


def blur_shared_loads(P, gy, gx, gr, n_steps) -> int:
    """Shared-memory loads of the fused blur launch over both grids: one
    per value each pass writes, over the regions each step computes in
    every tile (``csrc/bilateral_blur.cu``)."""
    from repro_torch.kernels.bilateral_blur.cuda import tile_shape

    ty, tx, _rs, _smem = tile_shape(gy, gx, gr, n_steps)
    total = 0
    for y0 in range(0, gy, ty):
        for x0 in range(0, gx, tx):
            y1, x1 = min(gy, y0 + ty), min(gx, x0 + tx)
            sy0, sy1 = max(0, y0 - n_steps), min(gy, y1 + n_steps)
            sx0, sx1 = max(0, x0 - n_steps), min(gx, x1 + n_steps)
            for s in range(1, n_steps + 1):
                ny = (sy1 - sy0) - s * ((sy0 > 0) + (sy1 < gy))
                nx = (sx1 - sx0) - s * ((sx0 > 0) + (sx1 < gx))
                pnx = nx + (sx0 > 0) + (sx1 < gx)
                total += gr * ny * (pnx + 2 * nx)
    return 2 * P * total


def vr_kernel_rows(probes, ex, views, counts, codec_counts):
    """``bilateral_blur`` at the rig's grid shape, ``integral_image`` at
    the cost-volume shape and the codec at one capture field (8 x
    2160x3840 as 256-value blocks), each against its plain version on the
    card; ``counts`` are a rig frame's launches, ``codec_counts`` the
    capture runs' by codec width."""
    import torch
    import torch.nn.functional as F

    from repro_torch.camera import bssa
    from repro_torch.kernels.bilateral_blur import cuda as bcuda
    from repro_torch.kernels.bilateral_blur.ref import blur_ref
    from repro_torch.kernels.integral_image import cuda as icuda
    from repro_torch.kernels.integral_image.ref import integral_image_ref

    lefts, rights = views
    rows = []
    rough = bssa.rough_disparity(lefts, rights, ex.max_disp)
    val, wt = bssa.splat(lefts, rough, ex.spec)
    n_it = ex.n_iters

    def steps_ref(v, w, n):
        for _ in range(n):
            v, w = blur_ref(v, w)
        return v, w

    def same(got, want):
        return all(_bits_equal(a, b) for a, b in zip(got, want))

    # the fused refinement, one step, and 3 steps on a ragged grid
    if not same(bcuda.bilateral_blur_cuda(val, wt, n_it),
                steps_ref(val, wt, n_it)):
        raise AssertionError(f"bilateral_blur: {n_it} fused steps differ "
                             f"from {n_it} plain steps")
    if not same(bcuda.bilateral_blur_cuda(val, wt), blur_ref(val, wt)):
        raise AssertionError("bilateral_blur: one step differs from plain")
    gen = torch.Generator(device=val.device).manual_seed(3)
    for gr in (17, 9):                # 9: the kernel's generic gr
        rv = torch.randn((3, 37, 53, gr), device=val.device, generator=gen)
        rw = torch.rand((3, 37, 53, gr), device=val.device, generator=gen)
        if not same(bcuda.bilateral_blur_cuda(rv, rw, 3),
                    steps_ref(rv, rw, 3)):
            raise AssertionError(f"bilateral_blur: 3 steps on 3x37x53x{gr} "
                                 "differ from plain")
    both = torch.stack([val, wt]).reshape(-1, 1, *val.shape[1:])
    weight = torch.tensor([0.25, 0.5, 0.25], device=val.device)
    weight = (weight[:, None, None] * weight[None, :, None]
              * weight[None, None, :])[None, None]

    def library():
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False   # float32, as the kernel
        try:
            x = both
            for _ in range(n_it):
                x = F.conv3d(F.pad(x, (1, 1, 1, 1, 1, 1), mode="replicate"),
                             weight)
            return x
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    lib_ms = device_ms(library, reps=5)
    lib_err = max_abs_err(
        library().reshape(2, *val.shape),
        torch.stack(bcuda.bilateral_blur_cuda(val, wt, n_it)))
    print(f"bilateral_blur {tuple(val.shape)}: {n_it} steps in one launch "
          f"== {n_it} plain steps bit for bit, one step == one plain step, 3 "
          f"steps at 3x37x53x17 and 3x37x53x9 == plain; {n_it} x conv3d "
          "(cuDNN, TF32 off) "
          f"max |diff| {lib_err:g}", flush=True)
    n = val.numel()
    rows.append(kernel_row(
        probes, "bilateral_blur", bcuda, counts["bilateral_blur"], 0.0,
        lambda: bcuda.bilateral_blur_cuda(val, wt, n_it),
        device_ms(lambda: steps_ref(val, wt, n_it), reps=5), lib_ms,
        2 * 2 * 4 * n, n_it * 2 * 15 * n, PEAK_F32_OPS_S,
        shape="x".join(map(str, val.shape)), library_fn=library))
    # a diagnostic of the design, not a bound: the function needs no
    # shared-memory loads
    loads = blur_shared_loads(*val.shape, n_it)
    loads_ms = 1e3 * loads / (
        32 * torch.cuda.get_device_properties(0).multi_processor_count
        * sm_clock_hz())
    print(f"bilateral_blur design: {loads} shared-memory loads for {n_it} "
          f"steps ({loads / (2 * n_it * n):.3f} per value and step), "
          f"{loads_ms:.4f} ms at 32 a clock on every SM", flush=True)

    # integral_image at the cost volume's shape: one chunk of 8 hypotheses
    # of every pair, edge-padded |left - shifted right|
    P, h, w_ = lefts.shape
    ds = torch.arange(8, device=lefts.device)
    xs = (torch.arange(w_, device=lefts.device)[None] - ds[:, None]).clamp(
        0, w_ - 1)
    rs = torch.gather(rights[:, None].expand(P, 8, h, w_), 3,
                      xs[None, :, None, :].expand(P, 8, h, w_))
    x = F.pad((lefts[:, None] - rs).abs(), (2, 2, 2, 2),
              mode="replicate").reshape(P * 8, h + 4, w_ + 4)
    del rs
    got = icuda.integral_image_cuda(x)
    if not torch.equal(got, integral_image_ref(x)):
        raise AssertionError("integral_image at the cost-volume shape "
                             "differs from plain")
    print(f"integral_image {tuple(x.shape)}: kernel == plain bit for bit",
          flush=True)
    row = kernel_row(
        probes, "integral_image", icuda, counts["integral_image"], 0.0,
        lambda: icuda.integral_image_cuda(x),
        device_ms(lambda: integral_image_ref(x), reps=1, warm=1),
        device_ms(lambda: torch.cumsum(torch.cumsum(x, -2), -1), reps=3),
        4 * (x.numel() + got.numel()), 2 * x.numel(), PEAK_F32_OPS_S,
        reps=3, shape="x".join(map(str, x.shape)),
        library_fn=lambda: torch.cumsum(torch.cumsum(x, -2), -1))
    rows.append(row)
    print(f"integral_image per rig frame: {counts['integral_image']} "
          f"launches, bound {counts['integral_image'] * row['bound_ms']:.3f}"
          f" ms, kernel {counts['integral_image'] * row['ms']:.3f} ms",
          flush=True)

    # the codec at one capture field: the left views as 256-value blocks
    from repro_torch.kernels.wire_codec.ops import BLOCK
    field = lefts.reshape(-1, BLOCK).contiguous()
    codec_check("VR capture field", field)
    codec = []
    for bits in (8, 4, 16):            # rows 4b/5b, 4c/5c, 4d/5d
        more = codec_kernel_rows(probes, field, codec_counts[bits],
                                 shape="x".join(map(str, field.shape)),
                                 plain_reps=3, bits=bits,
                                 label="" if bits == 8 else f" {bits}-bit")
        for row in more:
            print(f"{row['name']} per {bits}-bit capture run: "
                  f"{row['launches']} launches, bound "
                  f"{row['launches'] * row['bound_ms']:.4f} ms, kernel "
                  f"{row['launches'] * row['ms']:.4f} ms", flush=True)
        codec += more
    return rows + codec


# -- §III serving fleet -------------------------------------------------------

SERVE_RUNGS = [(None, None)] + [(c, b) for c in CUTS
                                for b in (None, 16, 8, 4)]
SERVE_KERNELS = ("integral_image", "haar_stage", "quant_nn", "wire_encode",
                 "wire_decode")
# benchmarks/serving.py's full-run fleet (rows() with smoke=False)
FLEET_A, FLEET_B, TICKS_A, TICKS_B, HOT_FPS = 904, 120, 24, 24, 2
FLEET_CONFIG = dict(chunk=4, capacity=96, slo_s=2.5, tick_s=1.0,
                    max_queue_s=8.0, resolve_every=32, link_window=4,
                    admit_util=0.9, stats_window=8)
# every TickReport field but the wall clock (batch_s) and the completions,
# and every Completion field but its result arrays (FA_FIELDS)
REPORT_FIELDS = ("t", "n_ready", "n_served", "n_quiet", "n_requeued",
                 "bytes_sent", "resolves_fired", "cut_changes", "shed",
                 "n_failed_tx", "ladder_moves", "device_events")
COMPLETION_FIELDS = ("sid", "t", "n_frames", "kind", "wire_bytes", "seqs")
# The 8-bit codec's score error: the largest |score(vj-8) - score(vj raw)|
# on the windows both find, over every 4-frame chunk of the serving
# record's videos (0.04629, the port on the CPU; chip_smoke reads it again
# on the card and tests/test_torch_asset.py on the CPU).  Two 8-bit
# packings of the same window, each within it of the raw score, differ by
# at most twice it.
VJ8_CODEC_ERR = 0.0463


def reports_differ(a_reports, b_reports) -> list:
    """Every difference between two runs' tick reports, the wall clock
    aside: (tick, field) or (tick, sid, field); completions compared field
    for field and their result arrays with ``np.array_equal``."""
    if len(a_reports) != len(b_reports):
        return [("n_reports", len(a_reports), len(b_reports))]
    bad = []
    for i, (a, b) in enumerate(zip(a_reports, b_reports)):
        bad += [(i, f) for f in REPORT_FIELDS
                if getattr(a, f) != getattr(b, f)]
        if len(a.completions) != len(b.completions):
            bad.append((i, "n_completions"))
            continue
        for ca, cb in zip(a.completions, b.completions):
            bad += [(i, ca.sid, f) for f in COMPLETION_FIELDS
                    if getattr(ca, f) != getattr(cb, f)]
            bad += [(i, ca.sid, k) for k in FA_FIELDS
                    if not np.array_equal(np.asarray(ca.result[k]),
                                          np.asarray(cb.result[k]))]
    return bad


def _record_form(field, value):
    """A TickReport field as the serving record stores it (JSON lists)."""
    if field == "shed":
        return [[s.sid, list(s.seqs), list(s.arrivals)] for s in value]
    if isinstance(value, tuple):
        return [list(x) for x in value]
    return value


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serving_videos(ref):
    """The record's videos, made again by the port's generator and held
    to the record's sha256."""
    from repro_torch.camera.synthetic import security_video

    videos = [security_video(**p)[0] for p in ref.videos]
    for v, want in zip(videos, ref.video_sha256):
        if hashlib.sha256(v.tobytes()).hexdigest() != want:
            raise AssertionError("a serving video differs from the record's")
    return videos


def serving_server(ex, ref, run, chaos=None, telemetry=None):
    """The record's fleet registered on a port server over ``ex``; the
    chaos run's spec unless ``chaos`` is given."""
    from repro_torch.camera.offload.link import ETH_25G_LINK, GilbertElliott
    from repro_torch.camera.serve import ChaosSpec, ServeConfig, StreamingServer

    if chaos is None and run == "chaos":
        chaos = ChaosSpec(loss=GilbertElliott(**ref.chaos["loss"]),
                          max_retries=ref.chaos["max_retries"],
                          seed=ref.chaos["seed"])
    srv = StreamingServer(ex, link=ETH_25G_LINK, chaos=chaos,
                          config=ServeConfig(**ref.config),
                          telemetry=telemetry)
    for sid, cut, bits, _v in ref.streams:
        dec = srv.register(sid, fps=float(ref.frames_per_tick), cut=cut,
                           bits=bits)
        if not (dec.admitted and dec.cut == cut):
            raise AssertionError(f"{run}: {sid} not admitted at {cut}")
    return srv


def serving_feed(srv, ref, videos, tick):
    for tk, k, v, i, t in ref.script:
        if tk == tick:
            srv.enqueue(ref.streams[k][0], videos[v][i], t=t)


def serving_replay(ex, ref, run, videos, ticks=None, **kw):
    """The record's drive of ``run`` through the port's server, ``ticks``
    deep (the record's depth when None); returns (server, reports)."""
    srv = serving_server(ex, ref, run, **kw)
    reports = []
    for tick in range(ref.ticks if ticks is None else ticks):
        serving_feed(srv, ref, videos, tick)
        reports.append(srv.tick(float(tick + 1)))
    return srv, reports


def window_flips(a: dict, b: dict):
    """(windows one result finds and the other does not, score pairs of
    the windows both find), frame by frame."""
    flips, pairs = 0, []
    for i in range(len(a["motion"])):
        x = dict(zip(a["window_id"][i][a["window_valid"][i]],
                     a["scores"][i][a["window_valid"][i]]))
        y = dict(zip(b["window_id"][i][b["window_valid"][i]],
                     b["scores"][i][b["window_valid"][i]]))
        flips += len(set(x) ^ set(y))
        pairs += [(x[k], y[k]) for k in set(x) & set(y)]
    return flips, np.array(pairs, np.float32).reshape(-1, 2)


def serving_record_check(label, ref, run, reports):
    """Hold a port run to the JAX record of ``run``, tick for tick: every
    scheduling field equal; every completion's stream, kind, frames and
    seqs equal; its results bit-equal, or, where the port's integral
    image moves a window across a stage decision (ROADMAP queue 3), held
    by outcome: the same motion frames and drops, at most
    MAX_WINDOW_FLIPS windows found by one side only, auths within the
    flips, and bit-equal scores on the windows both find — except on vj
    streams, whose coded patches are packed window after window, so that
    a flipped window moves every later window's block scale: there the
    scores of the windows both find are held within 2 x VJ8_CODEC_ERR.
    Wire bytes equal except on vj streams with flipped windows, and each
    tick's bytes differ from the record's by exactly those streams'
    differences.  Returns (completions exact, by outcome, window flips,
    the largest vj score difference on windows both find)."""
    cuts = {sid: cut for sid, cut, _b, _v in ref.streams}
    want_reports, res = ref.reports[run], ref.results[run]
    o = ci = exact = outcome = flips = 0
    vj_diff = 0.0
    for i, (rep, want) in enumerate(zip(reports, want_reports)):
        where = f"{label} tick {i}"
        for k in REPORT_FIELDS:
            if k != "bytes_sent" and (_record_form(k, getattr(rep, k))
                                      != want[k]):
                raise AssertionError(f"{where}: {k} {getattr(rep, k)} != "
                                     f"record {want[k]}")
        if len(rep.completions) != len(want["completions"]):
            raise AssertionError(f"{where}: completion count differs")
        d_wire = 0.0
        for c, wc in zip(rep.completions, want["completions"]):
            if ((c.sid, c.t, c.n_frames, c.kind, list(c.seqs))
                    != (wc["sid"], wc["t"], wc["n_frames"], wc["kind"],
                        wc["seqs"])):
                raise AssertionError(f"{where}: completion {c.sid} differs")
            n = c.n_frames
            w_res = {f: res[f][ci] if f == "motion_dropped"
                     else res[f][o:o + n] for f in FA_FIELDS}
            o, ci = o + n, ci + 1
            if all(np.array_equal(c.result[f], w_res[f]) for f in FA_FIELDS):
                exact += 1
                if c.wire_bytes != wc["wire_bytes"]:
                    raise AssertionError(f"{where}: {c.sid} wire bytes")
                continue
            outcome += 1
            f_n, pairs = window_flips(c.result, w_res)
            flips += f_n
            same = all(np.array_equal(c.result[f], w_res[f]) for f in (
                "motion", "motion_dropped", "windows_dropped",
                "cascade_dropped"))
            if cuts[c.sid] != "vj":
                same = same and np.array_equal(pairs[:, 0].view(np.int32),
                                               pairs[:, 1].view(np.int32))
            elif len(pairs):
                d = float(np.abs(pairs[:, 0] - pairs[:, 1]).max())
                vj_diff = max(vj_diff, d)
                same = same and d <= 2 * VJ8_CODEC_ERR
            if not (same and 0 < f_n <= MAX_WINDOW_FLIPS
                    and abs(int(c.result["n_auth"].sum())
                            - int(w_res["n_auth"].sum())) <= f_n):
                raise AssertionError(f"{where}: {c.sid} differs beyond "
                                     f"{f_n} window flips")
            if cuts[c.sid] == "vj":
                d_wire += c.wire_bytes - wc["wire_bytes"]
            elif c.wire_bytes != wc["wire_bytes"]:
                raise AssertionError(f"{where}: {c.sid} wire bytes")
        if rep.bytes_sent != want["bytes_sent"] + d_wire:
            raise AssertionError(f"{where}: bytes {rep.bytes_sent} != "
                                 f"record {want['bytes_sent']} + {d_wire}")
    return exact, outcome, flips, vj_diff


def vj8_codec_error(ex, videos, chunk=4):
    """The 8-bit codec's score error (VJ8_CODEC_ERR): the largest
    |score(vj-8) - score(vj raw)| on the windows both find, over every
    ``chunk``-frame chunk of ``videos``, through the port's split
    executors on ``ex``."""
    import torch

    from repro_torch.camera.offload import FaceAuthOffloadExecutor

    raw, q8 = (FaceAuthOffloadExecutor(ex, "vj", bits=b) for b in (None, 8))
    worst = 0.0
    for v in videos:
        v = torch.as_tensor(v, device=ex.device)
        for s in range(0, len(v) - chunk + 1, chunk):
            a, b = raw(v[s:s + chunk])[0], q8(v[s:s + chunk])[0]
            _f, pairs = window_flips(
                *({f: getattr(r, f).cpu().numpy() for f in FA_FIELDS}
                  for r in (a, b)))
            if len(pairs):
                worst = max(worst, float(np.abs(pairs[:, 0]
                                                - pairs[:, 1]).max()))
    return worst


def serve_one_stream(ex, frames, cut, bits):
    """One stream served as one chunk; returns its completion."""
    from repro_torch.camera.offload.link import ETH_25G_LINK
    from repro_torch.camera.serve import ServeConfig, StreamingServer

    cfg = ServeConfig(chunk=len(frames), capacity=1, tick_s=1.0,
                      max_queue_s=1e9)
    srv = StreamingServer(ex, link=ETH_25G_LINK, config=cfg)
    dec = srv.register("s", fps=1.0, cut=cut, bits=bits)
    if not (dec.admitted and dec.cut == cut):
        raise AssertionError(f"one stream at {cut} not admitted: {dec}")
    for i, f in enumerate(frames.cpu().numpy()):
        srv.enqueue("s", f, t=i / len(frames))
    (comp,) = srv.tick(1.0).completions
    return comp


def serving_fleet_drive(srv, specs, ticks, t0):
    """benchmarks/serving.py's ``_drive``: tick the server, each stream
    fed ``frames_per_tick`` frames of its video a tick, phase-shifted."""
    changes, t, p99_max = [], t0, 0.0
    for _ in range(ticks):
        live = srv.streams
        for sid, (video, off, n) in specs.items():
            st = live.get(sid)
            if st is None:
                continue
            for j in range(n):
                idx = (off + st.frames_done + len(st.queue)) % len(video)
                srv.enqueue(sid, video[idx], t=t + j / n)
        t += srv.cfg.tick_s
        rep = srv.tick(t)
        changes.extend((rep.t,) + c for c in rep.cut_changes)
        if srv.last_link_report is not None:
            p99_max = max(p99_max, srv.last_link_report.p99_latency_s)
    return changes, t, p99_max


def count_dispatches(srv):
    """Record every group dispatch of ``srv``'s ticks as (tick, rung, the
    launches it made of each kernel), in a list returned now and filled as
    the server ticks.  The server's group-step lookup is wrapped on the
    instance; ``del srv._group_step`` takes the wrapper away."""
    from repro_torch.kernels import _build

    log, lookup = [], srv._group_step

    def group_step(rung):
        step = lookup(rung)

        def counted(chunks):
            before = dict(_build.launches)
            out = step(chunks)
            log.append((srv.tick_count, rung, {
                k: n - before.get(k, 0) for k, n in _build.launches.items()
                if n != before.get(k, 0)}))
            return out
        return counted

    srv._group_step = group_step
    return log


def serve_kernel_plains(qnn):
    """The serving path's five kernel wrappers, each with its plain
    version taking the same arguments: (name, ops module, the name it
    calls the wrapper by, plain).  ``qnn`` is the NN the ``quant_nn``
    launches serve (its scales; the weights come with the call)."""
    from repro_torch.kernels.haar_frontend import ops as hops
    from repro_torch.kernels.haar_frontend.ref import haar_stage_ref
    from repro_torch.kernels.integral_image import ops as iops
    from repro_torch.kernels.integral_image.ref import integral_image_ref
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul.ref import nn_forward_ref
    from repro_torch.kernels.wire_codec import ops as wops
    from repro_torch.kernels.wire_codec.ref import (
        wire_decode_ref,
        wire_encode_ref,
    )

    def nn_plain(x, args):
        w1t, b1, w2_q, b2 = args.tensors          # w1 k-major, padded
        return nn_forward_ref(x, w1t[:, :args.k].t().contiguous(), b1, w2_q,
                              b2, args.lut, lut_lo=args.lo, lut_hi=args.hi,
                              **qnn.scales())

    return [
        ("integral_image", iops, "integral_image_cuda", integral_image_ref),
        ("haar_stage", hops, "haar_stage_cuda", haar_stage_ref),
        ("quant_nn", qops, "quant_nn_cuda", nn_plain),
        ("wire_encode", wops, "wire_encode_cuda",
         lambda blocks, bits: wire_encode_ref(blocks, bits=bits)),
        ("wire_decode", wops, "wire_decode_cuda",
         lambda packed, scales, bits: wire_decode_ref(packed, scales,
                                                      bits=bits))]


@contextlib.contextmanager
def serve_kernels_as(qnn, mode):
    """Within the block, the serving kernels' call sites reach, with
    ``mode`` "held", each kernel and then its plain version on the same
    inputs, held bit for bit (a difference raises), and yield
    {kernel: [input shape of each call]}; with ``mode`` "plain", the plain
    versions alone, in the kernels' place."""
    seen, saved = {}, []

    def held(name, kernel, plain):
        def call(*args):
            got, want = kernel(*args), plain(*args)
            pairs = (zip(got, want) if isinstance(got, tuple)
                     else [(got, want)])
            if not all(_bits_equal(a, b) for a, b in pairs):
                raise AssertionError(
                    f"{name} at {tuple(args[0].shape)} differs from its "
                    "plain version on the same inputs")
            seen.setdefault(name, []).append(tuple(args[0].shape))
            return got
        return call

    for name, mod, attr, plain in serve_kernel_plains(qnn):
        kernel = getattr(mod, attr)
        saved.append((mod, attr, kernel))
        setattr(mod, attr, plain if mode == "plain"
                else held(name, kernel, plain))
    try:
        yield seen
    finally:
        for mod, attr, kernel in saved:
            setattr(mod, attr, kernel)


def _tree_bits_equal(a, b) -> bool:
    """Two nests of dicts / tuples of tensors equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_bits_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_tree_bits_equal, a, b))
    return _bits_equal(a, b)


def rung_label(rung) -> str:
    cut, bits = rung
    return "local" if cut is None else f"{cut}-{bits or 'raw'}"


def fleet_dispatch_check(log, counts):
    """Hold the fleet's launch totals to its group dispatches (the log of
    ``count_dispatches``): one dispatch a placement group a tick, the same
    launches at every dispatch of a rung, and those launches times the
    rung's dispatches summing to ``counts``, so that no launch happened
    outside a dispatch.  Returns {rung: (dispatches, launches a
    dispatch)}."""
    import collections

    per, total = {}, collections.Counter()
    if max(collections.Counter((t, r) for t, r, _ in log).values()) > 1:
        raise AssertionError("a placement group dispatched twice in a tick")
    for _tick, rung, got in log:
        n, first = per.get(rung, (0, got))
        if got != first:
            raise AssertionError(f"{rung_label(rung)} dispatches launched "
                                 f"{first} and {got}")
        per[rung] = (n + 1, first)
        total.update(got)
    if dict(total) != counts:
        raise AssertionError(f"the dispatches launched {dict(total)}, the "
                             f"counters read {counts}")
    return per


def serving_fleet(ex, frames, card):
    """The §III fleet of benchmarks/serving.py at full width: phase A, 904
    quiet streams (every 32nd local, the rest vj at 8 bits) for 24 ticks;
    phase B, 120 hot streams at 2 fps join for 24 more.  Returns the
    launch counts of the drive and the dispatch probes."""
    import statistics as stats_mod

    import torch

    from repro_torch.camera.offload import (
        BACKSCATTER,
        CutController,
        FaceAuthOffloadExecutor,
    )
    from repro_torch.camera.pipelines import (
        FAWorkloadStats,
        calibrate_fa,
        fa_pipeline,
        fa_profiles,
    )
    from repro_torch.camera.serve import FA_CUTS, ServeConfig, StreamingServer
    from repro_torch.camera.synthetic import security_video
    from repro_torch.kernels import _build
    from repro_torch.serve.engine import cascade_serve

    dev = ex.device
    h, w = frames.shape[1:]
    quiet = [security_video(n_frames=32, h=h, w=w, motion_frames=1,
                            seed=11 + k)[0] for k in range(4)]
    hot = [security_video(n_frames=24, h=h, w=w, motion_frames=20,
                          seed=31 + k)[0] for k in range(2)]
    cfg = ServeConfig(**FLEET_CONFIG)
    B = frames.shape[0]
    base = ex(frames)
    stats = FAWorkloadStats(
        n_frames=B, motion_frames=max(int(base.motion.sum()), 1),
        windows_to_nn=max(int(base.n_windows.sum()), 1))
    cal = calibrate_fa(stats)
    profiles = fa_profiles()
    profiles["nn"] = cal.nn_profile()
    offs = {c: FaceAuthOffloadExecutor(ex, c, bits=8) for c in FA_CUTS}
    ctl = CutController(
        lambda cut: offs[cut], cuts=FA_CUTS, template=fa_pipeline(stats),
        profiles=profiles, link=dataclasses.replace(
            BACKSCATTER, joules_per_byte=cal.rf_joules_per_byte),
        regime="energy", unit_rate_hz=1.0, duties=DUTIES)
    ctl.calibrate(frames)
    # the shared uplink provisioned for the quiet fleet with ~55% headroom
    # from the measured mean vj-8 chunk bytes, as benchmarks/serving.py
    vals = []
    for v in quiet[:2]:
        for s in range(0, len(v) - cfg.chunk + 1, cfg.chunk):
            _, wb = offs["vj"].encode_slots(
                torch.as_tensor(v[s:s + cfg.chunk], device=dev)[None])
            vals.append(float(wb[0]))
    q_chunk_b = float(np.mean(vals))
    n_a, n_b = FLEET_A, FLEET_B
    n_local = sum(1 for k in range(n_a) if k % 32 == 31)
    fleet_bps = (n_a - n_local) * q_chunk_b / cfg.chunk
    link = BACKSCATTER.scaled(max(fleet_bps / 0.45, 1.0)
                              / BACKSCATTER.bytes_per_s)
    srv = StreamingServer(ex, link=link, controller=ctl, config=cfg)
    peak_ready = (n_a - n_local) // cfg.chunk + n_b + cfg.capacity
    t0 = time.perf_counter()
    srv.prewarm(([(None, None)] if n_local else [])
                + [(c, 8) for c in FA_CUTS], max_ready=peak_ready)
    _sync(dev)
    print(f"serving fleet: prewarm {time.perf_counter() - t0:.2f} s "
          f"(buckets up to {srv._bucket(peak_ready)} chunks); link "
          f"{link.bytes_per_s:.1f} B/s from {q_chunk_b:.2f} B per quiet "
          "vj-8 chunk", flush=True)

    specs = {}
    admitted = rejected = replaced = 0
    for k in range(n_a):
        sid = f"q{k}"
        cut = None if k % 32 == 31 else "vj"
        dec = srv.register(sid, fps=1.0, cut=cut, bits=8 if cut else None,
                           motion_frac=0.1)
        if not dec.admitted:
            rejected += 1
            continue
        admitted += 1
        replaced += dec.cut != cut
        vid = quiet[k % len(quiet)]
        specs[sid] = (vid, (k * 7) % len(vid), 1)
        for j in range(k % cfg.chunk):
            srv.enqueue(sid, vid[(k * 7 + j) % len(vid)], t=0.0)
    srv.batch_lat_s.clear()
    log = count_dispatches(srv)
    _sync(dev)
    _build.reset_launches()
    wall0 = time.perf_counter()
    changes_a, t, p99_link_a = serving_fleet_drive(srv, specs, TICKS_A, 0.0)
    lat_a = list(srv.batch_lat_s)
    for k in range(n_b):
        sid = f"h{k}"
        dec = srv.register(sid, fps=float(HOT_FPS), cut="vj", bits=8, t=t,
                           motion_frac=0.15)
        if not dec.admitted:
            rejected += 1
            continue
        admitted += 1
        replaced += dec.cut != "vj"
        vid = hot[k % len(hot)]
        specs[sid] = (vid, (k * 5) % len(vid), HOT_FPS)
        for j in range(k % cfg.chunk):
            srv.enqueue(sid, vid[(k * 5 + j) % len(vid)], t=t)
    changes_b, t, p99_link_b = serving_fleet_drive(srv, specs, TICKS_B, t)
    _sync(dev)
    wall = time.perf_counter() - wall0
    counts = dict(_build.launches)
    p99 = srv.p99_batch_s()
    lat_b = srv.batch_lat_s[len(lat_a):]
    requeues = sum(s.requeues for s in srv.streams.values())
    changes = changes_a + changes_b
    print(f"serving fleet ({card}): streams_sustained={len(srv.streams)} "
          f"(phase A {n_a}, phase B {n_b}; admitted {admitted}, rejected "
          f"{rejected}, re-placed {replaced}); p99_batch_s={p99:.4f} "
          f"against the {cfg.slo_s} s SLO (slo_ok="
          f"{int(p99 <= cfg.slo_s)}); throughput_fps="
          f"{srv.frames_served() / max(t, 1e-9):.1f} ({srv.frames_served()}"
          f" frames over {t:.0f} s simulated); resolves_fired="
          f"{srv.total_resolves()}; cut_changes={len(changes)} (streams "
          f"{len({c[1] for c in changes})}, phase A {len(changes_a)}, "
          f"phase B {len(changes_b)}); requeued_chunks={requeues}; link "
          f"p99 A={p99_link_a:.4f} s B={p99_link_b:.4f} s", flush=True)
    print(f"serving fleet ({card}): {TICKS_A + TICKS_B} ticks in "
          f"{wall:.2f} s wall; tick wall median A "
          f"{1e3 * stats_mod.median(lat_a):.2f} ms, B "
          f"{1e3 * stats_mod.median(lat_b):.2f} ms, max "
          f"{1e3 * max(srv.batch_lat_s):.2f} ms; launches {counts}",
          flush=True)
    for name in SERVE_KERNELS:
        if counts.get(name, 0) < 1:
            raise AssertionError(f"the serving fleet never launched {name}")
    if srv.total_resolves() < 1:
        raise AssertionError("no windowed re-solve fired")
    del srv._group_step
    per_rung = fleet_dispatch_check(log, counts)
    print(f"serving fleet: {len(log)} group dispatches, each rung's "
          "launches a dispatch the same at every one of its dispatches and "
          "summing to the totals: " + "; ".join(
              f"{rung_label(r)} x{n}: {got}"
              for r, (n, got) in per_rung.items()), flush=True)

    # one dispatch of a local and of a vj-8 group on a full capacity of
    # hot chunks: its launches by the wrappers' counts
    hot_chunks = np.stack([np.roll(hot[k % 2], -k, axis=0)[:cfg.chunk]
                           for k in range(cfg.capacity)])
    stack = torch.as_tensor(hot_chunks, device=dev)
    dispatches = []
    for rung in ((None, None), ("vj", 8)):
        step = srv._group_step(rung)

        def dispatch(step=step):
            out = cascade_serve(srv._scores, step, stack,
                                threshold=srv._score_threshold,
                                capacity=cfg.capacity)
            _sync(dev)
            return out

        dispatch()
        _build.reset_launches()
        out = dispatch()
        got = dict(_build.launches)
        label = f"{rung_label(rung)} dispatch"
        if got != per_rung[rung][1]:
            raise AssertionError(f"{label}: launches {got}, the fleet's "
                                 f"dispatches {per_rung[rung][1]}")
        ms = host_ms(dispatch) if dev.type == "cuda" else 0.0
        with serve_kernels_as(ex.qnn, "held") as seen:
            held = dispatch()
        if {k: len(v) for k, v in seen.items()} != got:
            raise AssertionError(f"{label}: held {seen}, launched {got}")
        with serve_kernels_as(ex.qnn, "plain"):
            plain = dispatch()
        if not (_tree_bits_equal(out, held) and _tree_bits_equal(out, plain)):
            raise AssertionError(f"{label}: the dispatch with plain kernels "
                                 "differs from the kernels'")
        print(f"serving {label} ({cfg.capacity} slots x {cfg.chunk} "
              f"frames, {int(out[1].sum())} served): launches {got}, as "
              f"the fleet's; {ms:.3f} ms wall (median of 7); every kernel "
              "call == its plain version on its own inputs, bit for bit ("
              + ", ".join(f"{k} {' '.join('x'.join(map(str, s)) for s in v)}"
                          for k, v in seen.items())
              + "); the dispatch with plain versions == the kernels', bit "
              "for bit", flush=True)
        dispatches.append((label, dispatch, got))
    # one steady-state tick for the profile phase
    lat = 1e3 * stats_mod.median(lat_b[-8:])

    def one_tick():
        serving_fleet_drive(srv, specs, 1, srv.tick_count * cfg.tick_s)
        _sync(dev)

    return counts, ("serving tick (steady state)", one_tick, lat), dispatches


def serving_phase(ex, frames, card):
    """The §III serving fleet on the card: (1) one stream through the
    server == the executor at every rung, (2) the JAX record of an
    8-stream fleet at full width, clean and under chaos, (3) the fleet of
    benchmarks/serving.py, (4) chaos: an inert spec, the loss cell,
    checkpoint/restore, (5) telemetry off and on.  Returns the fleet's
    launch counts, its profile target and the dispatch probes."""
    import shutil
    import tempfile

    from repro_torch.bridge import load_fa_reference, load_serving_reference
    from repro_torch.camera.offload import FaceAuthOffloadExecutor
    from repro_torch.camera.pipelines import FaceAuthExecutor
    from repro_torch.camera.serve import ChaosSpec, StreamingServer
    from repro_torch.kernels import _build
    from repro_torch.obs import Telemetry

    t_phase = time.perf_counter()
    dev = ex.device
    # (1) single-stream bit-identity on the card
    base = ex(frames)
    for cut, bits in SERVE_RUNGS:
        comp = serve_one_stream(ex, frames, cut, bits)
        if cut is None:
            want, wire = base, 0.0
        else:
            want, pay = FaceAuthOffloadExecutor(ex, cut, bits=bits)(frames)
            wire = float(pay.wire_b)
        bad = [f for f in FA_FIELDS if not np.array_equal(
            comp.result[f], getattr(want, f).cpu().numpy())]
        if bits is None:
            bad += [f + " (fused)" for f in FA_FIELDS if not np.array_equal(
                comp.result[f], getattr(base, f).cpu().numpy())]
        if bad or comp.wire_bytes != wire or comp.kind != "served":
            raise AssertionError(f"one stream at {cut} {bits}: {bad}, "
                                 f"{comp.wire_bytes} B != {wire}")
    print(f"serving: one {len(frames)}-frame stream through StreamingServer"
          f" == FaceAuthExecutor (local, every cut raw) and == the split "
          f"executor (every cut at 16/8/4 bits), bit for bit, with its wire "
          f"bytes: {len(SERVE_RUNGS)} rungs", flush=True)

    # (2) the JAX record at full width
    ref = load_serving_reference()
    videos = serving_videos(ref)
    runs = {}
    for run in ("clean", "chaos"):
        srv, reports = serving_replay(ex, ref, run, videos)
        exact, outcome, flips, vj_diff = serving_record_check(
            f"serving record {run}", ref, run, reports)
        if srv.seq_audit() != ref.audits[run]:
            raise AssertionError(f"{run}: seq_audit differs from JAX's")
        runs[run] = reports
        print(f"serving record {run}: {len(reports)} ticks == JAX (every "
              f"scheduling field, {sum(r.n_failed_tx for r in reports)} "
              f"failed tx, {sum(len(r.ladder_moves) for r in reports)} "
              f"ladder moves, seq_audit); {exact} completions bit-equal, "
              f"{outcome} held by outcome ({flips} window flips; vj scores "
              f"on the windows both find within {vj_diff:.6g} of JAX's, "
              f"bound {2 * VJ8_CODEC_ERR:.4g})", flush=True)
    err = vj8_codec_error(ex, videos, ref.config["chunk"])
    if err > VJ8_CODEC_ERR:
        raise AssertionError(f"the 8-bit codec moves vj scores by {err}, "
                             f"more than the reading {VJ8_CODEC_ERR}")
    print(f"serving record: the 8-bit codec's vj score error on the "
          f"record's videos {err:.6g} (the bound's reading "
          f"{VJ8_CODEC_ERR})", flush=True)

    # (4) chaos: an inert spec == no chaos; checkpoint/restore
    _srv, inert = serving_replay(ex, ref, "clean", videos, chaos=ChaosSpec())
    if reports_differ(runs["clean"], inert):
        raise AssertionError("an inert ChaosSpec changed a tick report")
    half = ref.ticks // 2
    tmp = tempfile.mkdtemp(prefix="serving_ckpt_")
    try:
        for run in ("clean", "chaos"):
            srv, _reports = serving_replay(ex, ref, run, videos, ticks=half)
            srv.checkpoint(os.path.join(tmp, run))
            rest = StreamingServer.restore(os.path.join(tmp, run), ex,
                                           config=srv.cfg, link=srv.link,
                                           chaos=srv._chaos)
            if rest.seq_audit() != srv.seq_audit():
                raise AssertionError(f"{run}: restored seq_audit differs")
            if [(s.ladder.level if s.ladder else None)
                    for s in rest.streams.values()] != [
                        (s.ladder.level if s.ladder else None)
                        for s in srv.streams.values()]:
                raise AssertionError(f"{run}: restored ladders differ")
            for tick in range(half, ref.ticks):
                serving_feed(srv, ref, videos, tick)
                serving_feed(rest, ref, videos, tick)
                a, b = srv.tick(float(tick + 1)), rest.tick(float(tick + 1))
                # a restored fleet faults afresh from its seeds: only the
                # clean run continues tick for tick
                if run == "clean" and reports_differ([a], [b]):
                    raise AssertionError(f"restored server differs at "
                                         f"tick {tick}")
            if not rest.seq_audit()["ok"]:
                raise AssertionError(f"{run}: seq_audit after restore")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serving chaos: inert ChaosSpec == no chaos over {ref.ticks} "
          f"ticks, bit for bit; the loss cell == JAX above; checkpoints at "
          f"tick {half}: the clean fleet restored continues == the "
          "uninterrupted server, the chaos fleet restores its ladders; "
          "seq_audit ok", flush=True)

    # (5) telemetry off and on: outputs and launches
    fa = load_fa_reference(device=dev)
    tels = {}
    for name, tel in (("none", None), ("off", Telemetry(enabled=False)),
                      ("on", Telemetry(enabled=True))):
        tx = FaceAuthExecutor(fa.cascade, fa.nn, frames.shape[1],
                              frames.shape[2], device=dev, telemetry=tel,
                              **fa.scan)
        tx.calibrate(frames)
        _sync(dev)
        _build.reset_launches()
        _srv, reports = serving_replay(tx, ref, "clean", videos, ticks=4,
                                       telemetry=tel)
        _sync(dev)
        tels[name] = (reports, dict(_build.launches), tel)
    for name in ("off", "on"):
        if reports_differ(tels["none"][0], tels[name][0]):
            raise AssertionError(f"telemetry {name} changed a tick report")
    if tels["off"][1] != tels["none"][1]:
        raise AssertionError(f"telemetry off launched {tels['off'][1]} != "
                             f"{tels['none'][1]}")
    tot = tels["on"][2].counters.totals()
    local = [c for r in tels["on"][0] for c in r.completions
             if c.sid.startswith("local") and c.kind == "served"]
    want = {"exec.windows": sum(int(c.result["n_windows"].sum())
                                for c in local),
            "exec.auth": sum(int(c.result["n_auth"].sum()) for c in local),
            "serve.frames_delivered": sum(c.n_frames for r in tels["on"][0]
                                          for c in r.completions)}
    if any(tot.get(k) != v for k, v in want.items()):
        raise AssertionError(f"telemetry counters {tot} != outputs {want}")
    print(f"serving telemetry: off == none (reports and launches "
          f"{tels['off'][1]}); on: {len(tels['on'][2].trace)} trace "
          f"records, counters == outputs ({want})", flush=True)

    # (3) the fleet
    counts, target, dispatches = serving_fleet(ex, frames, card)
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, target, dispatches


# -- LM serving ---------------------------------------------------------------

LM_KERNEL = {"yi-9b": "flash_attention", "rwkv6-7b": "rwkv_wkv"}
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 4096, 32
PARITY_B, PARITY_S, PARITY_EXTRA, PARITY_LAYERS = 2, 1000, 4, 4
# Full-width prefill/decode parity, of max |logit|: about 3x the largest
# reading (2.21e-4 yi, 2.14e-4 rwkv6; tests/test_models.py:88's 1e-4 is
# below the float32 noise of these models at full width, see E below)
PARITY_REL = 7e-4
FLASH_TOL = 2e-2      # tests/test_kernels.py:43, bf16 atol = rtol
# Random-input flash rows (8 x 32768 x 1 head, and yi's heads at a ragged
# S): bf16 outputs within 4e-3 (about 4x the 32k reading of a kernel
# that keeps P in float32, 9.8e-4) plus one bf16 spacing (2^-7 of |x|:
# both sides round one float32 value), and the same inputs in float32 within
# tests/test_kernels.py:43's float32 atol = rtol
FLASH_32K_ATOL, FLASH_32K_RTOL = 4e-3, 2.0 ** -7
FLASH_RAGGED_S = 4000
FLASH_F32_TOL = 2e-5
WKV_REL = 2e-4        # tests/test_kernels.py:372, of max |plain|
WKV_BONUS_STD = 0.3   # a nonzero u, as tests/test_kernels.py:368 draws it
RECORD_REL = 1e-4     # floor of the JAX-record bound, below
# readings of the float32 parity and of the JAX records with the float32
# flash kernel's earlier 4 x 4 tiles, printed beside this run's: another
# float32 summation order should keep them near
EARLIER_PARITY = {"yi-9b": 2.21e-4, "rwkv6-7b": 2.14e-4}
EARLIER_RECORD = {"yi-9b": 7.33e-5, "rwkv6-7b": 1.44e-4}


def lm_record_check(model, rec):
    """The port against one JAX record (``assets/lm_reference.npz``):
    prefill logits and each teacher-forced decode step within
    max(RECORD_REL, E) of that step's largest |logit|, E the JAX model's
    own float32 sensitivity (its logits' move under a one-ulp move of every
    weight); greedy tokens equal to JAX's up to the first step where JAX's
    top two logits are closer than that bound (a near tie).  Returns
    (worst relative error, bound, greedy steps compared)."""
    import torch

    from repro_torch.serve.engine import generate

    dev = model.device
    tol = max(RECORD_REL, rec.sensitivity)
    prompts = torch.as_tensor(rec.prompts, dtype=torch.long, device=dev)
    logits, cache = model.prefill(prompts)
    got = [logits]
    cache = model.pad_cache(cache, rec.teacher.shape[1])
    s = prompts.shape[1]
    for i in range(rec.teacher.shape[1]):
        tok = torch.as_tensor(rec.teacher[:, i:i + 1], dtype=torch.long,
                              device=dev)
        lg, cache = model.decode_step(tok, cache, s + i)
        got.append(lg[:, 0])
    got = torch.stack(got, dim=1).float().cpu().numpy()
    want = np.concatenate([rec.prefill_logits[:, None], rec.decode_logits],
                          axis=1)
    if not np.isfinite(got).all():
        raise AssertionError("non-finite logits")
    rel = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    worst = float(rel.max())
    if worst > tol:
        step = np.unravel_index(rel.argmax(), rel.shape)
        raise AssertionError(f"logits {worst:.3g} from JAX at (row, step) "
                             f"{step}, bound {tol:.3g}")
    greedy = generate(model, prompts, rec.greedy.shape[1]).cpu().numpy()
    compared = 0
    for row in range(greedy.shape[0]):
        for t in range(greedy.shape[1]):
            if rec.greedy_gap[row, t] < tol * rec.greedy_max[row, t]:
                break
            if greedy[row, t] != rec.greedy[row, t]:
                raise AssertionError(f"greedy token (row {row}, step {t}) "
                                     f"{greedy[row, t]} != JAX's "
                                     f"{rec.greedy[row, t]}")
            compared += 1
    return worst, tol, compared


class _Capture:
    """Records the arguments of the first call of ``module.name`` while
    active (the inputs a kernel gets on the main path)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None

    def __enter__(self):
        def spy(*args, **kw):
            if self.args is None:
                self.args = tuple(a.clone() for a in args)
            return self.fn(*args, **kw)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def lm_serve_phase(arch, device):
    """One full-width model in bf16: a counted serve call (8 x 4096-token
    prompts, 32 greedy tokens), times, peak memory, finite logits, and the
    inputs its first kernel launch got.  Returns (model, prompts, kernel
    launches per serve call, serve ms, the captured kernel inputs)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv_scan import ops as wkv_ops
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.serve.engine import generate, stream

    kernel = LM_KERNEL[arch]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=0)
    torch.cuda.synchronize()
    print(f"{arch}: {model.n_params() / 1e9:.3f} B parameters in "
          f"{cfg.param_dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = make_prompts(cfg, LM_REQUESTS, LM_PROMPT, seed=1, device=device)

    def serve():
        return generate(model, prompts, LM_GEN)

    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    toks = serve()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    _build.reset_launches()
    model.prefill(prompts)
    torch.cuda.synchronize()
    prefill_counts = dict(_build.launches)
    print(f"{arch} serve call launches {counts}, prefill alone "
          f"{prefill_counts}", flush=True)
    want = cfg.n_layers
    other = ({"flash_attention", "rwkv_wkv"} - {kernel}).pop()
    if (counts.get(kernel, 0) != want or prefill_counts.get(kernel, 0) != want
            or counts.get(other, 0)):
        raise AssertionError(f"{arch}: {counts.get(kernel, 0)} {kernel} "
                             f"launches per serve call, "
                             f"{prefill_counts.get(kernel, 0)} in prefill; "
                             f"expected {want}, all in prefill")

    ops_module, fn = ((flash_ops, "flash_attention")
                      if kernel == "flash_attention" else
                      (wkv_ops, "rwkv_wkv"))
    with _Capture(ops_module, fn) as cap:
        steps = list(stream(model, prompts, LM_GEN))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(lg).all()) for _t, lg in steps)
    same = torch.equal(torch.stack([t for t, _lg in steps], 1), toks)
    del steps
    if not finite or not same:
        raise AssertionError(f"{arch}: finite logits {finite}, stream == "
                             f"generate {same}")

    prefill_ms = host_ms(lambda: model.prefill(prompts), reps=3)
    serve_ms = host_ms(serve, reps=3)
    decode_ms = (serve_ms - prefill_ms) / (LM_GEN - 1)
    print(f"{arch} serve ({LM_REQUESTS} x {LM_PROMPT} prompt tokens, "
          f"{LM_GEN} greedy tokens): prefill {prefill_ms:.3f} ms, decode "
          f"{decode_ms:.3f} ms per token, serve call {serve_ms:.3f} ms = "
          f"{1e3 * LM_REQUESTS * LM_GEN / serve_ms:.1f} generated tokens/s "
          f"(host clock, median of 3); peak {peak / 2 ** 30:.2f} GiB "
          f"({resident / 2 ** 30:.2f} GiB resident before the call); every "
          "logit finite", flush=True)
    return model, prompts, want, serve_ms, cap.args


def lm_parity_phase(arch, device):
    """Full width, PARITY_LAYERS deep, float32: the full forward (kernel)
    against prefill (kernel) + decode steps (plain), within PARITY_REL of
    the largest |logit|.  E, this model's own float32 sensitivity (how far
    the forward's logits move when every weight moves by one ulp), is
    printed beside it."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32)
    model = build_model(cfg, device, seed=0)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (PARITY_B, PARITY_S + PARITY_EXTRA)), device=device)
    full = model.logits(toks)
    logits, cache = model.prefill(toks[:, :PARITY_S])
    errs = [float((logits - full[:, PARITY_S - 1]).abs().max())]
    cache = model.pad_cache(cache, PARITY_EXTRA)
    for t in range(PARITY_S, PARITY_S + PARITY_EXTRA):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    del cache
    top = float(full.abs().max())
    rel = max(errs) / top
    gen = torch.Generator(device=device).manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():
            up = torch.rand(p.shape, generator=gen, device=device) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
    sens = float((model.logits(toks) - full).abs().max()) / top
    print(f"{arch} float32, {PARITY_LAYERS} layers, B={PARITY_B}, "
          f"S={PARITY_S} + {PARITY_EXTRA}: prefill/decode vs forward "
          f"max |diff| {max(errs):.4g} of max |logit| {top:.4g} (rel "
          f"{rel:.3g}, per step {[f'{e / top:.3g}' for e in errs]}); "
          f"bound {PARITY_REL:g}; one-ulp sensitivity E {sens:.3g}; "
          f"earlier reading {EARLIER_PARITY[arch]:.3g}",
          flush=True)
    if not torch.isfinite(full).all() or rel >= PARITY_REL:
        raise AssertionError(f"{arch}: prefill/decode diverge from the "
                             f"forward ({rel:.3g} >= {PARITY_REL:g})")


def lm_record_phase(device):
    """The JAX record's reduced float32 configs on the card, through the
    kernels."""
    import torch

    from repro_torch.bridge import (
        lm_params_from,
        load_lm_reference,
        numpy_lm_params,
    )
    from repro_torch.kernels import _build

    for name, rec in load_lm_reference().items():
        model = lm_params_from(numpy_lm_params(rec.cfg, rec.seed), rec.cfg,
                               device=device)
        _build.reset_launches()
        worst, tol, compared = lm_record_check(model, rec)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        kernel = LM_KERNEL[rec.cfg.name]
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"record {name}: {kernel} never launched")
        print(f"JAX record {name} ({rec.cfg.n_layers} layers, "
              f"{rec.prompts.shape[0]} x {rec.prompts.shape[1]} tokens): "
              f"logits within {worst:.3g} of JAX (bound {tol:.3g}, E "
              f"{rec.sensitivity:.3g}); {compared} of {rec.greedy.size} "
              f"greedy tokens compared, all equal; launches {counts}; "
              f"earlier reading {EARLIER_RECORD[rec.cfg.name]:.3g}",
              flush=True)


def _causal_pairs(s: int, window=None) -> int:
    if window is None:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


# which kernel of csrc/flash_attention.cu runs for each dtype
FLASH_KERNEL = {"bfloat16": "tensor_core (wgmma + TMA)",
                "float32": "cuda_core (float32 CUDA cores)"}


def flash_row(probes, q, k, v, launches, atol, rtol, window=None,
              label="", f32=False):
    """``flash_attention`` against its plain streaming form on (q, k, v)
    in the model's layout (bf16, within atol + rtol |plain|), timed beside
    ``scaled_dot_product_attention`` (with a window, through a dense
    boolean mask on the efficient backend).  With ``f32`` the
    same inputs in float32 too (within FLASH_F32_TOL), a row of their own.
    Each row names the kernel that ran."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import cuda as fcuda
    from repro_torch.kernels.flash_attention.ops import expand_kv
    from repro_torch.kernels.flash_attention.ref import mha_streaming
    from repro_torch.models.layers import pin_matmul_precision

    pin_matmul_precision()
    b, s, H, d = q.shape
    KV = k.shape[2]
    scale = d ** -0.5
    pos = torch.arange(s, device=q.device)
    n_ops = 4 * b * H * d * _causal_pairs(s, window)

    def one(q, k, v, atol, rtol, backend, peak_ops, launches):
        dtype = str(q.dtype).split(".")[-1]

        def plain():
            return mha_streaming(q, expand_kv(k, H), expand_kv(v, H), pos,
                                 pos, scale, window=window)

        got = fcuda.flash_attention_cuda(q, k, v, window=window, scale=scale)
        want = plain()
        err = max_abs_err(got, want)
        rms = float(want.double().square().mean().sqrt())
        n_bad = int(((got.double() - want.double()).abs()
                     > atol + rtol * want.double().abs()).sum())
        print(f"flash_attention {label} {dtype}, kernel {FLASH_KERNEL[dtype]}"
              f": max |err| {err:g} (max |plain| {float(want.abs().max()):g},"
              f" rms {rms:.4g}; bound {atol:g} + {rtol:g} |plain|)",
              flush=True)
        if n_bad:
            raise AssertionError(f"flash_attention {label} {dtype}: {n_bad} "
                                 "values outside the bound")
        del got
        plain_ms = device_ms(plain, reps=2, warm=1)
        lib_ms = None
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            mask, backend_used = None, backend
        else:                    # SDPA's window: a dense boolean mask
            i = torch.arange(s, device=q.device)
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            backend_used = SDPBackend.EFFICIENT_ATTENTION

        def library():
            with sdpa_kernel(backend_used):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=KV != H)

        try:
            lib_err = max_abs_err(library().transpose(1, 2), want)
            lib_ms = device_ms(library)
            print(f"flash_attention {label} {dtype}: SDPA ({backend_used.name}"
                  f" backend{'' if mask is None else ', boolean window mask'})"
                  f" max |diff| {lib_err:g}", flush=True)
        except RuntimeError as e:     # backend rules of SDPA
            print(f"SDPA not timed: {e}", flush=True)
            library = None
        del want
        n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        row = kernel_row(
            probes, "flash_attention", fcuda, launches, err,
            lambda: fcuda.flash_attention_cuda(q, k, v, window=window,
                                               scale=scale),
            plain_ms, lib_ms, n_bytes, n_ops, peak_ops, reps=5,
            shape=label if dtype == "bfloat16" else f"{label} {dtype}",
            library_fn=library)
        row["kernel"] = FLASH_KERNEL[dtype]
        return row

    rows = [one(q, k, v, atol, rtol, SDPBackend.FLASH_ATTENTION,
                PEAK_BF16_OPS_S, launches)]
    if f32:                      # not on the path: the serve call is bf16
        rows.append(one(*(t.float() for t in (q, k, v)), FLASH_F32_TOL,
                        FLASH_F32_TOL, SDPBackend.EFFICIENT_ATTENTION,
                        PEAK_F32_OPS_S, 0))
    return rows


def wkv_row(probes, args, launches):
    """``rwkv_wkv`` against the plain sequential recurrence: outputs and
    final state within WKV_REL of the plain version's largest entry.  On
    the path's own inputs; again with a seeded nonzero u (the path's bonus
    is zero, as the model initialises it); on inputs drawn as
    tests/test_kernels.py:363-368 draws them, where the bonus must move
    the plain outputs by at least 10 WKV_REL, so that a kernel that drops
    or misplaces it cannot pass; and on drawn inputs at a T ragged against
    the kernel's chunk (650, the JAX record's prompts) with w = 0 (where
    the model's exp(-exp(x)) underflows) in some channels.  Each check
    prints beside the kernel's errors those of ``wkv_chunked_ref``, the
    kernel's chunked arithmetic in plain PyTorch on the same inputs."""
    import torch

    from repro_torch.kernels.rwkv_scan import cuda as wcuda
    from repro_torch.kernels.rwkv_scan.ref import (
        CHUNK,
        wkv_chunked_ref,
        wkv_ref,
    )

    r, k, v, w, u = args
    B, T, H, K = r.shape
    V = v.shape[-1]

    def plain(r, k, v, w, u, fn=wkv_ref):
        b, t = r.shape[:2]
        heads = [x.transpose(1, 2).reshape(b * H, t, x.shape[-1])
                 for x in (r, k, v, w)]
        out, state = fn(*heads, u.expand(b, H, K).reshape(b * H, K))
        return (out.reshape(b, H, t, V).transpose(1, 2),
                state.reshape(b, H, K, V))

    def rel(got, want):
        return max_abs_err(got, want) / float(want.abs().max())

    def check(rkvw, u, label):
        out, state = wcuda.rwkv_wkv_cuda(*rkvw, u)
        want_out, want_state = plain(*rkvw, u)
        emu_out, emu_state = plain(*rkvw, u, fn=wkv_chunked_ref)
        rel_out, rel_state = rel(out, want_out), rel(state, want_state)
        print(f"rwkv_wkv {tuple(rkvw[0].shape)}, {label}: relative error "
              f"{rel_out:.3g} (outputs), {rel_state:.3g} (final state), "
              f"bound {WKV_REL}; the chunked emulation's "
              f"{rel(emu_out, want_out):.3g}, {rel(emu_state, want_state):.3g}"
              , flush=True)
        if not (rel_out < WKV_REL and rel_state < WKV_REL):
            raise AssertionError(f"rwkv_wkv ({label}) differs from the "
                                 "plain recurrence")
        if not (torch.isfinite(out).all() and torch.isfinite(state).all()):
            raise AssertionError(f"rwkv_wkv ({label}): non-finite values")
        return max_abs_err(out, want_out), state, want_out

    def bonus_moves(want_out, rkvw):
        zero_u, _ = plain(*rkvw, torch.zeros_like(u))
        return max_abs_err(want_out, zero_u) / float(want_out.abs().max())

    gen = torch.Generator(device=u.device).manual_seed(5)

    def draw(shape, std):
        return std * torch.randn(shape, generator=gen, device=u.device,
                                 dtype=u.dtype)

    path = (r, k, v, w)
    err, state, _ = check(path, u, "the path's inputs and u (max |u| "
                          f"{float(u.abs().max()):g})")
    bonus = draw(u.shape, WKV_BONUS_STD)
    _, _, want = check(path, bonus, f"the path's inputs, u ~ "
                       f"{WKV_BONUS_STD} N(0, 1)")
    print(f"rwkv_wkv: that bonus moves the plain outputs on the path's "
          f"inputs by {bonus_moves(want, path):.3g} of their largest",
          flush=True)
    drawn = (draw(r.shape, 0.5), draw(k.shape, 0.5), draw(v.shape, 0.5),
             torch.sigmoid(draw(w.shape, 2.0)))
    _, _, want = check(drawn, bonus, "drawn as tests/test_kernels.py:363")
    moved = bonus_moves(want, drawn)
    print(f"rwkv_wkv: on the drawn inputs the bonus moves the plain outputs "
          f"by {moved:.3g} of their largest (must be >= {10 * WKV_REL:g})",
          flush=True)
    if moved < 10 * WKV_REL:
        raise AssertionError("the bonus check cannot see a dropped bonus")
    del want, drawn
    ragged = (LM_REQUESTS, 650, H, K)
    if ragged[1] % CHUNK == 0:
        raise AssertionError("the ragged check needs T ragged against the "
                             "chunk")
    drawn = [draw(ragged, 0.5), draw(ragged, 0.5), draw(ragged, 0.5),
             torch.sigmoid(draw(ragged, 10.0))]
    drawn[3][:, ::3, :, ::2] = 0.0
    check(tuple(drawn), bonus, f"drawn, T = {ragged[1]} (ragged against the "
          f"chunk of {CHUNK}), dscale 10, w = 0 in every third step's even "
          "channels")
    del drawn
    plain_ms = device_ms(lambda: plain(r, k, v, w, u), reps=1, warm=0)
    # bytes: r, k, v, w and out once, u and the state; operations: the
    # kernel's chunked form (chunk L) per (b, h) and chunk: the inter-chunk
    # and state products 4 L K V, the strictly lower intra-chunk scores and
    # product 2 * L(L-1)/2 * (K + V), the diagonal 3 L K + 2 L V
    L = CHUNK
    per_chunk = 4 * L * K * V + L * (L - 1) * (K + V) + 3 * L * K + 2 * L * V
    n_ops = B * H * (-(-T // L)) * per_chunk
    n_bytes = 4 * (r.numel() * 3 + v.numel() * 2 + u.numel() + state.numel())
    return kernel_row(
        probes, "rwkv_wkv", wcuda, launches, err,
        lambda: wcuda.rwkv_wkv_cuda(r, k, v, w, u), plain_ms, None, n_bytes,
        n_ops, PEAK_F32_OPS_S, reps=5, shape="x".join(map(str, r.shape)))


def lm_phase(probes, device="cuda"):
    """The LM serving slice: each model at full width, the kernel rows on
    its own inputs, the float32 consistency check and the JAX record.
    Returns the kernel rows and the profile targets (one serve call per
    model)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import KERNEL_SHAPES
    from repro_torch.serve.engine import generate

    rows, targets = [], []
    for arch in LM_KERNEL:
        model, prompts, launches, serve_ms, args = lm_serve_phase(arch,
                                                                   device)
        targets.append((f"{arch} serve call",
                        lambda m=model, p=prompts: generate(m, p, LM_GEN),
                        serve_ms))
        if arch == "yi-9b":
            q, k, v = args
            rows += flash_row(probes, q, k, v, launches, FLASH_TOL,
                              FLASH_TOL, label="x".join(map(str, q.shape)))
        else:
            rows.append(wkv_row(probes, args, launches))
        del args
        torch.cuda.empty_cache()
    for arch in LM_KERNEL:
        lm_parity_phase(arch, device)
    lm_record_phase(device)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(3)
    case = {c["case"]: c for c in KERNEL_SHAPES["flash_attention"]}
    b, s, d = (case["prefill_32k"][k] for k in ("bh", "s", "d"))
    q, k, v = (torch.randn((b, s, 1, d), device=device, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    for window in (None, 4096):     # not on the path: no launches there
        rows += flash_row(
            probes, q, k, v, 0, FLASH_32K_ATOL, FLASH_32K_RTOL,
            window=window, f32=True,
            label=f"{b}x{s}x1x{d}" + (f" window {window}" if window else ""))
    del q, k, v
    # yi's heads at a prompt length ragged against the kernel's 128-row
    # tiles, random inputs: off the path as well
    cfg = get_config("yi-9b")
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v = (torch.randn((LM_REQUESTS, FLASH_RAGGED_S, heads, cfg.d_head),
                           device=device, generator=gen).to(torch.bfloat16)
               for heads in (cfg.n_heads, cfg.n_kv, cfg.n_kv))
    rows += flash_row(probes, q, k, v, 0, FLASH_32K_ATOL, FLASH_32K_RTOL,
                      label="x".join(map(str, q.shape)))
    return rows, targets


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
    """Host-clock times of the funnel, run before any profiler session
    (a profiler session leaves per-launch host cost behind it).  Returns
    the profile targets (label, call, wall ms)."""
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
    return [("S=1", lambda: ex(frames), ms),
            (f"S={STREAMS}", lambda: ex.run_streams(streams), msS)]


def dispatch_profile(label, fn, want):
    """One call of a serving group dispatch under torch.profiler: its
    launches of each serving kernel by the profiler's kernel names, held
    to the wrappers' counts ``want`` of the same call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    got = {name: sum(e.count for e in events if name in e.key)
           for name in SERVE_KERNELS}
    got = {k: v for k, v in got.items() if v}
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile serving {label}: kernel launches {got} (wrappers "
          f"counted {want}), {sum(e.count for e in events)} launches in "
          f"all, device busy {busy:.4f} ms", flush=True)
    if got != want:
        raise AssertionError(f"{label}: the profiler saw {got}, the "
                             f"wrappers counted {want}")


def profiles_phase(ex, frames, targets, probes, dispatches=()):
    """Every torch.profiler session of the run, after every host-clock and
    CUDA-event time: each kernel's device time per launch, then each
    target's device time by kernel, then the serving dispatches' kernel
    launches.  The funnel's host time is taken again just before and just
    after the sessions, to tell what the sessions leave behind from what
    the earlier phases do."""
    B = frames.shape[0]
    ms = host_ms(lambda: ex(frames))
    print(f"funnel before the profiler sessions, after the other phases: "
          f"{ms / B:.4f} ms per frame ({ms:.3f} ms per {B}-frame batch, "
          "median of 7)", flush=True)
    for label, fn, row, library_fn, kernel in probes:
        ms = launch_device_ms(fn, kernel)
        if row is None:                 # a route check: which kernel ran
            print(f"{label}: every launch was {kernel}, {ms:.4f} ms "
                  "(torch.profiler, 20 calls)", flush=True)
            continue
        row["device_ms"] = ms
        lib = ""
        if library_fn is not None:
            row["library_device_ms"] = call_device_ms(library_fn)
            lib = (f"; library call {row['library_device_ms']:.4f} ms "
                   "(all its kernels)")
        print(f"kernel {label}: device time per launch "
              f"{row['device_ms']:.4f} ms{lib} (torch.profiler, 20 calls)",
              flush=True)
    for label, fn, wall in targets:
        profile_phase(label, fn, wall)
    for label, fn, want in dispatches:
        dispatch_profile(label, fn, want)
    ms = host_ms(lambda: ex(frames))
    print(f"funnel after the profiler sessions: {ms / B:.4f} ms per frame "
          f"({ms:.3f} ms per {B}-frame batch, median of 7)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.bridge import load_fa_reference, load_vr_reference
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
    wgmma_check()

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

    counts, res, flips = main_phase(ex, frames, ref)
    targets = timing_phase(ex, frames, res)
    offload_counts, offload_target = offload_phase(ex, frames, res, flips)
    rows, probes = kernel_phase(ex, frames, {**counts, **{
        k: offload_counts[k] for k in ("wire_encode", "wire_decode")}})

    vr = load_vr_reference()
    vr_ex, views, fused, vr_counts, vr_ms = vr_phase(vr)
    vr_codec_counts = vr_offload_phase(vr, vr_ex, views, fused)
    del fused
    resilience_phase(ex, frames, vr_ex, views)
    rows += vr_kernel_rows(probes, vr_ex, views, vr_counts, vr_codec_counts)
    targets.append(("VR rig frame", lambda: vr_ex(*views), vr_ms))
    _serve_counts, serve_target, dispatches = serving_phase(ex, frames, card)
    targets.append(serve_target)
    lm_rows, lm_targets = lm_phase(probes)
    rows += lm_rows
    targets += lm_targets
    profiles_phase(ex, frames, targets + [offload_target], probes,
                   dispatches)

    print(json.dumps({"kernels": rows}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
