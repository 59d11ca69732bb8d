#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (at
first use, into ``build/repro_torch``) and checks with ``cuobjdump -sass``
that the bf16 flash kernels, the forward and the backward's dq and dkdv,
are ``wgmma`` kernels (HGMMA in their SASS) and that the float32 ones hold
no tensor-core instruction, then:

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
   then the training phase — the §III training path at full width on
   the card (``assets/train_reference.npz``): harvests the hard negatives
   and trains the 10x33 cascade (``train_cascade``, features on the card,
   every ``integral_image`` launch held to its plain version bit for
   bit), which must pick the asset's 99 stumps and polarities with
   thresholds within THRESHOLD_TOL and alphas and stage thresholds within
   CASCADE_TOL, and equal the same training on the CPU bit for bit;
   ``cascade_apply`` of the asset's cascade on the training windows
   against JAX's; the ``integral_image`` row at the training shape
   (2 x 2,300 windows of 20x20); the NN fitted from JAX's initial weights
   and batch schedule within NN_TOL of the asset's with JAX's
   classification error; the port's own seeded ``train_face_nn`` by
   tests/test_camera_pipeline.py's outcome rules; the funnel on the
   port-trained models against the JAX executor's record (capacities and
   motion equal, at most 2 window flips, auths within them); the golden
   ``detect_faces`` against ``FusedDetector`` on two frames by the
   borderline rule; and the wall times of the harvest, the cascade and
   the NN training;
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
9. LM training phase — yi-9b, then rwkv6-7b, at full width, 8 layers
   deep (TRAIN_LAYERS), bf16 parameters with a float32 master, one model
   on the card at a time after the serving models are freed: weights
   drawn on the card (seed 0), ``train.loop.train`` for 12 steps of
   ``batch_for_step(DataConfig(vocab, 2048, 8, 0), step)`` with the
   training CLI's AdamW (lr 3e-3, warmup 1, cosine over 12 steps),
   checkpoints every 4 steps held in host memory, one at a time
   (``MemoryCheckpoints``: a full-width 8-layer checkpoint is 27-32 GB,
   and the machine lets a run write 45 GiB to its disk in all) and a
   failure injected once at step 9,
   after which the loop restores step 8 and replays.  Every loss and grad
   norm finite; the replayed step 8 equal
   to the first (bits, else the reference's rtol 1e-5 / atol 1e-6);
   every weight leaf's step-0 gradient finite and nonzero; the launches
   of every step the predicted TRAIN_LAUNCHES (each layer's forward
   kernel twice, the second time under ``torch.utils.checkpoint``'s
   recompute, and its backward kernel once); step ms (host clock, median
   of the steps after the first), tokens/s, model FLOPs share, peak GiB,
   ``adamw_update``'s ms (CUDA events).  Then the backward kernels against
   their plain versions on layer 0's inputs at step 1 (rows 7g and 7h:
   the forward kernel's O and log-sum-exp first held to ``mha_streaming``'s,
   which the plain backward then takes; ``flash_attention_bwd`` in bf16
   within FLASH_TOL + FLASH_TOL |plain| and FLASH_BWD_BF16_REL of max
   |plain|, in float32 (the 3xTF32 ``mma.sync`` kernels) within
   FLASH_BWD_F32_TOL of it, each beside the first draft's recorded time
   and SDPA's backward, timed as forward + backward less forward (its
   device time, of the backward alone on a kept graph, in the profile
   phase); row 8b: ``rwkv_wkv_bwd`` within
   WKV_REL), every run bit-equal to the next; the forward with its
   log-sum-exp bit-equal to the forward without; on drawn inputs (flash at
   yi's heads with S = 4000, causal and with a window of 1024, and at D =
   64 (FLASH_BWD_D64), both dtypes; WKV at T = 650, 11 and 200 (B = 1)
   with w = 0 in some channels and a seeded nonzero u, the chunked
   emulation's errors beside the
   kernel's); the JAX training records
   (``assets/lm_train_reference.npz``) through the kernels in float32;
   and the loop with its checkpoints on disk at the record's yi config
   (a failure replayed bit-equal, a resume); then the compressed training
   phase — yi-9b as above through ``make_train_step_compressed`` at one
   pod (the int8 error-feedback exchange, its codec on the
   ``wire_encode`` / ``wire_decode`` kernels), 4 steps from the plain
   run's weights and batches: step 0's loss equal to the plain run's,
   every residual within half a quantization step plus an ulp, launches
   a step held (16 + 8 flash, one encode and one decode a call of the
   exchange), the codec route against the plain compressor bit for bit,
   the step's and the exchange's time, the peak, the link bytes, the
   planner's roofline row, rows 4g / 5g on the largest gradient leaf, and
   the JAX compressed-training record
   (``assets/lm_compressed_train_reference.npz``) at one pod;
10. whisper phase — whisper-medium, the encoder-decoder, at full width
   and full depth (24 + 24 layers), bf16, weights drawn on the card (seed
   0): a serve call (encode 8 x 1500 x 1024 frames drawn in bf16, seed 2;
   ``generate`` from the encoder output on 8 prompts of 200 tokens, seed
   1, 32 greedy tokens) that launches ``flash_attention`` exactly 24
   times, all in prefill, and projects each layer's cross keys and values
   once, in prefill, never in a decode step; every logit finite, ``stream``
   == ``generate``; encode, prefill and per-token decode ms by host clock
   and CUDA events, peak memory; row 7 at the prefill's inputs.  The
   float32 parity at 4 + 4 layers (weights drawn as unstacked layers; the
   stacked init's chaotic reading printed beside it); the JAX record
   ``assets/lm_encdec_reference.npz`` through the kernels (serving, and
   one training step with every leaf's gradient probes); then
   ``train.loop.train`` on the whole model, 6 steps of 8 x 448 tokens and
   8 x 1500 frames, bf16 with a float32 master, checkpoints every 4 steps
   in host memory (10.6 GB each), a failure at step 5 replayed from step
   4: finite losses, the replay equal, every leaf's step-0 gradient
   finite and nonzero, 48 forward and 24 backward launches a step; step
   ms, tokens/s, model FLOPs (the encoder's parameters on the frames, its
   full attention and the cross-attention counted), AdamW's share, peak
   memory; row 7g at layer 0's backward inputs;
11. mixtral phase — mixtral-8x22b, the MoE layer, at full width, 8 of
   its 56 layers (the whole model does not fit one card), bf16, weights
   drawn on the card (seed 0): a serve call (8 prompts of 8192 tokens,
   seed 1, so the window of 4096 binds; 32 greedy tokens) that launches
   ``flash_attention`` exactly 8 times, all in prefill; every logit
   finite, ``stream`` == ``generate``; prefill and per-token decode ms,
   peak memory, the assignments each layer drops in the prefill and in
   one decode step (capacity 20,480 and 2 an expert).  Routing at the
   last layer on the MoE inputs of that prefill and decode step, on the
   card against the CPU port: the float32 router logits within their
   a-priori summation bound, choices equal except at near ties (within
   the card's own probability differences; printed), weights within what the logits' difference allows, the CPU's
   ``sort_dispatch`` of the card's choices bit-equal to the card's, and
   the bf16 layer output within 2^-7 of max + 2^-7 |x| of the CPU port's
   float32 on the same routing.  Row 7m at the prefill's first flash
   inputs (8 x 8192 x 48/8 x 128, window 4096; held to 2^-7 of max
   |plain|, the forward's bound at the models' scale, with the count
   outside FLASH_TOL's elementwise bound printed), SDPA timed with a
   boolean window mask.  The float32 parity at 2 layers and capacity
   factor 16 (nothing drops) within PARITY_REL, and at the published
   1.25 printed with its drops, not held: the capacity depends on how
   many tokens a call routes, so forward, prefill and decode drop
   differently, in the reference too.  The JAX record
   ``assets/lm_moe_reference.npz`` through the kernels in float32
   (``moe_record_check``: forward, loss with ce and aux, served logits
   and greedy tokens within max(1e-4, E), every layer's drops equal).
   Then MoE training (``mixtral_train_phase``): ``train.loop.train`` on 1
   of the 56 layers at full width (2.91 B parameters, 43.3 GiB with
   gradients, master and moments), bf16 with a float32 master, 6 steps
   of 8 x 2048 tokens, checkpoints every 4 steps in host memory (40.7 GB
   each), a failure at step 5 replayed from step 4, with every check of
   the LM training phase (2 forward and 1 backward launches a step) and,
   besides, each step's aux loss and the assignments the layer drops in
   the step's forward (counted once, not in the remat recompute), the
   model FLOPs by active parameters (top 2 of the 8 experts), the card's
   peak and the host's peak RSS; row 7gm at layer 0's backward inputs at
   step 1 (8 x 2048 x 48/8 x 128, causal: the window of 4096 does not
   bind) beside SDPA's flash backward; ``adamw_update`` in slices
   bit-equal to the whole-leaf update on one 64000 x 4096 leaf; the
   select backward of the expert loop's ``w[i]`` timed on one expert
   leaf beside ``unbind``'s; and the JAX MoE training record
   ``assets/lm_moe_train_reference.npz`` through the kernels in float32
   (``lm_train_record_check``: the step-0 gradient of every leaf, each
   step's loss, ce, aux and grad norm within max(1e-4, E), the lr within
   an ulp, each step's drops equal);
12. deepseek phase — deepseek-v2-236b, MLA and the dense prefix, at full
   width, 6 of 60 layers (the dense first layer and five MoE layers of
   160 experts top-6 with two shared; 21.7 B parameters, 40.5 GiB), bf16,
   8 x 4096-token prompts, 32 greedy tokens: 6 flash launches, all in
   prefill, at MLA's key width of 192 (128 + the shared rope key, folded
   into each head) and value width of 128; finite logits, stream ==
   generate; a decode cache of the latent and rope key alone; drops a
   MoE layer; routing at the last layer as mixtral's; row 7mla at the
   prefill's first flash inputs (held as 7m; SDPA on the first backend
   that takes dv != d) and the pair on drawn inputs at S = 4000 in bf16
   and float32; the float32 parity at 2 layers and capacity factor 32
   (above 160 / 6, so that a call of t tokens keeps all its 6 t choices)
   with nothing dropped; the JAX
   record ``assets/lm_mla_reference.npz`` as mixtral's.  Then MLA
   training (``deepseek_train_phase``): ``train.loop.train`` on 1 of the
   60 layers at full width, the dense MLA prefix layer with its SwiGLU
   FFN (1.467 B parameters, 21.9 GiB with gradients, master and moments;
   a second layer is a MoE layer of ~4.05 B), with mixtral's steps,
   checkpoints and failure and every check of the LM training phase (1
   forward and 1 backward launch a step: the prefix runs without remat,
   as the reference's unscanned prefix), the model FLOPs with MLA's
   products at their own widths; row 7gmla at layer 0's backward inputs
   at step 1 (8 x 2048 x 128/128, d 192, dv 128, causal) beside SDPA's
   cuDNN backward; row 7hmla, the float32 backward on drawn inputs at
   8 x 4000 x 32 heads, beside SDPA's efficient backward; and the JAX MLA
   training record ``assets/lm_mla_train_reference.npz`` through the
   kernels in float32 as mixtral's;
13. jamba phase — jamba-v0.1-52b, Mamba layers with an attention layer in
   every period of 8, at full width, 8 of 32 layers (one period: 7 Mamba
   layers and the attention layer 4; MoE, 16 experts top-2, on the odd
   layers; 13.3 B parameters, 24.8 GiB), bf16, 8 x 4096-token prompts,
   32 greedy tokens: 1 flash launch, in prefill, at a head group of 4;
   finite logits, stream == generate; the decode cache a layer of each
   kind (the Mamba conv and ssm state against the attention keys and
   values); the serve call's transient memory below one (b, s, d_inner,
   d_state) float32 tensor (the scan builds its exp(delta A) and Bx a
   chunk of 256 steps at a time); drops a MoE layer; routing at the last
   layer as mixtral's; row 7j at the prefill's flash inputs (held as 7m);
   the last Mamba layer in float32 on the card against the CPU port, on
   the serve call's own input to it (within (1 + MAMBA_MARGIN) times the
   CPU port's own distance from a float64 evaluation), and the chunked
   scan bit-equal to the unchunked one on that layer's inputs at a length
   ragged against the chunk; the float32 parity at layers 0-4 and
   capacity factor 16; the JAX record ``assets/lm_hybrid_reference.npz``
   as mixtral's;
14. profile phase — every torch.profiler session of the run: each kernel's
   device time per launch, the device time by kernel of one call at S = 1,
   S = 64, the VR rig frame, a steady-state serving tick (its device-busy
   share), the executed offload cut, one serve call of each LM and one
   training step of each (mixtral's and deepseek's at their 1 layer; yi's
   compressed step too),
   whisper's, mixtral's, deepseek's and jamba's
   included (jamba's prefill alone too) (each model
   built anew when its profile runs; the card's activity alone),
   the serving dispatches' kernel launches by the profiler's names (held
   to the wrappers' counts), with the funnel's host time just before and
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
PEAK_TF32_OPS_S = 495e12        # TF32 tensor cores, dense
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
    """The bf16 flash kernels are ``wgmma`` kernels: the SASS of the built
    library (``cuobjdump -sass``) holds HGMMA, the ``wgmma`` instruction,
    in the forward at each of its (d, dv) pairs (d / 16 for S = Q K^T and
    16 for P V's hi and lo terms over a key tile of 128: 20 at (64, 64),
    24 at (128, 128), 28 at MLA's (192, 128)) and in both bf16 backward
    kernels (dq and dkdv) at each (d, dv) pair of ``BWD_PAIRS``; the
    float32 forward holds no tensor-core instruction (HGMMA or HMMA): its
    products stay float32 FMAs, never TF32; the float32 backward's dq and
    dkdv kernels (``tf32x3``) hold HMMA, the ``mma.sync`` their 3xTF32
    products run on, at each pair, and no HGMMA.  The int8 kernels' IMMA
    counts are printed."""
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.cuda import BWD_PAIRS, PAIRS

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
        if "flash_attention" in name or "quant_" in name:
            print(f"SASS {name}: " + ", ".join(f"{n[op]} {op}" for op in ops),
                  flush=True)
    flash = {k: v for k, v in counts.items() if "flash_attention_kernel" in k}
    bf16 = sorted(n["HGMMA"] for name, n in flash.items()
                  if "tensor_core" in name)
    f32 = [n["HGMMA"] + n["HMMA"] for name, n in flash.items()
           if "cuda_core" in name]
    want = sorted(d // 16 + 16 for d, _dv in PAIRS)
    if bf16 != want or len(f32) != len(PAIRS) or any(f32):
        raise AssertionError(f"expected {want} HGMMA in the bf16 flash "
                             "kernels and no tensor-core instruction in the "
                             f"float32 ones: {bf16}, {f32}")
    bwd = {k: v for k, v in counts.items() if "flash_attention_bwd" in k}
    bwd_bf16 = {k: v["HGMMA"] for k, v in bwd.items() if "tensor_core" in k}
    bwd_f32 = {k: v for k, v in bwd.items() if "tf32x3" in k}

    def pair_of(name):
        return next(p for p in BWD_PAIRS if f"ILi{p[0]}ELi{p[1]}E" in name)

    def kinds(names):
        return {(part, p) for part in ("_dq_", "_dkdv_") for p in BWD_PAIRS
                for k in names if part in k and f"ILi{p[0]}ELi{p[1]}E" in k}

    n = 2 * len(BWD_PAIRS)
    if (len(bwd_bf16) != n or len(kinds(bwd_bf16)) != n
            or not all(bwd_bf16.values()) or len(bwd_f32) != n
            or len(kinds(bwd_f32)) != n
            or not all(v["HMMA"] and not v["HGMMA"]
                       for v in bwd_f32.values())):
        raise AssertionError("expected HGMMA in the bf16 backward's dq and "
                             f"dkdv kernels at each of {BWD_PAIRS}, and HMMA "
                             f"without HGMMA in the float32 ones: {bwd_bf16},"
                             f" {bwd_f32}")
    print("flash_attention: the bf16 kernel's SASS holds HGMMA (wgmma), 24 "
          "and 20; the float32 kernel's no HGMMA or HMMA", flush=True)
    print("flash_attention_bwd: the bf16 dq and dkdv kernels' SASS holds "
          "HGMMA (wgmma) at each (d, dv) pair ("
          + ", ".join(f"{'dq' if '_dq_' in k else 'dkdv'} {pair_of(k)} {n}"
                      for k, n in sorted(bwd_bf16.items()))
          + "); the float32 ones' HMMA (3xTF32 mma.sync), no HGMMA ("
          + ", ".join(f"{'dq' if '_dq_' in k else 'dkdv'} {pair_of(k)} "
                      f"{n['HMMA']}" for k, n in sorted(bwd_f32.items()))
          + ")", flush=True)


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


# torch.profiler keeps only the card's records that fall inside its capture
# window on the host's clock.  Late in a whole run of this script sessions
# lost records at their end: 0, 0 and 19 of 20 launches of a 14 us kernel
# in three sessions, and a serve call the last ~8 of its 31 decode steps,
# as if the card's timestamps, taken to the host's clock, ran later as
# the process ages.  So each session waits PROFILE_TAIL_S after its last
# synchronise before it closes.
PROFILE_TAIL_S = 0.5


def close_session():
    """The end of a profiler session: the card drained, then
    PROFILE_TAIL_S more inside the capture window."""
    import torch

    torch.cuda.synchronize()
    time.sleep(PROFILE_TAIL_S)


def launch_device_ms(fn, kernel, reps: int = 20, tries: int = 3) -> float:
    """Device milliseconds of one launch of the CUDA kernel named
    ``kernel``, by torch.profiler over ``reps`` calls of ``fn``: the
    kernel alone, without the host time between launches that CUDA events
    around back-to-back calls also count.  ``kernel`` may be (name, n): a
    wrapper whose one launch runs n CUDA kernels whose names hold ``name``
    (the backward kernels), timed together.  The profiler now and then
    drops a kernel's record; a session that does not see exactly ``reps``
    launches is taken again, and after ``tries`` such sessions the call
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernel, per_call = kernel if isinstance(kernel, tuple) else (kernel, 1)
    want = reps * per_call
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            close_session()
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and kernel in e.key]
        count = sum(e.count for e in events)
        if count == want:
            return sum(e.self_device_time_total for e in events) / 1e3 / reps
        print(f"profiler saw {count} launches of {kernel}, expected {want}: "
              "profiling again", flush=True)
    raise AssertionError(f"profiler saw {count} launches of {kernel}, "
                         f"expected {want}, in each of {tries} sessions")


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
        close_session()
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
    library call timed as ``library_ms``, or a ``Deferred`` that builds it
    there), which fills the row's ``device_ms`` and ``library_device_ms``
    there.  ``shared_ms``, where
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
    """Bit-for-bit equality (float32 and bf16 tensors compared as int32
    and int16 words)."""
    import torch

    words = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in words and b.dtype == a.dtype:
        a, b = a.view(words[a.dtype]), b.view(words[a.dtype])
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

# -- the training phase ------------------------------------------------------

THRESHOLD_TOL = 1e-5    # stump thresholds: features of two table orders
CASCADE_TOL = 1e-9      # alphas and stage thresholds
NN_TOL = 1e-4           # the fit from JAX's draws against the asset's NN
TRAIN_STEPS = 1500      # fa_hotpath._workload's train_face_nn(steps=1500)
BORDERLINE_TOL = 1e-4   # tests/test_detect.py:91's borderline rule


def training_set(frames, truth):
    """The full-width cascade's training windows: ``face_dataset(400,
    seed=3)`` and the hard negatives harvested from the §III video
    (``workloads.fa_cascade``).  Returns (X, y, n_faces, harvest ms)."""
    from repro_torch.camera.synthetic import face_dataset
    from repro_torch.camera.viola_jones import harvest_hard_negatives

    X, y, _ = face_dataset(n_per_class=400, seed=3)
    t0 = time.perf_counter()
    neg = harvest_hard_negatives(frames, truth)
    ms = 1e3 * (time.perf_counter() - t0)
    return (np.concatenate([X, neg]),
            np.concatenate([y, np.zeros(len(neg), np.int32)]), len(X), ms)


def cascade_check(label, got, want) -> dict:
    """A trained cascade against the asset's: the same stumps (features
    and polarities) and stage sizes, thresholds within THRESHOLD_TOL,
    alphas and stage thresholds within CASCADE_TOL.  Returns the
    readings."""
    def rows(c):
        return [(f.kind, f.y, f.x, f.h, f.w) for f in c.feats]

    if rows(got) != rows(want) or got.stage_sizes != want.stage_sizes:
        raise AssertionError(f"{label}: the cascade picked other stumps "
                             f"({got.stage_sizes} vs {want.stage_sizes})")
    if not np.array_equal(got.polarity, want.polarity):
        raise AssertionError(f"{label}: polarities differ")
    d = {k: float(np.abs(np.asarray(getattr(got, k), np.float64)
                         - np.asarray(getattr(want, k), np.float64)).max())
         for k in ("thresholds", "alphas", "stage_thresholds")}
    print(f"{label}: {len(got.feats)} stumps, stages {got.stage_sizes}, "
          f"features and polarities == the asset's; thresholds within "
          f"{d['thresholds']:.3g}, alphas {d['alphas']:.3g}, stage "
          f"thresholds {d['stage_thresholds']:.3g}", flush=True)
    if d["thresholds"] > THRESHOLD_TOL or max(
            d["alphas"], d["stage_thresholds"]) > CASCADE_TOL:
        raise AssertionError(f"{label}: {d} beyond {THRESHOLD_TOL} / "
                             f"{CASCADE_TOL}")
    return d


def cascades_bit_equal(a, b) -> bool:
    return ([(f.kind, f.y, f.x, f.h, f.w) for f in a.feats]
            == [(f.kind, f.y, f.x, f.h, f.w) for f in b.feats]
            and a.stage_sizes == b.stage_sizes
            and all(np.array_equal(np.asarray(getattr(a, k)).view(np.uint8),
                                   np.asarray(getattr(b, k)).view(np.uint8))
                    for k in ("thresholds", "polarity", "alphas",
                              "stage_thresholds")))


def nn_readings(nn, want, X, y) -> dict:
    """A trained NN against the asset's: the largest weight difference,
    the classification error on the training windows and the int8
    weights of the funnel's quantization that differ."""
    import torch

    from repro_torch.camera.face_nn import classification_error, forward_float
    from repro_torch.kernels.quant_matmul.ops import quantize_nn

    diff = max(float((getattr(nn, k) - getattr(want, k)).abs().max())
               for k in ("w1", "b1", "w2", "b2"))
    x = torch.as_tensor(X, device=nn.w1.device)
    q, qw = quantize_nn(nn), quantize_nn(want)
    return {"max_abs": diff,
            "error": classification_error(forward_float(nn, x), y),
            "int8_differ": int((q.w1_q != qw.w1_q).sum()
                               + (q.w2_q != qw.w2_q).sum())}


def seeded_nn_check(device):
    """The port's own seeded ``train_face_nn`` on tests/test_camera_
    pipeline.py's split, held by that test's outcome rules (:58-86): the
    LUT within 0.01 of float, 8 bits within 0.015 of float, 4 bits no
    better than 8.  Returns (errors, wall ms)."""
    import torch

    from repro_torch.camera.face_nn import (
        classification_error,
        forward_float,
        forward_lut,
        forward_quantized,
        make_sigmoid_lut,
        train_face_nn,
    )
    from repro_torch.camera.synthetic import face_dataset

    X, y, _ = face_dataset(n_per_class=250, seed=1)
    ntr = int(0.9 * len(X))
    t0 = time.perf_counter()
    nn = train_face_nn(X[:ntr], y[:ntr], steps=TRAIN_STEPS, device=device)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    xte, yte = torch.as_tensor(X[ntr:], device=device), y[ntr:]
    lut, meta = make_sigmoid_lut(device=device)
    e = {"float": classification_error(forward_float(nn, xte), yte),
         "lut": classification_error(forward_lut(nn, xte, lut, meta), yte)}
    for b in (16, 8, 4):
        e[b] = classification_error(forward_quantized(nn, xte, b, lut, meta),
                                    yte)
    print(f"seeded train_face_nn on the card: test errors {e} "
          f"({TRAIN_STEPS} steps, {ms:.1f} ms)", flush=True)
    if not (abs(e["float"] - e["lut"]) <= 0.01
            and e[8] - e["float"] <= 0.015 and e[4] >= e[8]):
        raise AssertionError(f"the seeded NN breaks the outcome rules: {e}")
    return e, ms


def vj_borderline(cascade, frame, pos, device) -> bool:
    """tests/test_detect.py:91's rule on the port's golden features: some
    stump response or stage score of the window within BORDERLINE_TOL of
    its threshold."""
    from repro_torch.camera.viola_jones import eval_features_scaled

    y, x, win = pos
    F = eval_features_scaled(frame[None, y:y + win, x:x + win], win,
                             cascade.feats, device=device).cpu().numpy()[0]
    if np.min(np.abs(F - cascade.thresholds)) < BORDERLINE_TOL:
        return True
    pred = cascade.polarity * np.sign(F - cascade.thresholds)
    pred[pred == 0] = 1.0
    weighted = cascade.alphas * pred
    off = 0
    for si, size in enumerate(cascade.stage_sizes):
        score = weighted[off:off + size].sum()
        if abs(score - cascade.stage_thresholds[si]) < BORDERLINE_TOL:
            return True
        if score < cascade.stage_thresholds[si]:
            break
        off += size
    return False


def golden_check(cascade, frames, idx, scan, device) -> int:
    """``detect_faces``, the golden per-window detector, against
    ``FusedDetector`` on the frames ``idx`` (tests/test_detect.py:130):
    every window found by one side only is borderline, at most
    MAX_WINDOW_FLIPS of them.  Returns the number of flips."""
    from repro_torch.camera.viola_jones import FusedDetector, detect_faces

    det = FusedDetector(cascade, frames.shape[1], frames.shape[2],
                        device=device, **scan)
    dets, stats = det.detect(frames[idx])
    flips = found = 0
    for i, fused in zip(idx, dets):
        ref, n_inv, _ = detect_faces(cascade, frames[i], device=device,
                                     **scan)
        if n_inv != stats["n_windows"]:
            raise AssertionError(f"golden scan {n_inv} windows, fused "
                                 f"{stats['n_windows']}")
        diff = set(ref) ^ set(fused)
        for pos in diff:
            if not vj_borderline(cascade, frames[i], pos, device):
                raise AssertionError(f"frame {i}: non-borderline mismatch "
                                     f"at {pos}")
        flips += len(diff)
        found += len(ref)
    print(f"detect_faces on frames {list(idx)}: {found} windows, {flips} "
          f"borderline flips against FusedDetector ({stats['n_windows']} "
          "scanned a frame)", flush=True)
    if flips > MAX_WINDOW_FLIPS or not found:
        raise AssertionError(f"{flips} flips, {found} windows")
    return flips


def trained_funnel_check(out, ref, base):
    """The funnel's result ``out`` on port-trained models against the JAX
    executor's on the asset's (``ref.outputs``): motion equal, at most
    MAX_WINDOW_FLIPS windows found by one side only, auths within the
    flips.  Counts the windows shared with ``base``, the port's run on
    the asset's models, whose score differs.  Returns (flips, moved)."""
    keys = ("motion", "n_windows", "n_auth", "window_id", "window_valid",
            "scores")
    got = {k: getattr(out, k).cpu().numpy() for k in keys}
    was = {k: getattr(base, k).cpu().numpy() for k in keys}
    o = ref.outputs
    if not np.array_equal(got["motion"], o["motion"]):
        raise AssertionError("motion frames differ from the asset's")
    flips = moved = 0
    for i in range(len(got["motion"])):
        def scored(r):
            v = r["window_valid"][i]
            return dict(zip(r["window_id"][i][v], r["scores"][i][v]))
        mine, theirs, before = scored(got), scored(o), scored(was)
        flips += len(set(mine) ^ set(theirs))
        moved += sum(mine[k].view(np.int32) != before[k].view(np.int32)
                     for k in set(mine) & set(before))
    n_win, n_auth = int(got["n_windows"].sum()), int(got["n_auth"].sum())
    print(f"funnel on the port-trained models: {int(got['motion'].sum())} "
          f"motion frames, {n_win} windows, {n_auth} auth (JAX "
          f"{int(o['n_windows'].sum())}, {int(o['n_auth'].sum())}); {flips} "
          f"window flips; {moved} shared windows score otherwise than on "
          "the asset's models", flush=True)
    if (flips > MAX_WINDOW_FLIPS
            or abs(n_auth - int(o["n_auth"].sum())) > flips):
        raise AssertionError(f"{flips} flips, {n_auth} auth")
    return flips, moved


def training_phase(ref, frames_np, truth, res, card, probes,
                   device="cuda"):
    """Train the §III cascade and NN on the card at full width and hold
    them to the JAX-trained asset; drive the funnel with them.  ``res``
    is the main path's result on the asset's models.  Returns the
    ``integral_image`` row at the training shape."""
    import torch

    from repro_torch.bridge import load_train_reference
    from repro_torch.camera.face_nn import fit_face_nn
    from repro_torch.camera.pipelines import FaceAuthExecutor
    from repro_torch.camera.viola_jones import (
        cascade_apply,
        eval_features,
        make_feature_pool,
        train_cascade,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels.integral_image import cuda as icuda
    from repro_torch.kernels.integral_image.ref import integral_image_ref

    tr = load_train_reference(device=device)
    X, y, n_faces, harvest_ms = training_set(frames_np, truth)
    if (n_faces, len(X) - n_faces) != (2 * tr.n_per_class, tr.n_negatives):
        raise AssertionError(f"{len(X)} training windows")
    pool = make_feature_pool(n=250)

    # 1, 3: the cascade on the card, every integral launch held (the
    # training path launches no other serving kernel)
    with serve_kernels_as(None, "held") as held:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        casc = train_cascade(X, y, pool, device=device)
        cascade_ms = 1e3 * (time.perf_counter() - t0)
        launches = _build.launches["integral_image"]
    seen = held.get("integral_image", [])
    print(f"train_cascade on the card: {launches} integral_image launches "
          f"({seen}), each == plain bit for bit; {cascade_ms:.1f} ms",
          flush=True)
    if launches < 1 or len(seen) != launches:
        raise AssertionError("train_cascade never launched integral_image")
    cascade_check("train_cascade (card)", casc, ref.cascade)

    # 2: the same training on the CPU
    F_card = eval_features(X.reshape(-1, 20, 20), pool, device=device).cpu()
    F_cpu = eval_features(X.reshape(-1, 20, 20), pool, device="cpu")
    cpu = train_cascade(X, y, pool, device="cpu")
    if not (_bits_equal(F_card, F_cpu) and cascades_bit_equal(casc, cpu)):
        raise AssertionError("the card's features or cascade differ from "
                             "the CPU port's")
    print(f"features {tuple(F_card.shape)} and cascade: card == CPU port "
          "bit for bit", flush=True)
    acc, evals = cascade_apply(ref.cascade, X.reshape(-1, 20, 20),
                               device=device)
    acc, evals = acc.cpu().numpy(), evals.cpu().numpy()
    apply_flips = int((acc != tr.accepted).sum())
    print(f"cascade_apply of the asset's cascade on the {len(X)} training "
          f"windows: {int(acc.sum())} accepted, {int(evals.sum())} stage "
          f"evaluations (JAX {int(tr.accepted.sum())}, "
          f"{int(tr.stage_evals.sum())}); {apply_flips} windows differ",
          flush=True)
    if apply_flips > MAX_WINDOW_FLIPS:
        raise AssertionError(f"cascade_apply: {apply_flips} flips")

    # the kernel at the training shape (row 1c)
    w = torch.as_tensor(X.reshape(-1, 20, 20), device=device)
    x = torch.cat([w, w * w]).contiguous()
    got = icuda.integral_image_cuda(x)
    if not torch.equal(got, integral_image_ref(x)):
        raise AssertionError("integral_image at the training shape differs "
                             "from plain")
    row = kernel_row(
        probes, "integral_image", icuda, launches, 0.0,
        lambda: icuda.integral_image_cuda(x),
        device_ms(lambda: integral_image_ref(x), reps=5, warm=1),
        device_ms(lambda: torch.cumsum(torch.cumsum(x, -2), -1)),
        4 * (x.numel() + got.numel()), 2 * x.numel(), PEAK_F32_OPS_S,
        shape="x".join(map(str, x.shape)),
        library_fn=lambda: torch.cumsum(torch.cumsum(x, -2), -1))

    # 4: the NN from JAX's initial weights and schedule
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nn = fit_face_nn(tr.init, X[:n_faces], y[:n_faces], tr.batches)
    torch.cuda.synchronize()
    nn_ms = 1e3 * (time.perf_counter() - t0)
    r = nn_readings(nn, ref.nn, X[:n_faces], y[:n_faces])
    print(f"fit_face_nn on the card from JAX's draws: weights within "
          f"{r['max_abs']:.3g} of the asset's, error {r['error']} (JAX "
          f"{tr.classification_error}), {r['int8_differ']} int8 weights "
          f"differ; {TRAIN_STEPS} steps {nn_ms:.1f} ms", flush=True)
    if r["max_abs"] > NN_TOL or r["error"] != tr.classification_error:
        raise AssertionError(f"the NN: {r}")

    # 5: the port's own seeded training
    _errors, seeded_ms = seeded_nn_check(device)

    # 6: the funnel on the port-trained models
    frames = torch.as_tensor(frames_np, device=device)
    ex = FaceAuthExecutor(casc, nn, frames.shape[1], frames.shape[2],
                          device=device, **ref.scan)
    caps = ex.calibrate(frames)
    if caps != (ref.frame_capacity, ref.window_capacity,
                ref.cascade_capacities):
        raise AssertionError(f"capacities {caps}")
    torch.cuda.synchronize()
    _build.reset_launches()
    out = ex(frames)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    print(f"funnel on the port-trained models: launches {counts}, "
          f"capacities {caps}", flush=True)
    trained_funnel_check(out, ref, res)
    for name in ("integral_image", "haar_stage", "quant_nn"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"the trained funnel never launched {name}")

    # 7: the golden detector on two frames with detections
    idx = [int(i) for i in np.where(ref.outputs["n_windows"] > 0)[0][:2]]
    with serve_kernels_as(None, "held") as held:
        golden_check(casc, frames_np, idx, ref.scan, device)
    seen = held.get("integral_image", [])
    print(f"detect_faces and the fused detector: {len(seen)} integral_image "
          f"launches at {sorted({s[1:] for s in seen})}, each == plain bit "
          "for bit", flush=True)

    # 8: the times
    print(f"training on {card}: harvest_hard_negatives {harvest_ms:.1f} ms, "
          f"train_cascade {cascade_ms:.1f} ms, train_face_nn({TRAIN_STEPS} "
          f"steps) {nn_ms:.1f} ms from JAX's draws, {seeded_ms:.1f} ms "
          "seeded (host clock)", flush=True)
    return row


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
    versions alone, in the kernels' place.  ``qnn`` may be None where no
    ``quant_nn`` launch follows."""
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
    """The port against one JAX record (``assets/lm_reference.npz``, or
    ``lm_encdec_reference.npz``'s serving record, prompts served from the
    encoder output of its frames): prefill logits and each teacher-forced
    decode step within
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
    enc_out = None
    if rec.frames is not None:          # an encoder-decoder's record
        with torch.no_grad():
            enc_out = model.encode(torch.as_tensor(rec.frames, device=dev))
    logits, cache = model.prefill(prompts, enc_out)
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
    greedy = generate(model, prompts, rec.greedy.shape[1],
                      enc_out=enc_out).cpu().numpy()
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


def unstacked_init_(model, seed: int):
    """Draw every stacked normal leaf of ``model`` again, each layer's
    slice as the reference draws an unstacked layer: with the fan-in of
    the slice's own leading axis (d_model for a projection), where the
    stacked init takes it from the number of layers."""
    import torch

    from repro_torch.models.layers import fill_
    from repro_torch.models.transformer import STACKED

    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for path, spec, tensors in model._leaves():
            if path[0] in STACKED and spec.init == "normal":
                one = dataclasses.replace(spec, shape=spec.shape[1:])
                for t in tensors:
                    fill_(t, one, gen)


def parity_reading(cfg, device, unstacked=False):
    """The full forward (kernel) against prefill (kernel) + PARITY_EXTRA
    decode steps (plain) on PARITY_B x PARITY_S tokens (an encoder-decoder
    served from the encoder output of drawn frames): (each step's max
    |diff| relative to the largest |logit|, that largest, E: the logits'
    move when every weight moves by one ulp)."""
    import torch

    from repro_torch.launch.serve import build_model, make_frames

    model = build_model(cfg, device, seed=0)
    if unstacked:
        unstacked_init_(model, seed=0)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (PARITY_B, PARITY_S + PARITY_EXTRA)), device=device)
    frames = (make_frames(cfg, PARITY_B, seed=3, device=device)
              if cfg.is_encdec else None)

    def forward():
        with torch.no_grad():
            enc = None if frames is None else model.encode(frames)
            return model.logits(toks, enc), enc

    full, enc = forward()
    logits, cache = model.prefill(toks[:, :PARITY_S], enc)
    errs = [float((logits - full[:, PARITY_S - 1]).abs().max())]
    cache = model.pad_cache(cache, PARITY_EXTRA)
    for t in range(PARITY_S, PARITY_S + PARITY_EXTRA):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    del cache, enc
    top = float(full.abs().max())
    finite = bool(torch.isfinite(full).all())
    gen = torch.Generator(device=device).manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():
            up = torch.rand(p.shape, generator=gen, device=device) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
    sens = float((forward()[0] - full).abs().max()) / top
    return [e / top for e in errs] if finite else None, top, sens


def lm_parity_phase(arch, device):
    """Full width, PARITY_LAYERS deep, float32: the full forward (kernel)
    against prefill (kernel) + decode steps (plain), within PARITY_REL of
    the largest |logit|, E printed beside it (``parity_reading``).  An
    encoder-decoder (whisper) runs PARITY_LAYERS of each stack and is held
    on weights drawn as unstacked layers (``unstacked_init_``): with the
    reference's stacked init (fan-in 4) its random decoder is chaotic, its
    attention over 1500 frames one-hot, and a one-ulp move of the
    decoder's weights alone moves its logits by 15-30% (measured on one
    H100), so no float32 decode that rounds apart from the forward can stay
    within 7e-4; that reading is printed beside it."""
    import torch

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32)
    depth = f"{PARITY_LAYERS} layers"
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, enc_layers=PARITY_LAYERS)
        depth = f"{PARITY_LAYERS} + {PARITY_LAYERS} layers, {cfg.enc_seq} frames"
        steps, top, sens = parity_reading(cfg, device)
        print(f"{arch} float32, {depth}, the reference's stacked init "
              f"(not held): prefill/decode vs forward per step "
              f"{[f'{e:.3g}' for e in steps]} of max |logit| {top:.4g}; "
              f"one-ulp sensitivity E {sens:.3g}", flush=True)
        free_card()
    steps, top, sens = parity_reading(cfg, device, unstacked=cfg.is_encdec)
    rel = max(steps) if steps is not None else float("inf")
    earlier = EARLIER_PARITY.get(arch)
    init = ", weights drawn as unstacked layers" if cfg.is_encdec else ""
    print(f"{arch} float32, {depth}{init}, B={PARITY_B}, "
          f"S={PARITY_S} + {PARITY_EXTRA}: prefill/decode vs forward "
          f"rel {rel:.3g} of max |logit| {top:.4g} (per step "
          f"{[f'{e:.3g}' for e in steps or []]}); bound {PARITY_REL:g}; "
          f"one-ulp sensitivity E {sens:.3g}"
          + ("" if earlier is None else f"; earlier reading {earlier:.3g}"),
          flush=True)
    if rel >= PARITY_REL:
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
# and of csrc/flash_attention_bwd.cu
FLASH_BWD_KERNEL = {"bfloat16": "tensor_core (wgmma + TMA)",
                    "float32": "tf32x3 (3xTF32 mma.sync, cp.async ring)"}


def flash_row(probes, q, k, v, launches, atol, rtol, window=None,
              label="", f32=False, o_rel=None):
    """``flash_attention`` against its plain streaming form on (q, k, v)
    in the model's layout (bf16, within atol + rtol |plain|, or with
    ``o_rel`` within o_rel of max |plain|, the count outside the
    elementwise bound printed), timed beside
    ``scaled_dot_product_attention`` (with a window, through a dense
    boolean mask on the efficient backend; with a value width apart
    from the query-key width, MLA's, on the first backend of flash, cuDNN
    and efficient that takes it, its name printed).  With ``f32`` the
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
    KV, dv = k.shape[2], v.shape[3]
    scale = d ** -0.5
    pos = torch.arange(s, device=q.device)
    # S = q k^T and P V: 2 (d + dv) operations a causal (query, key) pair
    n_ops = 2 * b * H * (d + dv) * _causal_pairs(s, window)
    # the plain form's key chunk: its float32 logits (b, H, s, chunk) and
    # their exponentials within 4 GiB each (8 x 48 x 8192 at 7m: 256)
    chunk = 1024
    while b * H * s * chunk * 4 > 2 ** 32:
        chunk //= 2

    def one(q, k, v, atol, rtol, backend, peak_ops, launches):
        dtype = str(q.dtype).split(".")[-1]

        def plain():
            return mha_streaming(q, expand_kv(k, H), expand_kv(v, H), pos,
                                 pos, scale, window=window, chunk=chunk)

        got = fcuda.flash_attention_cuda(q, k, v, window=window, scale=scale)
        want = plain()
        err = max_abs_err(got, want)
        rms = float(want.double().square().mean().sqrt())
        n_bad = int(((got.double() - want.double()).abs()
                     > atol + rtol * want.double().abs()).sum())
        top = float(want.abs().max())
        print(f"flash_attention {label} {dtype}, kernel {FLASH_KERNEL[dtype]}"
              f": max |err| {err:g} (max |plain| {top:g}, rms {rms:.4g}); "
              f"{n_bad} of {want.numel()} values outside {atol:g} + {rtol:g}"
              f" |plain|" + ("" if o_rel is None else
                              f"; {err / top:.3g} of max |plain| (bound "
                              f"{o_rel:g})"), flush=True)
        if (n_bad if o_rel is None else err > o_rel * top):
            raise AssertionError(f"flash_attention {label} {dtype}: {n_bad} "
                                 "values outside the bound")
        del got
        plain_ms = device_ms(plain, reps=2, warm=1)
        lib_ms = None
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            mask, backend_used = None, backend
            if dv != d and backend == SDPBackend.FLASH_ATTENTION:
                # the first backend that takes a value width of its own
                for cand in (SDPBackend.FLASH_ATTENTION,
                             SDPBackend.CUDNN_ATTENTION,
                             SDPBackend.EFFICIENT_ATTENTION):
                    try:
                        with sdpa_kernel(cand):
                            F.scaled_dot_product_attention(
                                qt[:1, :, :128], kt[:1, :, :128],
                                vt[:1, :, :128], is_causal=True)
                        backend_used = cand
                        break
                    except RuntimeError as e:
                        print(f"SDPA {cand.name} backend refuses d {d}, "
                              f"dv {dv}: {str(e).splitlines()[0][:120]}",
                              flush=True)
        else:                    # SDPA's window: a dense boolean mask
            i = torch.arange(s, device=q.device)
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            backend_used = SDPBackend.EFFICIENT_ATTENTION
            # and the kv heads repeated, as row 7h gives that backend
            kt, vt = (expand_kv(t, H).transpose(1, 2) for t in (k, v))

        def library():
            with sdpa_kernel(backend_used):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=kt.shape[1] != H)

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
        n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                      + b * s * H * dv)
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


def serve_call(arch, device):
    """The serve call of ``lm_serve_phase`` on a model built anew from the
    same seeds, for the profile phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.serve.engine import generate

    cfg = get_config(arch)
    model = build_model(cfg, device, seed=0)
    prompts = make_prompts(cfg, LM_REQUESTS, LM_PROMPT, seed=1, device=device)
    return lambda: generate(model, prompts, LM_GEN)


def free_card():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_phase(probes, device="cuda"):
    """The LM serving slice: each model at full width, the kernel rows on
    its own inputs, the float32 consistency check and the JAX record.
    Returns the kernel rows and the profile targets (one serve call per
    model)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import KERNEL_SHAPES

    rows, targets = [], []
    for arch in LM_KERNEL:
        model, prompts, launches, serve_ms, args = lm_serve_phase(arch,
                                                                   device)
        del model, prompts
        targets.append((f"{arch} serve call",
                        Deferred(lambda a=arch: serve_call(a, device)),
                        serve_ms))
        if arch == "yi-9b":
            q, k, v = args
            rows += flash_row(probes, q, k, v, launches, FLASH_TOL,
                              FLASH_TOL, label="x".join(map(str, q.shape)))
        else:
            rows.append(wkv_row(probes, args, launches))
        del args
        free_card()
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


# -- LM training -----------------------------------------------------------------

TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH = 8, 2048, 8
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 12, 4, 9
TRAIN_LR = 3e-3                 # launch/train.py's --lr
# launches per training step, predicted: each layer's forward kernel once
# in the forward and once more where torch.utils.checkpoint recomputes the
# layer in the backward; the backward kernel once per layer.  mixtral's
# run is 1 of 56 layers deep (MIXTRAL_TRAIN_LAYERS, below), deepseek's 1 of
# 60 (DEEPSEEK_TRAIN_LAYERS: the dense MLA prefix layer, which runs without
# remat, as the reference's unscanned prefix: its forward kernel once a
# step), jamba's 1 of 32 (JAMBA_TRAIN_LAYERS: layer 0, Mamba with a
# SwiGLU FFN, no attention: no flash launch)
MIXTRAL_TRAIN_LAYERS = DEEPSEEK_TRAIN_LAYERS = JAMBA_TRAIN_LAYERS = 1
TRAIN_LAUNCHES = {"yi-9b": {"flash_attention": 2 * TRAIN_LAYERS,
                            "flash_attention_bwd": TRAIN_LAYERS},
                  "rwkv6-7b": {"rwkv_wkv": 2 * TRAIN_LAYERS,
                               "rwkv_wkv_bwd": TRAIN_LAYERS},
                  "mixtral-8x22b": {
                      "flash_attention": 2 * MIXTRAL_TRAIN_LAYERS,
                      "flash_attention_bwd": MIXTRAL_TRAIN_LAYERS},
                  "deepseek-v2-236b": {
                      "flash_attention": DEEPSEEK_TRAIN_LAYERS,
                      "flash_attention_bwd": DEEPSEEK_TRAIN_LAYERS},
                  "jamba-v0.1-52b": {"flash_attention": 0,
                                     "flash_attention_bwd": 0}}
# the LM training phase's runs (mixtral's runs in its own phase)
LM_TRAIN_ARCHS = ("yi-9b", "rwkv6-7b")
REPLAY_RTOL, REPLAY_ATOL = 1e-5, 1e-6   # tests/test_train.py:136-138
# The flash backward against its plain version, the plain one given the
# plain forward's O and log-sum-exp.  bf16: each output within the
# forward's elementwise bound (FLASH_TOL) and within FLASH_BWD_BF16_REL of
# its max |plain|: the kernel rounds its float32 sums to bf16 once, at most
# half a spacing, 2^-8 of max |plain|, and the bound is twice that
# (readings 2.1e-3 to 2.8e-3), so that zeros or a flipped sign fail at any
# output size.  float32: within FLASH_BWD_F32_TOL of max |plain| per
# output.  The forward kernel's O is held to the plain forward's within
# FLASH_O_REL of max |plain| in bf16 (one spacing of the top binade: both
# round; reading 4.3e-3) and FLASH_BWD_F32_TOL in float32 (readings
# 2e-7); each row's log-sum-exp within FLASH_LSE_REL of the largest
# |logit| the row could hold (readings 2.8e-7 in bf16, whose tensor-core
# sums err with their terms' size, at most 9e-8 in float32)
FLASH_BWD_BF16_REL = FLASH_O_REL = 2.0 ** -7
FLASH_BWD_F32_TOL = 1e-4
FLASH_LSE_REL = 2e-6
FLASH_BWD_S, FLASH_BWD_B, FLASH_BWD_WINDOW = 4000, 2, 1024
# the kernels' D = 64 instantiations (bf16 and float32), which no model
# of the path runs, on drawn inputs (b, s, H, KV, d) ragged against the
# tiles, causal and with a window of FLASH_BWD_D64_WINDOW
FLASH_BWD_D64, FLASH_BWD_D64_WINDOW = (2, 1000, 8, 2, 64), 100
# rows 7g and 7h of the first-draft backward (the bf16 one before its
# redesign, the float32 one before its own), as recorded (CUDA events on an
# NVIDIA H100 80GB HBM3 at 700 W; not measured by this script): printed
# beside this run's times, never in the kernels line
FLASH_BWD_PARENT_MS = {"7g": 33.9454, "7h": 33.6306}
# row 8b of the parent commit, the first-draft WKV backward (one block of
# 256 threads a head, CUDA cores), as recorded (CUDA events at the rwkv6-7b
# training shape on an NVIDIA H100 80GB HBM3 at 700 W; not measured by this
# script): printed beside this run's time, never in the kernels line
WKV_BWD_PARENT_MS = 11.9546
# the drawn backward cases (B, T, H): ragged against the chunk of 16, a T
# shorter than a chunk, one batch row
WKV_BWD_T = 650
WKV_BWD_DRAWN = ((8, WKV_BWD_T, 64), (2, 11, 8), (1, 200, 16))


def train_flops(cfg, model, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of ``batch`` x ``seq`` tokens: 6 per
    parameter and token it applies to, plus attention's two products (2 s
    t d for the logits, d the query-key width, and 2 s t dv for P V, dv the
    value width: d_head each, MLA's qk_nope + qk_rope and v_dim) three
    times over (forward, and twice in the backward), in each decoder layer
    whose mixer is attention (``layer_kinds``: not RWKV's or Mamba's).  A
    decoder applies its active parameters (``Model.n_active_params``, the
    reference's count: a MoE layer's routed experts count top_k of
    n_experts) to every token and attends causally (half the pairs).  An encoder-decoder's encoder applies its own, and
    each decoder layer its cross keys' and values' projections, to the
    enc_seq frames of every row; its encoder attends to all frame pairs
    and each decoder layer's cross-attention to all token-frame pairs."""
    from repro_torch.models.transformer import layer_kinds

    tokens, frames = batch * seq, batch * cfg.enc_seq
    d, dv = ((cfg.mla.qk_nope + cfg.mla.qk_rope, cfg.mla.v_dim)
             if cfg.attn_type == "mla" else (cfg.d_head, cfg.d_head))
    per_pair = 3 * 2 * batch * cfg.n_heads * (d + dv)
    on_frames = 0
    if cfg.is_encdec:
        on_frames = sum(p.numel() for layer in model.enc_layers
                        for p in layer.parameters())
        on_frames += sum(p.numel() for p in model.enc_final_norm.values())
        on_frames += sum(layer.cross[w].numel() for layer in model.layers
                         for w in ("wk", "wv"))
    flops = (6.0 * (model.n_active_params() - on_frames) * tokens
             + 6.0 * on_frames * frames)
    attn_layers = sum(kind[0] == "attn" for kind in layer_kinds(cfg))
    flops += per_pair * _causal_pairs(seq) * attn_layers
    if cfg.is_encdec:
        flops += per_pair * cfg.enc_seq ** 2 * cfg.enc_layers
        flops += per_pair * seq * cfg.enc_seq * cfg.n_layers
    return flops


FLOPS_RULE = {False: "6 N per token, N the active parameters (a MoE "
                     "layer's routed experts at top_k of n_experts) + "
                     "causal attention",
              True: "6 N per token or frame + causal, encoder and cross "
                    "attention"}


class MemoryCheckpoints:
    """``train``'s checkpoint store in host memory, for the full-width runs:
    each save keeps every leaf as the host array ``ckpt.checkpoint`` would
    write (bf16 as its raw values) under the leaf's name, with ``extra``.
    It holds one checkpoint at a time: a save drops the older one before
    it copies the new one, into the older one's arrays where a leaf's
    shape and type are the same (host pages already mapped: a copy from
    the card at its link's rate).  A checkpoint there is 10.6-40.7 GB
    (whisper to mixtral's one layer), and a call on the card's machine
    may write 45 GiB to its disk in all and holds 96 GiB of host memory;
    the package's on-disk store runs in ``lm_train_disk_run`` at the JAX
    record's config."""

    def __init__(self):
        self._saved = {}

    def save(self, step, tree, extra=None):
        from repro_torch.ckpt import checkpoint as ck

        old = {}
        for leaves, _extra in self._saved.values():
            old.update(leaves)
        self._saved.clear()
        leaves = {}
        for path, leaf in ck._flatten(tree):
            name = ck._name(path)
            leaves[name] = _host_copy(leaf, old.pop(name, None))
        del old
        self._saved[step] = (leaves, dict(extra or {}))

    def latest_step(self):
        return max(self._saved, default=None)

    def restore(self, step, like_tree):
        from repro_torch.ckpt import checkpoint as ck

        leaves, extra = self._saved[step]
        out = []
        for path, like in ck._flatten(like_tree):
            arr = leaves[ck._name(path)]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"shape drift for {ck._name(path)}: saved "
                                 f"{arr.shape} vs {tuple(like.shape)}")
            out.append(ck._restore_leaf(arr, like))
        return ck._unflatten(like_tree, iter(out)), dict(extra)

    def prune(self, keep):
        for step in sorted(self._saved)[:-keep]:
            del self._saved[step]


def _host_copy(leaf, dst=None):
    """A checkpoint tree's leaf as ``ckpt.checkpoint.host_array`` gives it,
    a ``bridge.StackedLeaf``'s tensors copied from the card straight into
    their slices of ``dst`` where its shape and type fit (else into a new
    array)."""
    import torch

    from repro_torch.bridge import StackedLeaf
    from repro_torch.ckpt import checkpoint as ck

    if not isinstance(leaf, StackedLeaf):
        arr = ck.host_array(leaf)   # a copy unless it views a CPU tensor
        return np.array(arr, copy=not arr.flags.owndata)
    raw = leaf.tensors[0].dtype == torch.bfloat16
    dtype = (ck.BF16_RAW if raw else
             torch.empty(0, dtype=leaf.tensors[0].dtype).numpy().dtype)
    if dst is None or dst.shape != leaf.shape or dst.dtype != dtype:
        dst = np.empty(leaf.shape, dtype)
    host = torch.from_numpy(dst.view(np.int16) if raw else dst)
    for t, h in zip(leaf.tensors, host if leaf.stacked else host[None]):
        h.copy_(t.detach().view(torch.int16) if raw else t.detach())
    return dst


class _LastCall:
    """While ``on`` is true, keeps (clones of) the arguments of the latest
    call of ``module.name``: in a backward pass that is layer 0's.
    ``take`` makes what is kept from the call's arguments (clones of each
    when None)."""

    def __init__(self, module, name, take=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.take = take or (lambda *args: tuple(a.clone() for a in args))
        self.args, self.on = None, False

    def __enter__(self):
        def spy(*args, **kw):
            if self.on:
                self.args = self.take(*args)
            return self.fn(*args, **kw)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class _ForwardDrops:
    """The assignments each MoE dispatch drops in the forward of
    ``model.loss``, counted once a forward: a spy on
    ``models.moe.sort_dispatch`` that counts only while ``model.loss``
    runs, so not in the backward, where ``torch.utils.checkpoint``
    recomputes each layer under remat and dispatches again.  ``groups()``
    gives one list a ``loss`` call (a step, or a microbatch), one count a
    MoE layer in call order; the counts stay on the card until read."""

    def __init__(self, model):
        from repro_torch.models import moe

        self.module, self.fn, self.model = moe, moe.sort_dispatch, model
        self.log, self.on = [], False

    def __enter__(self):
        def spy(*args):
            out = self.fn(*args)
            if self.on:
                self.log[-1].append((~out[2]).sum())
            return out

        loss = self.model.loss

        def counted_loss(batch):
            self.log.append([])
            self.on = True
            try:
                return loss(batch)
            finally:
                self.on = False
        self.module.sort_dispatch = spy
        self.model.loss = counted_loss
        return self

    def __exit__(self, *exc):
        self.module.sort_dispatch = self.fn
        del self.model.loss

    def groups(self):
        return [[int(n) for n in group] for group in self.log]


def train_size(**size) -> dict:
    """A training run's size: TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH,
    TRAIN_STEPS, TRAIN_CKPT_EVERY and TRAIN_FAIL_AT as they stand at the
    call, with ``size``'s entries in their place (``layers`` None: the
    config's full depth)."""
    return {"layers": TRAIN_LAYERS, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
            "steps": TRAIN_STEPS, "ckpt_every": TRAIN_CKPT_EVERY,
            "fail_at": TRAIN_FAIL_AT, **size}


def lm_train_run(arch, device, want=None, capture=None, **size):
    """``train.loop.train`` on ``arch`` at full width, ``layers`` deep (sizes
    from ``train_size(**size)``; None: the config's full depth), in bf16
    with a float32 master: ``steps``
    steps of ``batch`` x ``seq`` tokens (an encoder-decoder's batches with
    their ``batch`` x enc_seq frames), checkpoints every ``ckpt_every`` held
    in host memory, one at a time (``MemoryCheckpoints``: a checkpoint is
    27 GB for yi, 32 GB for rwkv, 10.6 GB for whisper and 40.7 GB for
    mixtral's one layer, and the card's machine lets a run write 45 GiB to
    its disk in all), a failure injected once at step
    ``fail_at``, after which the loop restores the checkpoint of step
    ``fail_at`` - 1 and replays.  Holds every loss and grad norm finite,
    the replayed step to the first (bits, else REPLAY_RTOL / REPLAY_ATOL),
    every weight leaf's step-0 gradient finite and nonzero, and each
    step's kernel launches to ``want`` (TRAIN_LAUNCHES[arch] when None).
    Returns (readings, layer 0's backward-kernel inputs at step 1, or
    what ``capture``, a (module, name, take) of ``_LastCall``, keeps of
    the latest call at step 1: None where no such call ran); the
    readings hold the launches of each step, the optimizer's share of
    the step (``adamw_update`` between CUDA events, no synchronisation
    added), the card's and the host's peak memory, and for a MoE model
    each step's aux loss and the assignments each MoE layer drops in the
    step's forward (``_ForwardDrops``: the recompute under remat is not
    counted)."""
    import resource

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv_scan import ops as wkv_ops
    from repro_torch.launch.train import batches, opt_config
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as step_mod
    from repro_torch.train.loop import LoopConfig, train

    t_phase = time.perf_counter()
    size = train_size(**size)
    layers, seq, batch, steps, ckpt_every, fail_at = (size[k] for k in (
        "layers", "seq", "batch", "steps", "ckpt_every", "fail_at"))
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, device)
    n_params = model.n_params()
    make = batches(DataConfig(vocab=cfg.vocab, seq=seq, global_batch=batch,
                              seed=0), model.device, cfg)
    want = TRAIN_LAUNCHES[arch] if want is None else want
    capture = capture or ((wkv_ops, "rwkv_wkv_bwd_cuda", None)
                          if cfg.mixer == "rwkv" else
                          (flash_ops, "flash_attention_bwd_cuda", None))
    per_step, state, grads_seen = [], {"step": None}, {}

    def make_batch(step):
        if state["step"] is not None:     # the launches of the step just run
            per_step.append((state["step"], dict(_build.launches)))
        _build.reset_launches()
        state["step"] = step
        cap.on = step == 1 and cap.args is None
        return make(step)

    failed = {"done": False}

    def fail_hook(step):
        if step == fail_at and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("injected node failure")

    grads_of, adamw = step_mod.grads_of, step_mod.adamw_update
    adam_events, aux = [], []

    def timed_adamw(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = adamw(*a, **kw)
        end.record()
        adam_events.append((start, end))
        return out

    def checked_grads(m, batch):
        loss, metrics, grads = grads_of(m, batch)
        aux.append(metrics["aux"])
        if not grads_seen:
            grads_seen.update(
                n_leaves=len(grads),
                bad=[n for n, g in grads.items()
                     if not (bool(torch.isfinite(g).all())
                             and float(g.abs().max()) > 0)])
        return loss, metrics, grads

    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_mod.grads_of, step_mod.adamw_update = checked_grads, timed_adamw
    store = MemoryCheckpoints()
    # deepseek's one layer is its dense prefix: a MoE config with no MoE
    # layer, no drops to count and an aux loss of 0
    has_moe = any(kind[1] == "moe" for kind in model.kinds)
    drops = (_ForwardDrops(model) if has_moe
             else contextlib.nullcontext())
    try:
        with _LastCall(*capture) as cap, drops:
            t0 = time.perf_counter()
            _m, _state, out = train(
                model, make_batch,
                LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                           keep=1),
                opt_config(TRAIN_LR, steps), seed=0,
                fail_hook=fail_hook, verbose=False, store=store)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
    finally:
        step_mod.grads_of, step_mod.adamw_update = grads_of, adamw
    del store
    per_step.append((state["step"], dict(_build.launches)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # this process's peak resident host memory (KiB on Linux)
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    hist = out["history"]
    ran = [h["step"] for h in hist]
    expect = list(range(fail_at)) + list(range(fail_at - 1, steps))
    if not failed["done"] or ran != expect:
        raise AssertionError(f"{arch}: steps run {ran}, expected {expect}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist):
        raise AssertionError(f"{arch}: non-finite loss or grad norm: {hist}")
    first, again = hist[fail_at - 1], hist[fail_at]
    same = (first["loss"] == again["loss"]
            and first["grad_norm"] == again["grad_norm"])
    if not same and not all(
            abs(first[k] - again[k]) <= REPLAY_ATOL + REPLAY_RTOL * abs(first[k])
            for k in ("loss", "grad_norm")):
        raise AssertionError(f"{arch}: the replayed step {fail_at - 1} "
                             f"differs: {first} != {again}")
    if grads_seen.get("bad") or grads_seen.get("n_leaves") != len(
            list(model.parameters())):
        raise AssertionError(f"{arch}: step-0 gradients not finite and "
                             f"nonzero in every leaf: {grads_seen}")
    bad = [(s, c) for s, c in per_step
           if {k: c.get(k, 0) for k in want} != want
           or set(c) - set(want)]
    if bad or len(per_step) != len(hist):
        raise AssertionError(f"{arch}: launches per step {per_step}, "
                             f"predicted {want}")
    ms = 1e3 * statistics.median(h["dt"] for h in hist[1:])
    adam_ms = statistics.median(a.elapsed_time(b) for a, b in adam_events[1:])
    tokens = batch * seq
    flops = train_flops(cfg, model, batch, seq)
    readings = {"arch": arch, "layers": cfg.n_layers, "params": n_params,
                "step_ms": ms, "tokens_s": tokens / (ms / 1e3),
                "model_flops": flops,
                "mfu": flops / (ms / 1e3) / PEAK_BF16_OPS_S,
                "adamw_ms": adam_ms, "launches": per_step[0][1],
                "peak_gib": peak, "resident_gib": resident,
                "host_peak_gib": host_peak, "loop_s": loop_s,
                "losses": [h["loss"] for h in hist],
                "grad_norms": [h["grad_norm"] for h in hist],
                "replay_bit_equal": same,
                "aux": [float(a) for a in aux]}
    if has_moe:
        readings["drops"] = drops.groups()
        if len(readings["drops"]) != len(hist):
            raise AssertionError(f"{arch}: {len(readings['drops'])} "
                                 f"forwards counted, {len(hist)} steps run")
    depth = (f"{cfg.enc_layers} + {cfg.n_layers} layers" if cfg.is_encdec
             else f"{cfg.n_layers} layer" + "s" * (cfg.n_layers > 1))
    frames = (f" and {batch} x {cfg.enc_seq} frames" if cfg.is_encdec
              else "")
    print(f"{arch} training, {depth} at full width "
          f"({n_params / 1e9:.3f} B parameters, bf16 with a float32 master), "
          f"{batch} x {seq} tokens{frames} a step: losses "
          f"{[round(h['loss'], 4) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}", flush=True)
    print(f"{arch} training: step {ms:.3f} ms (host clock, synchronised, "
          f"median of the {len(hist) - 1} steps after the first), "
          f"{readings['tokens_s']:.1f} tokens/s, model FLOPs {flops:.4g} a "
          f"step ({FLOPS_RULE[cfg.is_encdec]}) = "
          f"{100 * readings['mfu']:.2f}% of 989 TFLOP/s; peak "
          f"{peak:.2f} GiB ({resident:.2f} GiB of earlier phases resident "
          f"before the run); host peak RSS {host_peak:.2f} GiB (the "
          f"process so far); loop {loop_s:.1f} s with {len(hist)} steps, "
          f"checkpoints and the restore", flush=True)
    if has_moe:
        print(f"{arch} training: per step run (steps {ran}), the "
              f"assignments each MoE layer drops in the forward "
              f"{readings['drops']} of {batch * seq * cfg.moe.top_k} a "
              f"layer, aux loss {readings['aux']}", flush=True)
    print(f"{arch} training: adamw_update {adam_ms:.3f} ms a step (CUDA "
          f"events around it, median of {len(adam_events) - 1} steps), "
          f"{100 * adam_ms / ms:.1f}% of the step", flush=True)
    print(f"{arch} training: step {fail_at} failed once (injected), "
          f"step {fail_at - 1} replayed from its checkpoint: loss "
          f"{again['loss']!r} vs {first['loss']!r}, grad norm "
          f"{again['grad_norm']!r} vs {first['grad_norm']!r} "
          f"({'bit-equal' if same else 'within the reference rtol/atol'}); "
          f"step-0 gradients finite and nonzero in all "
          f"{grads_seen['n_leaves']} leaves; launches per step "
          f"{per_step[0][1]} at every one of {len(per_step)} steps "
          f"(predicted {want}); phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del model, _m, _state
    return readings, cap.args


def _bwd_module(name):
    """SOURCE and REPLACES of a backward kernel's row: its own source, the
    TPU kernel whose forward it differentiates."""
    from types import SimpleNamespace

    from repro_torch.kernels.flash_attention import cuda as fcuda
    from repro_torch.kernels.rwkv_scan import cuda as wcuda

    mod = fcuda if name == "flash_attention_bwd" else wcuda
    return SimpleNamespace(SOURCE=mod.BWD_SOURCE, REPLACES=mod.REPLACES)


def flash_plain_forward(q, k, v, o, lse, label, window=None):
    """The forward kernel's O and log-sum-exp on ``q, k, v`` against
    ``mha_streaming``'s (kv heads expanded, float32 arithmetic, O in v's
    dtype): O within FLASH_O_REL (bf16) or FLASH_BWD_F32_TOL (float32) of
    its max |plain|; each row's lse within FLASH_LSE_REL of the largest
    |logit| the row could hold, scale |q_i| max_j |k_j| (a float32 sum's
    error grows with its terms, not with its value).  Returns the plain (O,
    lse), which the plain backward takes."""
    import torch

    from repro_torch.kernels.flash_attention.ops import expand_kv
    from repro_torch.kernels.flash_attention.ref import mha_streaming

    H, KV = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1], device=q.device)
    o_ref, lse_ref = mha_streaming(q, expand_kv(k, H), expand_kv(v, H), pos,
                                   pos, scale, window=window, return_lse=True)
    rel = FLASH_O_REL if q.dtype == torch.bfloat16 else FLASH_BWD_F32_TOL
    o_err, o_top = max_abs_err(o, o_ref), float(o_ref.abs().max())
    q_norm = q.float().norm(dim=-1).transpose(1, 2)               # (b, H, s)
    k_norm = k.float().norm(dim=-1).amax(dim=1).repeat_interleave(
        H // KV, dim=1)                                           # (b, H)
    size = scale * q_norm * k_norm[..., None]
    lse_rel = float(((lse.double() - lse_ref.double()).abs()
                     / size.double().clamp_min(1e-30)).max())
    print(f"flash_attention {label}: O {o_err:.3g} from the plain forward "
          f"(max |plain| {o_top:.4g}, {o_err / o_top:.3g} of it, bound "
          f"{rel:g}); lse {max_abs_err(lse, lse_ref):.3g} (max |plain| "
          f"{float(lse_ref.abs().max()):.4g}), {lse_rel:.3g} of its row's "
          f"scale |q_i| max |k_j| / sqrt(d) (bound {FLASH_LSE_REL:g})",
          flush=True)
    if (lse.shape != lse_ref.shape or not o_err <= rel * o_top
            or not lse_rel <= FLASH_LSE_REL):
        raise AssertionError(f"flash_attention {label}: the forward kernel's "
                             f"O or log-sum-exp differs from the plain one")
    return o_ref, lse_ref


def flash_bwd_check(q, k, v, o, dout, lse, label, window=None, f32_tol=None):
    """The flash backward kernel, given the forward kernel's ``o`` and
    ``lse``, against ``flash_attention_bwd_ref`` given the plain forward's
    (``flash_plain_forward``, which first holds the two forwards together),
    both computing in float32 from the same q, k, v, dout: bf16 outputs
    within FLASH_TOL + FLASH_TOL |plain| (the count outside it printed)
    and within FLASH_BWD_BF16_REL of each output's max |plain|, float32
    within ``f32_tol`` of it.  Returns (max |err|, plain function)."""
    from repro_torch.kernels.flash_attention import cuda as fcuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    scale = q.shape[-1] ** -0.5
    o_ref, lse_ref = flash_plain_forward(q, k, v, o, lse, label, window=window)
    # the plain backward's query chunk: its float32 (b, H, chunk, t)
    # logits, P, dP and dS within 4 GiB each (deepseek's 8 x 128 heads of
    # 2,048 keys: 512)
    chunk = 1024
    while q.shape[0] * q.shape[2] * chunk * k.shape[1] * 4 > 2 ** 32:
        chunk //= 2

    def plain():
        return flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, o_ref, dout)), lse_ref,
            window=window, scale=scale, chunk=chunk)

    got = fcuda.flash_attention_bwd_cuda(q, k, v, o, dout, lse,
                                         window=window, scale=scale)
    want = plain()
    again = fcuda.flash_attention_bwd_cuda(q, k, v, o, dout, lse,
                                           window=window, scale=scale)
    deterministic = all(torch_equal(a, b) for a, b in zip(got, again))
    rel = FLASH_BWD_BF16_REL if f32_tol is None else f32_tol
    errs, bad, worst = [], [], 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = max_abs_err(a, b)
        top = float(b.abs().max())
        worst = max(worst, err)
        ok = err <= rel * top and bool(a.isfinite().all())
        out = ""
        if f32_tol is None:             # the forward's elementwise bound
            n_out = int(((a.double() - b.double()).abs() > FLASH_TOL
                         + FLASH_TOL * b.double().abs()).sum())
            ok = ok and not n_out
            out = f", {n_out} of {b.numel()} outside the elementwise bound"
        errs.append(f"{name} {err:.3g} (max |plain| {top:.4g}, "
                    f"{err / top:.3g} of it{out})")
        if not ok:
            bad.append(name)
    bound = (f"{FLASH_TOL:g} + {FLASH_TOL:g} |plain| and {rel:g} of max "
             "|plain|" if f32_tol is None else f"{rel:g} of max |plain|")
    print(f"flash_attention_bwd {label} {str(q.dtype).split('.')[-1]}: "
          f"max |err| {', '.join(errs)}; bound {bound}; two runs "
          f"bit-equal {deterministic}", flush=True)
    if bad or not deterministic:
        raise AssertionError(f"flash_attention_bwd {label}: {bad} outside "
                             f"the bound, deterministic {deterministic}")
    return worst, plain


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def sdpa_forward(q, k, v, window=None):
    """SDPA's forward on the model's layout, with grad: (backend, a call of
    it, its leaves).  The flash backend in bf16, cuDNN's in bf16 where the
    value width is not the query-key width (MLA's: the flash backend
    refuses it), the efficient one in float32 (the flash backend takes no
    float32, and the efficient one no GQA: its k and v get the query
    heads' count, here); a window as a dense boolean mask."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention.ops import expand_kv

    H, s = q.shape[2], q.shape[1]
    backend = (SDPBackend.EFFICIENT_ATTENTION
               if q.dtype != torch.bfloat16 or window is not None else
               SDPBackend.FLASH_ATTENTION if v.shape[-1] == q.shape[-1] else
               SDPBackend.CUDNN_ATTENTION)
    if backend == SDPBackend.EFFICIENT_ATTENTION:
        k, v = expand_kv(k, H), expand_kv(v, H)
    KV = k.shape[2]
    mask = None
    if window is not None:
        i = torch.arange(s, device=q.device)
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    leaves = tuple(t.transpose(1, 2).detach().requires_grad_(True)
                   for t in (q, k, v))

    def fwd():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, is_causal=mask is None,
                enable_gqa=KV != H)
    return backend, fwd, leaves


def sdpa_backward_ms(q, k, v, dout, window=None):
    """SDPA's backward alone (``sdpa_forward``'s backend), as forward +
    backward less forward (CUDA events).  Returns (ms, a ``Deferred`` that
    builds ``sdpa_backward_only``, for the profile phase to time by device
    and free), or (None, None) where SDPA refuses the inputs."""
    import torch

    backend, fwd, leaves = sdpa_forward(q, k, v, window)
    gt = dout.transpose(1, 2)

    def fwd_bwd():
        fwd().backward(gt)
        for x in leaves:
            x.grad = None

    try:
        with torch.no_grad():
            f_ms = device_ms(fwd, reps=5)
        fb_ms = device_ms(fwd_bwd, reps=5)
    except RuntimeError as e:     # backend rules of SDPA
        print(f"SDPA backward not timed: {e}", flush=True)
        return None, None
    print(f"SDPA ({backend.name} backend) on {tuple(q.shape)} "
          f"{str(q.dtype).split('.')[-1]}: forward + backward {fb_ms:.4f} ms, "
          f"forward {f_ms:.4f} ms (CUDA events)", flush=True)
    return fb_ms - f_ms, Deferred(
        lambda: sdpa_backward_only(q, k, v, dout, window))


def sdpa_backward_only(q, k, v, dout, window=None):
    """A call that runs SDPA's backward alone, on the graph of one forward
    that it keeps (built at this call, freed with the call)."""
    _backend, fwd, leaves = sdpa_forward(q, k, v, window)
    out, gt = fwd(), dout.transpose(1, 2)

    def backward_only():
        out.backward(gt, retain_graph=True)
        for x in leaves:
            x.grad = None
    return backward_only


def flash_bwd_rows(probes, args, launches):
    """Rows 7g (bf16) and 7h (float32) on layer 0's backward-kernel inputs
    at step 1 of the yi-9b training run, then the drawn checks at yi's heads
    with S = FLASH_BWD_S and at FLASH_BWD_D64, causal and windowed, in both
    dtypes; every check first holds the forward kernel's O and log-sum-exp
    to the plain forward's, which the plain backward then takes.  Also: the forward with
    its log-sum-exp gives O bit-equal to the forward without."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as fcuda

    q, k, v, o, dout, lse = args
    H, d, KV = q.shape[2], q.shape[3], k.shape[2]
    o_plain = fcuda.flash_attention_cuda(q, k, v)
    o_lse, lse_again = fcuda.flash_attention_cuda(q, k, v, return_lse=True)
    if not (torch.equal(o_plain, o) and torch.equal(o_lse, o)
            and torch.equal(lse_again, lse)):
        raise AssertionError("the forward with its log-sum-exp is not the "
                             "forward without it, bit for bit")
    print(f"flash_attention {tuple(q.shape)} bf16: O with the log-sum-exp "
          "requested == O without it == the training run's, bit for bit; "
          "lse == the run's", flush=True)
    mod = _bwd_module("flash_attention_bwd")
    rows = []
    # 7h's bound: the same float32-accurate work as 3xTF32 on the tensor
    # cores (three TF32 products for each), the float32 CUDA cores' time for
    # it printed beside
    for label, dtype, tol, times, peak in (
            ("7g", torch.bfloat16, None, 1, PEAK_BF16_OPS_S),
            ("7h", torch.float32, FLASH_BWD_F32_TOL, 3, PEAK_TF32_OPS_S)):
        if dtype == torch.bfloat16:
            x = (q, k, v, o, dout, lse)
        else:
            q32, k32, v32 = (t.float() for t in (q, k, v))
            o32, lse32 = fcuda.flash_attention_cuda(q32, k32, v32,
                                                    return_lse=True)
            x = (q32, k32, v32, o32, dout.float(), lse32)
        shape = "x".join(map(str, q.shape)) + f" {str(dtype).split('.')[-1]}"
        err, plain = flash_bwd_check(*x, f"{label} {shape} (layer 0, step 1)",
                                     f32_tol=tol)
        plain_ms = device_ms(plain, reps=1, warm=0)
        lib_ms, lib_fn = sdpa_backward_ms(x[0], x[1], x[2], x[4])
        n_bytes, n_ops = flash_bwd_bytes_ops(x[0], x[1], x[2], x[5])
        row = kernel_row(
            probes, "flash_attention_bwd", mod,
            launches if dtype == torch.bfloat16 else 0, err,
            lambda x=x: fcuda.flash_attention_bwd_cuda(*x), plain_ms, lib_ms,
            n_bytes, times * n_ops, peak, reps=5, shape=f"{label} {shape}",
            library_fn=lib_fn, kernel=("flash_attention_bwd", 2))
        row["backward_of"] = "row 7"
        row["kernel"] = FLASH_BWD_KERNEL[str(dtype).split(".")[-1]]
        parent = FLASH_BWD_PARENT_MS[label]
        lib = ("not timed" if lib_ms is None else
               f"{lib_ms:.4f} ms, {lib_ms / row['ms']:.2f}x this kernel's")
        print(f"flash_attention_bwd {label} ({row['kernel']}): "
              f"{row['ms']:.4f} ms by CUDA events in this run; SDPA's "
              f"backward in this run {lib}; the first draft, as recorded, "
              f"{parent:.4f} ms ({parent / row['ms']:.2f}x this run's time; "
              "not measured here)", flush=True)
        if dtype == torch.float32:
            print(f"flash_attention_bwd 7h: bound {row['bound_ms']:.4f} ms "
                  "(3xTF32 at 495 TFLOP/s); the float32 CUDA cores' "
                  f"{1e3 * n_ops / PEAK_F32_OPS_S:.4f} ms (67 TFLOP/s)",
                  flush=True)
        rows.append(row)
        del x
    del q, k, v, o, dout, lse
    torch.cuda.empty_cache()
    dev = o_plain.device
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [((FLASH_BWD_B, FLASH_BWD_S, H, KV, d), window, dtype, tol)
             for window in (None, FLASH_BWD_WINDOW)
             for dtype, tol in ((torch.bfloat16, None),
                                (torch.float32, FLASH_BWD_F32_TOL))]
    cases += [(FLASH_BWD_D64, window, dtype, tol)
              for window in (None, FLASH_BWD_D64_WINDOW)
              for dtype, tol in ((torch.bfloat16, None),
                                 (torch.float32, FLASH_BWD_F32_TOL))]
    for (cb, cs, cH, cKV, cd), window, dtype, tol in cases:
        q, k, v = (torch.randn((cb, cs, heads, cd), device=dev,
                               generator=gen).to(dtype)
                   for heads in (cH, cKV, cKV))
        o, lse = fcuda.flash_attention_cuda(q, k, v, window=window,
                                            return_lse=True)
        dout = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
        flash_bwd_check(q, k, v, o, dout, lse,
                        f"drawn {cb}x{cs}x{cH}/{cKV}x{cd}"
                        + (f" window {window}" if window else " causal"),
                        window=window, f32_tol=tol)
        del q, k, v, o, dout, lse
        torch.cuda.empty_cache()
    return rows


def wkv_bwd_plain(r, k, v, w, u, dout, chunked=False):
    """``wkv_bwd_ref`` (or, ``chunked``, ``wkv_bwd_chunked_ref``, the
    kernel's chunked arithmetic) on the model's layout -> (dr, dk, dv, dw,
    du summed over b)."""
    from repro_torch.kernels.rwkv_scan.ref import (
        wkv_bwd_chunked_ref,
        wkv_bwd_ref,
    )

    B, T, H, K = r.shape

    def hf(x):
        return x.transpose(1, 2).reshape(B * H, T, x.shape[-1])

    fn = wkv_bwd_chunked_ref if chunked else wkv_bwd_ref
    out = fn(*(hf(x) for x in (r, k, v, w)),
             u.expand(B, H, K).reshape(B * H, K), hf(dout))
    grads = [x.reshape(B, H, T, x.shape[-1]).transpose(1, 2)
             for x in out[:4]]
    return (*grads, out[4].reshape(B, H, K).sum(0))


def wkv_bwd_check(args, label):
    """The WKV backward kernel against ``wkv_bwd_ref``: every output within
    WKV_REL of its largest plain entry, beside the errors of
    ``wkv_bwd_chunked_ref`` (the kernel's arithmetic in plain PyTorch) on
    the same inputs.  Returns the largest |err|."""
    from repro_torch.kernels.rwkv_scan import cuda as wcuda

    got = wcuda.rwkv_wkv_bwd_cuda(*args)
    want = wkv_bwd_plain(*args)
    emu = wkv_bwd_plain(*args, chunked=True)
    again = wcuda.rwkv_wkv_bwd_cuda(*args)
    deterministic = all(torch_equal(a, b) for a, b in zip(got, again))
    rels, emus, worst = [], [], 0.0
    for name, a, b, e in zip(("dr", "dk", "dv", "dw", "du"), got, want, emu):
        err = max_abs_err(a, b)
        worst = max(worst, err)
        top = float(b.abs().max())
        rel = err / top
        rels.append(f"{name} {rel:.3g}")
        emus.append(f"{max_abs_err(e, b) / top:.3g}")
        if not (rel < WKV_REL and bool(a.isfinite().all())):
            raise AssertionError(f"rwkv_wkv_bwd {label} {name}: relative "
                                 f"error {rel:g}")
    print(f"rwkv_wkv_bwd {tuple(args[0].shape)}, {label}: relative error "
          f"{', '.join(rels)}; bound {WKV_REL}; the chunked emulation's "
          f"{', '.join(emus)}; two runs bit-equal {deterministic}",
          flush=True)
    if not deterministic:
        raise AssertionError("rwkv_wkv_bwd is not deterministic")
    return worst


def wkv_bwd_rows(probes, args, launches):
    """Row 8b on layer 0's backward-kernel inputs at step 1 of the rwkv6-7b
    training run (u as trained one step, so nonzero), then drawn inputs
    (WKV_BWD_DRAWN: T ragged against the chunk of 16, T shorter than a
    chunk, one batch row) with w = 0 in every third step's even channels
    and a seeded nonzero u."""
    import torch

    from repro_torch.kernels.rwkv_scan import cuda as wcuda

    r = args[0]
    B, T, H, K = r.shape
    err = wkv_bwd_check(args, "layer 0 at step 1 of the training run, u "
                        f"max {float(args[4].abs().max()):.3g}")
    plain_ms = device_ms(lambda: wkv_bwd_plain(*args), reps=1, warm=0)
    # the function's traffic: r, k, v, w, dout read, dr, dk, dv, dw written,
    # u read and du written; the chunk states the design stores every
    # BWD_CHUNK steps are its own scratch, printed beside the row
    n_bytes = 4 * 9 * r.numel() + 4 * 2 * args[4].numel()
    scratch = 2 * 4 * B * H * -(-T // wcuda.BWD_CHUNK) * K * K
    print(f"rwkv_wkv_bwd 8b: the parent commit's first draft took "
          f"{WKV_BWD_PARENT_MS} ms by CUDA events at this shape (recorded, "
          "not measured by this run)", flush=True)
    print(f"rwkv_wkv_bwd 8b: the design's chunk-state scratch, written by "
          f"its first pass and read by its second, {scratch / 1e9:.3f} GB = "
          f"{1e3 * scratch / PEAK_BYTES_S:.4f} ms at 3.35 TB/s (not in the "
          f"bound: the function does not need it)", flush=True)
    # the plain reverse recurrence's operations per step and (b, h): the
    # forward state (3 K V), dr, dk, dv and dw (2 K V each), dS (3 K V)
    n_ops = 14 * K * K * T * B * H
    row = kernel_row(probes, "rwkv_wkv_bwd", _bwd_module("rwkv_wkv_bwd"),
                     launches, err, lambda: wcuda.rwkv_wkv_bwd_cuda(*args),
                     plain_ms, None, n_bytes, n_ops, PEAK_F32_OPS_S, reps=5,
                     shape="8b " + "x".join(map(str, r.shape)),
                     kernel=("rwkv_wkv_bwd", 3))
    row["backward_of"] = "row 8"
    dev = r.device
    gen = torch.Generator(device=dev).manual_seed(7)
    for shape in WKV_BWD_DRAWN:
        shape = (*shape, K)

        def draw(std):
            return std * torch.randn(shape, device=dev, generator=gen)

        w = torch.sigmoid(draw(10.0))
        w[:, ::3, :, ::2] = 0.0
        u = WKV_BONUS_STD * torch.randn((shape[2], K), device=dev,
                                        generator=gen)
        wkv_bwd_check((draw(0.5), draw(0.5), draw(0.5), w, u, draw(1.0)),
                      f"drawn, w = 0 in every third step's even channels, "
                      f"u ~ {WKV_BONUS_STD} N(0, 1)")
    return row


def lm_train_record_check(rec, device):
    """The port's train step on one JAX training record
    (``assets/lm_train_reference.npz``, or ``lm_encdec_reference.npz``'s
    training record, on ``encdec_batch_for_step`` batches;
    ``assets/lm_moe_train_reference.npz``): the step-0 gradient of every
    leaf by its norm and its probe g . p, and each step's loss, ce, grad
    norm and, where the record has it, aux loss, within max(RECORD_REL, E)
    of JAX's, E the record's one-ulp sensitivity of that quantity (a probe
    relative to |g| |p|, the rest relative to their size; for a leaf's
    norm and probe one E for all leaves or one a leaf); the learning rate
    within one float32 ulp; where the record has them, the assignments
    each MoE layer drops in each step's forward (``_ForwardDrops``)
    equal to JAX's.  Returns the readings."""
    import torch

    from repro_torch.bridge import (
        lm_params_from,
        lm_train_probe,
        numpy_lm_params,
        to_jax_tree,
    )
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import batches
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    model = lm_params_from(numpy_lm_params(rec.cfg, rec.seed), rec.cfg,
                           device=device)
    batch = batches(DataConfig(**rec.data), model.device, rec.cfg)

    # the steps, the step-0 gradient kept from the first one's
    # ``grads_of`` (the same call on the same weights and batch as a
    # separate one before the steps)
    grads_of, kept = step_mod.grads_of, {}

    def first_grads(m, b):
        out = grads_of(m, b)
        if not kept:
            kept.update((n, g.clone()) for n, g in out[2].items())
        return out

    state = init_opt_state(model.named_leaves())
    step_fn = step_mod.make_train_step(model, AdamWConfig(**rec.opt))
    steps_rel = {"loss": [], "ce": [], "grad_norm": []}
    if rec.aux is not None:
        steps_rel["aux"] = []
    counter = (_ForwardDrops(model) if rec.drops is not None
               else contextlib.nullcontext())
    step_mod.grads_of = first_grads
    try:
        with counter:
            for s in range(rec.steps):
                state, met = step_fn(state, batch(s))
                _record_step_check(rec, s, met, steps_rel)
    finally:
        step_mod.grads_of = grads_of

    e = rec.sensitivity
    e_leaf = {k: np.broadcast_to(np.asarray(e[k], np.float64),
                                 (len(rec.leaf_names),))
              for k in ("g_norm", "g_probe")}
    tree = to_jax_tree(model, kept)
    worst = {"g_norm": 0.0, "g_probe": 0.0}
    excess = {"g_norm": (0.0, ""), "g_probe": (0.0, "")}
    for i, name in enumerate(rec.leaf_names):
        g = tree
        for key in name.split("/"):
            g = g[int(key)] if isinstance(g, list) else g[key]
        g = g.double().cpu().numpy()
        probe = lm_train_probe(g.shape)
        norm = np.sqrt(rec.g_sq[i])
        rel = {"g_norm": abs(np.sqrt(np.sum(g * g)) - norm) / norm,
               "g_probe": abs(np.sum(g * probe) - rec.g_probe[i]) / (
                   norm * np.sqrt(np.sum(probe * probe)))}
        for k, r in rel.items():
            worst[k] = max(worst[k], r)
            over = r / max(RECORD_REL, e_leaf[k][i])
            if over > excess[k][0]:
                excess[k] = (over, name)
    for k, (over, name) in excess.items():
        if over > 1:
            raise AssertionError(f"{rec.cfg.name} record: step-0 gradient "
                                 f"{k} of {name} {over:.3g} times its bound "
                                 "from JAX")
    del kept, tree
    out = {"steps": rec.steps, "grad": worst, "steps_rel": steps_rel,
           "grad_of_bound": {k: v[0] for k, v in excess.items()}}
    if rec.drops is not None:
        out["drops"] = counter.groups()
        if not np.array_equal(out["drops"], rec.drops):
            raise AssertionError(f"{rec.cfg.name} record: drops per step "
                                 f"{out['drops']}, JAX's "
                                 f"{rec.drops.tolist()}")
    return out


def _record_step_check(rec, s, met, rel):
    """Step ``s`` of ``lm_train_record_check``: each quantity of ``rel``
    (appended to it) and the learning rate against the record."""
    e = rec.sensitivity
    for k in rel:
        want = float(rec.__dict__[k][s])
        r = abs(float(met[k]) - want) / abs(want)
        rel[k].append(r)
        if r > max(RECORD_REL, e[k][s]):
            raise AssertionError(f"{rec.cfg.name} record step {s}: {k} "
                                 f"{float(met[k])!r} vs JAX {want!r} "
                                 f"({r:.3g}, bound "
                                 f"{max(RECORD_REL, e[k][s]):.3g})")
    lr, want = np.float32(float(met["lr"])), rec.lr[s]
    if abs(int(lr.view(np.int32)) - int(want.view(np.int32))) > 1:
        raise AssertionError(f"record step {s}: lr {lr!r} vs {want!r}")


def lm_train_record_phase(device, records=None, want=None):
    """The JAX training records (name -> record;
    ``assets/lm_train_reference.npz``'s when None) on the card, through
    the kernels: each launches its forward and backward kernel at least
    once, and exactly ``want[name]`` times where ``want`` predicts it
    (name -> {kernel: launches over the record's steps})."""
    import torch

    from repro_torch.bridge import load_lm_train_reference
    from repro_torch.kernels import _build

    records = load_lm_train_reference() if records is None else records
    for name, rec in records.items():
        _build.reset_launches()
        readings = lm_train_record_check(rec, device)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        fwd = "rwkv_wkv" if rec.cfg.mixer == "rwkv" else "flash_attention"
        if counts.get(fwd, 0) < 1 or counts.get(fwd + "_bwd", 0) < 1:
            raise AssertionError(f"training record {name}: kernels not "
                                 f"launched: {counts}")
        predicted = (want or {}).get(name)
        if predicted is not None and {
                k: counts.get(k, 0) for k in predicted} != predicted:
            raise AssertionError(f"training record {name}: launches "
                                 f"{counts}, predicted {predicted}")
        e = rec.sensitivity
        print(f"JAX training record {name} ({rec.cfg.n_layers} layers, "
              f"{rec.data['global_batch']} x {rec.data['seq']} tokens, "
              f"{rec.steps} steps, float32): step-0 gradient leaf norms "
              f"within {readings['grad']['g_norm']:.3g} (bound "
              f"{max(RECORD_REL, e['g_norm']):.3g}), probes within "
              f"{readings['grad']['g_probe']:.3g} (bound "
              f"{max(RECORD_REL, e['g_probe']):.3g}); per step loss "
              f"{[f'{r:.3g}' for r in readings['steps_rel']['loss']]} (E "
              f"{[f'{x:.3g}' for x in e['loss']]}), grad norm "
              f"{[f'{r:.3g}' for r in readings['steps_rel']['grad_norm']]} "
              f"(E {[f'{x:.3g}' for x in e['grad_norm']]}); lr within an "
              f"ulp; launches {counts}"
              + ("" if predicted is None else f" (predicted {predicted})"),
              flush=True)
        if rec.aux is not None:
            print(f"JAX training record {name}: per step aux "
                  f"{[f'{r:.3g}' for r in readings['steps_rel']['aux']]} (E "
                  f"{[f'{x:.3g}' for x in e['aux']]}); drops per step and "
                  f"MoE layer {readings['drops']}, equal to JAX's",
                  flush=True)


def lm_train_disk_run(device):
    """The loop with its checkpoints on disk, on the card, at the JAX
    training record's yi config (float32, heads of 128: the float32 flash
    kernels and their backward): 8 steps, checkpoints every 4 into a
    temporary directory, a failure injected at step 5 and replayed from
    step 4 (bit-equal), then a second ``train`` that resumes from the last
    checkpoint and runs steps 8 and 9."""
    import tempfile

    import torch

    from repro_torch.bridge import load_lm_train_reference
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.train import batches
    from repro_torch.models.transformer import Model
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.optimizer import AdamWConfig

    rec = load_lm_train_reference()["yi"]
    make = batches(DataConfig(**rec.data), device)
    opt_cfg = AdamWConfig(**rec.opt)
    failed = []

    def fail_hook(step):
        if step == 5 and not failed:
            failed.append(step)
            raise RuntimeError("injected node failure")

    _build.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        _m, _s, out = train(Model(rec.cfg, device), make,
                            LoopConfig(total_steps=8, ckpt_every=4,
                                       ckpt_dir=d), opt_cfg,
                            fail_hook=fail_hook, verbose=False)
        _m, _s, more = train(Model(rec.cfg, device), make,
                             LoopConfig(total_steps=10, ckpt_every=4,
                                        ckpt_dir=d), opt_cfg, verbose=False)
        files = sorted(os.listdir(d))
    torch.cuda.synchronize()
    hist = out["history"]
    steps = [h["step"] for h in hist]
    replay = [(h["loss"], h["grad_norm"]) for h in hist if h["step"] == 4]
    counts = dict(_build.launches)
    if (steps != [0, 1, 2, 3, 4, 4, 5, 6, 7] or len(set(replay)) != 1
            or [h["step"] for h in more["history"]] != [8, 9]
            or counts.get("flash_attention_bwd", 0) < 1):
        raise AssertionError(f"the on-disk loop: steps {steps}, replayed "
                             f"step 4 {replay}, resumed "
                             f"{[h['step'] for h in more['history']]}, "
                             f"launches {counts}")
    print(f"loop with checkpoints on disk ({rec.cfg.name} record config, "
          f"float32): steps {steps}, step 4 replayed bit-equal "
          f"{replay[0]}; a second train resumed at step 8 and ran "
          f"{[h['step'] for h in more['history']]}; checkpoints left "
          f"{files}; launches {counts}", flush=True)


class Deferred:
    """A profile target built only when its profile runs, and freed after
    it, so that no two full-width models share the card."""

    def __init__(self, build):
        self.build = build


def train_step_target(arch, device, compressed=False, **size):
    """One training step of ``arch`` at a training run's size
    (``train_size(**size)``), for the profile phase: (model, state and
    batch built on the card, then the step); ``compressed``: the int8
    error-feedback step at one pod."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import batches, opt_config
    from repro_torch.models.transformer import Model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import (
        init_ef_states,
        make_train_step,
        make_train_step_compressed,
    )

    size = train_size(**size)
    cfg = get_config(arch)
    if size["layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=size["layers"])
    model = Model(cfg, device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    state = {"opt": init_opt_state(model.named_leaves())}
    data = batches(DataConfig(vocab=cfg.vocab, seq=size["seq"],
                              global_batch=size["batch"], seed=0),
                   model.device, cfg)(0)
    if compressed:
        ef = init_ef_states(model)
        step = make_train_step_compressed(model,
                                          opt_config(TRAIN_LR, TRAIN_STEPS))

        def one():
            state["opt"], _ef, _met = step(state["opt"], ef, data)
        return one
    step = make_train_step(model, opt_config(TRAIN_LR, TRAIN_STEPS))

    def one():
        state["opt"], _met = step(state["opt"], data)
    return one


def lm_train_phase(probes, device="cuda"):
    """The LM training slice: each model's training run (one at a time),
    the backward kernels' rows and checks, and the JAX training records.
    Returns (kernel rows, profile targets, readings)."""
    import torch

    t0 = time.perf_counter()
    rows, targets, readings = [], [], []
    for arch in LM_TRAIN_ARCHS:
        r, args = lm_train_run(arch, device)
        readings.append(r)
        bwd = [k for k in TRAIN_LAUNCHES[arch] if k.endswith("_bwd")][0]
        launches = r["launches"][bwd]       # measured: each step's count
        if arch == "yi-9b":
            rows += flash_bwd_rows(probes, args, launches)
        else:
            rows.append(wkv_bwd_rows(probes, args, launches))
        del args
        torch.cuda.empty_cache()
        targets.append((f"{arch} training step ({TRAIN_LAYERS} layers)",
                        Deferred(lambda a=arch: train_step_target(a, device)),
                        r["step_ms"]))
    lm_train_record_phase(device)
    lm_train_disk_run(device)
    print(f"LM training phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, targets, readings


# -- the pod-scale cost stack: the int8 error-feedback exchange ------------------

COMPRESSED_STEPS = 4            # steps of the compressed yi run
COMPRESSED_KEEP_STEP = 1        # the step whose largest leaf the rows take
                                # (its residual is nonzero)


def ef_bound_ratio(target, residual, scale, block):
    """max over the values of |residual| / (scale / 2 + ulp(absmax)), each
    value against its flat block's scale and the ulp of its block's
    largest |target|: at most 1 where every value was sent within half a
    quantization step (a device scalar)."""
    import torch

    from repro_torch.core.reduction import flat_blocks

    absmax = flat_blocks(target, block).abs().amax(dim=1, keepdim=True)
    ulp = torch.nextafter(absmax, torch.full_like(absmax, float("inf")))
    bound = scale / 2 + (ulp - absmax)
    return (flat_blocks(residual, block).abs() / bound).amax()


class _EFCalls:
    """Counts and checks every call of ``core.reduction.ef_compress_int8``
    while it is entered: each call's residual against ``ef_bound_ratio``
    (kept as a device scalar; the checks' time by CUDA events), and at
    step ``keep`` (set ``step`` before each) a copy of the largest call's
    input and incoming residual."""

    def __init__(self, keep):
        self.keep, self.step = keep, None
        self.ratios, self.events, self.kept = {}, {}, None

    def __enter__(self):
        import torch

        from repro_torch.core import reduction

        self._mod, self._fn = reduction, reduction.ef_compress_int8
        fn = self._fn

        def checked(x, state, block=256):
            out = fn(x, state, block=block)
            (_q, scale), _deq, new = out
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            target = x.to(torch.float32) + state.residual
            self.ratios.setdefault(self.step, []).append(
                ef_bound_ratio(target, new.residual, scale, block))
            del target
            if self.step == self.keep and (
                    self.kept is None or x.numel() > self.kept[0].numel()):
                self.kept = (x.clone(), state.residual.clone())
            end.record()
            self.events.setdefault(self.step, []).append((start, end))
            return out

        reduction.ef_compress_int8 = checked
        return self

    def __exit__(self, *exc):
        self._mod.ef_compress_int8 = self._fn

    def worst(self, step) -> float:
        return max(float(r) for r in self.ratios[step])

    def check_ms(self, step) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events[step])


def ef_route_check(label, x, residual, block=256):
    """``ef_compress_int8`` through the wire codec's kernels against the
    plain compressor (``quantize_int8`` / ``dequantize_int8``, the
    residual by ``sub_products``) on the same card tensors: q, scale, deq
    and the new residual bit for bit."""
    from repro_torch.core.reduction import (
        EFState,
        dequantize_int8,
        ef_compress_int8,
        quantize_int8,
        sub_products,
    )

    (q, scale), deq, new = ef_compress_int8(x, EFState(residual), block)
    target = x.float() + residual
    want_q, want_s = quantize_int8(target, block=block)
    want_deq = dequantize_int8(want_q, want_s, x.shape)
    same = {"q": _bits_equal(q, want_q), "scale": _bits_equal(scale, want_s),
            "deq": _bits_equal(deq, want_deq),
            "residual": _bits_equal(new.residual,
                                    sub_products(target, want_q, want_s))}
    if not all(same.values()):
        raise AssertionError(f"ef_compress_int8 {label}: codec route vs "
                             f"plain {same}")
    print(f"ef_compress_int8 {label} {tuple(x.shape)}: the codec route == "
          "the plain compressor bit for bit (q, scale, deq, residual)",
          flush=True)


def compressed_record_check(rec, device, pod_group=None):
    """The port's compressed train step on the JAX compressed-training
    record (``assets/lm_compressed_train_reference.npz``) at the pod count
    of ``pod_group`` (None: 1 pod; this process is the pod of its rank and
    takes its rows of each batch): each step's loss, ce, grad norm and the
    norm of all this pod's residuals within max(RECORD_REL, E) of JAX's,
    E the record's one-ulp sensitivity of that quantity at that step; the
    learning rate within one float32 ulp.  Returns the readings: per
    quantity each step's relative difference, and per step the largest
    over leaves of a leaf's residual norm's difference ("res_leaf") and of
    that over its own max(RECORD_REL, E) ("res_leaf_of_bound"), read, not
    held: a leaf of a few blocks moves by whole quantization steps where a
    code flips at a near tie, and 24 one-ulp draws need not flip as many
    codes as the port's other summation order does (the CPU test holds
    each code at step 0 instead)."""
    import torch

    from repro_torch.bridge import lm_params_from, numpy_lm_params
    from repro_torch.core.reduction import pod_count
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import batches
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import (
        init_ef_states,
        make_train_step_compressed,
    )

    npods = pod_count(pod_group)
    rank = 0 if pod_group is None else torch.distributed.get_rank(pod_group)
    model = lm_params_from(numpy_lm_params(rec.cfg, rec.seed), rec.cfg,
                           device=device)
    make = batches(DataConfig(**rec.data), model.device, rec.cfg)
    state = init_opt_state(model.named_leaves())
    ef = init_ef_states(model)
    if list(ef) != rec.leaf_names:
        raise AssertionError(f"residual leaves {list(ef)} != the record's "
                             f"{rec.leaf_names}")
    step_fn = make_train_step_compressed(model, AdamWConfig(**rec.opt),
                                         pod_group)
    want, e = rec.runs[npods], rec.sensitivity[npods]
    rows = rec.data["global_batch"] // npods
    rel = {k: [] for k in ("loss", "ce", "grad_norm", "res_norm",
                           "res_leaf", "res_leaf_of_bound")}
    for s in range(rec.steps):
        toks = make(s)["tokens"][rank * rows:(rank + 1) * rows]
        state, ef, met = step_fn(state, ef, {"tokens": toks})
        leaf = np.array([float(r.double().square().sum().sqrt())
                         for r in ef.values()])
        got = {k: float(met[k]) for k in ("loss", "ce", "grad_norm")}
        got["res_norm"] = float(np.sqrt(np.sum(leaf ** 2)))
        for k, v in got.items():
            w, bound = want[k][s], e[k][s]
            if k == "res_norm":             # this pod's
                w, bound = w[rank], bound[rank]
            r = abs(v - float(w)) / abs(float(w))
            rel[k].append(r)
            if r > max(RECORD_REL, bound):
                raise AssertionError(
                    f"compressed record, {npods} pod(s), pod {rank}, step "
                    f"{s}: {k} {v!r} vs JAX {float(w)!r} ({r:.3g}, bound "
                    f"{max(RECORD_REL, bound):.3g})")
        w = want["res_leaf"][s][rank]
        r_leaf = np.abs(leaf - w) / np.where(w > 0, w, 1.0)
        of_bound = r_leaf / np.maximum(RECORD_REL, e["res_leaf"][s][rank])
        rel["res_leaf"].append(float(r_leaf.max()))
        rel["res_leaf_of_bound"].append(float(of_bound.max()))
        lr, wlr = np.float32(float(met["lr"])), want["lr"][s]
        if abs(int(lr.view(np.int32)) - int(wlr.view(np.int32))) > 1:
            raise AssertionError(f"compressed record step {s}: lr {lr!r} vs "
                                 f"{wlr!r}")
    return rel


def link_bytes(numels, block=256) -> tuple:
    """(bytes one pod puts on the pod link a step: int8 codes and a
    float32 scale a block, each call of the exchange; 2 x 4 bytes a value
    for a float32 ring all-reduce of the same values)."""
    coded = sum(n + 4 * -(-n // block) for n in numels)
    return coded, 8 * sum(numels)


def compressed_train_phase(probes, plain, device="cuda"):
    """yi-9b at full width, TRAIN_LAYERS deep, bf16 with a float32 master,
    TRAIN_BATCH x TRAIN_SEQ tokens a step, through
    ``make_train_step_compressed`` at one pod (``pod_group`` None), from
    the weights and batches of the plain yi run (``plain``, its
    readings): every loss and grad norm finite; step 0's loss == the plain
    run's; at every step each value's residual (at step 0 the difference
    between the sent gradient and the float32 one) within half its block's
    quantization step plus an ulp of the block's absmax; launches a step:
    16 + 8 flash, and one ``wire_encode`` and one ``wire_decode`` a call of
    the exchange (a reference leaf, or a slice where the slices hold whole
    blocks); the codec route == the plain compressor on the step's largest
    leaf and on a drawn tensor with all-zero blocks and a ragged tail; the
    JAX compressed-training record at one pod.  Prints the step's ms and
    tokens/s, the exchange's ms (CUDA events), the peak, the link bytes
    and the planner's roofline row with the card's profile beside the
    measured step.  Returns the rows 4g and 5g (the codec on the largest
    leaf) and the step's profile target."""
    import torch

    from repro_torch.bridge import load_lm_compressed_train_reference
    from repro_torch.configs.registry import get_config
    from repro_torch.core.costmodel import H100_SXM, format_roofline_table
    from repro_torch.core.placement import ShardingPlan, estimate_plan
    from repro_torch.core.reduction import flat_blocks
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.train import batches, opt_config
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import init_opt_state

    t_phase = time.perf_counter()
    arch = "yi-9b"
    cfg = dataclasses.replace(get_config(arch), n_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    n_params = model.n_params()
    state = init_opt_state(model.named_leaves())
    ef = step_mod.init_ef_states(model)
    make = batches(DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=0),
                   model.device, cfg)
    step_fn = step_mod.make_train_step_compressed(
        model, opt_config(TRAIN_LR, TRAIN_STEPS))
    layout = step_mod.ef_leaves(model)
    params = model.named_leaves()
    calls = []                  # numels of the exchange's calls a step
    for _name, _stacked, pnames in layout:
        n, k = params[pnames[0]].numel(), len(pnames)
        calls += [n * k // step_mod.n_calls(k, n)] * step_mod.n_calls(k, n)
    want = dict(TRAIN_LAUNCHES[arch], wire_encode=len(calls),
                wire_decode=len(calls))

    exchange, ex_events = step_mod.exchange_grads, []

    def timed_exchange(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = exchange(*a, **kw)
        end.record()
        ex_events.append((start, end))
        return out

    hist, per_step = [], []
    step_mod.exchange_grads = timed_exchange
    try:
        with _EFCalls(COMPRESSED_KEEP_STEP) as efc:
            for s in range(COMPRESSED_STEPS):
                batch = make(s)
                efc.step = s
                _build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, ef, met = step_fn(state, ef, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                per_step.append(dict(_build.launches))
                hist.append({"loss": float(met["loss"]),
                             "grad_norm": float(met["grad_norm"]), "dt": dt})
    finally:
        step_mod.exchange_grads = exchange
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist):
        raise AssertionError(f"compressed {arch}: non-finite loss or grad "
                             f"norm: {hist}")
    if hist[0]["loss"] != plain["losses"][0]:
        raise AssertionError(f"compressed {arch}: step-0 loss "
                             f"{hist[0]['loss']!r} != the plain run's "
                             f"{plain['losses'][0]!r}")
    ratios = [efc.worst(s) for s in range(COMPRESSED_STEPS)]
    if max(ratios) > 1:
        raise AssertionError(f"compressed {arch}: a residual beyond half a "
                             f"quantization step + an ulp: {ratios} of the "
                             "bound by step")
    bad = [(s, c) for s, c in enumerate(per_step)
           if {k: c.get(k, 0) for k in want} != want or set(c) - set(want)]
    if bad:
        raise AssertionError(f"compressed {arch}: launches per step "
                             f"{per_step}, predicted {want}")
    check_ms = [efc.check_ms(s) for s in range(COMPRESSED_STEPS)]
    ms = [1e3 * h["dt"] - c for h, c in zip(hist, check_ms)]
    step_ms = statistics.median(ms[1:])
    ex_ms = statistics.median(a.elapsed_time(b) - c for (a, b), c in
                              zip(ex_events[1:], check_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    coded, ring = link_bytes(calls)
    print(f"{arch} compressed training, {cfg.n_layers} layers at full width "
          f"({n_params / 1e9:.3f} B parameters, bf16 with a float32 master), "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, one pod: losses "
          f"{[h['loss'] for h in hist]}, grad norms "
          f"{[h['grad_norm'] for h in hist]}; step-0 loss == the plain "
          f"run's {plain['losses'][0]!r}; residuals within "
          f"{[f'{r:.6f}' for r in ratios]} of half a quantization step + "
          f"an ulp of the block's absmax, by step", flush=True)
    print(f"{arch} compressed training: step {step_ms:.3f} ms (host clock, "
          f"synchronised, median of the {COMPRESSED_STEPS - 1} steps after "
          f"the first, less the checks' {statistics.median(check_ms[1:]):.3f}"
          f" ms by CUDA events; the plain step {plain['step_ms']:.3f} ms), "
          f"{tokens / (step_ms / 1e3):.1f} tokens/s; the exchange "
          f"(exchange_grads) {ex_ms:.3f} ms a step (CUDA events, less the "
          f"checks), {100 * ex_ms / step_ms:.1f}% of the step; peak "
          f"{peak:.2f} GiB ({resident:.2f} GiB resident before; the plain "
          f"run's {plain['peak_gib']:.2f}); launches per step "
          f"{per_step[0]} at every step (predicted {want})", flush=True)
    print(f"{arch} compressed training: one pod would put {coded:,} bytes "
          f"a step on the pod link (int8 codes + float32 scales of "
          f"{len(calls)} calls) against {ring:,} for a float32 ring "
          f"all-reduce (2 x 4 bytes a parameter): {ring / coded:.3f}x fewer",
          flush=True)
    rl = estimate_plan(
        ShardingPlan("1chip"), name=f"{arch}|{cfg.n_layers}L train",
        params=n_params, active_params=model.n_active_params(),
        layer_flops=2 * model.n_active_params() * tokens, train=True,
        tokens=tokens, d_model=cfg.d_model, seq=TRAIN_SEQ,
        batch=TRAIN_BATCH, n_layers=cfg.n_layers, hbm_gib=80)
    roof = dataclasses.replace(rl.roofline, chip=H100_SXM)
    print("planner's roofline (core.placement.estimate_plan, one chip, "
          f"hbm_gib=80, chip=H100_SXM; feasible {rl.feasible}) beside the "
          f"measured step {step_ms / 1e3:.6f} s:\n"
          + format_roofline_table([roof])
          + f"\n  step_s {roof.step_s:.6f} s predicted, {step_ms / 1e3:.6f} s"
          " measured", flush=True)

    # the codec route against the plain compressor, and rows 4g / 5g on
    # the largest leaf of step COMPRESSED_KEEP_STEP
    x, res = efc.kept
    del step_fn, state, ef, model, params
    free_card()
    ef_route_check(f"largest gradient leaf (step {COMPRESSED_KEEP_STEP})",
                   x, res)
    g = torch.Generator(device=device).manual_seed(34)
    drawn = torch.randn(1000 * 256 + 77, generator=g, device=device)
    drawn[256:3 * 256] = 0                 # all-zero blocks
    drawn[-77:] = 0                        # and a zero ragged tail
    ef_route_check("drawn, all-zero blocks, ragged tail", drawn,
                   torch.zeros_like(drawn))
    ef_route_check("drawn, nonzero blocks and residual, ragged tail",
                   drawn * 3, torch.randn(drawn.shape, generator=g,
                                          device=device) * 1e-3)
    blocks = flat_blocks(x + res, step_mod.BLOCK).contiguous()
    del x, res
    rows = codec_kernel_rows(
        probes, blocks, {"wire_encode": want["wire_encode"],
                         "wire_decode": want["wire_decode"]},
        shape=f"{blocks.shape[0]} x {blocks.shape[1]}",
        label=f", {arch} largest gradient leaf")
    for row, name in zip(rows, ("4g", "5g")):
        row["table_row"] = name
    del blocks

    rec = load_lm_compressed_train_reference()
    _build.reset_launches()
    rel = compressed_record_check(rec, device)
    counts = dict(_build.launches)
    if min(counts.get(k, 0) for k in ("flash_attention",
                                      "flash_attention_bwd", "wire_encode",
                                      "wire_decode")) < 1:
        raise AssertionError(f"compressed record: kernels not launched: "
                             f"{counts}")
    e = rec.sensitivity[1]
    print(f"JAX compressed-training record (1 pod, {rec.cfg.n_layers} "
          f"layers, {rec.data['global_batch']} x {rec.data['seq']} tokens, "
          f"{rec.steps} steps, float32): per step loss "
          f"{[f'{r:.3g}' for r in rel['loss']]} (E "
          f"{[f'{v:.3g}' for v in e['loss']]}), grad norm "
          f"{[f'{r:.3g}' for r in rel['grad_norm']]} (E "
          f"{[f'{v:.3g}' for v in e['grad_norm']]}), residual norm "
          f"{[f'{r:.3g}' for r in rel['res_norm']]} (E "
          f"{[f'{v[0]:.3g}' for v in e['res_norm']]}); lr within an ulp; "
          f"read, not held: a leaf's residual norm at most "
          f"{[f'{r:.3g}' for r in rel['res_leaf_of_bound']]} of its own "
          f"max(1e-4, E); launches {counts}", flush=True)
    print(f"compressed training phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    target = (f"{arch} compressed training step ({TRAIN_LAYERS} layers, "
              "one pod)", Deferred(lambda: train_step_target(
                  arch, device, compressed=True)), step_ms)
    return rows, [target]


# -- whisper, the encoder-decoder ------------------------------------------------

WHISPER = "whisper-medium"
# the serve call: 8 requests of 1500 x 1024 frames, 200-token prompts
# (ragged against the 64-row flash tiles; 200 + 32 within the published
# model's 448-token text context), 32 greedy tokens
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_GEN = 8, 200, 32
# the training run: full depth, 8 x 448 tokens and 8 x 1500 frames a step;
# a failure at step 5, replayed from the checkpoint of step 4
WHISPER_SEQ, WHISPER_BATCH = 448, 8
WHISPER_STEPS, WHISPER_CKPT_EVERY, WHISPER_FAIL_AT = 6, 4, 5


def whisper_launches(cfg, training: bool) -> dict:
    """The launches predicted for whisper: the decoder's self-attention is
    its one kernel, and each decoder layer (24) launches the forward once
    in a serve call (in prefill), and in a training step once in the
    forward and once in the recompute, the backward once."""
    if training:
        return {"flash_attention": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    return {"flash_attention": cfg.n_layers}


class _Calls:
    """Counts the calls of ``module.name`` while active."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.n = 0

    def __enter__(self):
        def spy(*args, **kw):
            self.n += 1
            return self.fn(*args, **kw)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def whisper_serve_call(device):
    """The serve call of ``whisper_serve_phase`` on a model built anew
    from the same seeds, for the profile phase: encode, then generate."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_model, make_frames, make_prompts
    from repro_torch.serve.engine import generate

    cfg = get_config(WHISPER)
    model = build_model(cfg, device, seed=0)
    frames = make_frames(cfg, WHISPER_REQUESTS, seed=2, device=device)
    prompts = make_prompts(cfg, WHISPER_REQUESTS, WHISPER_PROMPT, seed=1,
                           device=device)

    @torch.no_grad()
    def serve():
        return generate(model, prompts, WHISPER_GEN,
                        enc_out=model.encode(frames))
    return model, frames, prompts, serve


def whisper_serve_phase(probes, device):
    """whisper-medium at full width and full depth (24 + 24 layers) in
    bf16: a counted serve call (encode 8 x 1500 x 1024 frames, prefill 8 x
    200-token prompts with the cross keys and values, 32 greedy tokens)
    that launches ``flash_attention`` exactly 24 times, all in prefill,
    and computes each layer's cross keys and values once per request (in
    prefill, never in a decode step); every logit finite; ``stream`` ==
    ``generate``; encode, prefill and per-token decode times by host clock
    and CUDA events, and peak memory.  Then the kernel row at the inputs
    of the first prefill launch.  Returns (kernel row, serve ms)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention as attn
    from repro_torch.serve.engine import stream

    t0 = time.perf_counter()
    model, frames, prompts, serve = whisper_serve_call(device)
    cfg = model.cfg
    torch.cuda.synchronize()
    print(f"{WHISPER}: {model.n_params() / 1e9:.3f} B parameters in "
          f"{cfg.param_dtype}, {cfg.enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with torch.no_grad():
        enc = model.encode(frames)

    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with _Calls(attn, "cross_kv") as kv:
        toks = serve()
        torch.cuda.synchronize()
        counts, kv_call = dict(_build.launches), kv.n
        peak = torch.cuda.max_memory_allocated()
        _build.reset_launches()
        kv.n = 0
        _logits, cache = model.prefill(prompts, enc)
        torch.cuda.synchronize()
        prefill_counts, kv_prefill = dict(_build.launches), kv.n
        cache = model.pad_cache(cache, 1)
        _build.reset_launches()
        kv.n = 0
        model.decode_step(toks[:, :1], cache, WHISPER_PROMPT)
        torch.cuda.synchronize()
        decode_counts, kv_decode = dict(_build.launches), kv.n
    del cache
    print(f"{WHISPER} serve call launches {counts}, prefill alone "
          f"{prefill_counts}, a decode step {decode_counts}; cross K/V "
          f"projections: {kv_call} a call, {kv_prefill} in prefill, "
          f"{kv_decode} in a decode step", flush=True)
    want = whisper_launches(cfg, training=False)
    if counts != want or prefill_counts != want or decode_counts:
        raise AssertionError(f"{WHISPER}: launches {counts} a serve call, "
                             f"{prefill_counts} in prefill, "
                             f"{decode_counts} in a decode step; expected "
                             f"{want}, all in prefill")
    if kv_call != cfg.n_layers or kv_prefill != cfg.n_layers or kv_decode:
        raise AssertionError(f"{WHISPER}: cross K/V computed {kv_call} "
                             f"times a call, {kv_prefill} in prefill, "
                             f"{kv_decode} in a decode step; expected once "
                             "a layer, in prefill")

    with _Capture(flash_ops, "flash_attention") as cap:
        steps = list(stream(model, prompts, WHISPER_GEN, enc_out=enc))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(lg).all()) for _t, lg in steps)
    same = torch.equal(torch.stack([t for t, _lg in steps], 1), toks)
    del steps
    if not finite or not same:
        raise AssertionError(f"{WHISPER}: finite logits {finite}, stream == "
                             f"generate {same}")

    def encode():
        with torch.no_grad():
            return model.encode(frames)

    times = {}
    for name, fn in (("encode", encode),
                     ("prefill", lambda: model.prefill(prompts, enc)),
                     ("serve call", serve)):
        times[name] = (host_ms(fn, reps=3), device_ms(fn, reps=3, warm=1))
    decode = [(times["serve call"][i] - times["encode"][i]
               - times["prefill"][i]) / (WHISPER_GEN - 1) for i in (0, 1)]
    serve_ms = times["serve call"][0]
    print(f"{WHISPER} serve ({WHISPER_REQUESTS} requests of "
          f"{cfg.enc_seq} x {cfg.d_model} frames and {WHISPER_PROMPT} prompt "
          f"tokens, {WHISPER_GEN} greedy tokens): "
          + ", ".join(f"{k} {h:.3f} ms (CUDA events {d:.3f} ms)"
                      for k, (h, d) in times.items())
          + f"; decode {decode[0]:.3f} ms per token (CUDA events "
          f"{decode[1]:.3f} ms); {1e3 * WHISPER_REQUESTS * WHISPER_GEN / serve_ms:.1f} "
          f"generated tokens/s (host clock, median of 3); peak "
          f"{peak / 2 ** 30:.2f} GiB ({resident / 2 ** 30:.2f} GiB resident "
          "before the call); every logit finite, stream == generate",
          flush=True)
    del model, frames, prompts, serve, enc
    free_card()
    q, k, v = cap.args
    rows = flash_row(probes, q, k, v, want["flash_attention"],
                     FLASH_TOL, FLASH_TOL,
                     label=f"whisper prefill {'x'.join(map(str, q.shape))}")
    return rows[0], serve_ms


def whisper_record_phase(device):
    """``assets/lm_encdec_reference.npz`` on the card, through the kernels
    in float32: the serving record (prefill logits, 16 teacher-forced
    decode steps, greedy tokens up to the first near tie) and one training
    step (loss, grad norm, every leaf's gradient norm and probe), each
    within max(RECORD_REL, E)."""
    import torch

    from repro_torch.bridge import (
        lm_params_from,
        load_lm_encdec_reference,
        numpy_lm_params,
    )
    from repro_torch.kernels import _build

    serve, train = load_lm_encdec_reference()
    model = lm_params_from(numpy_lm_params(serve.cfg, serve.seed), serve.cfg,
                           device=device)
    _build.reset_launches()
    worst, tol, compared = lm_record_check(model, serve)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    if counts.get("flash_attention", 0) < 1:
        raise AssertionError(f"whisper record: flash_attention never "
                             f"launched: {counts}")
    print(f"JAX record whisper ({serve.cfg.enc_layers} + "
          f"{serve.cfg.n_layers} layers, {serve.prompts.shape[0]} x "
          f"{serve.prompts.shape[1]} tokens, {serve.cfg.enc_seq} frames, "
          f"float32): logits within {worst:.3g} of JAX (bound {tol:.3g}, E "
          f"{serve.sensitivity:.3g}); {compared} of {serve.greedy.size} "
          f"greedy tokens compared, all equal; launches {counts}", flush=True)
    del model
    _build.reset_launches()
    r = lm_train_record_check(train, device)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    if (counts.get("flash_attention", 0) < 1
            or counts.get("flash_attention_bwd", 0) < 1):
        raise AssertionError(f"whisper training record: kernels not "
                             f"launched: {counts}")
    e = train.sensitivity
    print(f"JAX training record whisper (one step, "
          f"{train.data['global_batch']} x {train.data['seq']} tokens and "
          f"{train.cfg.enc_seq} frames, float32): loss "
          f"{r['steps_rel']['loss'][0]:.3g} from JAX (E {e['loss'][0]:.3g}), "
          f"grad norm {r['steps_rel']['grad_norm'][0]:.3g} (E "
          f"{e['grad_norm'][0]:.3g}); the {len(train.leaf_names)} leaves' "
          f"gradient norms and probes (enc_stack and cross included) at most "
          f"{r['grad_of_bound']['g_norm']:.3g} and "
          f"{r['grad_of_bound']['g_probe']:.3g} of their bounds; launches "
          f"{counts}", flush=True)


def flash_bwd_bytes_ops(q, k, v, lse):
    """The bytes a flash backward must move (q, k, v, o, dout and lse read
    once, dq, dk, dv written once) and its causal operations: five
    products, S = q k^T, dQ = dS K and dK = dS^T Q over the query-key width
    d, dP = dO V^T and dV = P^T dO over the value width dv, 2 s t each per
    (b, h), halved by the mask."""
    b, s, H, d = q.shape
    dv = v.shape[-1]
    n_bytes = (q.element_size() * (2 * q.numel() + 2 * (k.numel() + v.numel())
                                   + 2 * b * s * H * dv) + 4 * lse.numel())
    return n_bytes, 2 * (3 * d + 2 * dv) * _causal_pairs(s) * b * H


def flash_bwd_row(probes, args, launches, label, source="layer 0, step 1"):
    """``flash_attention_bwd`` (bf16) on layer 0's backward-kernel inputs
    at step 1 of a training run (``label``: whisper's, row 7gw; mixtral's,
    row 7gm; deepseek's MLA pair, row 7gmla), or on drawn inputs
    (``source``: jamba's attention shape, row 7gj), against the plain
    backward given the plain forward's O and log-sum-exp
    (``flash_bwd_check``), timed beside SDPA's backward."""
    from repro_torch.kernels.flash_attention import cuda as fcuda

    q, k, v, o, dout, lse = args
    shape = "x".join(map(str, q.shape)) + (
        f" dv {v.shape[-1]}" if v.shape[-1] != q.shape[-1] else "") + \
        " bfloat16"
    err, plain = flash_bwd_check(q, k, v, o, dout, lse,
                                 f"{label} {shape} ({source})")
    plain_ms = device_ms(plain, reps=2, warm=1)
    lib_ms, lib_fn = sdpa_backward_ms(q, k, v, dout)
    n_bytes, n_ops = flash_bwd_bytes_ops(q, k, v, lse)
    row = kernel_row(
        probes, "flash_attention_bwd", _bwd_module("flash_attention_bwd"),
        launches, err, lambda: fcuda.flash_attention_bwd_cuda(*args),
        plain_ms, lib_ms, n_bytes, n_ops, PEAK_BF16_OPS_S, reps=5,
        shape=f"{label} {shape}", library_fn=lib_fn,
        kernel=("flash_attention_bwd", 2))
    row["backward_of"] = "row 7"
    row["kernel"] = FLASH_BWD_KERNEL["bfloat16"]
    return row


def whisper_phase(probes, device="cuda"):
    """The encoder-decoder slice: the serve call at full depth, float32
    parity at PARITY_LAYERS of each stack, the JAX record, and the
    full-depth training run.  Returns (kernel rows, profile targets,
    training readings)."""
    import torch

    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    cfg = get_config(WHISPER)
    fwd_row, serve_ms = whisper_serve_phase(probes, device)
    lm_parity_phase(WHISPER, device)
    whisper_record_phase(device)
    free_card()
    r, args = lm_train_run(WHISPER, device, layers=None, seq=WHISPER_SEQ,
                           batch=WHISPER_BATCH, steps=WHISPER_STEPS,
                           ckpt_every=WHISPER_CKPT_EVERY,
                           fail_at=WHISPER_FAIL_AT,
                           want=whisper_launches(cfg, training=True))
    bwd_row = flash_bwd_row(probes, args, r["launches"][
        "flash_attention_bwd"], "whisper")
    del args
    torch.cuda.empty_cache()
    targets = [(f"{WHISPER} serve call",
                Deferred(lambda: whisper_serve_call(device)[-1]), serve_ms),
               (f"{WHISPER} training step ({cfg.enc_layers} + "
                f"{cfg.n_layers} layers)",
                Deferred(lambda: train_step_target(
                    WHISPER, device, layers=None, seq=WHISPER_SEQ,
                    batch=WHISPER_BATCH)), r["step_ms"])]
    print(f"whisper phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return [fwd_row, bwd_row], targets, r


# -- mixtral: the MoE layer ------------------------------------------------------

MIXTRAL = "mixtral-8x22b"
# the serve call: 8 of 56 layers at full width in bf16 (the whole model,
# 140.6 B parameters, does not fit one card), 8 requests of 8192-token
# prompts (the window of 4096 binds from position 4096 on; the published
# context is 64k), 32 greedy tokens
MIXTRAL_LAYERS = 8
MIXTRAL_REQUESTS, MIXTRAL_PROMPT, MIXTRAL_GEN = 8, 8192, 32
# the float32 parity: the reference's own parity test raises the capacity
# factor so that nothing drops (tests/test_models.py:22-26, _f32_nodrop).
# Two layers: at 4 the stacked init's random experts turn the model
# chaotic (benchmarks/torch_mixtral_probe.py --only parity)
NODROP_FACTOR = 16.0
MIXTRAL_PARITY_LAYERS = 2
# the bf16 layer output against the CPU port's float32 on the same routing:
# within 2^-7 of max |float32| + 2^-7 |float32| (h and the expert outputs
# are rounded to bf16 there; 0.23 of this bound at full width on the CPU)
MOE_BF16_REL = 2.0 ** -7
MOE_ROWS = 64             # prefill tokens recomputed in float32 on the CPU
# the training run: 1 of 56 layers (MIXTRAL_TRAIN_LAYERS) at full width in
# bf16 with a float32 master: the layer and the embeddings are 2.91 B
# parameters, 43.3 GiB with gradients, master and moments, and a second
# layer would add 37.3 GiB; 8 x 2048 tokens a step (TRAIN_SEQ,
# TRAIN_BATCH), 6 steps, a failure at step 5 replayed from the checkpoint
# of step 4, as whisper's run
MIXTRAL_TRAIN_STEPS, MIXTRAL_TRAIN_CKPT_EVERY, MIXTRAL_TRAIN_FAIL_AT = 6, 4, 5
# the sliced AdamW against the whole-leaf update on the card: one leaf of
# yi's embedding size, 2^27 elements or more (4 slices of
# ``optimizer.SLICE``)
ADAMW_SLICE_SHAPE = (64000, 4096)

# -- deepseek-v2-236b: MLA and the dense prefix
DEEPSEEK = "deepseek-v2-236b"
# the serve call: the dense first layer and five MoE layers of 60 at full
# width in bf16 (40.5 GiB: the embeddings 2.10 GB, the prefix 0.84 GB, a
# MoE layer 8.11 GB with its 160 experts, the shared experts and MLA;
# a seventh layer would pass 72 GiB with the prefill's transients and the
# earlier phases' resident memory), 8 requests of 4096-token prompts, 32
# greedy tokens
DEEPSEEK_LAYERS = 6
DEEPSEEK_REQUESTS, DEEPSEEK_PROMPT, DEEPSEEK_GEN = 8, 4096, 32
# the float32 parity at 2 layers (the prefix and one MoE layer): with 160
# experts and top-6, a call's capacity reaches its token count only at a
# factor of 160 / 6 = 26.7 or more (at the reference's 16 a decode step
# of 8 requests has 5 slots an expert), so 32: nothing can drop
DEEPSEEK_NODROP_FACTOR = 32.0
DEEPSEEK_PARITY_LAYERS = 2
# the drawn MLA flash rows (7mla's ragged and float32 counterparts): the
# serve call's batch and a prompt ragged against the tiles, 32 heads
DEEPSEEK_RAGGED = (LM_REQUESTS, FLASH_RAGGED_S, 32)

# -- jamba-v0.1-52b: Mamba layers with attention in every period of 8
JAMBA = "jamba-v0.1-52b"
# the serve call: one whole period of the layer kinds (7 Mamba layers and
# the attention layer 4; MoE, 16 experts top-2, on the odd layers) of 32
# at full width in bf16 (13.3 B parameters, 24.8 GiB; the whole model,
# 51.6 B, does not fit one card), 8 requests of 4096-token prompts, 32
# greedy tokens
JAMBA_LAYERS = 8
JAMBA_REQUESTS, JAMBA_PROMPT, JAMBA_GEN = 8, 4096, 32
# the float32 parity at layers 0-4: four Mamba layers, two MoE layers and
# the attention layer, on the reference's stacked init (one period: every
# matrix drawn at std 1, yet E 8.6e-5 on one H100, not chaotic); at factor
# 16 a call's capacity 2 t an expert holds all its t choices of 16 experts
# top-2
JAMBA_PARITY_LAYERS = 5
JAMBA_NODROP_FACTOR = 16.0
# the chunked scan against the unchunked one on the card: 2 requests of
# the layer's own inputs, a length ragged against the chunk of 256
JAMBA_SCAN_B, JAMBA_SCAN_S, JAMBA_SCAN_CHUNK = 2, 1000, 256
# the Mamba layer on the card against the CPU port in float32: the card
# may lie MAMBA_MARGIN times as far from a float64 evaluation of the layer
# as the CPU port lies (both round every operation of the same float32
# computation; their GEMMs sum in other orders), so the two lie within
# (1 + MAMBA_MARGIN) times the CPU port's own distance of each other
MAMBA_MARGIN = 4
MAMBA_CPU_ROWS = 1          # requests recomputed on the CPU
# the training run: JAMBA_TRAIN_LAYERS of 32 (layer 0: Mamba with a SwiGLU
# FFN, and the embeddings: 818,352,416 parameters, ~13.1 GB of training
# state; layer 1, a MoE layer of 16 experts top-2, would add ~2.8 B) at
# full width in bf16 with a float32 master, 8 x 2048 tokens a step, with
# mixtral's steps, checkpoints and failure (MIXTRAL_TRAIN_*).  Layer 0's
# step-1 inputs then feed the scan's backward on the card, checkpointed
# against its earlier form at JAMBA_SCAN_B x JAMBA_SCAN_S (chunks of
# JAMBA_SCAN_CHUNK), and layer 0's float32 gradients on MAMBA_GRAD_ROWS
# request of 2048 tokens, card against the CPU port and float64
MAMBA_GRAD_ROWS = 1
SCAN_BWD_REPS = 3
# row 7gj: the bf16 backward at jamba's attention shape (b, s, H, KV, d),
# 32 query heads over 8 KV heads (a head group of 4), drawn
JAMBA_ATTN = (8, 2048, 32, 8, 128)


class _Drops:
    """The assignments each MoE dispatch drops while active, in call order
    (one call a MoE layer): a spy on ``models.moe.sort_dispatch``, which
    reads each call's count (a host sync: not for timed runs)."""

    def __init__(self):
        from repro_torch.models import moe

        self.module, self.fn, self.log = moe, moe.sort_dispatch, []

    def __enter__(self):
        def spy(*args):
            out = self.fn(*args)
            self.log.append(int((~out[2]).sum()))
            return out
        self.module.sort_dispatch = spy
        return self

    def __exit__(self, *exc):
        self.module.sort_dispatch = self.fn


class _Inputs:
    """The inputs ``module.name`` (``models.moe.moe_ffn`` or
    ``models.ssm.mamba_mixer``, both called as (params, cfg, m, x, ...))
    gets from one layer (its parameters ``params``) while active, cloned,
    in call order."""

    def __init__(self, module, name, params):
        self.module, self.name, self.params, self.xs = module, name, params, []
        self.fn = getattr(module, name)

    def __enter__(self):
        def spy(params, cfg, m, x, *rest):
            if params is self.params:
                self.xs.append(x.clone())
            return self.fn(params, cfg, m, x, *rest)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def moe_record_check(model, rec, extras):
    """The port against the JAX MoE record (``assets/lm_moe_reference.npz``,
    mixtral's smoke config in float32 at capacity factor 1.25): the full
    forward's logits, the loss with its ce and aux, and (``lm_record_check``)
    the prefill, 16 teacher-forced decode steps and greedy tokens, each
    within max(RECORD_REL, E) of its largest entry, E the record's one-ulp
    sensitivity of that output; the assignments each MoE layer drops in
    the forward, the prefill and every decode step equal to JAX's.  Returns
    the readings."""
    import torch

    dev = model.device
    L = sum(kind[1] == "moe" for kind in model.kinds)      # MoE layers
    n = rec.teacher.shape[1]
    sens = extras["sensitivity"]
    toks = torch.as_tensor(np.concatenate([rec.prompts, rec.teacher], 1),
                           dtype=torch.long, device=dev)
    with _Drops() as fwd:
        logits = model.logits(toks).float().cpu().numpy()
    with torch.no_grad():
        loss, metrics = model.loss({"tokens": toks})
    want = extras["logits"]
    out = {"logits": float(np.abs(logits - want).max() / np.abs(want).max())}
    for k, got in (("loss", loss), ("ce", metrics["ce"]),
                   ("aux", metrics["aux"])):
        out[k] = abs(float(got) - float(extras[k])) / abs(float(extras[k]))
    for k, v in out.items():
        if not v <= max(RECORD_REL, sens[k]):
            raise AssertionError(f"MoE record {k}: {v:.3g} from JAX, bound "
                                 f"{max(RECORD_REL, sens[k]):.3g}")
    with _Drops() as served:
        out["served"], out["served_bound"], out["greedy_compared"] = \
            lm_record_check(model, rec)
    drops = {"forward": fwd.log[:L], "prefill": served.log[:L],
             "decode": np.reshape(served.log[L:L + n * L], (n, L)).tolist()}
    for k, got in drops.items():
        if not np.array_equal(got, extras[f"{k}_drops"]):
            raise AssertionError(f"MoE record: {k} drops {got}, JAX's "
                                 f"{extras[f'{k}_drops'].tolist()}")
    out["drops"] = drops
    return out


def mixtral_cfg(layers=None, **kw):
    """mixtral-8x22b at full width, ``layers`` deep (MIXTRAL_LAYERS when
    None), fields ``kw`` replaced."""
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(MIXTRAL), n_layers=layers
                               or MIXTRAL_LAYERS, **kw)


def jamba_cfg(layers=None, **kw):
    """jamba-v0.1-52b at full width, ``layers`` deep (JAMBA_LAYERS when
    None), fields ``kw`` replaced."""
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(JAMBA), n_layers=layers
                               or JAMBA_LAYERS, **kw)


def deepseek_cfg(layers=None, **kw):
    """deepseek-v2-236b at full width, ``layers`` deep (the dense prefix
    and MoE layers; DEEPSEEK_LAYERS when None), fields ``kw`` replaced."""
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(DEEPSEEK), n_layers=layers
                               or DEEPSEEK_LAYERS, **kw)


# each MoE model's serve call: (config, requests, prompt tokens, greedy
# tokens); its parity's depth and no-drop factor; its JAX record's loader
MOE_CALLS = {
    MIXTRAL: (mixtral_cfg, MIXTRAL_REQUESTS, MIXTRAL_PROMPT, MIXTRAL_GEN),
    DEEPSEEK: (deepseek_cfg, DEEPSEEK_REQUESTS, DEEPSEEK_PROMPT,
               DEEPSEEK_GEN),
    JAMBA: (jamba_cfg, JAMBA_REQUESTS, JAMBA_PROMPT, JAMBA_GEN)}
MOE_PARITY = {MIXTRAL: (MIXTRAL_PARITY_LAYERS, NODROP_FACTOR),
              DEEPSEEK: (DEEPSEEK_PARITY_LAYERS, DEEPSEEK_NODROP_FACTOR),
              JAMBA: (JAMBA_PARITY_LAYERS, JAMBA_NODROP_FACTOR)}
MOE_RECORD = {MIXTRAL: "load_lm_moe_reference",
              DEEPSEEK: "load_lm_mla_reference",
              JAMBA: "load_lm_hybrid_reference"}


def moe_serve_call(arch, device):
    """The serve call of ``moe_serve_phase`` on a model built anew from
    the same seeds, for the profile phase: (model, prompts, call)."""
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.serve.engine import generate

    cfg_of, requests, prompt, gen = MOE_CALLS[arch]
    cfg = cfg_of()
    model = build_model(cfg, device, seed=0)
    prompts = make_prompts(cfg, requests, prompt, seed=1, device=device)
    return model, prompts, lambda: generate(model, prompts, gen)


def mixtral_serve_call(device):
    return moe_serve_call(MIXTRAL, device)


def moe_rows_f32(p, m, xt, idx, w, keep, rows):
    """The MoE output of tokens ``rows`` of ``xt`` in float32 on the CPU,
    given the routing (idx, w, keep): each kept choice's expert in
    float32 (``moe._expert_ffn`` on float32 weights), weighted and summed."""
    import torch

    from repro_torch.models import moe

    x = xt[rows].float()
    idx, w, keep = idx[rows], w[rows], keep[rows]
    out = torch.zeros(x.shape, dtype=torch.float32)
    for e in torch.unique(idx[keep]).tolist():
        r, j = ((idx == e) & keep).nonzero(as_tuple=True)
        y = moe._expert_ffn(*(p[k][e:e + 1].cpu().float()
                              for k in ("w_gate", "w_up", "w_down")),
                            x[r][None])[0]
        out.index_add_(0, r, y * w[r, j, None])
    return out


def routing_check(p, m, x, label, n_rows=None, arch=MIXTRAL):
    """One layer's MoE on the card against the CPU port, on the input
    ``x`` that the serve call gave it: the float32 router logits, each
    within the a-priori bound of two float32 sums of d products (2 d
    2^-24 sum |x w|); the choices (a differing one must be a near tie by
    what the run measures: where the card's k-th choice is a and the CPU's
    b, P[b] - P[a] <= dP[a] + max dP of the row, P the CPU probabilities
    and dP their difference from the card's; a correct top-k on the card
    always meets this, since some expert v ranked at or above b on the CPU
    ranks at or below a on the card, so P[b] - P[a] <= P[v] - P[a] <=
    dP[a] + dP[v]); the weights where the choices agree, within what the logits' difference moves them (a
    top-k weight moves at most half the largest logit move of its row,
    plus 1e-6 of rounding); the CPU's ``sort_dispatch`` of the card's
    choices (slot and keep bit-equal to the card's); and the card's bf16
    output against the CPU port's float32 on that routing (all tokens, or
    ``n_rows`` drawn ones whose choices agree; MOE_BF16_REL).  Returns the
    readings."""
    import torch

    from repro_torch.models import moe

    xt = x.reshape(-1, x.shape[-1])
    t, e = xt.shape[0], m.n_experts
    cap = moe._capacity(t, m)
    w_card, idx_card, aux_card = moe.router_topk(p["router"], m, xt)
    _, slot_card, keep_card = moe.sort_dispatch(xt, idx_card, e, cap)
    y_card = moe._moe_local(p, m, xt)[0].float().cpu()
    logits_card = xt.float() @ p["router"]
    probs_card = torch.softmax(logits_card, dim=-1).cpu()
    logits_card = logits_card.cpu()
    torch.cuda.synchronize()
    idx_card, w_card, slot_card, keep_card = (
        a.cpu() for a in (idx_card, w_card, slot_card, keep_card))

    xt_cpu, router = xt.cpu(), p["router"].cpu()
    w_cpu, idx_cpu, aux_cpu = moe.router_topk(router, m, xt_cpu)
    logits = xt_cpu.float() @ router
    probs = torch.softmax(logits, dim=-1)
    dlogit = (logits_card - logits).abs()
    sum_bound = (2 * xt.shape[-1] * 2.0 ** -24
                 * (xt_cpu.double().abs() @ router.double().abs()))
    logit_of_bound = float((dlogit / sum_bound).max())
    w_bound = 0.5 * dlogit.max(dim=-1).values[:, None] + 1e-6
    dprob = (probs_card - probs).abs()
    r, j = (idx_card != idx_cpu).nonzero(as_tuple=True)
    a, b_ = idx_card[r, j], idx_cpu[r, j]
    gap = probs[r, b_] - probs[r, a]
    tie_bound = dprob[r, a] + dprob[r].max(dim=-1).values
    near = gap <= tie_bound
    agree = (idx_card == idx_cpu).all(dim=-1)
    w_of_bound = (float(((w_card - w_cpu).abs() / w_bound)[agree].max())
                  if agree.any() else 0.0)
    _, slot_cpu, keep_cpu = moe.sort_dispatch(xt_cpu[:, :1], idx_card, e, cap)
    dispatch_equal = (torch.equal(slot_cpu, slot_card)
                      and torch.equal(keep_cpu, keep_card))

    if n_rows is None:
        rows = torch.arange(t)
    else:
        gen = torch.Generator().manual_seed(6)
        pool = agree.nonzero()[:, 0]
        rows = pool[torch.randperm(len(pool), generator=gen)[:n_rows]]
        dropped = ((~keep_card).any(-1) & agree).nonzero()[:, 0]
        rows = torch.cat([rows, dropped[:4]])      # a few with a drop
    want = moe_rows_f32(p, m, xt_cpu, idx_card, w_cpu, keep_card, rows)
    got = y_card[rows]
    err = (got - want).abs()
    bound = MOE_BF16_REL * float(want.abs().max()) + MOE_BF16_REL * want.abs()
    worst = float((err / bound).max())
    print(f"{arch} routing {label} ({t} tokens, capacity {cap}): "
          f"{len(r)} of {idx_card.numel()} choices differ from the CPU "
          f"port's, {int(near.sum())} of them near ties (CPU "
          f"probabilities {[f'{float(g):.3g}' for g in gap[:8]]} apart, "
          f"bounds {[f'{float(u):.3g}' for u in tie_bound[:8]]} from the "
          f"card's differences); logits within "
          f"{float(dlogit.max()):.3g}"
          f" ({logit_of_bound:.3g} of their float32 sums' bound, max |logit| "
          f"{float(logits.abs().max()):.4g}); top_w where the choices agree "
          f"within {float((w_card - w_cpu)[agree].abs().max()):.3g} "
          f"({w_of_bound:.3g} of the bound the logits give); aux {float(aux_card):.6g}"
          f" (CPU {float(aux_cpu):.6g}); sort_dispatch on the CPU of the "
          f"card's choices: slot and keep "
          f"{'bit-equal' if dispatch_equal else 'DIFFER'}, "
          f"{int((~keep_card).sum())} of {keep_card.numel()} dropped; the "
          f"layer's bf16 output on {len(rows)} tokens within "
          f"{float(err.max()):.4g} of the CPU port's float32 (max |float32| "
          f"{float(want.abs().max()):.4g}; {worst:.3g} of the bound "
          f"{MOE_BF16_REL:g} max + {MOE_BF16_REL:g} |x|)", flush=True)
    if not near.all():
        raise AssertionError(f"{arch} routing {label}: a differing choice "
                             "is not a near tie")
    if not (logit_of_bound <= 1.0 and w_of_bound <= 1.0 and dispatch_equal
            and worst <= 1.0):
        raise AssertionError(f"{arch} routing {label}: logits "
                             f"{logit_of_bound:.3g} and weights "
                             f"{w_of_bound:.3g} of their bounds, dispatch "
                             f"equal {dispatch_equal}, output {worst:.3g} of "
                             "its bound")
    return {"differ": len(r), "near_ties": int(near.sum()),
            "logits": logit_of_bound, "weights": w_of_bound,
            "out_of_bound": worst}


def moe_serve_phase(probes, device, arch):
    """One MoE model at full width, bf16, weights drawn on the card (seed
    0): a serve call (``MOE_CALLS[arch]``: prompts of seed 1, greedy
    tokens) that launches ``flash_attention`` exactly once a layer, all
    in prefill (mixtral's window binding); every logit finite; ``stream``
    == ``generate``; prefill and per-token decode times (host clock,
    median of 3), peak memory; the decode cache's entries and bytes a
    layer; the assignments each MoE layer drops in the prefill and in one
    decode step; routing on the card against the CPU port at the last
    layer, on the MoE inputs of the prefill and of that decode step.
    Then the flash row (7m, 7mla, 7j) at the inputs of the prefill's
    first flash launch.  Returns (kernel rows, {"serve_ms", "prefill_ms",
    "mamba": (the last Mamba layer's parameters in float32 on the card,
    its prefill input, its index), or None without Mamba layers}).  With
    Mamba layers the serve call's transient memory is held below one
    (b, s, d_inner, d_state) float32 tensor: the scan builds none."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import moe, ssm
    from repro_torch.serve.engine import stream

    _cfg, requests, prompt, gen = MOE_CALLS[arch]
    t0 = time.perf_counter()
    model, prompts, serve = moe_serve_call(arch, device)
    cfg = model.cfg
    m = cfg.moe
    n_moe = sum(kind[1] == "moe" for kind in model.kinds)
    n_attn = sum(kind[0] == "attn" for kind in model.kinds)
    mamba_at = [i for i, kind in enumerate(model.kinds) if kind[0] == "mamba"]
    window = cfg.window if cfg.attn_type == "swa" else None
    torch.cuda.synchronize()
    print(f"{arch}: {cfg.n_layers} of {get_config(arch).n_layers} "
          f"layers ({cfg.first_dense} dense, {n_moe} MoE, {n_attn} "
          f"attention, {len(mamba_at)} Mamba), "
          f"{model.n_params() / 1e9:.3f} B parameters "
          f"({model.n_active_params() / 1e9:.3f} B active a "
          f"token) in {cfg.param_dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    toks = serve()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    probe = model.layers[-1].mlp
    mixer = model.layers[mamba_at[-1]].mixer if mamba_at else None
    with _Drops() as drops, _Inputs(moe, "moe_ffn", probe) as moe_in, \
            _Inputs(ssm, "mamba_mixer", mixer) as mamba_in:
        _build.reset_launches()
        _logits, cache = model.prefill(prompts)
        torch.cuda.synchronize()
        prefill_counts, prefill_drops = dict(_build.launches), list(drops.log)
        cache = model.pad_cache(cache, gen)
        entries = {}                    # the first layer of each mixer kind
        for kind, c in zip(model.kinds, cache):
            entries.setdefault(kind[0], (
                {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                 for k, v in c.items()},
                sum(v.numel() * v.element_size() for v in c.values())))
        _build.reset_launches()
        drops.log.clear()
        model.decode_step(toks[:, :1], cache, prompt)
        torch.cuda.synchronize()
        decode_counts, decode_drops = dict(_build.launches), list(drops.log)
    del cache, _logits
    print(f"{arch} serve call launches {counts}, prefill alone "
          f"{prefill_counts}, a decode step {decode_counts}; the decode "
          "cache a layer: " + "; ".join(
              f"{kind} {entry}, {n} bytes ({n / 2 ** 20:.1f} MiB)"
              for kind, (entry, n) in entries.items())
          + f"; assignments dropped a MoE "
          f"layer: prefill {prefill_drops} of {requests * prompt * m.top_k} "
          f"(capacity {moe._capacity(requests * prompt, m)} an expert),"
          f" a decode step {decode_drops} of {requests * m.top_k} "
          f"(capacity {moe._capacity(requests, m)})", flush=True)
    want = {"flash_attention": n_attn}
    want_cache = {"attn": ({"ckv", "krope"} if cfg.attn_type == "mla"
                           else {"k", "v"}), "mamba": {"conv", "ssm"}}
    if (counts != want or prefill_counts != want or any(decode_counts.values())
            or len(prefill_drops) != n_moe or len(decode_drops) != n_moe
            or any(set(entry) != want_cache[kind]
                   for kind, (entry, _n) in entries.items())):
        raise AssertionError(f"{arch}: launches {counts} a serve call, "
                             f"{prefill_counts} in prefill, {decode_counts} "
                             f"in a decode step; expected {want}, all in "
                             f"prefill; {len(prefill_drops)} and "
                             f"{len(decode_drops)} MoE dispatches of "
                             f"{n_moe}; cache entries {entries}")
    if mamba_at:
        mc = cfg.mamba
        whole = 4 * requests * prompt * mc.expand * cfg.d_model * mc.d_state
        print(f"{arch}: the serve call's transient "
              f"{(peak - resident) / 2 ** 30:.2f} GiB above the resident; one "
              f"(b, s, d_inner, d_state) float32 tensor {whole / 2 ** 30:.2f}"
              " GiB", flush=True)
        if peak - resident >= whole:
            raise AssertionError(f"{arch}: the serve call's transient "
                                 f"{peak - resident} bytes, not below one "
                                 f"whole scan tensor of {whole}")

    with _Capture(flash_ops, "flash_attention") as cap:
        steps = list(stream(model, prompts, gen))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(lg).all()) for _t, lg in steps)
    same = torch.equal(torch.stack([t for t, _lg in steps], 1), toks)
    del steps
    if not finite or not same:
        raise AssertionError(f"{arch}: finite logits {finite}, stream == "
                             f"generate {same}")

    prefill_ms = host_ms(lambda: model.prefill(prompts), reps=3)
    serve_ms = host_ms(serve, reps=3)
    decode_ms = (serve_ms - prefill_ms) / (gen - 1)
    print(f"{arch} serve ({requests} x {prompt} prompt tokens"
          + ("" if window is None else f", window {window}")
          + f", {gen} greedy tokens): prefill {prefill_ms:.3f} ms, decode "
          f"{decode_ms:.3f} ms per token, serve call {serve_ms:.3f} ms = "
          f"{1e3 * requests * gen / serve_ms:.1f} generated "
          f"tokens/s (host clock, median of 3); peak {peak / 2 ** 30:.2f} GiB"
          f" ({resident / 2 ** 30:.2f} GiB resident before the call); every "
          "logit finite, stream == generate", flush=True)

    x_prefill, x_decode = moe_in.xs
    routing_check(probe, m, x_decode, f"layer {cfg.n_layers - 1}, decode "
                  "step", arch=arch)
    routing_check(probe, m, x_prefill, f"layer {cfg.n_layers - 1}, prefill",
                  n_rows=MOE_ROWS, arch=arch)
    mamba = None
    if mamba_at:
        mamba = ({k: v.detach().float() for k, v in mixer.items()},
                 mamba_in.xs[0], mamba_at[-1])
    del model, prompts, serve, x_prefill, x_decode, moe_in, mamba_in, probe
    del mixer
    free_card()
    q, k, v = cap.args
    del cap
    shape = "x".join(map(str, q.shape)) + f"/{k.shape[2]}"
    if v.shape[-1] != q.shape[-1]:
        shape += f" dv {v.shape[-1]}"
    rows = flash_row(probes, q, k, v, want["flash_attention"], FLASH_TOL,
                     FLASH_TOL, window=window, o_rel=FLASH_O_REL,
                     label=f"{arch.split('-')[0]} prefill {shape}"
                     + ("" if window is None else f" window {window}"))
    del q, k, v
    free_card()
    return rows, {"serve_ms": serve_ms, "prefill_ms": prefill_ms,
                  "mamba": mamba}


def mla_drawn_rows(probes, device):
    """The MLA flash pair off the path: drawn unit-normal inputs at
    DEEPSEEK_RAGGED (batch, a prompt ragged against the tiles, heads),
    keys of 192 and values of 128, in bf16 (FLASH_32K_ATOL + RTOL |x|)
    and float32 (FLASH_F32_TOL): the float32 kernel's MLA tiling."""
    import torch

    b, s, H = DEEPSEEK_RAGGED
    gen = torch.Generator(device=device).manual_seed(6)
    q, k, v = (torch.randn((b, s, H, w), device=device, generator=gen)
               .to(torch.bfloat16) for w in (192, 192, 128))
    rows = flash_row(probes, q, k, v, 0, FLASH_32K_ATOL, FLASH_32K_RTOL,
                     f32=True, label=f"{b}x{s}x{H}x192 dv 128")
    del q, k, v
    free_card()
    return rows


def moe_parity_phase(device, arch):
    """Full width, ``MOE_PARITY[arch]`` layers deep, float32, the
    reference's stacked init: prefill (kernel) + decode steps (plain)
    against the full forward (kernel) at the no-drop capacity factor,
    where nothing drops, within PARITY_REL of the largest |logit|, E
    printed beside it; then the same weights at the published 1.25 with
    the assignments dropped, printed and not held: the capacity depends
    on how many tokens a call routes, so the forward, the prefill and a
    decode step drop differently, in the reference too."""
    import torch

    from repro_torch.models.transformer import layer_kinds

    L, factor = MOE_PARITY[arch]
    cfg_of = MOE_CALLS[arch][0]
    nodrop = cfg_of(L, param_dtype=torch.float32)
    nodrop = dataclasses.replace(nodrop, moe=dataclasses.replace(
        nodrop.moe, capacity_factor=factor))
    n = sum(kind[1] == "moe" for kind in layer_kinds(nodrop))   # MoE layers
    depth = f"{L} layers, B={PARITY_B}, S={PARITY_S} + {PARITY_EXTRA}"

    with _Drops() as drops:
        steps, top, sens = parity_reading(nodrop, device)
    free_card()
    rel = max(steps) if steps is not None else float("inf")
    print(f"{arch} float32, {depth}, capacity factor {factor:g}, the "
          f"reference's stacked init ({sum(drops.log)} assignments dropped "
          f"in all): prefill/decode vs forward rel {rel:.3g} of max |logit| "
          f"{top:.4g} (per step {[f'{e:.3g}' for e in steps or []]}); "
          f"bound {PARITY_REL:g}; one-ulp sensitivity E {sens:.3g}",
          flush=True)
    if rel >= PARITY_REL or sum(drops.log):
        raise AssertionError(f"{arch}: prefill/decode diverge from the "
                             f"forward ({rel:.3g} >= {PARITY_REL:g}) or "
                             f"{sum(drops.log)} assignments dropped")
    published = cfg_of(L, param_dtype=torch.float32)
    with _Drops() as drops:
        steps, top, sens = parity_reading(published, device)
    free_card()
    log = drops.log
    print(f"{arch} float32, {depth}, the reference's stacked init, the "
          f"published capacity factor {published.moe.capacity_factor:g} (not "
          f"held: capacity depends on the call's token count): prefill/decode"
          f" vs forward per step {[f'{e:.3g}' for e in steps or []]} of max "
          f"|logit| {top:.4g}; assignments dropped a MoE layer: forward "
          f"{log[:n]}, prefill {log[n:2 * n]}, decode steps "
          f"{[log[i:i + n] for i in range(2 * n, (2 + PARITY_EXTRA) * n, n)]}"
          f"; E {sens:.3g}", flush=True)


def moe_record_phase(device, arch):
    """The arch's JAX record (``assets/lm_moe_reference.npz``,
    ``lm_mla_reference.npz``) on the card through the kernels in float32
    (``moe_record_check``)."""
    import torch

    from repro_torch import bridge
    from repro_torch.kernels import _build

    rec, extras = getattr(bridge, MOE_RECORD[arch])()
    model = bridge.lm_params_from(bridge.numpy_lm_params(rec.cfg, rec.seed),
                                  rec.cfg, device=device)
    _build.reset_launches()
    r = moe_record_check(model, rec, extras)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    if counts.get("flash_attention", 0) < 1:
        raise AssertionError(f"{arch} record: flash_attention never "
                             f"launched: {counts}")
    e = extras["sensitivity"]
    cfg = rec.cfg
    shape = ("" if cfg.attn_type != "swa" else f", window {cfg.window}")
    if cfg.attn_type == "mla":
        shape = (f", MLA {cfg.mla.qk_nope} + {cfg.mla.qk_rope} / "
                 f"{cfg.mla.v_dim} over a latent of {cfg.mla.kv_lora}, "
                 f"{cfg.n_heads} heads")
    if cfg.mixer == "mamba":
        shape = (f", Mamba d_state {cfg.mamba.d_state}, attention at layers "
                 f"{[i for i, k in enumerate(model.kinds) if k[0] == 'attn']}"
                 f" ({cfg.n_heads}/{cfg.n_kv} heads of {cfg.d_head})")
    print(f"JAX record {arch} ({cfg.n_layers} layers, "
          f"{rec.prompts.shape[0]} x {rec.prompts.shape[1]} tokens{shape}, "
          f"capacity factor {cfg.moe.capacity_factor:g}"
          f", float32): forward logits within {r['logits']:.3g} (E "
          f"{e['logits']:.3g}); loss {r['loss']:.3g}, ce {r['ce']:.3g}, aux "
          f"{r['aux']:.3g} (E {e['loss']:.3g}, {e['ce']:.3g}, {e['aux']:.3g});"
          f" served logits {r['served']:.3g} (bound {r['served_bound']:.3g});"
          f" {r['greedy_compared']} of {rec.greedy.size} greedy tokens "
          f"compared, all equal; drops equal to JAX's: forward "
          f"{r['drops']['forward']}, prefill {r['drops']['prefill']}, decode "
          f"steps {sum(map(sum, r['drops']['decode']))} in all; launches "
          f"{counts}", flush=True)


def adamw_slices_check(device):
    """``adamw_update`` in slices of ``optimizer.SLICE`` elements against
    the same update with the slice patched to the whole leaf, from the
    same state and bf16 gradient of one ADAMW_SLICE_SHAPE leaf: the new
    bf16 parameters, the master and both moments bit for bit."""
    import torch

    from repro_torch.train import optimizer as opt

    shape = ADAMW_SLICE_SHAPE
    gen = torch.Generator(device=device).manual_seed(5)

    def draw(scale):
        return torch.randn(shape, device=device, generator=gen) * scale

    param, mu, nu, grad = draw(1.0).bfloat16(), draw(1e-3), draw(1e-3), \
        draw(1.0).bfloat16()
    nu.square_()
    cfg = opt.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2, decay_steps=12)
    ends, slices = [], opt.SLICE
    for size in (grad.numel(), slices):
        state = opt.OptState(
            step=torch.tensor(3, dtype=torch.int32, device=device),
            master={"w": param.float()}, mu={"w": mu.clone()},
            nu={"w": nu.clone()})
        out = {"w": param.clone()}
        opt.SLICE = size
        try:
            opt.adamw_update(cfg, {"w": grad.clone()}, state, torch.bfloat16,
                             out=out)
        finally:
            opt.SLICE = slices
        ends.append((out["w"], state.master["w"], state.mu["w"],
                     state.nu["w"]))
        del state, out
    same = [_bits_equal(a, b) for a, b in zip(*ends)]
    if not all(same):
        raise AssertionError(f"sliced adamw_update differs from the "
                             f"whole-leaf one (params, master, mu, nu): "
                             f"{same}")
    print(f"adamw_update on one {shape[0]} x {shape[1]} leaf "
          f"({grad.numel():,} elements) in {-(-grad.numel() // slices)} "
          f"slices of {slices:,} == the whole-leaf update, bit for bit: "
          "bf16 parameters, master, first and second moments", flush=True)


def select_backward_check(cfg, device, step_ms):
    """The expert loop's ``w[i]`` under autograd (``models.moe.
    _expert_ffn``): each expert's select backward makes a zero tensor the
    size of the whole (n_experts, d, f) leaf, and the leaf's gradient
    sums n_experts of them.  On one such bf16 leaf the experts' gradients
    go back through the selects and, for comparison, through ``unbind``
    (one stacked buffer); the two gradients are compared and each is timed
    by CUDA events, three leaves a MoE layer against the training step."""
    import torch

    from repro_torch.models.transformer import layer_kinds

    m = cfg.moe
    e, d, f = m.n_experts, cfg.d_model, m.d_ff_expert
    w = torch.zeros((e, d, f), dtype=cfg.param_dtype, device=device,
                    requires_grad=True)
    gen = torch.Generator(device=device).manual_seed(4)
    gs = [torch.randn((d, f), device=device, generator=gen).to(w.dtype)
          for _ in range(e)]

    def selects():
        return torch.autograd.grad([w[i] for i in range(e)], w, gs)[0]

    def unbound():
        return torch.autograd.grad(list(w.unbind(0)), w, gs)[0]

    equal = torch.equal(selects(), unbound())
    sel_ms = device_ms(selects, reps=5, warm=1)
    unb_ms = device_ms(unbound, reps=5, warm=1)
    layers = sum(kind[1] == "moe" for kind in layer_kinds(cfg))
    per_step = 3 * layers * sel_ms
    print(f"select backward of one ({e}, {d}, {f}) {str(w.dtype)[6:]} expert "
          f"leaf: {sel_ms:.4f} ms through {e} selects, {unb_ms:.4f} ms "
          f"through unbind (CUDA events, mean of 5); gradients equal: "
          f"{equal}; {3 * layers} such leaves a step: {per_step:.4f} ms, "
          f"{100 * per_step / step_ms:.2f}% of the {step_ms:.3f} ms step "
          f"(unbind would save {3 * layers * (sel_ms - unb_ms):.4f} ms)",
          flush=True)


def mixtral_train_phase(probes, device="cuda"):
    """MoE training: mixtral-8x22b through ``train.loop.train`` at
    MIXTRAL_TRAIN_LAYERS of 56 layers at full width (``lm_train_run``),
    row 7gm at layer 0's step-1 backward inputs, the sliced AdamW on the
    card, the select backward's cost and the JAX MoE training record.
    Returns (row 7gm, the profile target)."""
    import torch

    from repro_torch.bridge import load_lm_moe_train_reference

    r, args = lm_train_run(MIXTRAL, device, layers=MIXTRAL_TRAIN_LAYERS,
                           steps=MIXTRAL_TRAIN_STEPS,
                           ckpt_every=MIXTRAL_TRAIN_CKPT_EVERY,
                           fail_at=MIXTRAL_TRAIN_FAIL_AT)
    row = flash_bwd_row(probes, args, r["launches"]["flash_attention_bwd"],
                        "mixtral")
    del args
    free_card()
    adamw_slices_check(device)
    free_card()
    select_backward_check(mixtral_cfg(MIXTRAL_TRAIN_LAYERS), device,
                          r["step_ms"])
    free_card()
    lm_train_record_phase(device, {"mixtral": load_lm_moe_train_reference()})
    torch.cuda.empty_cache()
    target = (f"{MIXTRAL} training step ({MIXTRAL_TRAIN_LAYERS} layer)",
              Deferred(lambda: train_step_target(
                  MIXTRAL, device, layers=MIXTRAL_TRAIN_LAYERS)),
              r["step_ms"])
    return row, target


def mixtral_phase(probes, device="cuda"):
    """The MoE slice: the serve call, routing on the card, row 7m, float32
    parity and the JAX record; then MoE training (``mixtral_train_phase``).
    Returns (kernel rows, profile targets)."""
    t0 = time.perf_counter()
    rows, times = moe_serve_phase(probes, device, MIXTRAL)
    moe_parity_phase(device, MIXTRAL)
    moe_record_phase(device, MIXTRAL)
    free_card()
    train_row, train_target = mixtral_train_phase(probes, device)
    rows.append(train_row)
    free_card()
    targets = [(f"{MIXTRAL} serve call ({MIXTRAL_LAYERS} layers)",
                Deferred(lambda: mixtral_serve_call(device)[-1]),
                times["serve_ms"]), train_target]
    print(f"mixtral phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, targets


def mla_bwd_f32_row(probes, device):
    """Row 7hmla: the float32 backward (``tf32x3`` at MLA's tiles) on drawn
    unit-normal inputs at DEEPSEEK_RAGGED (batch, a prompt ragged against
    the tiles, 32 heads), keys of 192 and values of 128, causal, against
    the plain backward given the plain forward's O and log-sum-exp
    (FLASH_BWD_F32_TOL of max |plain|), timed beside SDPA's efficient
    backward; bound as row 7h's: the products as 3xTF32 at 495 TFLOP/s.
    Off the path (the training step is bf16): no launches counted."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as fcuda

    b, s, H = DEEPSEEK_RAGGED
    gen = torch.Generator(device=device).manual_seed(7)
    q, k, v = (torch.randn((b, s, H, w), device=device, generator=gen)
               for w in (192, 192, 128))
    o, lse = fcuda.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.randn(o.shape, device=device, generator=gen)
    args = (q, k, v, o, dout, lse)
    label = f"7hmla {b}x{s}x{H}x192 dv 128 float32"
    err, plain = flash_bwd_check(*args, f"{label} (drawn)",
                                 f32_tol=FLASH_BWD_F32_TOL)
    plain_ms = device_ms(plain, reps=1, warm=0)
    lib_ms, lib_fn = sdpa_backward_ms(q, k, v, dout)
    n_bytes, n_ops = flash_bwd_bytes_ops(q, k, v, lse)
    row = kernel_row(
        probes, "flash_attention_bwd", _bwd_module("flash_attention_bwd"), 0,
        err, lambda: fcuda.flash_attention_bwd_cuda(*args), plain_ms, lib_ms,
        n_bytes, 3 * n_ops, PEAK_TF32_OPS_S, reps=3, shape=label,
        library_fn=lib_fn, kernel=("flash_attention_bwd", 2))
    row["backward_of"] = "row 7"
    row["kernel"] = FLASH_BWD_KERNEL["float32"]
    print(f"flash_attention_bwd 7hmla: bound {row['bound_ms']:.4f} ms "
          "(3xTF32 at 495 TFLOP/s); the float32 CUDA cores' "
          f"{1e3 * n_ops / PEAK_F32_OPS_S:.4f} ms (67 TFLOP/s)", flush=True)
    return row


def deepseek_train_phase(probes, device="cuda"):
    """MLA training: deepseek-v2-236b through ``train.loop.train`` at
    DEEPSEEK_TRAIN_LAYERS of 60 layers at full width (``lm_train_run``:
    the dense MLA prefix layer with its SwiGLU FFN; a second layer is a
    MoE layer of ~4.05 B parameters, ~60 GiB of training state, which one
    card cannot hold beside the first), mixtral's MIXTRAL_TRAIN_* steps,
    checkpoints and failure; row 7gmla at layer 0's step-1 backward inputs
    (d 192, dv 128), row 7hmla, and the JAX MLA training record (float32:
    the float32 kernels at MLA's pair, its backward too).  Returns (rows,
    readings)."""
    from repro_torch.bridge import load_lm_mla_train_reference

    r, args = lm_train_run(DEEPSEEK, device, layers=DEEPSEEK_TRAIN_LAYERS,
                           steps=MIXTRAL_TRAIN_STEPS,
                           ckpt_every=MIXTRAL_TRAIN_CKPT_EVERY,
                           fail_at=MIXTRAL_TRAIN_FAIL_AT)
    rows = [flash_bwd_row(probes, args, r["launches"]["flash_attention_bwd"],
                          "7gmla deepseek")]
    del args
    free_card()
    rows.append(mla_bwd_f32_row(probes, device))
    free_card()
    lm_train_record_phase(device,
                          {"deepseek": load_lm_mla_train_reference()})
    free_card()
    return rows, r


def deepseek_phase(probes, device="cuda"):
    """The MLA slice: deepseek-v2-236b's serve call at DEEPSEEK_LAYERS of
    60 layers (the dense prefix and MoE layers), routing on the card, row
    7mla at the prefill's first flash inputs, the MLA pair on drawn
    ragged inputs in bf16 and float32, the float32 parity and the JAX
    record; then MLA training (``deepseek_train_phase``).  Returns (kernel
    rows, profile targets)."""
    t0 = time.perf_counter()
    rows, times = moe_serve_phase(probes, device, DEEPSEEK)
    rows += mla_drawn_rows(probes, device)
    moe_parity_phase(device, DEEPSEEK)
    moe_record_phase(device, DEEPSEEK)
    free_card()
    train_rows, r = deepseek_train_phase(probes, device)
    rows += train_rows
    targets = [(f"{DEEPSEEK} serve call ({DEEPSEEK_LAYERS} layers)",
                Deferred(lambda: moe_serve_call(DEEPSEEK, device)[-1]),
                times["serve_ms"]),
               (f"{DEEPSEEK} training step ({DEEPSEEK_TRAIN_LAYERS} layer)",
                Deferred(lambda: train_step_target(
                    DEEPSEEK, device, layers=DEEPSEEK_TRAIN_LAYERS)),
                r["step_ms"])]
    print(f"deepseek phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, targets


def mamba_f64(p, cfg, x):
    """The Mamba mixer over a full sequence from the zero state in float64
    (the reference's operations without its float32 roundings), on the
    CPU -> (out, final ssm state); differentiable (``mamba_grad_check``
    takes its gradients)."""
    import torch
    import torch.nn.functional as F

    m = cfg.mamba
    p = {k: v.double() for k, v in p.items()}
    x = x.double()
    b, s, _d = x.shape
    xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xpad = torch.cat([xi.new_zeros((b, m.d_conv - 1, xi.shape[-1])), xi], 1)
    xc = F.silu(sum(xpad[:, i:i + s] * p["conv_w"][i]
                    for i in range(m.d_conv)) + p["conv_b"])
    dt, B, C = (xc @ p["x_proj"]).split([m.dt_rank, m.d_state, m.d_state], -1)

    def rms(v, w):
        return v * torch.rsqrt(v.square().mean(-1, keepdim=True)
                               + cfg.norm_eps) * w

    dt, B, C = rms(dt, p["dt_norm"]), rms(B, p["b_norm"]), rms(C, p["c_norm"])
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h = x.new_zeros((b, xc.shape[-1], m.d_state))
    ys = []
    # each step's operands by unbind: under autograd a select's backward
    # would fill a zero tensor of the whole sequence a step
    for d_t, B_t, xc_t, C_t in zip(delta.unbind(1), B.unbind(1),
                                   xc.unbind(1), C.unbind(1)):
        h = (torch.exp(d_t[..., None] * A) * h
             + d_t[..., None] * B_t[:, None, :] * xc_t[..., None])
        ys.append((h * C_t[:, None, :]).sum(-1))
    y = (torch.stack(ys, 1) + p["D"] * xc) * F.silu(z)
    return y @ p["out_proj"], h


def mamba_layer_check(cfg, p, x, layer):
    """The Mamba layer on the card against the CPU port, in float32, on the
    serve call's own prefill input ``x`` of layer ``layer`` (its bf16
    weights ``p`` in float32): the card's output and final state for all
    requests, the CPU port's for the first MAMBA_CPU_ROWS, and a float64
    evaluation of those (``mamba_f64``).  Both float32 runs round every
    operation of the same computation; the card may lie MAMBA_MARGIN
    times as far from float64 as the CPU port does, so the two are held
    within (1 + MAMBA_MARGIN) D of each other, D the CPU port's own
    distance from float64, each relative to the float64 answer's largest
    entry (the card's own distance printed beside it).  Then the chunked
    scan on the card against the unchunked one, bit for bit, on the
    layer's own scan inputs at JAMBA_SCAN_B x JAMBA_SCAN_S (ragged against
    the chunk of JAMBA_SCAN_CHUNK).  Returns the readings."""
    import torch

    from repro_torch.models import ssm

    cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    seen = []
    scan = ssm._mamba_scan

    def spy(*args, **kw):
        seen.append(args[:5])
        return scan(*args, **kw)

    t0 = time.perf_counter()
    ssm._mamba_scan = spy
    try:
        with torch.no_grad():
            out, st = ssm.mamba_mixer(p, cfg, cfg.mamba, x.float())
        torch.cuda.synchronize()
    finally:
        ssm._mamba_scan = scan
    card_s = time.perf_counter() - t0
    rows = slice(0, MAMBA_CPU_ROWS)
    got = {"out": out[rows].cpu(), "ssm": st["ssm"][rows].cpu()}
    del out, st
    pc = {k: v.cpu() for k, v in p.items()}
    xc = x[rows].float().cpu()
    t0 = time.perf_counter()
    with torch.no_grad():
        out, st = ssm.mamba_mixer(pc, cfg, cfg.mamba, xc)
        cpu = {"out": out, "ssm": st["ssm"]}
        exact = dict(zip(("out", "ssm"), mamba_f64(pc, cfg, xc)))
    cpu_s = time.perf_counter() - t0
    read = {}
    for k in ("out", "ssm"):
        top = float(exact[k].abs().max())
        d_cpu = float((cpu[k].double() - exact[k]).abs().max()) / top
        d_card = float((got[k].double() - exact[k]).abs().max()) / top
        diff = float((got[k].double() - cpu[k].double()).abs().max()) / top
        read[k] = (diff, (1 + MAMBA_MARGIN) * d_cpu, d_card, d_cpu, top)
        finite = bool(torch.isfinite(got[k]).all())
        print(f"{JAMBA} Mamba layer {layer} float32 {k} "
              f"({tuple(x.shape[:2])} on the card, {MAMBA_CPU_ROWS} on the "
              f"CPU): card vs CPU port {diff:.3g} of max |float64| {top:.4g},"
              f" bound (1 + {MAMBA_MARGIN}) x {d_cpu:.3g} = "
              f"{read[k][1]:.3g} (the CPU port's distance from float64); "
              f"the card's own {d_card:.3g}; finite {finite}", flush=True)
        if not finite or diff > read[k][1]:
            raise AssertionError(f"{JAMBA} Mamba layer {layer} {k}: card vs "
                                 f"CPU {diff:.3g}, bound {read[k][1]:.3g}")
    print(f"{JAMBA} Mamba layer {layer}: {card_s:.2f} s on the card, "
          f"{cpu_s:.2f} s on the CPU (float32 and float64)", flush=True)

    b, n, c = JAMBA_SCAN_B, JAMBA_SCAN_S, JAMBA_SCAN_CHUNK
    args = [a[:b, :n].contiguous() if a.dim() == 3 else a for a in seen[0]]
    del seen
    y1, h1 = ssm._mamba_scan(*args, chunk=c)
    y2, h2 = ssm._mamba_scan(*args, chunk=n)
    equal = torch.equal(y1, y2) and torch.equal(h1, h2)
    print(f"{JAMBA} scan on the card at {b} x {n} of layer {layer}'s inputs: "
          f"chunks of {c} (the last {n % c}) vs one chunk of {n}: "
          f"{'bit-equal' if equal else 'DIFFER'}", flush=True)
    if not equal:
        raise AssertionError(f"{JAMBA}: the chunked scan differs from the "
                             "unchunked one")
    return read


def _mixer_inputs(params, cfg, m, x, *rest):
    """What ``_LastCall`` keeps of a ``models.ssm.mamba_mixer`` call: its
    parameters and its input, detached clones."""
    return ({k: v.detach().clone() for k, v in params.items()},
            x.detach().clone())


def scan_selects(delta, A, B, xc, C, h0=None, chunk=None):
    """The scan's form before its chunks were checkpointed: plain autograd
    through the chunks, each step's operands read by a select, ``dA[:,
    t]`` and ``Bx[:, t]``, whose backward fills a zero tensor of the whole
    chunk buffer and adds it; the forward's operations and bits are
    ``models.ssm._mamba_scan``'s."""
    import torch

    from repro_torch.models import ssm

    b, s, di = delta.shape
    chunk = ssm.mamba_chunk(b, di, A.shape[-1]) if chunk is None else chunk
    h = (torch.zeros((b, di, A.shape[-1]), dtype=torch.float32,
                     device=delta.device) if h0 is None else h0)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        dA = torch.exp(delta[:, sl, :, None] * A)
        Bx = (delta[:, sl, :, None] * B[:, sl, None, :]) * xc[:, sl, :, None]
        hs = []
        for t in range(dA.shape[1]):
            h = torch.addcmul(Bx[:, t], dA[:, t], h)
            hs.append(h)
        del dA, Bx
        ys.append((torch.stack(hs, dim=1) * C[:, sl, None, :]).sum(-1))
    return torch.cat(ys, dim=1), h


def scan_backward_check(cfg, p, x, device):
    """The scan's backward on the card, on layer 0's own scan inputs at
    step 1 (the mixer rerun on its step-1 input ``x`` and weights ``p``,
    bf16 as in the run, without grad) cut to JAMBA_SCAN_B x JAMBA_SCAN_S,
    in chunks of JAMBA_SCAN_CHUNK, with drawn cotangents on y and on the
    last state: ``models.ssm._mamba_scan`` (a checkpoint a chunk, steps by
    ``unbind``) against ``scan_selects``, its form before, every gradient
    (delta, A, B, xc, C) equal under ``torch.equal``.  Each form's
    backward timed by CUDA events (median of SCAN_BWD_REPS, each after a
    forward of its own) and its peak memory above what was allocated
    before its forward.  Returns the readings."""
    import torch

    from repro_torch.models import ssm

    seen = []
    scan = ssm._mamba_scan

    def spy(*args, **kw):
        seen.append(args[:5])
        return scan(*args, **kw)

    b, n, c = JAMBA_SCAN_B, JAMBA_SCAN_S, JAMBA_SCAN_CHUNK
    ssm._mamba_scan = spy
    try:
        with torch.no_grad():
            ssm.mamba_mixer(p, cfg, cfg.mamba, x[:b])
    finally:
        ssm._mamba_scan = scan
    args = [a[:b, :n].contiguous() if a.dim() == 3 else a for a in seen[0]]
    del seen
    gen = torch.Generator(device=device).manual_seed(10)
    gy = torch.randn(args[0].shape, device=device, generator=gen)
    gh = torch.randn((b, *args[1].shape), device=device, generator=gen)
    read, grads = {}, {}
    for name, form in (("checkpointed", ssm._mamba_scan),
                       ("selects", scan_selects)):
        times, peaks = [], []
        for _ in range(SCAN_BWD_REPS):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            leaves = [a.clone().requires_grad_() for a in args]
            y, h = form(*leaves, chunk=c)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            g = torch.autograd.grad((y, h), leaves, (gy, gh))
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            peaks.append(torch.cuda.max_memory_allocated() - base)
            del leaves, y, h
        grads[name] = g
        read[name] = (statistics.median(times), max(peaks))
        del g
    equal = [torch.equal(a, b_) for a, b_ in zip(grads["checkpointed"],
                                                 grads["selects"])]
    zero = [float(a.abs().max()) == 0 for a in grads["checkpointed"]]
    (ck_ms, ck_peak), (sel_ms, sel_peak) = (read["checkpointed"],
                                            read["selects"])
    print(f"{JAMBA} scan backward on the card at {b} x {n} of layer 0's "
          f"step-1 inputs, chunks of {c} (the last {n % c}): checkpointed "
          f"(unbind) {ck_ms:.4f} ms, peak {ck_peak / 2 ** 30:.3f} GiB; the "
          f"earlier form (selects, no checkpoints) {sel_ms:.4f} ms, peak "
          f"{sel_peak / 2 ** 30:.3f} GiB (CUDA events, median of "
          f"{SCAN_BWD_REPS}; peak above the memory before the forward); "
          f"gradients of delta, A, B, xc, C equal: {equal}", flush=True)
    if not all(equal) or any(zero):
        raise AssertionError(f"{JAMBA}: the checkpointed scan's gradients "
                             f"differ from the earlier form's {equal} or "
                             f"are zero {zero}")
    return {"ms": ck_ms, "peak": ck_peak, "selects_ms": sel_ms,
            "selects_peak": sel_peak}


def mamba_grad_check(cfg, p, x, device):
    """Layer 0's gradients in float32, card against CPU: the mixer on the
    first MAMBA_GRAD_ROWS request of its step-1 input ``x`` (2048 tokens)
    with its step-1 weights ``p`` in float32, the objective out . P + h_s
    . Q (P, Q drawn); the gradient of the input and of every leaf on the
    card, in the CPU port and in float64 autograd (``mamba_f64``).  Both
    float32 runs round every operation of the same computation, the card's
    backward its ``addcmul``s and products too; the card may lie
    MAMBA_MARGIN times as far from float64 as the CPU port does, so each
    gradient is held within (1 + MAMBA_MARGIN) D of the CPU port's, D the
    CPU port's own distance from float64, all relative to the float64
    gradient's largest entry.  Returns the readings."""
    import torch

    from repro_torch.models import ssm

    cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    m = cfg.mamba
    di = m.expand * cfg.d_model
    xr = x[:MAMBA_GRAD_ROWS].float().cpu()
    pc = {k: v.float().cpu() for k, v in p.items()}
    gen = torch.Generator().manual_seed(8)
    P = torch.randn(xr.shape, generator=gen)
    Q = torch.randn((xr.shape[0], di, m.d_state), generator=gen)
    names = ["x"] + sorted(pc)

    def grads(params, xin, P, Q, f64=False):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        xl = xin.detach().clone().requires_grad_()
        if f64:
            out, h = mamba_f64(leaves, cfg, xl)
        else:
            out, st = ssm.mamba_mixer(leaves, cfg, m, xl)
            h = st["ssm"]
        loss = (out * P).sum() + (h * Q).sum()
        g = torch.autograd.grad(loss, [xl] + [leaves[k] for k in names[1:]])
        return {k: v.detach().cpu() for k, v in zip(names, g)}

    t0 = time.perf_counter()
    card = grads({k: v.to(device) for k, v in pc.items()}, xr.to(device),
                 P.to(device), Q.to(device))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = grads(pc, xr, P, Q)
    exact = grads({k: v.double() for k, v in pc.items()}, xr.double(),
                  P.double(), Q.double(), f64=True)
    cpu_s = time.perf_counter() - t0
    read, bad = {}, []
    for k in names:
        top = float(exact[k].abs().max())
        d_cpu = float((cpu[k].double() - exact[k]).abs().max()) / top
        d_card = float((card[k].double() - exact[k]).abs().max()) / top
        diff = float((card[k].double() - cpu[k].double()).abs().max()) / top
        finite = bool(torch.isfinite(card[k]).all())
        read[k] = (diff, (1 + MAMBA_MARGIN) * d_cpu, d_card, d_cpu, top)
        if not finite or not diff <= read[k][1]:
            bad.append(k)
    print(f"{JAMBA} Mamba layer 0 float32 gradients on {tuple(xr.shape[:2])}"
          f" of its step-1 input (card vs CPU port, of max |float64|, "
          f"bound (1 + {MAMBA_MARGIN}) x the CPU port's own distance from "
          f"float64; the card's own): " + "; ".join(
              f"{k} {r[0]:.3g} <= {r[1]:.3g} ({r[2]:.3g})"
              for k, r in read.items())
          + f"; {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU "
          f"(float32 and float64)", flush=True)
    if bad:
        raise AssertionError(f"{JAMBA} Mamba layer 0 gradients {bad}: card "
                             "vs CPU port outside (1 + MAMBA_MARGIN) D")
    return read


def jamba_attn_bwd_row(probes, device):
    """Row 7gj: the bf16 backward (``tensor_core``) at jamba's attention
    shape JAMBA_ATTN (32 query heads over 8 KV heads: a head group of 4,
    which no run of the path has), causal, on drawn unit-normal inputs,
    with the forward kernel's O and log-sum-exp (``flash_bwd_row``).  No
    timed path runs it: no launches counted."""
    import torch

    from repro_torch.kernels.flash_attention import cuda as fcuda

    b, s, H, KV, d = JAMBA_ATTN
    gen = torch.Generator(device=device).manual_seed(9)
    q, k, v = (torch.randn((b, s, heads, d), device=device,
                           generator=gen).bfloat16() for heads in (H, KV, KV))
    o, lse = fcuda.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.randn(q.shape, device=device, generator=gen).bfloat16()
    return flash_bwd_row(probes, (q, k, v, o, dout, lse), 0,
                         f"7gj {JAMBA} {H}/{KV} heads", source="drawn")


def jamba_train_phase(probes, device="cuda"):
    """Mamba training: jamba-v0.1-52b through ``train.loop.train`` at
    JAMBA_TRAIN_LAYERS of 32 layers at full width (``lm_train_run``:
    layer 0, Mamba with a SwiGLU FFN, and the embeddings; no flash launch),
    mixtral's MIXTRAL_TRAIN_* steps, checkpoints and failure, keeping
    layer 0's mixer weights and input at step 1; on those the scan's
    backward against its earlier form (``scan_backward_check``) and the
    layer's float32 gradients against the CPU port (``mamba_grad_check``);
    row 7gj; the JAX hybrid training record (float32: the float32 flash
    kernels forward and backward at (128, 128), a head group of 2), its
    launches held to the count predicted from its remat'd periods.
    Returns (rows, readings)."""
    from repro_torch.bridge import load_lm_hybrid_train_reference
    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer_kinds

    r, (p, x) = lm_train_run(
        JAMBA, device, layers=JAMBA_TRAIN_LAYERS, steps=MIXTRAL_TRAIN_STEPS,
        ckpt_every=MIXTRAL_TRAIN_CKPT_EVERY, fail_at=MIXTRAL_TRAIN_FAIL_AT,
        capture=(ssm, "mamba_mixer", _mixer_inputs))
    free_card()
    cfg = jamba_cfg(JAMBA_TRAIN_LAYERS)
    r["scan"] = scan_backward_check(cfg, p, x, device)
    free_card()
    r["grads"] = mamba_grad_check(cfg, p, x, device)
    del p, x
    free_card()
    rows = [jamba_attn_bwd_row(probes, device)]
    free_card()
    rec = load_lm_hybrid_train_reference()
    # a step: each attention layer's forward kernel in the forward and
    # again where remat recomputes its period, its backward kernel once
    attn = sum(kind[0] == "attn" for kind in layer_kinds(rec.cfg))
    want = {"flash_attention": (1 + rec.cfg.remat) * attn * rec.steps,
            "flash_attention_bwd": attn * rec.steps}
    lm_train_record_phase(device, {"jamba": rec}, want={"jamba": want})
    free_card()
    return rows, r


def jamba_phase(probes, device="cuda"):
    """The Mamba slice: jamba-v0.1-52b's serve call at JAMBA_LAYERS of 32
    layers (``moe_serve_phase``: one flash launch, routing, row 7j), the
    last Mamba layer on the card against the CPU port and the chunked
    scan against the unchunked one, the float32 parity and the JAX
    record; then Mamba training (``jamba_train_phase``).  Returns (kernel
    rows, profile targets: the serve call, its prefill and a training
    step)."""
    t0 = time.perf_counter()
    rows, times = moe_serve_phase(probes, device, JAMBA)
    p, x, layer = times.pop("mamba")
    mamba_layer_check(jamba_cfg(), p, x, layer)
    del p, x
    free_card()
    moe_parity_phase(device, JAMBA)
    moe_record_phase(device, JAMBA)
    free_card()
    train_rows, r = jamba_train_phase(probes, device)
    rows += train_rows

    def prefill_call():
        model, prompts, _serve = moe_serve_call(JAMBA, device)
        return lambda: model.prefill(prompts)

    targets = [(f"{JAMBA} serve call ({JAMBA_LAYERS} layers)",
                Deferred(lambda: moe_serve_call(JAMBA, device)[-1]),
                times["serve_ms"]),
               (f"{JAMBA} prefill ({JAMBA_LAYERS} layers)",
                Deferred(prefill_call), times["prefill_ms"]),
               (f"{JAMBA} training step ({JAMBA_TRAIN_LAYERS} layer)",
                Deferred(lambda: train_step_target(
                    JAMBA, device, layers=JAMBA_TRAIN_LAYERS)),
                r["step_ms"])]
    print(f"jamba phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, targets


def profile_phase(label, fn, wall_ms, sessions=1):
    """Device time by kernel over one call (torch.profiler), against the
    call's unprofiled wall time.  With ``sessions`` > 1 the call is
    profiled that many times, each session printed, and the call's span by
    CUDA events (after the sessions, so a diagnostic, not a reading) is
    printed beside them: a session whose busy time falls well short of the
    others' and of that span has lost kernel records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(sessions):
        # the card's activity alone: with the host's too, reading a serve
        # call's ~1e5 launches back takes minutes for the same kernels,
        # launches and busy time (benchmarks/torch_mixtral_probe.py)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            close_session()
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        tag = f" (session {session + 1} of {sessions})" if sessions > 1 else ""
        print(f"profile {label}{tag}: {len(kernels)} kernel names, "
              f"{sum(e.count for e in kernels)} launches, device busy "
              f"{busy:.4f} ms of {wall_ms:.4f} ms wall "
              f"({100 * busy / wall_ms:.1f}%)", flush=True)
        for e in top:
            print(f"  {e.self_device_time_total / 1e3:9.4f} ms  "
                  f"x{e.count:<4d} {e.key[:90]}", flush=True)
        del prof, kernels, top
    if sessions > 1:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        print(f"profile {label}: the call's span by CUDA events after the "
              f"sessions {start.elapsed_time(end):.4f} ms (a diagnostic of "
              "the capture, not a reading)", flush=True)


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
        close_session()
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
        if isinstance(library_fn, Deferred):  # a kept graph: built now
            row["library_device_ms"] = call_device_ms(library_fn.build())
            free_card()
        elif library_fn is not None:
            row["library_device_ms"] = call_device_ms(library_fn)
        if library_fn is not None:
            lib = (f"; library call {row['library_device_ms']:.4f} ms "
                   "(all its kernels)")
        print(f"kernel {label}: device time per launch "
              f"{row['device_ms']:.4f} ms{lib} (torch.profiler, 20 calls)",
              flush=True)
    # the probes hold the kernel rows' inputs (7mla's 4.3 GB among them):
    # free them before each model is built again for its profile
    probes.clear()
    free_card()
    for label, fn, wall in targets:
        if isinstance(fn, Deferred):        # one full-width model at a time
            fn = fn.build()
            # the training steps twice: one earlier run read the rwkv
            # step's kernels at half of the other runs' device time
            profile_phase(label, fn, wall,
                          sessions=2 if "training step" in label else 1)
            del fn
            free_card()
        else:
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
    frames_np, truth = security_video(**ref.video)
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
    rows.append(training_phase(ref, frames_np, truth, res, card, probes))

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
    free_card()
    train_rows, train_targets, readings = lm_train_phase(probes)
    rows += train_rows
    targets += train_targets
    free_card()
    compressed_rows, compressed_targets = compressed_train_phase(
        probes, readings[0])
    rows += compressed_rows
    targets += compressed_targets
    free_card()
    whisper_rows, whisper_targets, _whisper = whisper_phase(probes)
    rows += whisper_rows
    targets += whisper_targets
    free_card()
    mixtral_rows, mixtral_targets = mixtral_phase(probes)
    rows += mixtral_rows
    targets += mixtral_targets
    free_card()
    deepseek_rows, deepseek_targets = deepseek_phase(probes)
    rows += deepseek_rows
    targets += deepseek_targets
    free_card()
    jamba_rows, jamba_targets = jamba_phase(probes)
    rows += jamba_rows
    targets += jamba_targets
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
