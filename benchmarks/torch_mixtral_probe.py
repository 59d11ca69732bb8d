"""Two readings behind chip_smoke.py's mixtral phase, on one card.

    python3 benchmarks/torch_mixtral_probe.py [--only parity|profile]

``parity``: chip_smoke's float32 prefill/decode-vs-forward reading
(``parity_reading``: 2 x 1000 tokens + 4 decode steps, capacity factor 16,
so nothing drops) of mixtral-8x22b at full width, 2 and 4 layers deep, on
the reference's stacked init and on weights drawn as unstacked layers
(``unstacked_init_``), each with its one-ulp sensitivity E: how deep the
held reading can go before the random weights turn chaotic.

``profile``: one serve call of yi-9b and of mixtral (8 of 56 layers), each
under torch.profiler with the card's activity alone, with the host's too,
and alone again: kernel names, launches and busy time read by each, the
profiled call's wall time and the time ``key_averages`` takes to read the
session back (what chip_smoke's profile phase spends).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def parity():
    import torch

    import chip_smoke as cs

    for layers, unstacked in ((2, False), (4, False), (2, True), (4, True)):
        t0 = time.perf_counter()
        cfg = cs.mixtral_cfg(layers, param_dtype=torch.float32)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cs.NODROP_FACTOR))
        steps, top, sens = cs.parity_reading(cfg, "cuda", unstacked=unstacked)
        cs.free_card()
        init = "unstacked" if unstacked else "stacked"
        print(f"parity {layers} layers, {init} init: per step "
              f"{[f'{e:.3g}' for e in steps]} of max |logit| {top:.4g}; E "
              f"{sens:.3g} ({time.perf_counter() - t0:.1f} s)", flush=True)


def profile():
    import torch
    from torch.profiler import ProfilerActivity, profile as session

    import chip_smoke as cs

    def read(fn, acts):
        t0 = time.perf_counter()
        with session(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ks = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in ks) / 1e3
        names = "+".join(str(a).split(".")[-1] for a in acts)
        print(f"  {names}: {len(ks)} kernel names, "
              f"{sum(e.count for e in ks)} launches, device busy {busy:.4f} "
              f"ms; the call {t1 - t0:.1f} s, reading it back "
              f"{time.perf_counter() - t1:.1f} s", flush=True)

    card = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, build in (("yi-9b", lambda: cs.serve_call("yi-9b", "cuda")),
                         (cs.MIXTRAL,
                          lambda: cs.mixtral_serve_call("cuda")[-1])):
        fn = build()
        fn()
        torch.cuda.synchronize()
        print(f"{label} serve call:", flush=True)
        for acts in (card, both, card):
            read(fn, acts)
        del fn
        cs.free_card()


def main(argv=None):
    import chip_smoke as cs
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("parity", "profile"))
    args = ap.parse_args(argv)
    print(cs.gpu_name_and_power(), flush=True)
    _build.library()
    if args.only in (None, "parity"):
        parity()
    if args.only in (None, "profile"):
        profile()


if __name__ == "__main__":
    main()
