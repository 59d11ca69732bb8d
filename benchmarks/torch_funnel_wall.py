#!/usr/bin/env python3
"""Wall time of the port's face-auth funnel, two source trees in turns.

    python3 benchmarks/torch_funnel_wall.py [--roots TREE [TREE ...]]
        [--turns N] [--reps N] [--json OUT]
    python3 benchmarks/torch_funnel_wall.py --haar-source FILE [--reps N]

For each tree (a checkout, or ``git archive`` of a commit unpacked into a
directory; default: this checkout), a process of its own imports that
tree's ``repro_torch``, builds its kernels, builds the full-width funnel
executor from its ``assets/fa_reference.npz`` as ``chip_smoke.py`` does,
and takes ``--reps`` host-clock readings of the S=1 call (``ex(frames)``,
the 62-frame batch) and of the S=64 call (``ex.run_streams`` over 64
shifted feeds), each call ended by a synchronize.  With two trees A and
B the processes run A B B A, ``--turns`` times over, one after the other,
so that both see the same card and host in the same session.  Prints one
line per process and, last, each tree's median, least and largest
reading over all its processes.

Processes of one tree differ by a quarter in their S=1 medians, so the
second form compares two Haar-stage kernels in one process: it builds
FILE (another ``haar_stage.cu``, say a parent commit's) beside this
checkout's kernel and takes the S=1 readings call by call in turns (A B B
A), the wrapper bound to one kernel and then the other; nothing else of
the funnel changes between the two.  Needs a CUDA card and the CUDA
toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = 64


def measure(root: str, reps: int, haar_source: str | None = None) -> dict:
    """One process's readings (ms) of the funnel of the tree at ``root``;
    with ``haar_source``, S=1 readings of this tree's Haar kernel and of
    that one's, in turns."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch.bridge import load_fa_reference
    from repro_torch.camera.pipelines import FaceAuthExecutor
    from repro_torch.camera.synthetic import security_video
    from repro_torch.kernels import _build

    _build.library()
    ref = load_fa_reference(device="cuda")
    frames_np, _truth = security_video(**ref.video)
    frames = torch.as_tensor(frames_np, device="cuda")
    ex = FaceAuthExecutor(ref.cascade, ref.nn, frames.shape[1],
                          frames.shape[2], device="cuda", **ref.scan)
    ex.calibrate(frames)
    streams = torch.stack([torch.roll(frames, 5 * s, dims=0)
                           for s in range(STREAMS)])

    def readings(fn, n):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    if haar_source is not None:
        from repro_torch.kernels.haar_frontend import cuda as hcuda
        from torch_kernel_variants import build

        own = hcuda._kernel()
        with open(haar_source) as f:
            alt = build("haar_alt", f.read(), _build._nvcc(),
                        _build.NVCC_FLAGS).repro_haar_stage
        alt.argtypes, alt.restype = own.argtypes, own.restype
        out = {"root": root, "haar_source": haar_source, "s1_ms": [],
               "s1_alt_ms": []}
        for i in range(reps):
            for key, fn in ((("s1_ms", own), ("s1_alt_ms", alt))
                            if i % 2 == 0 else
                            (("s1_alt_ms", alt), ("s1_ms", own))):
                hcuda._fn = fn
                out[key] += readings(lambda: ex(frames), 1)
        hcuda._fn = own
        return out
    return {"root": root, "s1_ms": readings(lambda: ex(frames), reps),
            f"s{STREAMS}_ms": readings(lambda: ex.run_streams(streams),
                                       reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[ROOT])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--json")
    ap.add_argument("--one", action="store_true",
                    help="measure the single root in this process")
    ap.add_argument("--haar-source",
                    help="a haar_stage.cu to time against this checkout's")
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.one:
        print(json.dumps(measure(roots[0], args.reps)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.haar_source:
        run = measure(ROOT, args.reps, os.path.abspath(args.haar_source))
        summary = {key: {"median": statistics.median(run[key]),
                         "min": min(run[key]), "max": max(run[key]),
                         "n": len(run[key])}
                   for key in ("s1_ms", "s1_alt_ms")}
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"card": card, "run": run, "summary": summary}, f,
                          indent=1)
        print(json.dumps(summary), flush=True)
        return 0

    order = []
    for _ in range(args.turns):
        order += roots + roots[::-1]
    runs = []
    for root in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--roots",
             root, "--reps", str(args.reps)],
            capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            raise RuntimeError(f"the process for {root} failed")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        run = runs[-1]
        print(f"{root}: S=1 median {statistics.median(run['s1_ms']):.4f} ms, "
              f"S={STREAMS} median "
              f"{statistics.median(run[f's{STREAMS}_ms']):.4f} ms "
              f"({args.reps} readings each)", flush=True)
    summary = {}
    for root in roots:
        mine = [r for r in runs if r["root"] == root]
        summary[root] = {}
        for key in ("s1_ms", f"s{STREAMS}_ms"):
            vals = [v for r in mine for v in r[key]]
            summary[root][key] = {"median": statistics.median(vals),
                                  "min": min(vals), "max": max(vals),
                                  "n": len(vals)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "runs": runs, "summary": summary}, f,
                      indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
