"""Train steps of two or more checkouts on one card, in turns.

    git archive <commit> | tar -x -C build/<name>      # build/ is ignored
    python3 scripts/train_ab.py build/a . [--steps 4]

Each checkout runs in a fresh process of its own, in the order a b ... b
a, and trains smollm-360m and mamba2-780m as ``chip_smoke.py`` phase 10g
does (``launch.train.train`` at full width and depth: batch 8, seq 1024,
adamw lr 3e-4, clip 1.0, remat, 4 clients, the default cut) for
``--steps`` steps.  It prints every step's seconds (step 0 pays the
first calls), the peak memory and, per arch, one more step's device time
(``torch.profiler``) in all and in kernels whose name holds ``rmsnorm``
(a plain backward's elementwise kernels show only in the total).
Each process builds and loads the kernel library of its own checkout.

Needs a CUDA card and nvcc; imports neither jax nor repro.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys
checkout, steps = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, os.path.join(checkout, "src"))
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.device import set_float32_precision
set_float32_precision()
from repro_torch.kernels import _build
_build.load()
from repro_torch.configs import get_config
from repro_torch.launch import train as TR
for arch in ("smollm-360m", "mamba2-780m"):
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    res = TR.train(cfg, steps=steps, batch=8, seq=1024, device="cuda")
    row = {"checkout": checkout, "arch": arch, "step_s": res["step_s"],
           "peak_gb": res["peak_bytes"] / 1e9}
    del res
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TR.train(cfg, steps=1, batch=8, seq=1024, device="cuda")
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    row["device_ms"] = sum(e.self_device_time_total for e in dev) / 1e3
    row["rmsnorm_kernels_ms"] = sum(
        e.self_device_time_total for e in dev if "rmsnorm" in e.key) / 1e3
    print("AB " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--steps", type=int, default=4,
                    help="train steps per process and arch")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rows = []
    for checkout in args.checkouts + args.checkouts[::-1]:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.abspath(checkout),
             str(args.steps)], capture_output=True, text=True, timeout=900)
        for ln in proc.stdout.splitlines():
            if ln.startswith("AB "):
                print(ln, flush=True)
                rows.append(json.loads(ln[3:]))
        if proc.returncode != 0:
            print(f"{checkout}: rc={proc.returncode}\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr, flush=True)
            return 1
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/train_ab.json", "w") as f:
        json.dump({"card": card, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
