"""Decode and prefill of two or more checkouts on one card, in turns.

    git archive <commit> | tar -x -C build/<name>      # build/ is ignored
    python3 scripts/serve_ab.py build/a build/b . [--variants direct]

Each checkout runs in a fresh process of its own, in the order a b c ...
c b a, and serves each of the seven archs that ``chip_smoke.py`` phase 8
serves, as phase 8 does (full width and depth,
seed-0 weights, batch 8, prompt 1024, 32 decode steps, the default cut,
after a warm-up serve at prompt 64), ``--reps`` times per process (2 by
default).  An arch a checkout does not have (its ``get_config`` raises) is
skipped there and says so.  It prints prefill ms and decode ms per step of
each serve, then each (checkout, arch)'s smallest, median and largest, and
writes them all to ``chiprun_out/serve_ab.json``.
Each process builds and loads the kernel library of its own checkout.

``--variants direct`` adds a run of the last checkout in which the
rmsnorm wrapper calls the kernel without going through
``torch.autograd.Function``, to tell the Function's cost per call from the
rest of a decode step.

Needs a CUDA card and nvcc; imports neither jax nor repro.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ARCHS = ("smollm-360m", "mamba2-780m", "gemma3-4b", "recurrentgemma-2b",
         "internvl2-1b", "musicgen-large", "deepseek-v2-lite-16b")

CHILD = r"""
import json, os, sys, time
checkout, variant, reps = sys.argv[1], sys.argv[2], int(sys.argv[3])
archs = sys.argv[4:]
sys.path.insert(0, os.path.join(checkout, "src"))
import torch
from repro_torch.device import set_float32_precision
set_float32_precision()
from repro_torch.kernels import _build
_build.load()
if variant == "direct":
    from repro_torch.kernels import rmsnorm as K
    if hasattr(K, "_forward"):
        K.rmsnorm = lambda x, scale, eps=K.EPS: K._forward(x, scale, eps)
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
for arch in archs:
    try:
        cfg = get_config(arch)
    except (NotImplementedError, KeyError) as e:
        print("AB " + json.dumps({"checkout": checkout, "variant": variant,
                                  "arch": arch, "skipped": str(e)}),
              flush=True)
        continue
    dev = torch.device("cuda")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    serve.serve(cfg, params, batch=8, prompt_len=64, decode_steps=2)
    for rep in range(reps):
        res = serve.serve(cfg, params, batch=8, prompt_len=1024,
                          decode_steps=32)
        print("AB " + json.dumps({
            "checkout": checkout, "variant": variant, "arch": arch,
            "rep": rep, "prefill_ms": 1e3 * res["prefill_s"],
            "decode_ms_per_step": 1e3 * res["decode_s"] / 32}), flush=True)
    del params, res
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--variants", default="",
                    help="comma-separated extra variants (direct)")
    ap.add_argument("--reps", type=int, default=2,
                    help="serves per process and arch")
    args = ap.parse_args()
    variants = ["plain"] + [v for v in args.variants.split(",") if v]
    runs = [(c, "plain") for c in args.checkouts] \
        + [(args.checkouts[-1], v) for v in variants[1:]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rows = []
    for checkout, variant in runs + runs[::-1]:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.abspath(checkout),
             variant, str(args.reps), *ARCHS], capture_output=True,
            text=True, timeout=1800)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        for ln in lines:
            print(ln, flush=True)
            rows.append(json.loads(ln[3:]))
        if proc.returncode != 0:
            print(f"{checkout} {variant}: rc={proc.returncode}\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr, flush=True)
            return 1
    summary = {}
    for r in rows:
        if "skipped" not in r:
            key = f"{r['checkout']} {r['variant']} {r['arch']}"
            for m in ("prefill_ms", "decode_ms_per_step"):
                summary.setdefault(key, {}).setdefault(m, []).append(r[m])
    for key, ms in summary.items():
        for m, v in ms.items():
            ms[m] = {"n": len(v), "min": min(v),
                     "median": statistics.median(v), "max": max(v)}
        print("SUMMARY " + json.dumps({"run": key, **ms}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/serve_ab.json", "w") as f:
        json.dump({"card": card, "runs": rows, "summary": summary}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
