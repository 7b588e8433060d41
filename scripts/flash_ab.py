"""flash's 16-bit forward and backward kernels of two or more builds on one
card, in turns.

    git archive <commit> | tar -x -C build/<name>      # build/ is ignored
    python3 scripts/flash_ab.py build/parent . [--iters 20]
    python3 scripts/flash_ab.py . --variant name=-DMACRO=1

A build is a checkout, or a checkout with extra nvcc flags (``--variant
NAME=FLAGS`` adds the last checkout given built with FLAGS, e.g. a ``-D``
of a kernel's tiling macro).  Each build runs in a fresh process of its own,
in the order a b ... b a, builds and loads its own kernel library (into
``build/kernels`` of its checkout, named by a hash of the sources and
flags) and prints the Hopper kernels' ptxas report (registers, spills,
and any note that ptxas serialized their wgmma instructions).
Then, on q / k / v (and a cotangent) drawn on the card from a seed, at
phase 4b's timed 16-bit shapes of ``chip_smoke.py`` -- the forward at
smollm-360m's f16 prefill (d 64), qwen3-14b's in bf16 and f16,
command-r-35b's and dbrx-132b's training shape (d 128); the backward at
gemma3-4b's bf16 global and local training layers (d 256), qwen3-14b's
bf16 training shape (d 128) and smollm-360m's in f16 (d 64) -- it holds
each call on the route the build's rule picks, and on the ``mma`` route
forced, to the plain version (the forward within one ulp plus 1e-4 of
each value, the backward within one ulp plus 1e-4 of the largest
gradient), and times each with CUDA events over ``--iters`` calls after
three warm-up calls (ms a call).  It prints one ``AB`` JSON line a build
and case, and a summary a case and route over the builds, beside the
card's name and power limit (``nvidia-smi``).

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
checkout, name, flags, iters = (sys.argv[1], sys.argv[2],
                                 sys.argv[3].split(), int(sys.argv[4]))
sys.path.insert(0, os.path.join(checkout, "src"))
import numpy as np
import torch
from repro_torch.device import set_float32_precision
from repro_torch.kernels import _build
set_float32_precision()
_build.NVCC_FLAGS = (*_build.NVCC_FLAGS, *flags)
lib = _build.load()
import re
cur = None
for ln in lib.log.splitlines():
    if "Compiling entry function" in ln:
        m = re.search(r"(flash_[a-z_]+_kernel)I(\w+?)Li(\d+)E", ln)
        cur = f"{m[1]}<{m[2][-8:]},{m[3]}>" if m and "hopper" in ln else None
    elif cur is not None and ("registers" in ln or "spill" in ln
                              or "wgmma" in ln):
        print(f"PTXAS {name} {cur} {ln.strip()}", flush=True)
from repro_torch.kernels import flash_attention as FA

BF, F16 = torch.bfloat16, torch.float16
FWD = [("smollm_prefill_f16", (8, 1024, 1024, 15, 5, 64, True, 0), F16),
       ("qwen3_prefill_bf16", (8, 1024, 1024, 40, 8, 128, True, 0), BF),
       ("qwen3_prefill_f16", (8, 1024, 1024, 40, 8, 128, True, 0), F16),
       ("command_r_prefill_bf16", (8, 1024, 1024, 64, 8, 128, True, 0), BF),
       ("dbrx_train_bf16", (4, 1024, 1024, 48, 8, 128, True, 0), BF)]
BWD = [("gemma3_global_train_bf16", (4, 1024, 1024, 8, 4, 256, True, 0), BF),
       ("gemma3_local_train_bf16", (4, 1024, 1024, 8, 4, 256, True, 1024),
        BF),
       ("qwen3_train_bf16", (8, 1024, 1024, 40, 8, 128, True, 0), BF),
       ("smollm_train_f16", (8, 1024, 1024, 15, 5, 64, True, 0), F16)]


def randn(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()


def ulp(b):
    bits = {BF: 7, F16: 10}[b.dtype]
    _, e = torch.frexp(b.float().abs().clamp_min(torch.finfo(b.dtype).tiny))
    return torch.ldexp(torch.ones_like(b, dtype=torch.float32), e - 1 - bits)


def within(a, b, big=None):
    bound = 1e-4 * max(big, 1.0) if big is not None else (
        1e-4 + 1e-4 * b.float().abs())
    return bool(((a.float() - b.float()).abs() <= bound + ulp(b)).all())


def call_ms(fn):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def emit(kind, label, route, shape, ms, err, ok):
    print("AB " + json.dumps({"build": name, "kind": kind, "label": label,
                              "route": route, "shape": list(shape),
                              "ms": ms, "max_abs_err": err, "ok": ok}),
          flush=True)


for i, (label, shape, dtype) in enumerate(FWD):
    b, sq, sk, h, kv, d, causal, window = shape
    q, k, v = (randn(s, 10 * i + j).to(dtype) for j, s in enumerate(
        [(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)]))
    scale = d ** -0.5
    want = FA.attention_plain(q, k, v, causal=causal, window=window)
    rule = FA.flash_route(q, k, v, scale)
    for route in dict.fromkeys((rule, "mma")):
        fn = lambda r=route: FA._forward(q, k, v, causal, window, scale,
                                         route=r)
        got = fn()
        err = float((got.float() - want.float()).abs().max())
        ok = within(got, want) and torch.equal(got, fn())
        emit("fwd", label, route, shape, call_ms(fn), err, ok)
    del q, k, v, want
    torch.cuda.empty_cache()

for i, (label, shape, dtype) in enumerate(BWD):
    b, sq, sk, h, kv, d, causal, window = shape
    q, k, v, do = (randn(s, 100 + 10 * i + j).to(dtype) for j, s in
                   enumerate([(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                              (b, sq, h, d)]))
    scale = d ** -0.5
    _, lse = FA._attend(q, k, v, causal, window, scale)
    want = FA.attention_backward_plain(q, k, v, lse, do, causal=causal,
                                       window=window, scale=scale)
    big = max(float(w.float().abs().max()) for w in want)
    rule = FA.flash_backward_route(q, k, v, do, scale)
    for route in dict.fromkeys((rule, "mma")):
        fn = lambda r=route: FA._backward(q, k, v, lse, do, causal, window,
                                          scale, route=r)
        got = fn()
        err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
        ok = (all(within(a, w, big) for a, w in zip(got, want))
              and all(torch.equal(a, c) for a, c in zip(got, fn())))
        emit("bwd", label, route, shape, call_ms(fn), err, ok)
    del q, k, v, do, lse, want
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: the last checkout built with FLAGS")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    builds = [(os.path.abspath(c), c, "") for c in args.checkouts]
    for spec in args.variant:
        vname, _, flags = spec.partition("=")
        builds.append((builds[len(args.checkouts) - 1][0], vname, flags))
    rows, rc = [], 0
    for checkout, name, flags in builds + builds[::-1]:
        try:
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, checkout, name, flags,
                 str(args.iters)], capture_output=True, text=True,
                timeout=600)
        except subprocess.TimeoutExpired as e:
            print(f"{name}: timed out after {e.timeout} s\n{e.stdout}",
                  file=sys.stderr, flush=True)
            rc = 1
            continue
        for ln in proc.stdout.splitlines():
            if ln.startswith(("AB ", "PTXAS ")):
                print(ln, flush=True)
            if ln.startswith("AB "):
                rows.append(json.loads(ln[3:]))
        if proc.returncode != 0:
            rc = 1
            print(f"{name}: rc={proc.returncode}\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
    for kind, label, route in dict.fromkeys(
            (r["kind"], r["label"], r["route"]) for r in rows):
        got = {}
        for r in rows:
            if (r["kind"], r["label"], r["route"]) == (kind, label, route):
                got.setdefault(r["build"], []).append(r["ms"])
        print(f"SUMMARY {kind} {label} route={route} " + " ".join(
            f"{b}={'/'.join(f'{m:.6f}' for m in ms)}"
            for b, ms in got.items()), flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        print(f"outside tolerance: {bad}", file=sys.stderr, flush=True)
        rc = 1
    print(card, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
