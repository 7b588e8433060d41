"""Device time of each pass of flash's backward kernels.

    python3 scripts/flash_bwd_passes.py [--calls 10]

``repro_flash_attention_backward`` launches, on the ``"mma"`` route, three
kernels a call: (a) ``flash_bwd_rows_kernel<.., false>`` (D = rowsum(P o
dP)), (b) ``flash_bwd_kv_kernel`` (dK, dV) and (c)
``flash_bwd_rows_kernel<.., true>`` (dQ); on the ``"hopper"`` route
(16-bit d 128 and 256) two: ``flash_bwd_hopper_dq_kernel`` (D, then dQ)
and ``flash_bwd_hopper_dkdv_kernel`` (dK, dV), each instantiated per head
dim.  At each training shape of
``chip_smoke.py`` phase 4b (``FLASH_BWD_TRAIN``: q / k / v and the
cotangent drawn on the card from a seed, the forward kernel's lse) this
profiles ``--calls`` calls with ``torch.profiler`` on the route
``flash_backward_route`` picks and, where that is the Hopper route, on
the ``"mma"`` route too (label ``_mma``): qwen3-14b's, command-r-35b's
and dbrx-132b's at d 128 and gemma3-4b's global layer at d 256 in
bfloat16 on both routes, the rest on the mma route.  It prints each
kernel's mean device ms a launch, their sum, and the share of the call
each pass takes, with the head dim, beside the card's name and power
limit (``nvidia-smi``).

Needs a CUDA card and nvcc; imports neither jax nor repro.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def _cases():
    """chip_smoke.py's FLASH_BWD_TRAIN: (label, shape, dtype name)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FLASH_BWD_TRAIN, module.RMS_DTYPES


def _pass_name(key: str) -> str:
    """A backward kernel's pass from its (mangled) name."""
    if "hopper_dq_kernel" in key:
        return "d_dq"
    if "hopper_dkdv_kernel" in key:
        return "dkdv"
    if "rows_kernel" in key:
        return "d" if "false" in key else "dq"
    return "dkdv" if "kv_kernel" in key else key[:40]


def _passes(call, calls: int) -> dict:
    """Mean device ms a launch of each kernel over ``calls`` profiled
    calls, after three warm-up calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {_pass_name(e.key): e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_passes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import set_float32_precision
    from repro_torch.kernels import flash_attention as FA
    set_float32_precision()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cases, dtypes = _cases()
    dev = torch.device("cuda")
    for label, (b, sq, sk, h, kv, d, causal, window), dt in cases:
        dtype = getattr(torch, dtypes[dt][0])
        gen = torch.Generator(device=dev).manual_seed(0)
        q, do = (torch.randn(b, sq, h, d, device=dev, generator=gen)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, sk, kv, d, device=dev, generator=gen)
                .to(dtype) for _ in range(2))
        scale = d ** -0.5
        _, lse = FA._attend(q, k, v, causal, window, scale)
        route = FA.flash_backward_route(q, k, v, do, scale)
        for forced in (None, "mma") if route == "hopper" else (None,):
            passes = _passes(
                lambda: FA._backward(q, k, v, lse, do, causal, window,
                                     scale, route=forced), args.calls)
            total = sum(passes.values())
            print(f"{label}_{dt}" + (f"_{forced}" if forced else "")
                  + f" route={forced or route} d={d}"
                  f" shape={[b, sq, sk, h, kv, d]}"
                  f" causal={causal} window={window} total_ms={total:.6f} "
                  + " ".join(f"{k}_ms={v:.6f} ({100 * v / total:.1f} %)"
                             for k, v in passes.items()), flush=True)
        del q, k, v, do, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
