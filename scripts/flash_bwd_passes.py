"""Device time of each of the three passes of flash's backward kernel.

    python3 scripts/flash_bwd_passes.py [--calls 10]

``repro_flash_attention_backward`` launches three kernels a call: (a)
``flash_bwd_rows_kernel<.., false>`` (D = rowsum(P o dP)), (b)
``flash_bwd_kv_kernel`` (dK, dV) and (c) ``flash_bwd_rows_kernel<..,
true>`` (dQ).  At each training shape of ``chip_smoke.py`` phase 4b
(``FLASH_BWD_TRAIN``: q / k / v and the cotangent drawn on the card from
a seed, the forward kernel's lse) this profiles ``--calls`` calls with
``torch.profiler`` and prints each kernel's mean device ms a launch, their
sum, and the share of the call each pass takes, beside the card's name
and power limit (``nvidia-smi``).

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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
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
        for _ in range(3):
            FA._backward(q, k, v, lse, do, causal, window, scale)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                FA._backward(q, k, v, lse, do, causal, window, scale)
            torch.cuda.synchronize()
        passes = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = ("d" if "rows_kernel" in e.key and "false" in e.key
                    else "dq" if "rows_kernel" in e.key
                    else "dkdv" if "kv_kernel" in e.key else e.key[:40])
            passes[name] = e.self_device_time_total / e.count / 1e3
        total = sum(passes.values())
        print(f"{label}_{dt} shape={[b, sq, sk, h, kv, d]} causal={causal} "
              f"window={window} total_ms={total:.6f} "
              + " ".join(f"{k}_ms={v:.6f} ({100 * v / total:.1f} %)"
                         for k, v in passes.items()), flush=True)
        del q, k, v, do, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
