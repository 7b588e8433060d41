"""Split inference with the PyTorch port (paper §IV-C): serve a decoder with
the model cut between 'vehicle' and 'RSU', batched requests, prefill +
greedy decode with KV / SSM caches (twin of ``examples/split_inference.py``).

Uses the reduced smollm-360m config by default (``--full`` serves the
published widths, ``--arch`` any ported arch); the prefill and decode steps
are ``repro_torch.core.distributed``'s, as ``repro_torch.launch.serve``
runs them.  The same requests run twice: with a float uplink and with the
int8 smashed-data codec (``compress_smashed``).  It prints the greedy ids,
the drift of the int8 run's logits from the float run's (the int8 run fed
the float run's ids, so both see the same tokens) and the uplink bytes a
decode step.  Runs on the CUDA card by default; ``--device cpu`` runs it
on the CPU.

  PYTHONPATH=src python examples/split_inference_torch.py --device cpu
  PYTHONPATH=src python examples/split_inference_torch.py --arch \\
      mamba2-780m --full --batch 8 --prompt-len 1024 --steps 32
  PYTHONPATH=src python examples/split_inference_torch.py --device cpu \\
      --dtype float16
"""
import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.core import split as SP
from repro_torch.device import resolve_device
from repro_torch.kernels.quant import GROUP
from repro_torch.launch import serve
from repro_torch.models import transformer as T


def greedy(cfg, logits):
    """The argmax over the true vocab at the last position: (b,) or
    (b, K) for audio."""
    return logits[:, -1, ..., :cfg.vocab_size].float().argmax(dim=-1)


def run(cfg, params, prompt, steps: int, cut: int, compress: bool,
        feed=None):
    """Prefill ``prompt`` and decode ``steps`` tokens greedily (or, with
    ``feed``, the given ids: teacher forcing).  Returns the ids decoded,
    the logits of every step and the wall time (after a synchronize)."""
    device = params["embed"].device
    pos = serve.prompt_length(cfg, prompt)
    opts = D.DistOptions(cut=cut, compress_smashed=compress)
    prefill = D.make_prefill_step(cfg, opts, pos + steps)
    decode = D.make_decode_step(cfg, opts, pos + steps)
    serve._sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompt)
    ids, all_logits = [], [logits]
    for i in range(steps):
        nxt = greedy(cfg, logits) if feed is None else feed[i]
        ids.append(nxt)
        logits, caches = decode(params, serve.step_batch(cfg, nxt), caches,
                                pos)
        all_logits.append(logits)
        pos += 1
    serve._sync(device)
    return ids, all_logits, time.perf_counter() - t0


def uplink_bytes(cfg, batch: int, dtype: torch.dtype):
    """Bytes of one decode step's smashed tensor (batch, 1, d_model) on the
    uplink: in the activations' dtype, and as int8 with one float32 scale
    per group of the codec."""
    n = batch * cfg.d_model
    scales = batch * math.ceil(cfg.d_model / min(GROUP, cfg.d_model))
    return n * torch.empty((), dtype=dtype).element_size(), n + 4 * scales


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced "
                         "config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--cut", type=int, default=2)
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16", "float16"],
                    help="parameter dtype (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch if args.full else args.arch + "-smoke")
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype)
    cut = SP.clamp_cut(cfg, args.cut)
    params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    prompt = serve.prompt_batch(cfg, torch.Generator(device=device)
                                .manual_seed(1), args.batch, args.prompt_len)
    print(f"== split inference: {cfg.name} ({cfg.param_dtype}) on {device}, "
          f"cut {cut} of {T.total_periods(cfg)} periods, {args.batch} "
          f"requests, prompt {args.prompt_len}, {args.steps} greedy steps ==")

    ids, ref_logits, wall = run(cfg, params, prompt, args.steps, cut, False)
    ids8, _, wall8 = run(cfg, params, prompt, args.steps, cut, True)
    # the int8 uplink on the float run's ids: the logits see the same tokens
    _, int8_logits, _ = run(cfg, params, prompt, args.steps, cut, True,
                            feed=ids)
    drift = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(int8_logits, ref_logits))
    scale = max(float(b.float().abs().max()) for b in ref_logits)
    first = [int(t.flatten()[0]) for t in ids]
    first8 = [int(t.flatten()[0]) for t in ids8]
    dt = params["embed"].dtype
    plain, packed = uplink_bytes(cfg, args.batch, dt)
    print(f"[{str(dt).split('.')[-1]} uplink] {args.steps} tokens x "
          f"{args.batch} requests in {wall:.2f}s -> ids[0]={first}")
    print(f"[int8 uplink    ] {args.steps} tokens x {args.batch} requests in "
          f"{wall8:.2f}s -> ids[0]={first8}")
    print(f"logits drift of the int8 uplink (same tokens): max |diff| "
          f"{drift:.3e} of max |logit| {scale:.3e}; greedy ids "
          f"{'agree' if first == first8 else 'differ'} in row 0")
    print(f"uplink per decode step: {plain} B vs int8 {packed} B "
          f"({plain / packed:.2f}x reduction)")
    return {"ids": first, "ids_int8": first8, "drift": drift,
            "max_logit": scale, "uplink_bytes": plain,
            "uplink_bytes_int8": packed, "cut": cut}


if __name__ == "__main__":
    main()
