"""Split-inference serving driver of the port (twin of
``repro.launch.serve``; paper §IV-C).

Prefill + batched decode with the model split at the cut layer: the
vehicle-side periods produce the smashed activations, the RSU-side periods
decode against their caches.  Runs on ``cuda`` unless ``--device cpu`` is
given (without a card it raises); ``--smoke`` serves the reduced config.
A vision arch's prompt is ``n_patches`` random patch embeddings (0.02 x a
normal draw) and ``prompt_len - n_patches`` text tokens; an audio arch's is
``codes`` (batch, K, prompt_len), and each decode step samples each of the
K codebooks.

    python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 8 --prompt-len 1024 --decode-steps 32
    python -m repro_torch.launch.serve --arch mamba2-780m --smoke \\
        --device cpu --prompt-len 32 --decode-steps 4 --batch 2
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import distributed as D
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg: ArchConfig, gen: torch.Generator, batch: int,
                 prompt_len: int) -> Dict[str, torch.Tensor]:
    """Random prompts drawn from ``gen`` on its device: ``tokens``, plus
    ``patch_embeds`` for vision; ``codes`` (b, K, s) for audio."""
    dev = gen.device
    if cfg.frontend == "audio":
        return {"codes": torch.randint(
            0, cfg.vocab_size, (batch, cfg.n_codebooks, prompt_len),
            generator=gen, device=dev)}
    if cfg.frontend == "vision":
        s_text = max(prompt_len - cfg.n_patches, 1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, s_text),
                               generator=gen, device=dev)
        patches = torch.randn((batch, cfg.n_patches, cfg.d_model),
                              generator=gen, device=dev)
        return {"tokens": tokens, "patch_embeds": 0.02 * patches}
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                    generator=gen, device=dev)}


def prompt_length(cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> int:
    """Positions a prefill of ``batch`` fills."""
    if cfg.frontend == "audio":
        return batch["codes"].shape[2]
    n = batch["tokens"].shape[1]
    return n + cfg.n_patches if "patch_embeds" in batch else n


def sample(cfg: ArchConfig, logits: torch.Tensor, gen: torch.Generator,
           temperature: float = 1.0) -> torch.Tensor:
    """One sampled id per row (per row and codebook for audio) from the
    last position's logits, clamped into the true vocab: (b,) or (b, K)."""
    last = logits[:, -1].float() / temperature       # (b, V) or (b, K, V)
    probs = torch.softmax(last.reshape(-1, last.shape[-1]), dim=-1)
    nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
    # padded-vocab safety: clamp into the true vocab
    return torch.clamp(nxt, max=cfg.vocab_size - 1).reshape(last.shape[:-1])


def step_batch(cfg: ArchConfig, nxt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A decode step's batch from the sampled ids: ``tokens`` (b, 1), or
    ``codes`` (b, K, 1) for audio."""
    if cfg.frontend == "audio":
        return {"codes": nxt[:, :, None]}
    return {"tokens": nxt[:, None]}


def serve(cfg: ArchConfig, params, *, batch: int, prompt_len: int,
          decode_steps: int, cut: Optional[int] = None,
          temperature: float = 1.0, seed: int = 0) -> Dict[str, Any]:
    """Serve one batch of random prompts (:func:`prompt_batch`): a
    prefill, then ``decode_steps`` sampled tokens.  ``params`` lie on the
    device to serve on.  Returns the prompt batch, the last logits, the
    sampled ids, the caches and the prefill / decode wall times (seconds,
    after a device synchronize)."""
    device = params["embed"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = prompt_batch(cfg, gen, batch, prompt_len)
    pos = prompt_length(cfg, prompt)
    capacity = pos + decode_steps
    opts = D.DistOptions(cut=cfg.default_cut if cut is None else cut)
    prefill = D.make_prefill_step(cfg, opts, capacity)
    decode = D.make_decode_step(cfg, opts, capacity)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompt)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tokens = []
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        nxt = sample(cfg, logits, gen, temperature)
        tokens.append(nxt)
        logits, caches = decode(params, step_batch(cfg, nxt), caches, pos)
        pos += 1
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"prompt": prompt, "logits": logits, "tokens": tokens,
            "caches": caches, "prefill_s": prefill_s, "decode_s": decode_s,
            "cut": opts.cut}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--cut", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    res = serve(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                decode_steps=args.decode_steps, cut=args.cut,
                temperature=args.temperature)
    print(f"[serve] {cfg.name} prefill({args.prompt_len}) -> logits "
          f"{tuple(res['logits'].shape)} in {res['prefill_s']:.2f}s")
    steps = max(args.decode_steps, 1)
    print(f"[serve] decoded {args.decode_steps} steps x batch {args.batch} "
          f"in {res['decode_s']:.2f}s "
          f"({res['decode_s'] / steps * 1e3:.1f} ms/step)")
    if res["tokens"]:
        print(f"[serve] first sampled ids: "
              f"{res['tokens'][0].flatten()[:8].tolist()}")
    tok_s = (args.batch * args.decode_steps / res["decode_s"]
             if res["decode_s"] > 0 else 0.0)
    print(f"[serve] device={device} cut={res['cut']} "
          f"prefill_ms={res['prefill_s'] * 1e3:.3f} "
          f"decode_ms_per_step={res['decode_s'] / steps * 1e3:.3f} "
          f"decode_tokens_per_s={tok_s:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
