"""End-to-end sync-SFL training with the port (twin of
``repro.launch.train``).

Trains an LM arch with the model split at the cut: vehicle-side periods,
the smashed boundary (int8 under ``--compress``), RSU-side periods and
head, the |D_n|-weighted cross-entropy, global-norm clipping and adamw
(:func:`repro_torch.core.distributed.make_train_step`, which donates its
state: the loop rebinds ``state`` every step, as the reference's does, and
the optimizer writes the parameters and moments in place), on ``cuda``
unless ``--device cpu`` is given (without a card it raises).  Text, vision
(patch embeddings before the tokens; the loss on the text positions) and
audio (K codebooks in, each frame's K codes as its targets) archs train, in
their config's ``param_dtype``: qwen3-14b, command-r-35b and dbrx-132b in
bfloat16 (float32 moments; the MoE router float32), any arch in bfloat16
or float16 through ``dataclasses.replace(cfg, param_dtype="float16")``
passed to :func:`train` (mamba2-780m's SSD scan takes 16-bit inputs on the
card).  MLA and MoE archs (deepseek-v2-lite-16b, dbrx-132b) train with
their aux load-balance loss in the objective; parameters of another dtype
(float64, an integer type) are refused.
``--smoke`` trains the reduced config; without it the full config at
``--batch`` / ``--seq``.  The reference's mesh shapes (``--shape``,
``--multi-pod``) are not ported.

    python -m repro_torch.launch.train --arch smollm-360m --batch 8 \\
        --seq 1024 --steps 3
    python -m repro_torch.launch.train --arch qwen3-14b --smoke \\
        --device cpu --steps 2 --seq 32
    python -m repro_torch.launch.train --arch internvl2-1b --smoke \\
        --device cpu --steps 2 --seq 32
    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b \\
        --smoke --device cpu --steps 2 --seq 32
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import distributed as D
from repro_torch.device import resolve_device


def synth_batch(cfg: ArchConfig, gen: torch.Generator, batch: int, seq: int,
                n_clients: int) -> Dict[str, torch.Tensor]:
    """Synthetic federated LM batch of ``seq`` positions on the generator's
    device, the reference's shapes drawn from ``gen``: uniform ``tokens``
    and their next-token ``labels``; for vision ``n_patches`` patch
    embeddings (0.02 x a normal draw) before ``seq - n_patches`` tokens;
    for audio ``codes`` (b, K, seq) alone.  Heterogeneous |D_n| weights (a
    numpy power law, as in the paper's case study), ``batch // n_clients``
    rows per client."""
    dev = gen.device
    if cfg.frontend == "vision" and seq <= cfg.n_patches:
        raise ValueError(f"{cfg.name}: seq {seq} leaves no text after its "
                         f"{cfg.n_patches} patches")
    if cfg.frontend == "audio":
        out = {"codes": torch.randint(0, cfg.vocab_size,
                                      (batch, cfg.n_codebooks, seq),
                                      generator=gen, device=dev)}
    else:
        s_text = seq - (cfg.n_patches if cfg.frontend == "vision" else 0)
        toks = torch.randint(0, cfg.vocab_size, (batch, s_text + 1),
                             generator=gen, device=dev)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend == "vision":
            out["patch_embeds"] = 0.02 * torch.randn(
                (batch, cfg.n_patches, cfg.d_model), generator=gen,
                device=dev)
    sizes = np.arange(1, n_clients + 1, dtype=np.float32) ** -1.5
    w = np.repeat(sizes / sizes.sum(), batch // n_clients)
    out["weights"] = torch.as_tensor(w[:batch], device=dev)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          cut: Optional[int] = None, lr: float = 3e-4, n_clients: int = 4,
          compress: bool = False, device=None,
          on_step: Optional[Callable[[int, Dict[str, float]], None]] = None
          ) -> Dict[str, Any]:
    """Train ``steps`` sync-SFL steps (adamw, clip 1.0, remat) from fresh
    parameters drawn from seed 0 in ``cfg.param_dtype``, on synthetic
    batches (step i's tokens from a generator seeded i), each step the
    donated one (the state updated in place).  Returns the final state,
    the per-step metrics (floats), the per-step wall times (seconds, after
    a device synchronize), the cut and, on cuda, the peak allocated
    bytes."""
    dev = resolve_device(device)
    opts = D.DistOptions(cut=cfg.default_cut if cut is None else cut,
                         compress_smashed=compress, learning_rate=lr)
    state = D.init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                         opts)
    step_fn = D.make_train_step(cfg, opts)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics, step_s = [], []
    for i in range(steps):
        b = synth_batch(cfg, torch.Generator(device=dev).manual_seed(i),
                        batch, seq, n_clients)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        metrics.append(m)
        if on_step is not None:
            on_step(i, m)
    return {"state": state, "metrics": metrics, "step_s": step_s,
            "cut": opts.cut,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="the reference's mesh input shape (not ported)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cut", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-clients", type=int, default=4)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.shape is not None or args.multi_pod:
        raise NotImplementedError("--shape / --multi-pod needs the device "
                                  "mesh on torch.distributed, which is not "
                                  "ported yet")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    print(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"batch={args.batch} seq={args.seq}", flush=True)
    t0 = time.perf_counter()

    def log(i, m):
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"  step {i:4d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"aux={m['aux']:.6f} grad_norm={m['grad_norm']:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)

    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                cut=args.cut, lr=args.lr, n_clients=args.n_clients,
                compress=args.compress, device=args.device, on_step=log)
    print(f"[train] cut={res['cut']} device={res['state']['step'].device} "
          f"s_per_step={res['step_s']}", flush=True)
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps,
                               res["state"]["params"])
        print(f"[train] checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
