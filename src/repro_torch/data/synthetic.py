"""Synthetic datasets (twin of ``repro.data.synthetic``).

CIFAR-like images: the reference's recipe — per-class templates from a
fixed seed, smoothed by a separable [0.25, 0.5, 0.25] blur, plus Gaussian
noise — drawn with numpy.  A bigram token stream for the LM lane, drawn
from a ``torch.Generator``.  The reference draws both with threefry
``jax.random``, which neither numpy nor torch can replay, so the *values*
differ from the reference's by construction; parity tests hand the
reference's arrays to both sides.  :func:`lm_batch_from_stream` is the
reference's numpy slicing, exact on the same stream.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

TEMPLATE_SEED = 20240911  # class templates are a fixed property of the task


def make_cifar_like(rng: np.random.Generator, n: int, n_classes: int = 10,
                    noise: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """(images (n,32,32,3) float32, labels (n,) int32)."""
    labels = rng.integers(0, n_classes, size=n)
    t = np.random.default_rng(TEMPLATE_SEED).normal(
        size=(n_classes, 32, 32, 3)) * 0.7
    for axis in (1, 2):
        t = (0.25 * np.roll(t, 1, axis) + 0.5 * t
             + 0.25 * np.roll(t, -1, axis))
    images = t[labels] + noise * rng.normal(size=(n, 32, 32, 3))
    return images.astype(np.float32), labels.astype(np.int32)


def make_bigram_lm(gen: torch.Generator, vocab: int, n_tokens: int,
                   temperature: float = 1.0) -> torch.Tensor:
    """Token stream (n_tokens,) int64 from a fixed random bigram table (a
    learnable LM task): logits ``N(0, 1) * 2 / temperature`` per previous
    token, starting after token 0.  The table and the uniforms come from
    ``gen``; the walk runs on the host."""
    logits = torch.randn((vocab, vocab), generator=gen,
                         device=gen.device) * 2.0 / temperature
    u = torch.rand((n_tokens,), generator=gen, device=gen.device,
                   dtype=torch.float64)
    cdf = torch.cumsum(torch.softmax(logits.double(), dim=-1), dim=-1)
    cdf, u = cdf.cpu().numpy(), u.cpu().numpy()
    toks = np.empty(n_tokens, np.int64)
    tok = 0
    for i in range(n_tokens):
        tok = min(int(np.searchsorted(cdf[tok], u[i], side="right")),
                  vocab - 1)
        toks[i] = tok
    return torch.from_numpy(toks)


def lm_batch_from_stream(stream, batch: int, seq: int,
                         step: int) -> Dict[str, torch.Tensor]:
    """Deterministic sliding batches from a token stream (wraps around):
    tokens and next-token labels (batch, seq) int64."""
    stream = np.asarray(stream.cpu() if isinstance(stream, torch.Tensor)
                        else stream)
    n = stream.shape[0]
    starts = (np.arange(batch) * seq + step * batch * seq) % max(n - seq - 1,
                                                                 1)
    toks = np.stack([stream[s:s + seq] for s in starts])
    labels = np.stack([stream[s + 1:s + seq + 1] for s in starts])
    return {"tokens": torch.from_numpy(toks.astype(np.int64)),
            "labels": torch.from_numpy(labels.astype(np.int64))}
