"""Synthetic CIFAR-like images (twin of ``repro.data.synthetic``).

Same recipe as the reference — per-class templates from a fixed seed,
smoothed by a separable [0.25, 0.5, 0.25] blur, plus Gaussian noise — drawn
with numpy.  The reference draws with threefry ``jax.random``, which numpy
cannot replay, so the *values* differ from the reference's by construction;
parity tests hand the reference's arrays to both sides.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

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
