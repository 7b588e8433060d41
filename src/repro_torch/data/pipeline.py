"""Per-client data pipeline (twin of ``repro.data.pipeline``).

The batch-index streams are numpy and replay the reference exactly.  Shards
stay host numpy arrays; the cohort engine stages them on its device once
(:func:`stack_clients`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.partition import label_skew_power_law
from repro_torch.data.synthetic import make_cifar_like


def sample_batch_indices(n_items: int, batch_size: int, seed: int
                         ) -> np.ndarray:
    """One client batch: ``batch_size`` indices drawn from a seeded numpy
    generator (with replacement only when the shard is smaller)."""
    rng = np.random.default_rng(seed)
    return rng.choice(n_items, size=batch_size, replace=n_items < batch_size)


def fleet_batch_indices(lengths, steps: int, batch_size: int,
                        seed: int) -> np.ndarray:
    """Whole-fleet batch staging in one numpy draw: (steps, n, batch)
    uniform indices modulo each vehicle's shard length (the scenario
    engine's index stream; always with replacement)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    u = np.random.default_rng(seed).random((steps, len(lengths), batch_size))
    return (u * lengths[None, :, None]).astype(np.int32)


def epoch_batch_indices(n_items: int, batch_size: int, seed: int
                        ) -> np.ndarray:
    """Full-batch permutation epoch (drop remainder) as (n_full, batch)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_items)
    n_full = n_items // batch_size
    return order[:n_full * batch_size].reshape(n_full, batch_size)


@dataclasses.dataclass
class ClientDataset:
    images: np.ndarray   # (n, ...) features
    labels: np.ndarray   # (n,)
    client_id: int

    def __len__(self) -> int:
        return len(self.labels)


@dataclasses.dataclass
class StackedClients:
    """All client shards padded to a common length and stacked on a leading
    client axis, resident on one device.  Padding rows are never indexed:
    batch index streams are drawn modulo each client's true length."""
    images: torch.Tensor   # (n_clients, max_len, ...)
    labels: torch.Tensor   # (n_clients, max_len)
    lengths: np.ndarray    # (n_clients,)


def feature_dtype(images) -> type:
    """Features are staged as float32; token ids stay integers, as
    int64."""
    return (np.int64 if np.issubdtype(np.asarray(images).dtype, np.integer)
            else np.float32)


def stack_clients(clients, device: torch.device) -> StackedClients:
    """Features as :func:`feature_dtype`, labels as int64 with their
    trailing shape ((n,) per row, (n, seq) per token)."""
    n = len(clients)
    lengths = np.array([len(c) for c in clients], dtype=np.int64)
    max_len = int(lengths.max())
    img_shape = clients[0].images.shape[1:]
    lab_shape = clients[0].labels.shape[1:]
    images = np.zeros((n, max_len) + img_shape,
                      dtype=feature_dtype(clients[0].images))
    labels = np.zeros((n, max_len) + lab_shape, dtype=np.int64)
    for i, c in enumerate(clients):
        images[i, :lengths[i]] = c.images
        labels[i, :lengths[i]] = c.labels
    return StackedClients(torch.from_numpy(images).to(device),
                          torch.from_numpy(labels).to(device), lengths)


def make_federated_data(seed: int, n_train: int = 4096, n_test: int = 1024,
                        n_clients: int = 4, iid: bool = False,
                        labels_per_client: int = 6):
    """The paper's case-study data: CIFAR-like, 4 vehicles, 6-of-10 labels,
    power-law sizes (non-IID) or uniform (IID).

    Same recipe as the reference, but the images come from
    :func:`make_cifar_like`'s numpy generator, so the *values* differ from
    the reference's threefry draw by construction (the partition, given the
    labels, is the same numpy code).  Parity tests pass the reference's
    arrays to both sides instead."""
    rng = np.random.default_rng(seed)
    x, y = make_cifar_like(rng, n_train)
    xt, yt = make_cifar_like(rng, n_test)
    if iid:
        order = np.random.default_rng(seed).permutation(n_train)
        parts = np.array_split(order, n_clients)
    else:
        parts = label_skew_power_law(seed, y, n_clients,
                                     labels_per_client=labels_per_client)
    clients = [ClientDataset(x[p], y[p], i) for i, p in enumerate(parts)]
    return clients, {"images": xt, "labels": yt}
