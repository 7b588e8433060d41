"""Non-IID client partitioners (twin of ``repro.data.partition``; numpy,
so they replay the reference exactly).

``label_skew_power_law`` is the paper's setting: each vehicle keeps only
``labels_per_client`` of the ``n_classes`` labels (6 of 10) and sample
counts follow a power law (Li et al., paper ref [14]).
``dirichlet_partition`` is the standard Dirichlet(alpha) label skew.
"""
from __future__ import annotations

from typing import List

import numpy as np


def label_skew_power_law(seed: int, labels: np.ndarray, n_clients: int,
                         labels_per_client: int = 6, n_classes: int = 10,
                         power: float = 1.5) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    client_labels = [rng.choice(n_classes, size=labels_per_client,
                                replace=False) for _ in range(n_clients)]
    raw = (np.arange(1, n_clients + 1, dtype=np.float64)) ** (-power)
    rng.shuffle(raw)
    shares = raw / raw.sum()

    by_class = {c: rng.permutation(np.where(labels == c)[0])
                for c in range(n_classes)}
    cursor = {c: 0 for c in range(n_classes)}
    out: List[np.ndarray] = []
    total = len(labels)
    for i in range(n_clients):
        want = max(int(shares[i] * total), labels_per_client)
        per_label = max(want // labels_per_client, 1)
        idx = []
        for c in client_labels[i]:
            pool = by_class[int(c)]
            take = pool[cursor[int(c)]: cursor[int(c)] + per_label]
            # wrap around if a class is exhausted
            if len(take) < per_label:
                take = np.concatenate([take, pool[:per_label - len(take)]])
                cursor[int(c)] = per_label - len(take)
            else:
                cursor[int(c)] += per_label
            idx.append(take)
        out.append(np.concatenate(idx))
    return out


def dirichlet_partition(seed: int, labels: np.ndarray, n_clients: int,
                        alpha: float = 0.5, n_classes: int = 10
                        ) -> List[np.ndarray]:
    """Dirichlet(alpha) label-skew partition: each class is split over the
    clients in Dirichlet-drawn proportions; sorted indices per client."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    out = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = rng.permutation(np.where(labels == c)[0])
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            out[i].extend(part.tolist())
    return [np.asarray(sorted(x), dtype=np.int64) for x in out]


def partition_stats(parts: List[np.ndarray], labels: np.ndarray,
                    n_classes: int = 10):
    """Per client: its sample count and the classes it holds."""
    labels = np.asarray(labels)
    return [{"n": len(p), "classes": sorted(set(labels[p].tolist()))}
            for p in parts]
