"""Split MLP UnitModel + synthetic fleet data (twin of
``repro.models.mlp_unit``).

The 9-unit split MLP over feature vectors mirrors ResNet18's 9 split points
(every cut in {2, 4, 6, 8} is valid) at millisecond step cost: the fast
CPU parity model of the port.  Its fleet data is drawn with numpy, so it
replays the reference's shards exactly.

Every unit starts with a matmul, so on the ``topk_int8`` wire the RSU side
can start from the received packed buffer itself
(:meth:`MLPUnitModel.apply_units_packed`): the first unit reads it through
the ``unpack_dequant_matmul`` kernel and the dense smashed tensor never
exists on the RSU.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.core import cost
from repro_torch.data.pipeline import ClientDataset
from repro_torch.kernels import wire


class MLPUnitModel:
    """9-unit split MLP over feature vectors."""
    name = "mlp-split"

    def __init__(self, dim: int = 48, width: int = 64, n_units: int = 9,
                 n_classes: int = 10):
        self.dim, self.width, self.n_units = dim, width, n_units
        self.n_classes = n_classes

    def init(self, gen: torch.Generator):
        """Random init with the reference's recipe, drawn on the CPU."""
        units = []
        d_in = self.dim
        for _ in range(self.n_units):
            units.append({
                "w": torch.randn((d_in, self.width), generator=gen)
                * math.sqrt(2.0 / d_in),
                "b": torch.zeros(self.width),
            })
            d_in = self.width
        head = {"w": torch.randn((self.width, self.n_classes), generator=gen)
                * math.sqrt(1.0 / self.width),
                "b": torch.zeros(self.n_classes)}
        return units, head

    def apply_units(self, units, x, start):
        for u in units:
            x = torch.relu(x @ u["w"] + u["b"])
        return x

    # the leaf of the first RSU unit that the packed buffer multiplies
    packed_entry = "w"

    def apply_units_packed(self, units, buf, start, k_frac):
        """The RSU side from the received topk_int8 buffer (rows, words):
        the first unit is ``relu(unpack_dequant_matmul(buf, w) + b)``, the
        rest as :meth:`apply_units`.  Returns (features, the first unit's
        product) -- the cut-layer gradient is taken at the latter
        (:meth:`entry_input_grad`)."""
        entry = wire.dequant_matmul(buf, units[0][self.packed_entry], k_frac)
        return self.apply_entry(units, entry, start), entry

    def apply_entry(self, units, entry, start):
        """The RSU side from the first unit's product ``entry``."""
        x = torch.relu(entry + units[0]["b"])
        return self.apply_units(units[1:], x, start + 1)

    def entry_input_grad(self, units, g_entry):
        """The cut-layer gradient from the gradient at the first RSU unit's
        product: ``g @ w^T`` (the input gradient of ``x @ w``)."""
        return g_entry @ units[0]["w"].t()

    def head_predict(self, head, feats):
        return feats @ head["w"] + head["b"]

    def params_to_numpy(self, units, head):
        """(units, head) in the reference's layout, as numpy arrays."""
        return bridge.params_to_numpy(units, head)

    def head_loss(self, head, feats, labels):
        logits = self.head_predict(head, feats)
        return F.cross_entropy(logits, labels.long()), logits

    def profile(self):
        w, d = self.width, self.dim
        flops = [2.0 * d * w] + [2.0 * w * w] * (self.n_units - 1)
        pbytes = [(d * w + w) * 4] + [(w * w + w) * 4] * (self.n_units - 1)
        return cost.SplitProfile(
            name=self.name, unit_fwd_flops=flops, unit_param_bytes=pbytes,
            smashed_bytes_per_sample=[w * 4.0] * self.n_units,
            head_flops=2.0 * w * self.n_classes,
            head_param_bytes=(w * self.n_classes + self.n_classes) * 4,
            smashed_trailing_dim=[w] * self.n_units)


def make_mlp_fleet_data(n_clients: int, per_client: int, dim: int = 48,
                        seed: int = 0, n_test: int = 256,
                        n_classes: int = 10):
    """Class-structured feature vectors, one shard per vehicle (numpy; the
    same draws as the reference).  Returns (clients, test) with the test
    set as numpy arrays."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_classes, dim)).astype(np.float32)
    clients = []
    for i in range(n_clients):
        y = rng.integers(0, n_classes, size=per_client)
        x = templates[y] + 0.5 * rng.normal(size=(per_client, dim))
        clients.append(ClientDataset(x.astype(np.float32),
                                     y.astype(np.int32), i))
    yt = rng.integers(0, n_classes, size=n_test)
    xt = templates[yt] + 0.5 * rng.normal(size=(n_test, dim))
    test = {"images": xt.astype(np.float32), "labels": yt.astype(np.int32)}
    return clients, test
