"""Federation simulators: the single-RSU engine of the paper's Fig. 5
comparison (CL / FL / SL / SFL / ASFL) and the multi-RSU scenario engine
(twin of ``repro.core.fedsim``).

The SFL message flow is explicit, as in the paper's Fig. 3 workflow and the
reference: vehicle-side forward -> **uplink** (the smashed tensor is packed
on the vehicle and unpacked at the RSU by the codec kernels) -> RSU-side
forward/backward -> **downlink** (the cut-layer gradient crosses the same
wire) -> vehicle-side backward.  Where the reference computes the value
after one wire trip (``fake_quant`` / ``wire_fake`` / ``wire_boundary``),
the port sends the real packed buffer, so the same values arrive and the
bytes on the wire are counted from the buffers themselves.  On the
``topk_int8`` wire a model with a packed RSU entry (mlp9) starts the RSU
side from the buffer itself (the ``unpack_dequant_matmul`` kernel).

``FederationSim`` runs one scheme per simulation.  ``sfl`` / ``asfl``:
``CohortEngine.split_round`` in the reference's update order -- buckets in
ascending cut, members in ascending client index, the one shared RSU model
and optimizer state threaded through every client batch (paper §III-B) --
then a unit-wise |D_n|-weighted FedAvg with the RSU copy of every unit it
trained; its replicas run as a per-replica loop or vectorised
(``cohort_parallel``, see :class:`CohortEngine`), and the single-RSU fault
plane (coverage, mid-round dropout, upload loss) acts on the round's plan.
``fl``: full-model local training and a stacked FedAvg.  ``sl`` (one
travelling vehicle-side model through the message flow) and ``cl``
(centralised) are sequential chains.

``ScenarioEngine`` runs the multi-RSU vehicular setting: mobility and
handover from a scenario, cuts from rates or residence time, one cohort
per RSU trained against that RSU's edge model on the reference's
``sequential`` server schedule (a per-replica loop, the way
``split_round`` follows ``_bucket_unroll``), its ``parallel`` one (every
cohort at once, one mean-gradient step per RSU and local step:
:mod:`repro_torch.core.superstep`) or its ``streaming`` one (the parallel
round committed through a per-RSU StreamBuffer), error-feedback residuals
on the ``topk_int8`` wire, the fault plane (dropout, upload loss,
deadline stragglers with a staleness bank, RSU outages), presence churn,
and a sample-weighted edge->cloud merge every ``cloud_sync_every`` rounds,
in windows of ``superstep`` rounds with one read-back each.

Not ported yet (``SimConfig`` raises on a non-default value): the mesh,
the paged slot windows and the XLA compilation cache.  ``FederationSim``,
as the reference's single-RSU engine, runs its synchronous round whatever
``server_schedule`` (``parallel``) or ``superstep`` say, and refuses
``streaming`` and presence churn.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import bridge, optim
from repro_torch.core import (adaptive, aggregation, channel, compression,
                             cost, faults, streaming)
from repro_torch.core import superstep as SS
from repro_torch.core.superstep import (SERVER_SCHEDULES, SLOT_CAPACITIES,
                                        SUPERSTEP_LAYOUTS)
from repro_torch.data.pipeline import (ClientDataset, epoch_batch_indices,
                                       feature_dtype, fleet_batch_indices,
                                       sample_batch_indices, stack_clients)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import quant as quant_kernels
from repro_torch.kernels import wire as wire_kernels
from repro_torch.models import resnet as R
from repro_torch.tree import tree_flatten, tree_map

Params = Any


class ResNetModel:
    """The paper's ResNet18 over 32x32x3 inputs (NHWC at unit boundaries)."""
    name = "resnet18"

    def __init__(self, n_classes: int = 10):
        self.n_units = R.N_UNITS
        self.n_classes = n_classes

    def init(self, gen: torch.Generator):
        p = R.init_resnet18(gen, self.n_classes)
        return list(p["units"]), p["head"]

    def apply_units(self, units, x, start):
        for j, u in enumerate(units):
            x = R.apply_unit(u, x, start + j)
        return x

    def head_predict(self, head, feats):
        return feats.mean(dim=(1, 2)) @ head["w"] + head["b"]

    def params_to_numpy(self, units, head):
        """(units, head) in the reference's layout, as numpy arrays."""
        return bridge.params_to_numpy(units, head)

    def head_loss(self, head, feats, labels):
        logits = self.head_predict(head, feats)
        return F.cross_entropy(logits, labels.long()), logits

    def profile(self):
        return cost.resnet_profile()


# valid values of every categorical SimConfig field (the reference's)
SCHEMES = ("cl", "fl", "sl", "sfl", "asfl")
ADAPTIVE_STRATEGIES = ("paper", "paper-literal", "latency", "energy",
                       "memory", "residence")
COHORT_MODES = ("auto", "vmap", "scan", "unroll")
OPTIMIZERS = ("adam", "sgd", "momentum")
WIRE_SCHEMES = compression.WIRE_SCHEMES
FLEET_AXES = ("auto", "vehicle", "rsu", "grid")
FEDERATION_STRATEGIES = ("paper", "paper-literal", "latency", "energy",
                         "memory")
SCENARIO_STRATEGIES = ("paper", "paper-literal", "residence")
# SimConfig fields whose planes are not ported yet: a non-default value
# raises instead of being silently ignored
NOT_PORTED_FIELDS = ("compilation_cache_dir", "mesh_devices", "fleet_axis",
                     "mesh_shape")


@dataclasses.dataclass
class SimConfig:
    """The reference's flat engine config, field for field."""
    scheme: str = "asfl"
    cut: int = 4
    n_clients: int = 4
    batch_size: int = 16
    local_epochs: int = 5
    local_steps: Optional[int] = None
    lr: float = 1e-4
    rounds: int = 10
    seed: int = 0
    optimizer: str = "adam"
    adaptive_strategy: str = "paper"
    compress_smashed: bool = False
    wire: str = "none"
    wire_k: float = compression.WIRE_K
    server_flops: float = 2e12
    round_interval_s: float = 5.0
    mobility_dropout: bool = False
    fault_coverage: bool = False
    fault_dropout: float = 0.0
    fault_upload_loss: float = 0.0
    fault_straggler: float = 0.0
    fault_rsu_outage: float = 0.0
    fault_staleness_discount: float = 0.5
    fault_seed: int = 0
    stream_buffer_size: int = 4
    stream_churn_rate: float = 0.0
    stream_kernel: str = "constant"
    stream_alpha: float = 0.5
    stream_seed: int = 0
    cohort_parallel: str = "auto"
    eval_every: int = 1
    server_schedule: str = "sequential"
    slot_capacity: str = "pow2"
    superstep_layout: str = "ragged"
    superstep: int = 1
    compilation_cache_dir: Optional[str] = None
    mesh_devices: Union[int, str] = 1
    fleet_axis: str = "auto"
    mesh_shape: str = "auto"
    page_slots: int = 0
    stream_churn_source: str = "markov"

    def __post_init__(self):
        for field, allowed in (("scheme", SCHEMES),
                               ("adaptive_strategy", ADAPTIVE_STRATEGIES),
                               ("server_schedule", SERVER_SCHEDULES),
                               ("slot_capacity", SLOT_CAPACITIES),
                               ("superstep_layout", SUPERSTEP_LAYOUTS),
                               ("cohort_parallel", COHORT_MODES),
                               ("fleet_axis", FLEET_AXES),
                               ("optimizer", OPTIMIZERS),
                               ("wire", WIRE_SCHEMES)):
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(
                    f"SimConfig.{field}={value!r} is not valid; allowed "
                    f"values: {' | '.join(allowed)}")
        for field, floor in (("n_clients", 1), ("batch_size", 1),
                             ("local_epochs", 1), ("rounds", 1),
                             ("superstep", 1), ("cut", 1), ("eval_every", 0),
                             ("page_slots", 0)):
            value = getattr(self, field)
            if not isinstance(value, int) or value < floor:
                raise ValueError(
                    f"SimConfig.{field}={value!r} is not valid; expected an "
                    f"int >= {floor}")
        if self.local_steps is not None and self.local_steps < 1:
            raise ValueError(
                f"SimConfig.local_steps={self.local_steps!r} is not valid; "
                f"expected None (use local_epochs) or an int >= 1")
        if not 0.0 < self.wire_k <= 1.0:
            raise ValueError(
                f"SimConfig.wire_k={self.wire_k!r} is not valid; expected "
                f"a keep-fraction in (0, 1]")
        if self.compress_smashed and self.wire not in ("none", "int8"):
            raise ValueError(
                f"SimConfig.compress_smashed=True conflicts with "
                f"wire={self.wire!r}: compress_smashed is the legacy "
                f"spelling of wire='int8' — set wire alone")
        if self.mobility_dropout and self.fault_coverage:
            raise ValueError(
                "SimConfig.mobility_dropout=True conflicts with "
                "fault_coverage=True: mobility_dropout is the legacy "
                "spelling of fault_coverage — set fault_coverage alone")
        if self.stream_churn_source not in streaming.CHURN_SOURCES:
            raise ValueError(
                f"SimConfig.stream_churn_source="
                f"{self.stream_churn_source!r} is not valid; allowed "
                f"values: {' | '.join(streaming.CHURN_SOURCES)}")
        self.fault_config()  # rate / discount validation (FaultConfig)
        self.stream_config()  # kernel / rate validation (StreamConfig)
        defaults = SimConfig.__dataclass_fields__
        for field in NOT_PORTED_FIELDS:
            if getattr(self, field) != defaults[field].default:
                raise NotImplementedError(
                    f"SimConfig.{field}={getattr(self, field)!r}: not ported "
                    f"yet (the PyTorch port runs the default "
                    f"{defaults[field].default!r})")

    def wire_scheme(self) -> str:
        """compress_smashed=True is the legacy alias of wire="int8"."""
        if self.wire == "none" and self.compress_smashed:
            return "int8"
        return self.wire

    def fault_config(self) -> faults.FaultConfig:
        """The effective fault plane; ``mobility_dropout=True`` is the
        legacy spelling of ``fault_coverage=True``."""
        return faults.FaultConfig(
            dropout_rate=self.fault_dropout,
            upload_loss_rate=self.fault_upload_loss,
            straggler_factor=self.fault_straggler,
            rsu_outage_rate=self.fault_rsu_outage,
            staleness_discount=self.fault_staleness_discount,
            coverage=self.mobility_dropout or self.fault_coverage,
            seed=self.fault_seed)

    def stream_config(self) -> streaming.StreamConfig:
        """The effective streaming plane."""
        return streaming.StreamConfig(
            buffer_size=self.stream_buffer_size,
            churn_rate=self.stream_churn_rate, kernel=self.stream_kernel,
            alpha=self.stream_alpha, seed=self.stream_seed,
            churn_source=self.stream_churn_source)


@dataclasses.dataclass
class RoundMetrics:
    round: int
    loss: float
    test_acc: float
    comm_bytes: float
    sim_time_s: float
    energy_j: float
    cuts: List[int]
    n_dropout: int = 0
    n_upload_lost: int = 0
    survivor_frac: float = 1.0
    lost_update_bytes: float = 0.0


def wire_trip(cfg: SimConfig, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """One trip of ``x`` over the configured wire: packed by the sender,
    unpacked by the receiver.  Returns (what the receiver holds, bytes that
    crossed the wire).  ``none`` ships the dense f32 tensor as is."""
    wire = cfg.wire_scheme()
    if wire == "none":
        return x, 4 * x.numel()
    x = x.contiguous()
    if wire == "int8":
        q, s = quant_kernels.quantize_int8(x)
        return (quant_kernels.dequantize_int8(q, s, dtype=x.dtype),
                q.numel() + 4 * s.numel())
    buf = wire_kernels.sparsify_quant_pack(x, cfg.wire_k)
    return (wire_kernels.unpack_dequant(buf, x.shape[-1], cfg.wire_k,
                                        dtype=x.dtype),
            4 * buf.numel())


def _requires_grad(tree):
    leaves, rebuild = tree_flatten(tree)
    req = [p.detach().requires_grad_(True) for p in leaves]
    return req, rebuild(req), rebuild


def _send_up(model, cfg: SimConfig, sent: torch.Tensor,
             error_feedback: bool = False):
    """The uplink: ``sent`` packed on the vehicle.  Returns (what the RSU
    reads, whether that is the packed ``topk_int8`` buffer itself, bytes
    on the wire, error-feedback residual or None).  On ``topk_int8`` a
    model with a packed RSU entry (mlp9) reads the buffer; any other model
    reads the unpacked tensor.  The codec works along the last axis, so a
    stacked ``(n, B, ...)`` tensor goes up in one call per direction."""
    if cfg.wire_scheme() != "topk_int8":
        recv, nbytes = wire_trip(cfg, sent)
        return recv, False, nbytes, None
    d = sent.shape[-1]
    buf = wire_kernels.sparsify_quant_pack(sent.contiguous(), cfg.wire_k)
    res = None
    if error_feedback:
        res = sent - wire_kernels.unpack_dequant(buf, d, cfg.wire_k,
                                                 dtype=sent.dtype)
    if hasattr(model, "apply_units_packed"):
        return buf, True, 4 * buf.numel(), res
    return (wire_kernels.unpack_dequant(buf, d, cfg.wire_k, dtype=sent.dtype),
            False, 4 * buf.numel(), res)


def _rsu_step(model, cfg: SimConfig, opt: optim.Optimizer, cut: int, sv, so,
              recv, packed: bool, y):
    """The RSU's part of one client batch: forward/backward of the server
    side on the received smashed batch, the downlink of the cut-layer
    gradient, and the server's optimizer step.  Returns (sv, so, the
    gradient the vehicle receives, loss, logits, downlink bytes)."""
    sv_req, sv_t, sv_rebuild = _requires_grad(sv)
    if packed:          # the RSU's first matmul reads the buffer itself
        feats, entry = model.apply_units_packed(sv_t["units"], recv, cut,
                                                cfg.wire_k)
    else:
        entry = recv.detach().requires_grad_(True)              # RSU leaf
        feats = model.apply_units(sv_t["units"], entry, cut)
    loss, logits = model.head_loss(sv_t["head"], feats, y)
    grads = torch.autograd.grad(loss, sv_req + [entry])
    g_cut = grads[-1]
    if packed:
        g_cut = model.entry_input_grad(sv_t["units"], g_cut)
    g_recv, down_bytes = wire_trip(cfg, g_cut)                  # downlink
    with torch.no_grad():
        upd_s, so2 = opt.update(sv_rebuild(list(grads[:-1])), so, sv)
        sv2 = optim.apply_updates(sv, upd_s)
    return sv2, so2, g_recv, loss.detach(), logits.detach(), down_bytes


def sfl_message_flow(model, cfg: SimConfig, opt: optim.Optimizer, cut: int,
                     sv, so, cu, co, x, y, res=None,
                     error_feedback: bool = False):
    """One client batch against the shared RSU state: vehicle fwd ->
    uplink -> RSU fwd/bwd -> downlink -> vehicle bwd -> both optimizer
    steps.  Returns (sv, so, cu, co, loss, logits, wire bytes, residual).

    ``error_feedback`` (the scenario engine's ``topk_int8`` wire, EF-SGD):
    the vehicle packs smashed + ``res`` (None = zero) and keeps what the
    wire dropped, ``sent - unpack_dequant(buf)``, as the returned residual
    (None otherwise).  The cut-layer gradient takes the stateless
    downlink."""
    cu_req, cu_t, cu_rebuild = _requires_grad(cu)
    smashed = model.apply_units(cu_t, x, 0)
    sent = smashed.detach()
    if error_feedback and res is not None:
        sent = sent + res
    recv, packed, up_bytes, res = _send_up(model, cfg, sent, error_feedback)
    sv2, so2, g_recv, loss, logits, down_bytes = _rsu_step(
        model, cfg, opt, cut, sv, so, recv, packed, y)
    g_cu = torch.autograd.grad(smashed, cu_req, grad_outputs=g_recv)
    with torch.no_grad():
        upd_c, co2 = opt.update(cu_rebuild(list(g_cu)), co, cu)
        cu2 = optim.apply_updates(cu, upd_c)
    return (sv2, so2, cu2, co2, loss, logits, up_bytes + down_bytes, res)


def make_sfl_batch_step(model, cfg: SimConfig, cut: int):
    """One SFL batch for one client at a fixed cut: the oracle step
    (``repro.core.fedsim.make_sfl_batch_step``'s twin)."""
    opt = optim.from_name(cfg.optimizer, cfg.lr)

    def step(client_units, server_units, head, c_opt, s_opt, batch):
        x, y = batch["images"], batch["labels"]
        sv = {"units": list(server_units), "head": head}
        sv, s_opt, cu, c_opt, loss, logits, _, _ = sfl_message_flow(
            model, cfg, opt, cut, sv, s_opt, list(client_units), c_opt, x, y)
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return cu, sv["units"], sv["head"], c_opt, s_opt, loss, acc

    return step


@torch.no_grad()
def evaluate(model, units, head, test: Dict[str, torch.Tensor],
             batch: int = 256) -> float:
    """Test accuracy in batches of 256 (BatchNorm uses batch statistics, so
    the batching is part of the definition, as in the reference): correct
    predictions over every label, one per row (ResNet, mlp9) or per token
    (an LM's (n, seq) labels)."""
    n = test["labels"].shape[0]
    correct = total = 0
    for i in range(0, n, batch):
        y = test["labels"][i:i + batch]
        feats = model.apply_units(units, test["images"][i:i + batch], 0)
        logits = model.head_predict(head, feats)
        correct += int((logits.argmax(-1) == y).sum())
        total += y.numel()
    return correct / max(total, 1)


def _suffix_state(state, cut):
    """The RSU optimizer state (leaves mirror {"units", "head"}) sliced to
    the units after ``cut``; the step count stays shared."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict) and "units" in v:
            out[k] = {"units": list(v["units"][cut:]), "head": v["head"]}
        else:
            out[k] = v
    return out


def _merge_state(full, suffix, cut):
    out = {}
    for k, v in full.items():
        if isinstance(v, dict) and "units" in v:
            out[k] = {"units": list(v["units"][:cut])
                      + list(suffix[k]["units"]),
                      "head": suffix[k]["head"]}
        else:
            out[k] = suffix[k]
    return out


def _stacked(tree, n: int):
    """``n`` replicas of ``tree`` on a leading axis (views: every update
    makes new tensors)."""
    return tree_map(lambda a: a.expand((n,) + a.shape), tree)


def _select(mask: torch.Tensor, new, old):
    """Leaf-wise ``new`` where the (n,) ``mask`` is set, else ``old``, over
    trees stacked on a leading replica axis."""
    def f(a, b):
        return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return tree_map(f, new, old)


@dataclasses.dataclass
class RoundPlan:
    """Host-side staging of one round: per bucket (ascending cut) its
    members, their batch-index streams, step masks and FedAvg weights."""
    cuts_sig: Tuple[Tuple[int, int], ...]      # ((cut, n_members), ...)
    steps: int
    bucket_rows: List[np.ndarray]              # (n,) client per member
    bucket_idx: List[np.ndarray]               # (steps, n, B)
    bucket_mask: List[np.ndarray]              # (steps, n) bool
    bucket_w: List[np.ndarray]                 # (n,) aggregation weights
    server_unit_w: np.ndarray                  # (n_units,) RSU copy weights


class CohortEngine:
    """Runs whole federation rounds on one device.

    One instance per simulation: it owns the stacked client data (staged on
    the device once) and counts the client batch steps it ran and the bytes
    that crossed the wire.  ``mode`` is the reference's intra-bucket
    schedule of an SFL round, resolved from ``cfg.cohort_parallel``; every
    mode computes the same math in the same client order:

    * ``unroll`` and ``scan``: the per-replica loop, each slot of a bucket
      through the whole message flow in slot order.  In the reference
      ``scan`` fuses that loop into one ``lax.scan`` and ``unroll`` emits
      it as straight-line code: two XLA compile strategies for one loop, so
      both run the loop here.
    * ``vmap`` (the reference's ``_bucket_vmap``): a bucket's replicas and
      optimizer states are stacked on a leading axis; the vehicle-side
      forward runs as ``torch.func.vmap`` under ``torch.func.vjp``; the
      stacked smashed tensor goes up the wire in one codec call; the shared
      RSU consumes the smashed batches one slot at a time in slot order
      (paper §III-B), each with its own downlink; one vehicle-side backward
      takes the stacked cut-layer gradients, and ``torch.func.vmap`` of the
      optimizer update steps every replica.  Slots without a step keep
      their state, and neither their bytes nor their steps are counted.
    * ``auto``: ``vmap`` on a CUDA device, ``unroll`` on the CPU (the
      reference's rule: vmap on accelerators).

    ``fl_round`` vectorises the full-model batch step the same way under
    ``vmap``; ``cl_round`` and ``sl_round`` are sequential chains (one
    travelling model) under every mode.  The codec kernels are called only
    outside the ``torch.func`` transforms."""

    def __init__(self, model, cfg: SimConfig,
                 clients: Sequence[ClientDataset], device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.opt = optim.from_name(cfg.optimizer, cfg.lr)
        self.stacked = stack_clients(clients, device)
        mode = cfg.cohort_parallel
        if mode == "auto":
            mode = "vmap" if device.type == "cuda" else "unroll"
        self.mode = mode
        self.batch_steps = 0      # client batch steps run (lifetime)
        self.wire_bytes = 0       # bytes across the wire, both directions

    def _long(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _gather(self, rows: torch.Tensor, idx: torch.Tensor):
        """Batches of every replica: rows (n,), idx (n, B) -> (n, B, ...)."""
        return (self.stacked.images[rows[:, None], idx],
                self.stacked.labels[rows[:, None], idx])

    # ---- one bucket's local step, per schedule ------------------------
    def _bucket_loop(self, cut, sv, so, cus, cos, rows, idx, act):
        """Each active slot through the whole message flow, in slot order.
        ``cus`` / ``cos`` are lists of per-replica trees; ``rows`` host
        client indices, ``idx`` (n, B) on the device."""
        losses = []
        for i in np.flatnonzero(act):
            row = int(rows[i])
            x = self.stacked.images[row][idx[i]]
            y = self.stacked.labels[row][idx[i]]
            sv, so, cus[i], cos[i], loss, _, nbytes, _ = sfl_message_flow(
                self.model, self.cfg, self.opt, cut, sv, so, cus[i], cos[i],
                x, y)
            losses.append(loss)
            self.wire_bytes += nbytes
        return cus, cos, sv, so, losses

    def _bucket_vmap(self, cut, sv, so, cu, co, rows, idx, act, act_t):
        """The vectorised step: ``cu`` / ``co`` are stacked (n, ...) trees,
        ``rows`` (n,) on the device, ``act_t`` the (n,) mask on the
        device."""
        model, cfg, opt = self.model, self.cfg, self.opt
        x, y = self._gather(rows, idx)

        def client_fwd(c):
            return torch.func.vmap(
                lambda ci, xi: model.apply_units(ci, xi, 0))(c, x)

        smashed, client_vjp = torch.func.vjp(client_fwd, cu)
        recv, packed, up_bytes, _ = _send_up(model, cfg, smashed.detach())
        up_slot = up_bytes // len(act)
        g_sm = torch.zeros_like(smashed)
        losses = []
        for i in np.flatnonzero(act):
            sv, so, g_sm[i], loss, _, down_bytes = _rsu_step(
                model, cfg, opt, cut, sv, so, recv[i], packed, y[i])
            losses.append(loss)
            self.wire_bytes += up_slot + down_bytes
        (g_cu,) = client_vjp(g_sm)
        upd, co2 = torch.func.vmap(opt.update)(g_cu, co, cu)
        cu2 = optim.apply_updates(cu, upd)
        if not act.all():
            cu2, co2 = _select(act_t, cu2, cu), _select(act_t, co2, co)
        return cu2, co2, sv, so, losses

    # ---- rounds --------------------------------------------------------
    def _split_agg(self, plan: RoundPlan, server, bstates):
        """Unit-wise FedAvg: vehicle replicas of every unit before their cut
        plus the RSU copy of the units it served, |D_n|-weighted."""
        merged = []
        for u in range(self.model.n_units):
            swu = np.float32(plan.server_unit_w[u])
            trees, ws, den = [server["units"][u]], [swu], swu
            for bi, (cut, n) in enumerate(plan.cuts_sig):
                if cut > u:
                    w = plan.bucket_w[bi].astype(np.float32)
                    trees += [bstates[bi][i][u] for i in range(n)]
                    ws += list(w)
                    den = np.float32(den + np.sum(w, dtype=np.float32))
            num = aggregation.weighted_sum(trees, ws)
            merged.append(tree_map(lambda nm, ref: (nm / float(den)).to(
                ref.dtype), num, server["units"][u]))
        return merged, server["head"]

    def split_round(self, units, head, plan: RoundPlan, batch: int):
        """One SFL/ASFL round.  Returns (units, head, loss sum (device
        scalar), executed client batch steps).  The RSU and client
        optimizer states are fresh every round, as in the reference."""
        opt, dev = self.opt, self.device
        server = {"units": list(units), "head": head}
        s_opt = opt.init(server)
        vmap = self.mode == "vmap"
        bstates = []
        for cut, n in plan.cuts_sig:
            if vmap:
                cu = _stacked(list(units[:cut]), n)
                bstates.append((cu, torch.func.vmap(opt.init)(cu)))
            else:
                bstates.append(([list(units[:cut]) for _ in range(n)],
                                [opt.init(list(units[:cut]))
                                 for _ in range(n)]))
        idx = [self._long(i) for i in plan.bucket_idx]
        if vmap:
            rows = [self._long(r) for r in plan.bucket_rows]
            masks = [torch.as_tensor(m, device=dev) for m in plan.bucket_mask]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        cnt = 0
        for s in range(plan.steps):
            for bi, (cut, n) in enumerate(plan.cuts_sig):
                act = plan.bucket_mask[bi][s]
                if not act.any():
                    continue
                sv = {"units": list(server["units"][cut:]),
                      "head": server["head"]}
                so = _suffix_state(s_opt, cut)
                if vmap:
                    cu, co, sv, so, losses = self._bucket_vmap(
                        cut, sv, so, *bstates[bi], rows[bi], idx[bi][s], act,
                        masks[bi][s])
                else:
                    cu, co, sv, so, losses = self._bucket_loop(
                        cut, sv, so, *bstates[bi], plan.bucket_rows[bi],
                        idx[bi][s], act)
                bstates[bi] = (cu, co)
                for loss in losses:
                    loss_sum = loss_sum + loss
                cnt += len(losses)
                server = {"units": list(server["units"][:cut])
                          + list(sv["units"]), "head": sv["head"]}
                s_opt = _merge_state(s_opt, so, cut)
        self.batch_steps += cnt
        replicas = [[tree_map(lambda a: a[i], cu) for i in range(n)]
                    if vmap else cu
                    for (cu, _), (_, n) in zip(bstates, plan.cuts_sig)]
        units, head = self._split_agg(plan, server, replicas)
        return units, head, loss_sum, cnt

    def _full_batch(self, tree, ost, x, y):
        """One full-model (CL / FL local) batch step: (tree, state, loss).
        Written with ``torch.func`` so that ``vmap`` can take it whole."""
        model = self.model

        def loss_fn(t):
            feats = model.apply_units(t["units"], x, 0)
            return model.head_loss(t["head"], feats, y)[0]

        g, loss = torch.func.grad_and_value(loss_fn)(tree)
        upd, ost2 = self.opt.update(g, ost, tree)
        return optim.apply_updates(tree, upd), ost2, loss

    def fl_round(self, units, head, rows, idx, mask, w, batch: int):
        """One FL round: every participant trains the full model on its own
        data (``idx`` (steps, n, B), ``mask`` (steps, n)), then the
        |D_n|-weighted FedAvg over the stacked replicas.  Returns (units,
        head, loss sum, client batch steps)."""
        opt, dev = self.opt, self.device
        tree = {"units": list(units), "head": head}
        n, steps = len(rows), idx.shape[0]
        idx_t = self._long(idx)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        if self.mode == "vmap":
            st = _stacked(tree, n)
            ost = torch.func.vmap(opt.init)(st)
            rows_t = self._long(rows)
            mask_t = torch.as_tensor(mask, device=dev)
            batch_step = torch.func.vmap(self._full_batch)
            for s in range(steps):
                x, y = self._gather(rows_t, idx_t[s])
                st2, ost2, losses = batch_step(st, ost, x, y)
                if mask[s].all():
                    st, ost = st2, ost2
                    loss_sum = loss_sum + losses.sum()
                else:
                    st = _select(mask_t[s], st2, st)
                    ost = _select(mask_t[s], ost2, ost)
                    loss_sum = loss_sum + torch.where(
                        mask_t[s], losses, torch.zeros_like(losses)).sum()
        else:
            trees = [tree] * n
            osts = [opt.init(tree) for _ in range(n)]
            for s in range(steps):
                for i in np.flatnonzero(mask[s]):
                    r = int(rows[i])
                    trees[i], osts[i], loss = self._full_batch(
                        trees[i], osts[i], self.stacked.images[r][idx_t[s, i]],
                        self.stacked.labels[r][idx_t[s, i]])
                    loss_sum = loss_sum + loss
            st = tree_map(lambda *a: torch.stack(a), trees[0], *trees[1:])
        cnt = int(np.sum(mask))
        self.batch_steps += cnt
        avg = aggregation.stacked_fedavg(st, w)
        return list(avg["units"]), avg["head"], loss_sum, cnt

    def _chain_round(self, kind: str, cut: int, carry, rows, idx):
        """SL (one travelling vehicle-side model through the message flow)
        and CL (one centralised model): a sequential chain of batch steps,
        step t on client ``rows[t]``'s samples ``idx[t]``."""
        idx_t = self._long(idx)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for t in range(len(rows)):
            r = int(rows[t])
            x = self.stacked.images[r][idx_t[t]]
            y = self.stacked.labels[r][idx_t[t]]
            if kind == "sl":
                cu, sv, co, so = carry
                sv, so, cu, co, loss, _, nbytes, _ = sfl_message_flow(
                    self.model, self.cfg, self.opt, cut, sv, so, cu, co, x,
                    y)
                carry = (cu, sv, co, so)
                self.wire_bytes += nbytes
            else:
                tree, ost = carry
                tree, ost, loss = self._full_batch(tree, ost, x, y)
                carry = (tree, ost)
            loss_sum = loss_sum + loss
        self.batch_steps += len(rows)
        return carry, loss_sum

    def sl_round(self, units, head, cut, rows, idx, batch: int):
        """Vanilla SL: fresh optimizer states every round; returns (units,
        head, loss sum)."""
        sv = {"units": list(units[cut:]), "head": head}
        carry = (list(units[:cut]), sv, self.opt.init(list(units[:cut])),
                 self.opt.init(sv))
        (cu, sv, _, _), ls = self._chain_round("sl", cut, carry, rows, idx)
        return list(cu) + list(sv["units"]), sv["head"], ls

    def cl_round(self, units, head, cl_opt, rows, idx, batch: int):
        """Centralised training; the optimizer state is carried across
        rounds by the caller.  Returns (units, head, state, loss sum)."""
        carry = ({"units": list(units), "head": head}, cl_opt)
        (tree, cl_opt), ls = self._chain_round("cl", 0, carry, rows, idx)
        return list(tree["units"]), tree["head"], cl_opt, ls


def _to_device(tree, device):
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def _stage_test(test: Dict[str, Any], device: torch.device):
    images = np.asarray(test["images"])
    return {"images": torch.as_tensor(images.astype(feature_dtype(images)),
                                      device=device),
            "labels": torch.as_tensor(np.asarray(test["labels"], np.int64),
                                      device=device)}


class FederationSim:
    """The single-RSU simulator of the paper's Fig. 5 comparison: CL / FL /
    SL / SFL (fixed cut) / ASFL, with the single-RSU fault plane (coverage,
    mid-round dropout, upload loss), on one device (``cuda`` unless
    ``device="cpu"`` is passed; raises without a card)."""

    def __init__(self, model, clients: Sequence[ClientDataset],
                 test: Dict[str, Any], cfg: SimConfig,
                 fleet: Optional[List[channel.VehicleProfile]] = None,
                 ch_cfg: Optional[channel.ChannelConfig] = None, *,
                 device: DeviceLike = None):
        self.faults = cfg.fault_config()
        if (self.faults.straggler_factor > 0.0
                or self.faults.rsu_outage_rate > 0.0):
            raise ValueError(
                "FederationSim is the single-RSU engine: fault_straggler "
                "and fault_rsu_outage need the multi-RSU ScenarioEngine "
                "(residence deadlines and RSU outages are scenario "
                "concepts)")
        if self.faults.stochastic and cfg.scheme not in ("sfl", "asfl"):
            raise ValueError(
                f"fault injection is wired into the split-federation round "
                f"(sfl | asfl); scheme {cfg.scheme!r} does not support it")
        if cfg.server_schedule == "streaming":
            raise ValueError(
                "server_schedule='streaming' needs the multi-RSU "
                "ScenarioEngine (the StreamBuffer is per-RSU super-step "
                "carry state); FederationSim runs the single-RSU "
                "synchronous round loop")
        if cfg.stream_config().churning:
            raise ValueError(
                "presence churn (stream_churn_rate > 0 or "
                "stream_churn_source='mobility') needs the multi-RSU "
                "ScenarioEngine (churn is per-round engine state there; "
                "the single-RSU engine models coverage via fault_coverage)")
        self.device = resolve_device(device)
        self.model = model
        self.clients = list(clients)
        self.test = _stage_test(test, self.device)
        self.cfg = cfg
        self.fleet = fleet or channel.make_fleet(len(clients), cfg.seed)
        self.fleet_arr = channel.fleet_arrays(self.fleet)
        self.ch = ch_cfg or channel.ChannelConfig()
        self.profile = model.profile()
        self.engine = CohortEngine(model, cfg, self.clients, self.device)
        self.reset()

    def reset(self):
        """Re-initialise parameters (torch generator seeded with
        ``cfg.seed``; not the reference's threefry draw — parity tests load
        the reference's weights with :meth:`set_params`), the CL optimizer
        state and history."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        units, head = self.model.init(gen)
        self.set_params(units, head)
        self.history: List[RoundMetrics] = []

    def set_params(self, units, head):
        """Load global parameters (port layout) onto the sim's device."""
        self.units = [_to_device(u, self.device) for u in units]
        self.head = _to_device(head, self.device)
        self._cl_opt = None

    def _local_steps(self, client: ClientDataset) -> int:
        if self.cfg.local_steps is not None:
            return self.cfg.local_steps
        nb = max(len(client) // self.cfg.batch_size, 1)
        return nb * self.cfg.local_epochs

    def _n_batches(self, clients) -> np.ndarray:
        return np.array([max(len(c) // self.cfg.batch_size, 1)
                         for c in clients])

    def _round_rates(self, rnd: int) -> np.ndarray:
        t = rnd * self.cfg.round_interval_s
        return channel.sample_round_rates(self.ch, self.fleet_arr, t,
                                          self.cfg.seed * 1000 + rnd)

    def _participants(self, rnd: int) -> List[int]:
        """Vehicles in RSU coverage this round (all of them unless the
        coverage fault, the legacy ``mobility_dropout``, is on); at least
        one vehicle always takes part."""
        if not self.faults.coverage:
            return list(range(len(self.clients)))
        t = rnd * self.cfg.round_interval_s
        inr = np.nonzero(channel.in_range_mask(self.ch, self.fleet_arr, t))[0]
        return list(map(int, inr)) or [0]

    def _pick_cuts(self, rates: np.ndarray) -> List[int]:
        c = self.cfg
        if c.scheme in ("sfl", "sl"):
            return [c.cut] * len(self.clients)
        strat = c.adaptive_strategy
        if strat not in FEDERATION_STRATEGIES:
            raise ValueError(
                f"adaptive_strategy {strat!r} needs the multi-RSU "
                f"ScenarioEngine; FederationSim supports: "
                f"{' | '.join(FEDERATION_STRATEGIES)}")
        if strat == "paper":
            return adaptive.paper_threshold(rates)
        if strat == "paper-literal":
            return adaptive.paper_threshold(rates, literal_eq3=True)
        if strat == "memory":
            return adaptive.memory_constrained(
                self.profile, self.fleet_arr["memory_budget_bytes"],
                adaptive.paper_threshold, rates)
        flops = self.fleet_arr["compute_flops"]
        nb = max(len(self.clients[0]) // c.batch_size, 1)
        if strat == "latency":
            return adaptive.latency_optimal(self.profile, rates, flops,
                                            c.server_flops, nb, c.batch_size,
                                            c.local_epochs)
        return adaptive.energy_aware(self.profile, rates, flops,
                                     c.server_flops, nb, c.batch_size,
                                     c.local_epochs)

    def run(self, on_round: Optional[Callable[[RoundMetrics], None]] = None
            ) -> List[RoundMetrics]:
        """Run ``cfg.rounds`` rounds of ``cfg.scheme``; ``on_round`` gets
        each round's metrics as it completes."""
        round_fn = getattr(self, f"_round_{self.cfg.scheme}")
        for rnd in range(self.cfg.rounds):
            metrics = round_fn(rnd)
            self.history.append(metrics)
            if on_round is not None:
                on_round(metrics)
        return self.history

    def _metrics(self, rnd, loss, cuts, comm, time_s, energy) -> RoundMetrics:
        ev = self.cfg.eval_every
        if ev and rnd % ev == 0:
            acc = evaluate(self.model, self.units, self.head, self.test)
        else:
            acc = float("nan")
        return RoundMetrics(rnd, float(loss), acc, comm, time_s, energy, cuts)

    def _round_cl(self, rnd: int) -> RoundMetrics:
        """Centralised: every vehicle's raw data pooled at the RSU (the
        upper bound the paper argues against); the raw-data upload is
        charged on round 0."""
        cfgc = self.cfg
        if self._cl_opt is None:
            self._cl_opt = self.engine.opt.init(
                {"units": self.units, "head": self.head})
        rows_l, idx_l = [], []
        for ci, c in enumerate(self.clients):
            eidx = epoch_batch_indices(len(c), cfgc.batch_size,
                                       cfgc.seed + rnd)
            rows_l += [ci] * len(eidx)
            idx_l.append(eidx)
        rows = np.asarray(rows_l, np.int64)
        idx = np.concatenate(idx_l)
        self.units, self.head, self._cl_opt, ls = self.engine.cl_round(
            self.units, self.head, self._cl_opt, rows, idx, cfgc.batch_size)
        comm = sum(c.images.nbytes for c in self.clients) if rnd == 0 else 0.0
        return self._metrics(rnd, float(ls) / max(len(rows), 1), [], comm,
                             0.0, 0.0)

    def _round_fl(self, rnd: int) -> RoundMetrics:
        cfgc = self.cfg
        rates = self._round_rates(rnd)
        part = self._participants(rnd)
        steps_i = [self._local_steps(self.clients[ci]) for ci in part]
        idx = np.zeros((max(steps_i), len(part), cfgc.batch_size), np.int64)
        mask = np.zeros((max(steps_i), len(part)), bool)
        w = np.zeros(len(part), np.float64)
        for j, ci in enumerate(part):
            ln = len(self.clients[ci])
            w[j] = ln
            for s in range(steps_i[j]):
                idx[s, j] = sample_batch_indices(ln, cfgc.batch_size,
                                                 cfgc.seed + rnd * 997 + s)
                mask[s, j] = True
        self.units, self.head, ls, cnt = self.engine.fl_round(
            self.units, self.head, np.asarray(part), idx, mask, w,
            cfgc.batch_size)
        rc = cost.fl_round_cost_arrays(
            self.profile, self._n_batches(self.clients[ci] for ci in part),
            cfgc.batch_size, rates[part],
            self.fleet_arr["compute_flops"][part], cfgc.local_epochs,
            self.fleet_arr["tx_power_w"][part],
            self.fleet_arr["compute_power_w"][part])
        return self._metrics(rnd, float(ls) / max(float(cnt), 1.0), [],
                             float(rc.comm_bytes.sum()),
                             float(rc.latency.max()),
                             float(rc.energy_j.sum()))

    def _round_sl(self, rnd: int) -> RoundMetrics:
        """Vanilla sequential SL: the vehicle-side model travels from
        vehicle to vehicle; the RSU-side model trains continuously."""
        cfgc = self.cfg
        cut = cfgc.cut
        rates = self._round_rates(rnd)
        rows_l, idx_l = [], []
        for ci, c in enumerate(self.clients):
            for s in range(self._local_steps(c)):
                rows_l.append(ci)
                idx_l.append(sample_batch_indices(
                    len(c), cfgc.batch_size, cfgc.seed + rnd * 991 + s))
        rows = np.asarray(rows_l, np.int64)
        self.units, self.head, ls = self.engine.sl_round(
            self.units, self.head, cut, rows, np.stack(idx_l),
            cfgc.batch_size)
        rc = cost.sl_round_cost(
            self.profile, cut, self._n_batches(self.clients),
            cfgc.batch_size, rates, self.fleet_arr["compute_flops"],
            cfgc.server_flops, cfgc.local_epochs)
        return self._metrics(rnd, float(ls) / max(len(rows), 1),
                             [cut] * len(self.clients), rc.comm_bytes,
                             rc.latency, rc.energy_j)

    def _round_sfl(self, rnd: int) -> RoundMetrics:
        return self._parallel_split_round(rnd)

    def _round_asfl(self, rnd: int) -> RoundMetrics:
        return self._parallel_split_round(rnd)

    def _plan_split_round(self, rnd: int, cuts: List[int],
                          participants: List[int],
                          performed: Optional[Dict[int, int]] = None,
                          survivors: Optional[Dict[int, bool]] = None
                          ) -> RoundPlan:
        """Bucket participants by cut (ascending, members by client index)
        and pre-draw every member's batch-index stream for the round.
        Faults: ``performed[ci]`` truncates a dropout's step mask to the
        steps it ran; ``survivors[ci]`` False zeroes its merge weight."""
        cfgc = self.cfg
        buckets: Dict[int, List[int]] = {}
        for ci in participants:
            buckets.setdefault(cuts[ci], []).append(ci)
        steps = max(self._local_steps(self.clients[ci])
                    for ci in participants)
        cuts_sig, rows_l, idx_l, mask_l, w_l = [], [], [], [], []
        for cut in sorted(buckets):
            members = sorted(buckets[cut])
            n = len(members)
            idx = np.zeros((steps, n, cfgc.batch_size), np.int64)
            mask = np.zeros((steps, n), bool)
            w = np.zeros(n, np.float64)
            for j, ci in enumerate(members):
                ln = len(self.clients[ci])
                w[j] = ln if survivors is None or survivors[ci] else 0.0
                n_s = (self._local_steps(self.clients[ci])
                       if performed is None else performed[ci])
                for s in range(n_s):
                    idx[s, j] = sample_batch_indices(
                        ln, cfgc.batch_size,
                        cfgc.seed + rnd * 983 + s * 31 + ci)
                    mask[s, j] = True
            cuts_sig.append((cut, n))
            rows_l.append(np.asarray(members, np.int64))
            idx_l.append(idx)
            mask_l.append(mask)
            w_l.append(w)
        server_unit_w = np.array(
            [sum(len(self.clients[ci]) for ci in participants
                 if cuts[ci] <= u) for u in range(self.model.n_units)],
            np.float64)
        return RoundPlan(tuple(cuts_sig), steps, rows_l, idx_l, mask_l, w_l,
                         server_unit_w)

    def _parallel_split_round(self, rnd: int) -> RoundMetrics:
        """SFL/ASFL with SplitFed-V1 semantics: vehicle-side replicas train
        at (possibly heterogeneous) cuts while the RSU keeps one shared
        server-side model updated on every client batch; the round closes
        with the unit-wise FedAvg and the analytic cost model.  With the
        fault plane on, the host draw decides who drops out (and after how
        many steps) and whose upload is lost."""
        cfgc = self.cfg
        fc = self.faults
        rates = self._round_rates(rnd)
        participants = self._participants(rnd)
        cuts = [max(1, min(c, self.model.n_units - 1))
                for c in self._pick_cuts(rates)]
        performed = survivors = uploads = None
        if fc.stochastic:
            drop, dfrac, lost = faults.sample_faults_host(
                fc, rnd, len(self.clients))
            lost = lost & ~drop          # a dropout never uploads
            if all(drop[ci] or lost[ci] for ci in participants):
                # at least one participant survives: the first one's
                # failures are cleared
                drop[participants[0]] = lost[participants[0]] = False
            performed = {ci: (int(dfrac[ci] * self._local_steps(
                                  self.clients[ci])) if drop[ci]
                              else self._local_steps(self.clients[ci]))
                         for ci in participants}
            survivors = {ci: not (drop[ci] or lost[ci])
                         for ci in participants}
            uploads = {ci: not drop[ci] for ci in participants}
        plan = self._plan_split_round(rnd, cuts, participants, performed,
                                      survivors)
        self.units, self.head, ls, cnt = self.engine.split_round(
            self.units, self.head, plan, cfgc.batch_size)
        part = np.asarray(participants)
        if fc.stochastic:
            # charge only the work performed: a dropout pays its partial
            # smashed traffic and compute but no upload; an upload loss
            # pays everything; the latency bound is over the survivors
            rc = cost.sfl_round_cost_arrays(
                self.profile, np.asarray(cuts)[part],
                np.array([performed[ci] for ci in participants]),
                cfgc.batch_size, rates[part],
                self.fleet_arr["compute_flops"][part], cfgc.server_flops,
                1, self.fleet_arr["tx_power_w"][part],
                self.fleet_arr["compute_power_w"][part],
                wire=cfgc.wire_scheme(), wire_k=cfgc.wire_k,
                model_upload=np.array([uploads[ci]
                                       for ci in participants]))
            surv_arr = np.array([survivors[ci] for ci in participants])
            latency = float(np.max(rc.latency[surv_arr], initial=0.0))
        else:
            rc = cost.sfl_round_cost_arrays(
                self.profile, np.asarray(cuts)[part],
                self._n_batches(self.clients[ci] for ci in participants),
                cfgc.batch_size, rates[part],
                self.fleet_arr["compute_flops"][part], cfgc.server_flops,
                cfgc.local_epochs, self.fleet_arr["tx_power_w"][part],
                self.fleet_arr["compute_power_w"][part],
                wire=cfgc.wire_scheme(), wire_k=cfgc.wire_k)
            latency = float(rc.latency.max())
        m = self._metrics(rnd, float(ls) / max(float(cnt), 1.0), cuts,
                          float(rc.comm_bytes.sum()), latency,
                          float(rc.energy_j.sum()))
        if fc.stochastic:
            bytes_cum = np.concatenate(
                [[0.0], np.cumsum(self.profile.unit_param_bytes)])
            m.n_dropout = int(sum(drop[ci] for ci in participants))
            m.n_upload_lost = int(sum(lost[ci] for ci in participants))
            m.survivor_frac = (float(sum(survivors.values()))
                               / max(len(participants), 1))
            m.lost_update_bytes = float(sum(
                bytes_cum[cuts[ci]] for ci in participants
                if not survivors[ci]))
        return m


# --------------------------------------------------------------------------
# multi-RSU scenario engine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioRoundMetrics:
    """The reference's per-round scenario metrics, field for field (the
    fault fields keep their defaults without the fault plane, the
    streaming ones without presence churn or the ``streaming``
    schedule)."""
    round: int
    loss: float
    test_acc: float          # NaN on rounds without a cloud sync / eval
    comm_bytes: float
    sim_time_s: float        # slowest scheduled vehicle's round latency
    energy_j: float
    n_scheduled: int         # vehicles that trained this round
    n_skipped: int           # in coverage but residence-infeasible (cut 0)
    n_handover: int          # scheduled vehicles whose cell changed
    rsu_loads: List[int]     # participants per RSU
    cuts: List[int]          # fleet-wide cuts; 0 = sat the round out
    n_dropout: int = 0       # scheduled vehicles that dropped mid-round
    n_upload_lost: int = 0   # full work done, update lost on the uplink
    n_straggler: int = 0     # deadline missed; update banked, not lost
    n_rsu_down: int = 0      # RSUs that sat the round out
    survivor_frac: float = 1.0      # merged / scheduled
    lost_update_bytes: float = 0.0  # vehicle-side params that never merged
    stale_merged: float = 0.0       # banked weight merged this round
    n_present: int = -1             # presence after churn (-1: no churn)
    n_arrived: int = 0              # vehicles that arrived this round
    absorbed_samples: float = 0.0   # sample weight merged into edge models
    stream_merges: int = 0          # StreamBuffer fires this round
    buffer_occupancy: float = 0.0   # pending deltas over the RSUs
    stream_stale: float = 0.0       # summed ages of the merged deltas


class ScenarioEngine:
    """Multi-RSU federation over a mobility scenario, with handover and
    hierarchical edge->cloud aggregation (twin of the reference's
    ``ScenarioEngine``; :mod:`repro_torch.core.superstep`).  Per round:

    1. Fleet state from ``fleet_states(rnd)`` (default: the scenario's
       host ``fleet_state(rnd * round_interval_s, seed * 1000 + rnd)``);
       rates and residence are taken as float32, as the reference's
       program sees them.
    2. Cuts: ``paper`` / ``paper-literal`` Eq. 3 banding, or
       ``residence``-aware deadline feasibility (0 = SKIP); uncovered
       vehicles get 0.  One sort of (serving, cut, vehicle) keys lays the
       scheduled vehicles out as slots (:func:`superstep.slot_sort`).
    3. Every RSU trains its cohort against its edge model with fresh
       optimizer states, on the ``server_schedule``:

       * ``sequential`` (paper §III-B): each local step runs the RSU's
         slots in ascending (cut, vehicle) order through one shared RSU
         state, each vehicle on its own replica of the units before its
         cut (a per-replica loop, as ``split_round`` follows
         ``_bucket_unroll``);
       * ``parallel`` (arXiv:2405.18707): each local step runs every slot
         of the fleet at once, grouped by cut, against its RSU's model as
         it stood at the start of the step, and each RSU takes one
         |D_n|-weighted mean-gradient step
         (:class:`superstep.ParallelSchedule`);
       * ``streaming``: the parallel round, whose result each RSU pushes
         as a pending delta into its StreamBuffer of ``stream_buffer_size``
         B slots; the edge model moves only when B deltas are pending, by
         their staleness-weighted FedAvg (``stream_kernel`` of their ages;
         :func:`superstep.plan_stream`).

       Then the unit-wise |D_n|-weighted FedAvg with the RSU copy.
    4. On ``topk_int8`` every vehicle carries an error-feedback residual,
       indexed by vehicle (it follows the vehicle across handover) and
       zeroed when the vehicle's cut changes.
    5. Every ``cloud_sync_every`` rounds the sample-weighted cloud merge
       re-seeds every edge model from the global one.

    Presence churn (``stream_churn_rate`` or ``stream_churn_source=
    "mobility"``) gates step 1: a vehicle that is not present, or that
    arrived this round on a synchronous schedule (it is admitted the next
    round; ``streaming`` admits it at once), looks like one outside
    coverage.  The fault plane (``fault_*``, the reference's order) acts
    on step 2 onwards: a down RSU's cohort gets cut 0 (its load is 0); a
    mid-round dropout runs only its first ``floor(frac * steps)`` local
    steps and its update is not merged (the server-side steps it took
    stand); an upload loss trains in full and is not merged; a deadline
    straggler (the float32 analytic latency at its cut above
    ``fault_straggler x residence``) is not merged this round but banked
    per RSU and merged the next at ``fault_staleness_discount``; at least
    one scheduled vehicle always survives.  The FedAvg then weighs the
    survivors only, and each local step of the parallel schedule
    renormalises over the slots still active.

    ``superstep`` K runs K rounds as one window: planned on the host
    first (both capacity checks raise before any state changes), then run
    back to back with the per-round losses read back once; the eval score
    goes to the window's last synced round and ``on_round`` /
    ``on_cloud_merge`` fire after the window.  ``slot_capacity`` and
    ``superstep_layout`` shape the slot tables (:meth:`occupancy_stats`);
    under either schedule both layouts train the same bits.
    ``page_slots`` > 0 pages the ``ragged`` layout of the parallel and
    streaming schedules (the reference pages only there): each local step
    walks every cut bucket's slots in windows of that many, and the
    compacted slot table is padded to whole windows.  The edge models
    live as one (R, P) plane, ``edge_planes`` (``edges`` gives them as
    trees), merged at the cloud in one tensordot.

    Handover (a scheduled vehicle whose cell differs from its last
    covered cell) moves the vehicle and its data; server-side state stays
    at the RSU, and the vehicle-side model re-download is charged in the
    accounting.  ``batch_indices(rnd) -> (steps, n, batch)`` (default: the
    numpy :func:`fleet_batch_indices`), ``fleet_states``,
    ``fault_draws(rnd) -> (drop, drop_frac, lost, rsu_down)`` (default:
    :func:`faults.sample_scenario_faults_host`) and ``presence_toggles(rnd)
    -> bool (n,)`` (default: :func:`streaming.sample_toggles_host`) exist
    so the parity tests can feed both engines the reference's threefry
    draws; everything after a draw is the engine's.  With every fault and
    churn rate 0 and a schedule other than ``streaming`` none of these
    planes runs, whatever their seeds.  ``cohort_parallel`` and ``scheme``
    are single-RSU knobs, which the reference's scenario engine ignores
    too."""

    def __init__(self, model, clients: Sequence[ClientDataset],
                 test: Dict[str, Any], cfg: SimConfig, scenario,
                 cloud_sync_every: int = 1, *, device: DeviceLike = None,
                 fleet_states: Optional[Callable[[int], Any]] = None,
                 batch_indices: Optional[Callable[[int], np.ndarray]] = None,
                 fault_draws: Optional[Callable[[int], Tuple]] = None,
                 presence_toggles: Optional[
                     Callable[[int], np.ndarray]] = None):
        self.faults = cfg.fault_config()
        if self.faults.coverage:
            raise ValueError(
                "fault coverage (the legacy single-RSU mobility_dropout "
                "in-range test) does not apply to the multi-RSU super-step "
                "engine: scenarios model coverage through serving_rsu == -1")
        if len(clients) != scenario.n_vehicles:
            raise ValueError(f"{len(clients)} client shards for a scenario "
                             f"of {scenario.n_vehicles} vehicles")
        if cfg.adaptive_strategy not in SCENARIO_STRATEGIES:
            raise ValueError(
                f"ScenarioEngine supports adaptive_strategy "
                f"{' | '.join(SCENARIO_STRATEGIES)}, got "
                f"{cfg.adaptive_strategy!r} (the single-RSU FederationSim "
                f"strategies latency/energy/memory are not wired here)")
        self.device = resolve_device(device)
        self.model = model
        self.clients = list(clients)
        self.test = _stage_test(test, self.device)
        self.cfg = cfg
        self.scenario = scenario
        self.n_rsus = len(scenario.rsu_positions)
        self.fa = scenario.fleet_arrays
        self.profile = model.profile()
        self.lengths = np.array([len(c) for c in clients], dtype=np.int64)
        self.cloud_sync_every = max(int(cloud_sync_every), 1)
        self.opt = optim.from_name(cfg.optimizer, cfg.lr)
        self.stacked = stack_clients(self.clients, self.device)
        self.fleet_states = fleet_states or self._host_state
        self.batch_indices = batch_indices or self._host_batch_indices
        self.stream = cfg.stream_config()
        self.fault_draws = fault_draws or (
            lambda rnd: faults.sample_scenario_faults_host(
                self.faults, rnd, len(self.clients), self.n_rsus))
        self.presence_toggles = presence_toggles or (
            lambda rnd: streaming.sample_toggles_host(
                self.stream, rnd, len(self.clients)))
        # the planes run only when on (gated here, as the reference's
        # program is): fz the fault plane, cz presence churn, sz the
        # streaming schedule's StreamBuffer
        self.fz = self.faults.stochastic
        self.cz = self.stream.churning
        self.sz = cfg.server_schedule == "streaming"
        self.parallel = cfg.server_schedule in ("parallel", "streaming")
        self.mode = cfg.server_schedule if self.parallel else "loop"
        self.layout = cfg.superstep_layout
        # slot paging: the ragged parallel layout walks each cut bucket's
        # slots in windows of page_slots (the reference pages only there)
        self.page = (int(cfg.page_slots)
                     if self.parallel and self.layout == "ragged" else 0)
        self.batch_steps = 0      # client batch steps run (lifetime)
        self.wire_bytes = 0       # bytes across the wire, both directions
        # parallel schedule (lifetime): (cut bucket page, local step) and
        # (cut bucket page, RSU, local step) dispatches, the units of its
        # codec calls (a bucket is one page unless paged)
        self.bucket_steps = 0
        self.rsu_bucket_steps = 0
        self._states: Dict[int, Any] = {}
        self._cohort_counts: Dict[int, int] = {}
        self._covered_totals: Dict[int, int] = {}
        # one init: the plane takes its layout from the parameters it loads
        units, head = model.init(torch.Generator().manual_seed(cfg.seed))
        self.plane = SS.FlatPlane(units, head)
        self.set_params(units, head)
        self.history: List[ScenarioRoundMetrics] = []
        if self.parallel:
            self.schedule = SS.ParallelSchedule(
                model, cfg, self.opt, self.stacked, self.plane, self.device,
                wire_trip)

    def reset(self):
        """Fresh parameters (torch generator seeded with ``cfg.seed``; the
        parity tests load the reference's with :meth:`set_params`) and
        history."""
        units, head = self.model.init(
            torch.Generator().manual_seed(self.cfg.seed))
        self.set_params(units, head)
        self.history: List[ScenarioRoundMetrics] = []

    def set_params(self, units, head):
        """Load the global model (port layout) onto the device, re-seed
        every edge model from it and clear the per-vehicle state."""
        self._set_global(self.plane.flatten(
            [_to_device(u, self.device) for u in units],
            _to_device(head, self.device)))
        n = len(self.clients)
        self.samples = np.zeros(self.n_rsus, np.float32)
        self.prev = np.full(n, -1, np.int64)        # last covered cell
        self.wire_res: List[Optional[torch.Tensor]] = [None] * n
        self.wire_cut = np.full(n, -1, np.int64)    # cut of each residual
        self._sync_count = 0
        R, U, P = self.n_rsus, self.model.n_units, self.plane.size
        if self.fz:
            # the staleness bank: last round's deadline stragglers per RSU,
            # their weighted replicas on the plane and, per unit (head
            # column U is 0), the weight of those owning it
            self.stale_num = torch.zeros((R, P), dtype=torch.float32,
                                         device=self.device)
            self.stale_den = np.zeros((R, U + 1), np.float32)
        if self.cz:
            self.present = np.ones(n, bool)     # all present at the start
        if self.sz:
            # the StreamBuffer: per RSU, B pending deltas on the plane,
            # their merge weights, their ages in rounds and the fill count
            B = int(self.stream.buffer_size)
            self.sbuf = torch.zeros((R, B, P), dtype=torch.float32,
                                    device=self.device)
            self.sbuf_w = np.zeros((R, B), np.float32)
            self.sbuf_age = np.zeros((R, B), np.int32)
            self.sbuf_cnt = np.zeros(R, np.int32)

    @property
    def edges(self) -> List[Dict[str, Any]]:
        """Each RSU's edge model, ``{"units", "head"}``, as views of its row
        of ``edge_planes`` (R, P), the flat planes the engine keeps."""
        return [dict(zip(("units", "head"), self.plane.tree(p)))
                for p in self.edge_planes]

    @edges.setter
    def edges(self, trees: Sequence[Dict[str, Any]]):
        self.edge_planes = torch.stack([self.plane.flatten(e["units"],
                                                           e["head"])
                                        for e in trees])

    def _set_global(self, glob: torch.Tensor):
        """The global model := the plane ``glob``, and every edge model a
        copy of it."""
        self.units, self.head = self.plane.tree(glob)
        self.edge_planes = glob.expand(self.n_rsus, -1).clone()

    # ---- staging ------------------------------------------------------
    def _nb_ep(self) -> Tuple[int, int]:
        """(batches, epochs), uniform over the fleet: every scheduled
        vehicle runs the same number of local steps."""
        c = self.cfg
        if c.local_steps is not None:
            return c.local_steps, 1
        return max(int(self.lengths.max()) // c.batch_size, 1), c.local_epochs

    def _steps(self) -> int:
        nb, ep = self._nb_ep()
        return nb * ep

    def _host_state(self, rnd: int):
        return self.scenario.fleet_state(rnd * self.cfg.round_interval_s,
                                         self.cfg.seed * 1000 + rnd)

    def _state(self, rnd: int):
        """``fleet_states(rnd)``, once per round (capacity planning and the
        round itself read the same state)."""
        st = self._states.get(rnd)
        if st is None:
            st = self._states[rnd] = self.fleet_states(rnd)
        return st

    def _host_batch_indices(self, rnd: int) -> np.ndarray:
        return fleet_batch_indices(self.lengths, self._steps(),
                                   self.cfg.batch_size,
                                   self.cfg.seed * 1000 + rnd)

    def _pick_cuts(self, serving, rates, residence) -> np.ndarray:
        """(n,) cuts, 0 = SKIP or uncovered."""
        c, U = self.cfg, self.model.n_units
        if c.adaptive_strategy in ("paper", "paper-literal"):
            cuts = adaptive.paper_threshold(
                rates, literal_eq3=c.adaptive_strategy == "paper-literal")
        else:
            nb, ep = self._nb_ep()
            cuts = adaptive.residence_aware(
                self.profile, np.maximum(rates, 1.0),
                self.fa["compute_flops"], c.server_flops, nb, c.batch_size,
                ep, residence)
        cuts = np.asarray(cuts, np.int64)
        cuts = np.where(cuts > 0, np.clip(cuts, 1, U - 1), 0)
        return np.where(serving >= 0, cuts, 0)

    # ---- slot capacity ------------------------------------------------
    def _capacity(self, horizon: int) -> int:
        """Per-RSU slot capacity over rounds [0, horizon): the largest
        covered count of any cell, rounded as ``slot_capacity`` says."""
        for rnd in range(horizon):
            if rnd not in self._cohort_counts:
                s = np.asarray(self._state(rnd).serving_rsu)
                self._cohort_counts[rnd] = int(np.bincount(
                    s[s >= 0], minlength=self.n_rsus).max()) \
                    if (s >= 0).any() else 0
        return SS.round_capacity(
            max(self._cohort_counts[r] for r in range(horizon)),
            self.cfg.slot_capacity)

    def _total_slots(self, horizon: int) -> int:
        """The ragged parallel layout's compacted slot capacity over rounds
        [0, horizon): the largest covered count of any round, rounded like
        ``slot_capacity``; 0 for a layout or schedule without one."""
        if not (self.parallel and self.layout == "ragged"):
            return 0
        for rnd in range(horizon):
            if rnd not in self._covered_totals:
                s = np.asarray(self._state(rnd).serving_rsu)
                self._covered_totals[rnd] = int((s >= 0).sum())
        return SS.round_capacity(
            max(self._covered_totals[r] for r in range(horizon)),
            self.cfg.slot_capacity)

    def occupancy_stats(self) -> Dict[str, Any]:
        """How much of the slot layout the run used (the reference's
        keys): ``executed_slots`` is the slot table's size (R x capacity,
        or the ragged parallel layout's compacted capacity),
        ``mean_occupied_slots`` the mean scheduled count over the
        history, ``owned_plane_frac`` the share of the parameters a
        replica can own under the layout (the units below the strategy's
        pow2 cut bucket; 1.0 dense).  Every schedule of the port computes
        the occupied slots only."""
        horizon = max(int(self.cfg.rounds), 1)
        cap = self._capacity(horizon)
        executed = (self._total_slots(horizon)
                    if self.parallel and self.layout == "ragged"
                    else self.n_rsus * cap)
        occ = [float(m.n_scheduled) for m in self.history]
        mean_occ = float(np.mean(occ)) if occ else 0.0
        util = (mean_occ / executed) if executed else 0.0
        width = self.plane.size
        if self.layout == "ragged":
            bucket = SS.cut_prefix_bucket(adaptive.strategy_max_cut(
                self.cfg.adaptive_strategy, self.model.n_units),
                self.model.n_units)
            width = SS.owned_window(self.plane.unit_ids, bucket)[1]
        return {"layout": self.layout, "slot_capacity": int(cap),
                "executed_slots": int(executed),
                "mean_occupied_slots": mean_occ,
                "padded_slot_frac": float(1.0 - util),
                "owned_plane_frac": float(width / max(self.plane.size, 1)),
                "effective_flops_utilization": float(util)}

    # ---- the rounds ---------------------------------------------------
    def _host_planes(self) -> Dict[str, Any]:
        """The host state a window's plans thread from round to round
        (presence, the bank's weights, the StreamBuffer's bookkeeping);
        the engine takes each round's from its plan after training it."""
        ps: Dict[str, Any] = {}
        if self.cz:
            ps["present"] = self.present
        if self.fz:
            ps["stale_den"] = self.stale_den
        if self.sz:
            ps["sbuf"] = (self.sbuf_w, self.sbuf_age, self.sbuf_cnt)
        return ps

    def _plan(self, rnd: int, cap: int, slots: int,
              ps: Dict[str, Any]) -> Dict[str, Any]:
        """Host side of round ``rnd``: fleet state, presence, cuts, the
        fault plan, slot table and batch indices (the reference's order,
        ``superstep.py:1165-1248``).  ``ps`` is the host state after the
        previous round, updated here to this round's.  Raises if a cohort
        overflows its slot table."""
        st = self._state(rnd)
        n, R, U = len(self.clients), self.n_rsus, self.model.n_units
        serving = np.asarray(st.serving_rsu, np.int64)
        rates = np.asarray(st.rates_bps, np.float32)
        residence = np.asarray(st.residence_s, np.float32)
        plan: Dict[str, Any] = {"rnd": rnd}
        if self.cz:
            # presence: arrivals wait a round on the synchronous schedules
            # (they still register and download the model), streaming
            # admits them at once
            if self.stream.churn_source == "mobility":
                present = serving >= 0
            else:
                present = ps["present"] ^ np.asarray(
                    self.presence_toggles(rnd), bool)
            arrived = present & ~ps["present"]
            admit = present if self.sz else present & ~arrived
            serving, rates, residence = streaming.gate_presence(
                serving, rates, residence, admit)
            serving = serving.astype(np.int64)
            ps["present"] = present
            plan.update(n_present=int(present.sum()),
                        n_arrived=int(arrived.sum()))
        cuts = self._pick_cuts(serving, rates, residence)
        if self.fz:
            drop, dfrac, lost, rsu_down = (np.asarray(a)
                                           for a in self.fault_draws(rnd))
            rsu_down = faults.ensure_rsu_up(rsu_down)
            # a down RSU's cohort sits the round out before slot grouping
            down_v = rsu_down[np.clip(serving, 0, R - 1)] & (serving >= 0)
            cuts = np.where(down_v, 0, cuts)
        order, seg, counts = SS.slot_sort(serving, cuts, R, U)
        if int(counts.max(initial=0)) > cap:
            raise RuntimeError(
                f"per-RSU cohort of {int(counts.max())} exceeded slot "
                f"capacity {cap} in round {rnd}; the window was not run "
                f"— raise the capacity and reset() the engine")
        if slots and int(counts.sum()) > slots:
            raise RuntimeError(
                f"fleet-wide occupied slots {int(counts.sum())} exceeded "
                f"the compacted capacity {slots} in round {rnd}; the "
                f"window was not run — raise the capacity and reset() the "
                f"engine")
        plan.update(serving=serving, rates=rates, cuts=cuts, counts=counts,
                    idx=np.asarray(self.batch_indices(rnd), np.int64))
        sched = cuts > 0
        w_fleet = self.lengths.astype(np.float32)
        steps = self._steps()
        fault = None
        if self.fz:
            fc = self.faults
            # precedence: a dropout has nothing left to upload; an upload
            # loss discards what a straggler would have banked
            drop = np.asarray(drop, bool) & sched
            lost = np.asarray(lost, bool) & sched & ~drop
            if fc.straggler_factor > 0.0:
                nb, ep = self._nb_ep()
                lat = adaptive.latency_matrix(
                    self.profile, np.maximum(rates, np.float32(1.0)),
                    self.fa["compute_flops"], self.cfg.server_flops, nb,
                    self.cfg.batch_size, ep, range(1, U))
                lat = lat[np.arange(n), np.clip(cuts - 1, 0, U - 2)]
                strag = sched & (lat > np.float32(fc.straggler_factor)
                                 * residence)
            else:
                strag = np.zeros(n, bool)
            strag = strag & ~drop & ~lost
            rescue = faults.rescue_mask(sched, drop | lost | strag)
            drop, lost, strag = drop & ~rescue, lost & ~rescue, \
                strag & ~rescue
            dstep = faults.drop_steps(drop, dfrac, steps)
            bank_in = ps["stale_den"]
            # this round's bank weights, per RSU and unit, merge next round
            bank_out = np.zeros((R, U + 1), np.float32)
            for v in np.nonzero(strag)[0]:
                bank_out[serving[v], :cuts[v]] += w_fleet[v]
            ps["stale_den"] = bank_out
            fault = (dstep, sched & ~drop & ~lost & ~strag, strag)
            plan.update(rsu_down=rsu_down, bank_in=bank_in,
                        bank_out=bank_out,
                        stale_w=float(np.sum(bank_in, dtype=np.float32)))
        else:   # every scheduled vehicle survives and runs every step
            drop = lost = strag = np.zeros(n, bool)
            dstep = np.full(n, steps, np.int32)
        plan.update(drop=drop, lost=lost, strag=strag, dstep=dstep,
                    surv=sched & ~drop & ~lost & ~strag)
        if self.parallel:
            members, slot_seg = SS.slot_table_flat(
                order, seg, counts, self.layout, cap, slots)
            plan["par"] = SS.plan_parallel(
                members, slot_seg, cuts, self.lengths, R, U, fault, steps,
                self.page)
        else:
            plan["table"] = SS.slot_table_seq(order, counts, cap)
        if self.sz:     # each RSU pushes the sample weight it merged
            plan["stream"] = SS.plan_stream(
                *ps["sbuf"], plan["par"].w_seg, self.stream.buffer_size,
                self.stream.kernel, self.stream.alpha)
            ps["sbuf"] = plan["stream"].post
        plan["post"] = dict(ps)
        return plan

    def _rsu_round(self, edge, members, cuts, idx, ef, plan, bank=None):
        """One RSU's round on its edge model (sequential schedule): fresh
        RSU and replica optimizer states, ``steps`` passes over the slots
        in order, each vehicle stopping at its performed steps, then the
        unit-wise FedAvg over the survivors.  ``bank`` (the fault plane):
        (the RSU's bank weights (U + 1,) and numerator (P,) from last
        round, the discount), or None without one.  Returns (edge model,
        loss sum, client batch steps, sample weight merged, this round's
        bank numerator (P,) or None)."""
        opt, model, plane = self.opt, self.model, self.plane
        dstep = plan["dstep"]
        sv = {"units": list(edge["units"]), "head": edge["head"]}
        so = opt.init(sv)
        cus = [list(edge["units"][:cuts[v]]) for v in members]
        cos = [opt.init(cu) for cu in cus]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = 0
        for s in range(self._steps()):
            for i, v in enumerate(members):
                v, cut = int(v), int(cuts[v])
                if s >= dstep[v]:
                    continue                # dropped: stops at its step
                x = self.stacked.images[v][idx[s, v]]
                y = self.stacked.labels[v][idx[s, v]]
                svs = {"units": list(sv["units"][cut:]), "head": sv["head"]}
                (svs, sos, cus[i], cos[i], loss, _, nbytes,
                 self.wire_res[v]) = sfl_message_flow(
                    model, self.cfg, opt, cut, svs, _suffix_state(so, cut),
                    cus[i], cos[i], x, y, self.wire_res[v], ef)
                sv = {"units": list(sv["units"][:cut]) + list(svs["units"]),
                      "head": svs["head"]}
                so = _merge_state(so, sos, cut)
                loss_sum = loss_sum + loss
                cnt += 1
                self.wire_bytes += nbytes
        # unit-wise FedAvg over the survivors: replicas of every unit before
        # their cut, and the RSU copy at the weight of every survivor that
        # did not own the unit, plus last round's bank at the discount
        w_slots = self.lengths[members].astype(np.float32)
        keep, strag = plan["surv"][members], plan["strag"][members]
        w_total = np.float32(w_slots[keep].sum(dtype=np.float32))
        merged, banked = [], None
        for u in range(model.n_units):
            own = [i for i, v in enumerate(members)
                   if cuts[v] > u and keep[i]]
            w_own = w_slots[own]
            swu = np.float32(w_total - w_own.sum(dtype=np.float32))
            num = aggregation.weighted_sum(
                [cus[i][u] for i in own] + [sv["units"][u]],
                list(w_own) + [swu])
            den_u = w_total
            if bank is not None and bank[0][u] > 0.0:
                bank_den, bank_num, disc = bank
                den_u = np.float32(w_total + np.float32(disc) * bank_den[u])
                num = tree_map(lambda nm, st: nm + disc * st, num,
                               plane.units(bank_num, u, u + 1)[0])
            # the guard is a where: the weight can sit in (0, 1)
            merged.append(
                tree_map(lambda nm, ref: (nm / float(den_u)).to(ref.dtype),
                         num, sv["units"][u])
                if den_u > 0.0 else edge["units"][u])
            late = [i for i, v in enumerate(members)
                    if cuts[v] > u and strag[i]]
            if late:
                if banked is None:
                    banked = torch.zeros(plane.size, dtype=torch.float32,
                                         device=self.device)
                banked[plane.offsets[u]:plane.offsets[u + 1]] = \
                    plane.unit_vector(aggregation.weighted_sum(
                        [cus[i][u] for i in late], list(w_slots[late])), u)
        return ({"units": merged, "head": sv["head"]}, loss_sum, cnt,
                w_total, banked)

    def _train_sequential(self, plan, idx, ef):
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = 0
        members, mask = plan["table"]
        banked = None
        edges, rows = self.edges, list(self.edge_planes)
        for r in range(self.n_rsus):
            bank = None
            if self.fz and plan["bank_in"][r].any():
                bank = (plan["bank_in"][r], self.stale_num[r],
                        self.faults.staleness_discount)
            # an RSU without members merges only a bank it holds
            if not mask[r].any() and bank is None:
                continue
            edge, ls, c, w, bank_r = self._rsu_round(
                edges[r], members[r][mask[r]], plan["cuts"], idx, ef,
                plan, bank)
            rows[r] = self.plane.flatten(edge["units"], edge["head"])
            loss_sum = loss_sum + ls
            cnt += c
            self.samples[r] += w
            if bank_r is not None:
                if banked is None:
                    banked = torch.zeros_like(self.stale_num)
                banked[r] = bank_r
        self.edge_planes = torch.stack(rows)
        if self.fz:
            self.stale_num = banked if banked is not None \
                else torch.zeros_like(self.stale_num)
        return loss_sum, cnt

    def _train_parallel(self, plan, idx, ef, dev):
        par, planes = plan["par"], self.edge_planes
        bank = None
        if self.fz and plan["bank_in"].any():
            bank = (self.faults.staleness_discount, self.stale_num)
        merged, loss_sum, nbytes, banked = self.schedule.run_round(
            planes, par, dev, idx, self.wire_res if ef else None, bank)
        if self.fz:
            self.stale_num = banked if banked is not None \
                else torch.zeros_like(self.stale_num)
        if self.sz:
            merged = self._stream_commit(planes, merged, plan["stream"], dev)
        self.edge_planes = merged
        self.samples += par.w_seg
        self.wire_bytes += nbytes
        if par.fault is None:
            steps = self._steps()
            self.bucket_steps += sum(len(b.pages)
                                     for b in par.buckets) * steps
            self.rsu_bucket_steps += sum(len(pg.runs) for b in par.buckets
                                         for pg in b.pages) * steps
            return loss_sum, par.n_slots * steps
        for step in par.fault.steps:
            self.bucket_steps += sum(len(sb.sub.pages) for sb in step)
            self.rsu_bucket_steps += sum(len(pg.runs) for sb in step
                                         for pg in sb.sub.pages)
        return loss_sum, int(np.sum(plan["dstep"][plan["cuts"] > 0]))

    def _stream_commit(self, planes, merged, sp, dev):
        """The StreamBuffer commit of one round (:func:`superstep.
        plan_stream`): each RSU that merged sample weight pushes its delta
        ``merged - planes`` into its next free slot; a full buffer's RSU
        moves to ``planes + sum_b kw_b delta_b / den``; the rest keep
        ``planes``."""
        if sp.pushes:     # one (rsu, slot) each: no index is written twice
            rs = dev("push_rsu")
            self.sbuf[rs, dev("push_slot")] = merged[rs] - planes[rs]
        if not sp.fire.any():
            return planes
        step = planes + torch.einsum("rb,rbp->rp", dev("kw"),
                                     self.sbuf) / dev("den_b")[:, None]
        return torch.where(dev("fire")[:, None] > 0, step, planes)

    def _train_round(self, plan, staged, i):
        """Round ``plan`` on the device; host bookkeeping only (no read
        back).  Returns (loss sum on the device, client batch steps,
        handover mask)."""
        cfg = self.cfg
        cuts, serving = plan["cuts"], plan["serving"]
        sched = cuts > 0
        idx = staged.get(("idx", i))
        ef = cfg.wire_scheme() == "topk_int8"
        if ef:      # a residual is laid out for the cut it was built at
            for v in np.nonzero(sched & (cuts != self.wire_cut))[0]:
                self.wire_res[v] = None
        if self.parallel:
            loss_sum, cnt = self._train_parallel(
                plan, idx, ef, lambda *k: staged.get((i,) + k))
        else:
            loss_sum, cnt = self._train_sequential(plan, idx, ef)
        post = plan["post"]
        if self.cz:
            self.present = post["present"]
        if self.fz:
            self.stale_den = post["stale_den"]
        if self.sz:
            self.sbuf_w, self.sbuf_age, self.sbuf_cnt = post["sbuf"]
        self.batch_steps += cnt
        if ef:
            self.wire_cut = np.where(sched, cuts, self.wire_cut)
        handover = sched & (self.prev >= 0) & (self.prev != serving)
        self.prev = np.where(serving >= 0, serving, -1)
        if (plan["rnd"] + 1) % self.cloud_sync_every == 0:
            self._set_global(aggregation.stacked_cloud_merge(
                self.edge_planes, self.samples,
                self.plane.flatten(self.units, self.head)))
            self.samples[:] = 0.0
        return loss_sum, cnt, handover

    def run_superstep(self, rnd0: int, k: int) -> List[ScenarioRoundMetrics]:
        """Rounds [rnd0, rnd0 + k) as one window: planned on the host
        (raising before any state changes if a cohort overflows its slot
        table), staged on the device in one copy, run back to back, and
        their losses read back once.  Returns their metrics; the eval
        score goes to the last synced round."""
        horizon = max(self.cfg.rounds, rnd0 + k)
        cap = self._capacity(horizon)
        slots = SS.page_padded_slots(self._total_slots(horizon), self.page)
        ps = self._host_planes()
        plans = [self._plan(r, cap, slots, ps) for r in range(rnd0, rnd0 + k)]
        arrays: Dict[Any, np.ndarray] = {}
        for i, plan in enumerate(plans):
            arrays[("idx", i)] = plan["idx"]
            if self.parallel:
                SS.stage_parallel(plan["par"], i, arrays)
                if self.fz and plan["bank_in"].any():
                    arrays[(i, "st_den")] = plan["bank_in"]
                sp = plan.get("stream")
                if sp is not None and sp.pushes:
                    arrays[(i, "push_rsu")], arrays[(i, "push_slot")] = \
                        np.array(sp.pushes, np.int64).T
                if sp is not None and sp.fire.any():
                    arrays[(i, "kw")] = sp.kw
                    arrays[(i, "den_b")] = sp.den
                    arrays[(i, "fire")] = sp.fire.astype(np.float32)
        staged = SS.Staged(arrays, self.device)
        runs = [self._train_round(plan, staged, i)
                for i, plan in enumerate(plans)]
        losses = torch.stack([ls for ls, _, _ in runs]).tolist()
        out, eval_due, last_synced = [], False, None
        for i, (plan, (_, cnt, handover)) in enumerate(zip(plans, runs)):
            out.append(self._round_metrics(plan, losses[i] / max(float(cnt),
                                                                1.0),
                                           handover))
            if (plan["rnd"] + 1) % self.cloud_sync_every == 0:
                ev = self.cfg.eval_every
                if ev and self._sync_count % ev == 0:
                    eval_due = True
                self._sync_count += 1
                last_synced = i
        if eval_due:
            # the global model changes only at syncs: the current one is
            # the last synced round's
            out[last_synced].test_acc = evaluate(self.model, self.units,
                                                 self.head, self.test)
        return out

    def _round_metrics(self, plan, loss: float,
                       handover) -> ScenarioRoundMetrics:
        cuts, serving = plan["cuts"], plan["serving"]
        sched = cuts > 0
        comm, lat, energy = self._accounting(plan, sched, handover)
        m = ScenarioRoundMetrics(
            plan["rnd"], loss, float("nan"), comm, lat, energy,
            n_scheduled=int(sched.sum()),
            n_skipped=int(((serving >= 0) & ~sched).sum()),
            n_handover=int(handover.sum()),
            rsu_loads=[int(c) for c in plan["counts"]],
            cuts=[int(c) for c in cuts],
            absorbed_samples=float(self.lengths[plan["surv"]].sum()))
        if self.fz:
            bytes_cum = np.concatenate(
                [[0.0], np.cumsum(self.profile.unit_param_bytes)])
            m.n_dropout = int(plan["drop"].sum())
            m.n_upload_lost = int(plan["lost"].sum())
            m.n_straggler = int(plan["strag"].sum())
            m.n_rsu_down = int(plan["rsu_down"].sum())
            m.survivor_frac = (float(plan["surv"].sum())
                               / max(int(sched.sum()), 1))
            # stragglers are banked, not lost: only drop / lost updates die
            m.lost_update_bytes = float(
                bytes_cum[cuts[plan["drop"] | plan["lost"]]].sum())
            m.stale_merged = plan["stale_w"]
        if self.cz:
            m.n_present, m.n_arrived = plan["n_present"], plan["n_arrived"]
        if self.sz:
            # absorption happens when a buffer fires
            sp = plan["stream"]
            m.absorbed_samples = sp.absorbed
            m.stream_merges = sp.fires
            m.buffer_occupancy = sp.occupancy
            m.stream_stale = sp.stale
        return m

    def run_round(self, rnd: int) -> ScenarioRoundMetrics:
        return self.run_superstep(rnd, 1)[0]

    def run(self,
            on_round: Optional[Callable[[ScenarioRoundMetrics],
                                        None]] = None,
            on_cloud_merge: Optional[Callable[[int, "ScenarioEngine"],
                                              None]] = None,
            on_stream_merge: Optional[Callable[[ScenarioRoundMetrics,
                                                "ScenarioEngine"],
                                               None]] = None
            ) -> List[ScenarioRoundMetrics]:
        """Run ``cfg.rounds`` rounds in windows of ``superstep`` rounds;
        after each window ``on_round(metrics)`` for each of its rounds,
        ``on_cloud_merge(rnd, engine)`` after each of its cloud syncs and
        ``on_stream_merge(metrics, engine)`` after each of its rounds in
        which a StreamBuffer fired (each seeing the engine as the window
        left it)."""
        k = max(int(self.cfg.superstep), 1)
        for rnd0 in range(0, self.cfg.rounds, k):
            window = self.run_superstep(rnd0, min(k, self.cfg.rounds - rnd0))
            self.history.extend(window)
            for m in window:
                if on_round is not None:
                    on_round(m)
                if (on_cloud_merge is not None
                        and (m.round + 1) % self.cloud_sync_every == 0):
                    on_cloud_merge(m.round, self)
                if on_stream_merge is not None and m.stream_merges > 0:
                    on_stream_merge(m, self)
        return self.history

    def _accounting(self, plan, sched, handover):
        """Analytic comm / latency / energy over the scheduled vehicles,
        plus the handover migration bytes (the vehicle-side sub-model
        re-downloaded at the new cell).  Each vehicle pays the steps it
        performed, a dropout no model upload, and the round's latency is
        the slowest merged survivor's."""
        cfgc, cuts = self.cfg, plan["cuts"]
        act = np.nonzero(sched)[0]
        bytes_cum = np.concatenate(
            [[0.0], np.cumsum(self.profile.unit_param_bytes)])
        ho_bytes = float(bytes_cum[cuts[handover]].sum())
        if not len(act):
            return ho_bytes, 0.0, 0.0
        rc = cost.sfl_round_cost_arrays(
            self.profile, cuts[act], plan["dstep"][act], cfgc.batch_size,
            np.maximum(np.asarray(plan["rates"], np.float64)[act], 1.0),
            self.fa["compute_flops"][act], cfgc.server_flops, 1,
            self.fa["tx_power_w"][act], self.fa["compute_power_w"][act],
            wire=cfgc.wire_scheme(), wire_k=cfgc.wire_k,
            model_upload=~plan["drop"][act])
        lat = float(np.max(rc.latency[plan["surv"][act]], initial=0.0))
        return (float(rc.comm_bytes.sum()) + ho_bytes, lat,
                float(rc.energy_j.sum()))
