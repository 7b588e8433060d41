"""Federation simulators: single-RSU SFL / ASFL and the multi-RSU
scenario engine (twin of ``repro.core.fedsim``).

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

``CohortEngine.split_round`` runs one single-RSU round as a per-replica
loop in the reference's update order (``_bucket_unroll``): buckets in
ascending cut, members in ascending client index, the one shared RSU model
and optimizer state threaded through every client batch (paper §III-B),
then a unit-wise |D_n|-weighted FedAvg with the RSU copy of every unit it
trained.

``ScenarioEngine`` runs the multi-RSU vehicular setting: mobility and
handover from a scenario, cuts from rates or residence time, one cohort
per RSU trained against that RSU's edge model in the reference's
sequential server schedule, error-feedback residuals on the ``topk_int8``
wire, and a sample-weighted edge->cloud merge every ``cloud_sync_every``
rounds.  It follows the reference's per-round fused program at K = 1 as a
per-replica loop, the way ``split_round`` follows ``_bucket_unroll``.

Ported: schemes ``sfl`` / ``asfl`` with the host cut strategies, and the
scenario engine at one round per dispatch on the sequential schedule.
Not ported yet (``SimConfig`` raises on a non-default value): cl / fl /
sl, the fault and streaming planes, super-steps (K > 1), the mesh, the
parallel and streaming server schedules and the XLA execution knobs.
``slot_capacity`` and ``superstep_layout`` choose how the reference lays
its slot tables out in XLA; under the sequential schedule both give the
same math, so the port accepts and ignores them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim
from repro_torch.core import adaptive, aggregation, channel, compression, cost
from repro_torch.data.pipeline import (ClientDataset, fleet_batch_indices,
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

    def head_loss(self, head, feats, labels):
        logits = self.head_predict(head, feats)
        return F.cross_entropy(logits, labels.long()), logits

    def profile(self):
        return cost.resnet_profile()


# valid values of every categorical SimConfig field (the reference's)
SCHEMES = ("cl", "fl", "sl", "sfl", "asfl")
ADAPTIVE_STRATEGIES = ("paper", "paper-literal", "latency", "energy",
                       "memory", "residence")
SLOT_CAPACITIES = ("pow2", "tight8")
COHORT_MODES = ("auto", "vmap", "scan", "unroll")
OPTIMIZERS = ("adam", "sgd", "momentum")
WIRE_SCHEMES = compression.WIRE_SCHEMES
SERVER_SCHEDULES = ("sequential", "parallel", "streaming")
SUPERSTEP_LAYOUTS = ("ragged", "dense")
FLEET_AXES = ("auto", "vehicle", "rsu", "grid")
FEDERATION_STRATEGIES = ("paper", "paper-literal", "latency", "energy",
                         "memory")
SCENARIO_STRATEGIES = ("paper", "paper-literal", "residence")
PORTED_SCHEMES = ("sfl", "asfl")
# SimConfig fields whose planes are not ported yet: a non-default value
# raises instead of being silently ignored
NOT_PORTED_FIELDS = (
    "mobility_dropout", "fault_coverage", "fault_dropout",
    "fault_upload_loss", "fault_straggler", "fault_rsu_outage",
    "fault_staleness_discount", "fault_seed", "stream_buffer_size",
    "stream_churn_rate", "stream_kernel", "stream_alpha", "stream_seed",
    "cohort_parallel", "server_schedule", "superstep",
    "compilation_cache_dir",
    "mesh_devices", "fleet_axis", "mesh_shape", "page_slots",
    "stream_churn_source")


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
        if self.scheme not in PORTED_SCHEMES:
            raise NotImplementedError(
                f"SimConfig.scheme={self.scheme!r}: not ported yet; the "
                f"PyTorch port runs {' | '.join(PORTED_SCHEMES)}")
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
    sv_req, sv_t, sv_rebuild = _requires_grad(sv)
    sent = smashed.detach()
    if error_feedback and res is not None:
        sent = sent + res
    packed = False
    if cfg.wire_scheme() == "topk_int8":                        # uplink
        d = sent.shape[-1]
        buf = wire_kernels.sparsify_quant_pack(sent.contiguous(), cfg.wire_k)
        up_bytes = 4 * buf.numel()
        if error_feedback:
            res = sent - wire_kernels.unpack_dequant(buf, d, cfg.wire_k,
                                                     dtype=sent.dtype)
        packed = hasattr(model, "apply_units_packed")
        if packed:      # the RSU's first matmul reads the buffer itself
            feats, entry = model.apply_units_packed(sv_t["units"], buf, cut,
                                                    cfg.wire_k)
        else:
            entry = wire_kernels.unpack_dequant(
                buf, d, cfg.wire_k, dtype=sent.dtype).requires_grad_(True)
            feats = model.apply_units(sv_t["units"], entry, cut)
    else:
        recv, up_bytes = wire_trip(cfg, sent)
        entry = recv.detach().requires_grad_(True)              # RSU leaf
        feats = model.apply_units(sv_t["units"], entry, cut)
    loss, logits = model.head_loss(sv_t["head"], feats, y)
    grads = torch.autograd.grad(loss, sv_req + [entry])
    g_cut = grads[-1]
    if packed:
        g_cut = model.entry_input_grad(sv_t["units"], g_cut)
    g_recv, down_bytes = wire_trip(cfg, g_cut)                  # downlink
    g_cu = torch.autograd.grad(smashed, cu_req, grad_outputs=g_recv)
    with torch.no_grad():
        upd_c, co2 = opt.update(cu_rebuild(list(g_cu)), co, cu)
        cu2 = optim.apply_updates(cu, upd_c)
        upd_s, so2 = opt.update(sv_rebuild(list(grads[:-1])), so, sv)
        sv2 = optim.apply_updates(sv, upd_s)
    return (sv2, so2, cu2, co2, loss.detach(), logits.detach(),
            up_bytes + down_bytes, res if error_feedback else None)


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
    the batching is part of the definition, as in the reference)."""
    n = test["labels"].shape[0]
    correct = 0
    for i in range(0, n, batch):
        feats = model.apply_units(units, test["images"][i:i + batch], 0)
        logits = model.head_predict(head, feats)
        correct += int((logits.argmax(-1)
                        == test["labels"][i:i + batch]).sum())
    return correct / max(n, 1)


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
    """Runs whole split-federation rounds on one device.

    One instance per simulation: it owns the stacked client data (staged on
    the device once) and counts what crossed the wire.  The schedule is the
    reference's ``unroll`` order as a per-replica loop; the vmap/scan
    schedules of the JAX engine are XLA compilation strategies for the same
    math and have no counterpart here yet."""
    mode = "loop"

    def __init__(self, model, cfg: SimConfig,
                 clients: Sequence[ClientDataset], device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.opt = optim.from_name(cfg.optimizer, cfg.lr)
        self.stacked = stack_clients(clients, device)
        self.batch_steps = 0      # client batch steps run (lifetime)
        self.wire_bytes = 0       # bytes across the wire, both directions

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
                    trees += [bstates[bi][0][i][u] for i in range(n)]
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
        bstates = []
        for cut, n in plan.cuts_sig:
            bstates.append(([list(units[:cut]) for _ in range(n)],
                            [opt.init(list(units[:cut])) for _ in range(n)]))
        idx = [torch.as_tensor(i, dtype=torch.long, device=dev)
               for i in plan.bucket_idx]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        cnt = 0
        for s in range(plan.steps):
            for bi, (cut, n) in enumerate(plan.cuts_sig):
                cus, cos = bstates[bi]
                sv = {"units": list(server["units"][cut:]),
                      "head": server["head"]}
                so = _suffix_state(s_opt, cut)
                for i in range(n):
                    if not plan.bucket_mask[bi][s, i]:
                        continue
                    row = int(plan.bucket_rows[bi][i])
                    x = self.stacked.images[row][idx[bi][s, i]]
                    y = self.stacked.labels[row][idx[bi][s, i]]
                    sv, so, cus[i], cos[i], loss, _, nbytes, _ = \
                        sfl_message_flow(self.model, self.cfg, opt, cut,
                                         sv, so, cus[i], cos[i], x, y)
                    loss_sum = loss_sum + loss
                    cnt += 1
                    self.wire_bytes += nbytes
                server = {"units": list(server["units"][:cut])
                          + list(sv["units"]), "head": sv["head"]}
                s_opt = _merge_state(s_opt, so, cut)
        self.batch_steps += cnt
        units, head = self._split_agg(plan, server, bstates)
        return units, head, loss_sum, cnt


def _to_device(tree, device):
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def _stage_test(test: Dict[str, Any], device: torch.device):
    return {"images": torch.as_tensor(np.asarray(test["images"], np.float32),
                                      device=device),
            "labels": torch.as_tensor(np.asarray(test["labels"], np.int64),
                                      device=device)}


class FederationSim:
    """The single-RSU SFL / ASFL simulator on one device (``cuda`` unless
    ``device="cpu"`` is passed; raises without a card)."""

    def __init__(self, model, clients: Sequence[ClientDataset],
                 test: Dict[str, Any], cfg: SimConfig,
                 fleet: Optional[List[channel.VehicleProfile]] = None,
                 ch_cfg: Optional[channel.ChannelConfig] = None, *,
                 device: DeviceLike = None):
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
        the reference's weights with :meth:`set_params`) and history."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        units, head = self.model.init(gen)
        self.set_params(units, head)
        self.history: List[RoundMetrics] = []

    def set_params(self, units, head):
        """Load global parameters (port layout) onto the sim's device."""
        self.units = [_to_device(u, self.device) for u in units]
        self.head = _to_device(head, self.device)

    def _local_steps(self, client: ClientDataset) -> int:
        if self.cfg.local_steps is not None:
            return self.cfg.local_steps
        nb = max(len(client) // self.cfg.batch_size, 1)
        return nb * self.cfg.local_epochs

    def _round_rates(self, rnd: int) -> np.ndarray:
        t = rnd * self.cfg.round_interval_s
        return channel.sample_round_rates(self.ch, self.fleet_arr, t,
                                          self.cfg.seed * 1000 + rnd)

    def _pick_cuts(self, rates: np.ndarray) -> List[int]:
        c = self.cfg
        if c.scheme == "sfl":
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
        """Run ``cfg.rounds`` rounds; ``on_round`` gets each round's
        metrics as it completes."""
        for rnd in range(self.cfg.rounds):
            metrics = self._parallel_split_round(rnd)
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

    def _plan_split_round(self, rnd: int, cuts: List[int],
                          participants: List[int]) -> RoundPlan:
        """Bucket participants by cut (ascending, members by client index)
        and pre-draw every member's batch-index stream for the round."""
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
                w[j] = ln
                for s in range(self._local_steps(self.clients[ci])):
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
        with the unit-wise FedAvg and the analytic cost model."""
        cfgc = self.cfg
        rates = self._round_rates(rnd)
        participants = list(range(len(self.clients)))
        cuts = [max(1, min(c, self.model.n_units - 1))
                for c in self._pick_cuts(rates)]
        plan = self._plan_split_round(rnd, cuts, participants)
        self.units, self.head, ls, cnt = self.engine.split_round(
            self.units, self.head, plan, cfgc.batch_size)
        part = np.asarray(participants)
        rc = cost.sfl_round_cost_arrays(
            self.profile, np.asarray(cuts)[part],
            np.array([max(len(self.clients[ci]) // cfgc.batch_size, 1)
                      for ci in participants]),
            cfgc.batch_size, rates[part],
            self.fleet_arr["compute_flops"][part], cfgc.server_flops,
            cfgc.local_epochs, self.fleet_arr["tx_power_w"][part],
            self.fleet_arr["compute_power_w"][part],
            wire=cfgc.wire_scheme(), wire_k=cfgc.wire_k)
        return self._metrics(rnd, float(ls) / max(float(cnt), 1.0), cuts,
                             float(rc.comm_bytes.sum()),
                             float(rc.latency.max()),
                             float(rc.energy_j.sum()))


# --------------------------------------------------------------------------
# multi-RSU scenario engine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioRoundMetrics:
    """The reference's per-round scenario metrics, field for field (the
    fault and streaming fields keep their defaults: those planes are not
    ported yet)."""
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
    n_dropout: int = 0
    n_upload_lost: int = 0
    n_straggler: int = 0
    n_rsu_down: int = 0
    survivor_frac: float = 1.0
    lost_update_bytes: float = 0.0
    stale_merged: float = 0.0
    n_present: int = -1
    n_arrived: int = 0
    absorbed_samples: float = 0.0   # sample weight merged into edge models
    stream_merges: int = 0
    buffer_occupancy: float = 0.0
    stream_stale: float = 0.0


class ScenarioEngine:
    """Multi-RSU federation over a mobility scenario, with handover and
    hierarchical edge->cloud aggregation (twin of the reference's
    ``ScenarioEngine`` at ``superstep=1`` on the ``sequential`` server
    schedule).  Per round:

    1. Fleet state from ``fleet_states(rnd)`` (default: the scenario's
       host ``fleet_state(rnd * round_interval_s, seed * 1000 + rnd)``);
       rates and residence are taken as float32, as the reference's
       program sees them.
    2. Cuts: ``paper`` / ``paper-literal`` Eq. 3 banding, or
       ``residence``-aware deadline feasibility (0 = SKIP); uncovered
       vehicles get 0.
    3. Every RSU trains its cohort -- slots in ascending (cut, vehicle) --
       against its edge model with a fresh optimizer state: each local
       step runs the slots in order through one shared RSU state (paper
       §III-B), each vehicle on its own replica of the units before its
       cut; then the unit-wise |D_n|-weighted FedAvg with the RSU copy.
    4. On ``topk_int8`` every vehicle carries an error-feedback residual,
       indexed by vehicle (it follows the vehicle across handover) and
       zeroed when the vehicle's cut changes.
    5. Every ``cloud_sync_every`` rounds the sample-weighted cloud merge
       re-seeds every edge model from the global one.

    Handover (a scheduled vehicle whose cell differs from its last
    covered cell) moves the vehicle and its data; server-side state stays
    at the RSU, and the vehicle-side model re-download is charged in the
    accounting.  ``batch_indices(rnd) -> (steps, n, batch)`` (default: the
    numpy :func:`fleet_batch_indices`) and ``fleet_states`` exist so the
    parity tests can feed both engines the reference's threefry draws."""
    mode = "loop"

    def __init__(self, model, clients: Sequence[ClientDataset],
                 test: Dict[str, Any], cfg: SimConfig, scenario,
                 cloud_sync_every: int = 1, *, device: DeviceLike = None,
                 fleet_states: Optional[Callable[[int], Any]] = None,
                 batch_indices: Optional[Callable[[int], np.ndarray]] = None):
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
        self.batch_steps = 0      # client batch steps run (lifetime)
        self.wire_bytes = 0       # bytes across the wire, both directions
        self.reset()

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
        self.units = [_to_device(u, self.device) for u in units]
        self.head = _to_device(head, self.device)
        self.edges = [{"units": list(self.units), "head": self.head}
                      for _ in range(self.n_rsus)]
        n = len(self.clients)
        self.samples = np.zeros(self.n_rsus, np.float32)
        self.prev = np.full(n, -1, np.int64)        # last covered cell
        self.wire_res: List[Optional[torch.Tensor]] = [None] * n
        self.wire_cut = np.full(n, -1, np.int64)    # cut of each residual
        self._sync_count = 0

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

    # ---- the rounds ---------------------------------------------------
    def _rsu_round(self, edge, members, cuts, idx, ef):
        """One RSU's round on its edge model (sequential schedule): fresh
        RSU and replica optimizer states, ``steps`` passes over the slots
        in order, then the unit-wise FedAvg.  Returns (edge model, loss
        sum, client batch steps, sample weight)."""
        opt, model = self.opt, self.model
        sv = {"units": list(edge["units"]), "head": edge["head"]}
        so = opt.init(sv)
        cus = [list(edge["units"][:cuts[v]]) for v in members]
        cos = [opt.init(cu) for cu in cus]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = 0
        for s in range(self._steps()):
            for i, v in enumerate(members):
                v, cut = int(v), int(cuts[v])
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
        # unit-wise FedAvg: replicas of every unit before their cut, and the
        # RSU copy at the weight of every member that did not own the unit
        w_slots = self.lengths[members].astype(np.float32)
        w_total = np.float32(w_slots.sum(dtype=np.float32))
        den = float(max(w_total, np.float32(1.0)))
        merged = []
        for u in range(model.n_units):
            own = [i for i, v in enumerate(members) if cuts[v] > u]
            w_own = w_slots[own]
            swu = np.float32(w_total - w_own.sum(dtype=np.float32))
            num = aggregation.weighted_sum(
                [cus[i][u] for i in own] + [sv["units"][u]],
                list(w_own) + [swu])
            merged.append(tree_map(lambda nm, ref: (nm / den).to(ref.dtype),
                                   num, sv["units"][u]))
        return ({"units": merged, "head": sv["head"]}, loss_sum, cnt,
                w_total)

    def run_round(self, rnd: int) -> ScenarioRoundMetrics:
        cfg = self.cfg
        st = self.fleet_states(rnd)
        serving = np.asarray(st.serving_rsu, np.int64)
        rates = np.asarray(st.rates_bps, np.float32)
        residence = np.asarray(st.residence_s, np.float32)
        cuts = self._pick_cuts(serving, rates, residence)
        sched = cuts > 0
        idx = torch.as_tensor(np.array(self.batch_indices(rnd), np.int64),
                              device=self.device)
        ef = cfg.wire_scheme() == "topk_int8"
        if ef:      # a residual is laid out for the cut it was built at
            for v in np.nonzero(sched & (cuts != self.wire_cut))[0]:
                self.wire_res[v] = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = 0
        counts = np.zeros(self.n_rsus, np.int64)
        for r in range(self.n_rsus):
            members = sorted(np.nonzero(sched & (serving == r))[0],
                             key=lambda v: (cuts[v], v))
            counts[r] = len(members)
            if not members:
                continue
            self.edges[r], ls, c, w = self._rsu_round(
                self.edges[r], np.asarray(members), cuts, idx, ef)
            loss_sum = loss_sum + ls
            cnt += c
            self.samples[r] += w
        self.batch_steps += cnt
        if ef:
            self.wire_cut = np.where(sched, cuts, self.wire_cut)
        handover = sched & (self.prev >= 0) & (self.prev != serving)
        self.prev = np.where(serving >= 0, serving, -1)
        comm, lat, energy = self._accounting(rates, cuts, sched, handover)
        m = ScenarioRoundMetrics(
            rnd, float(loss_sum) / max(float(cnt), 1.0), float("nan"), comm,
            lat, energy, n_scheduled=int(sched.sum()),
            n_skipped=int(((serving >= 0) & ~sched).sum()),
            n_handover=int(handover.sum()),
            rsu_loads=[int(c) for c in counts],
            cuts=[int(c) for c in cuts],
            absorbed_samples=float(self.lengths[sched].sum()))
        if (rnd + 1) % self.cloud_sync_every == 0:
            glob = aggregation.cloud_merge(
                self.edges, self.samples,
                {"units": list(self.units), "head": self.head})
            self.units, self.head = list(glob["units"]), glob["head"]
            self.edges = [{"units": list(self.units), "head": self.head}
                          for _ in range(self.n_rsus)]
            self.samples[:] = 0.0
            ev = cfg.eval_every
            if ev and self._sync_count % ev == 0:
                m.test_acc = evaluate(self.model, self.units, self.head,
                                      self.test)
            self._sync_count += 1
        return m

    def run(self,
            on_round: Optional[Callable[[ScenarioRoundMetrics],
                                        None]] = None,
            on_cloud_merge: Optional[Callable[[int, "ScenarioEngine"],
                                              None]] = None
            ) -> List[ScenarioRoundMetrics]:
        """Run ``cfg.rounds`` rounds; ``on_round(metrics)`` after each,
        ``on_cloud_merge(rnd, engine)`` after each cloud sync."""
        for rnd in range(self.cfg.rounds):
            m = self.run_round(rnd)
            self.history.append(m)
            if on_round is not None:
                on_round(m)
            if (on_cloud_merge is not None
                    and (rnd + 1) % self.cloud_sync_every == 0):
                on_cloud_merge(rnd, self)
        return self.history

    def _accounting(self, rates, cuts, sched, handover):
        """Analytic comm / latency / energy over the scheduled vehicles,
        plus the handover migration bytes (the vehicle-side sub-model
        re-downloaded at the new cell)."""
        cfgc = self.cfg
        act = np.nonzero(sched)[0]
        bytes_cum = np.concatenate(
            [[0.0], np.cumsum(self.profile.unit_param_bytes)])
        ho_bytes = float(bytes_cum[cuts[handover]].sum())
        if not len(act):
            return ho_bytes, 0.0, 0.0
        nb, ep = self._nb_ep()
        rc = cost.sfl_round_cost_arrays(
            self.profile, cuts[act], nb, cfgc.batch_size,
            np.maximum(np.asarray(rates, np.float64)[act], 1.0),
            self.fa["compute_flops"][act], cfgc.server_flops, ep,
            self.fa["tx_power_w"][act], self.fa["compute_power_w"][act],
            wire=cfgc.wire_scheme(), wire_k=cfgc.wire_k)
        return (float(rc.comm_bytes.sum()) + ho_bytes,
                float(rc.latency.max()), float(rc.energy_j.sum()))
