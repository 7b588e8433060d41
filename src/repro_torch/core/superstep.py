"""The parallel server schedule, the slot tables and the super-step window
of the multi-RSU scenario engine (twin of ``repro.core.superstep``).

**Slots.**  Each round, one sort of (serving RSU, cut, vehicle) keys
(:func:`slot_sort`; unscheduled vehicles get segment R and sort last)
orders the fleet RSU-major, each RSU's vehicles in ascending (cut,
vehicle) order: the reference's server-update order.  Two layouts lay the
sorted order out as one flat slot table (:func:`slot_table_flat`):
``ragged`` is its prefix padded to the compacted capacity S (the largest
covered count of any round, rounded by ``slot_capacity``), ``dense`` the
flattened padded (R, C) table (C the largest covered count of any cell).
The occupied slots come out in the same order under both; a phantom slot
(segment R) carries weight 0.  Capacities are rounded to a power of two
(``pow2``) or the next multiple of 8 (``tight8``) by :func:`round_capacity`.

**The parallel schedule** (arXiv:2405.18707, "Adaptive and Parallel Split
Federated Learning in Vehicular Edge Computing"; the reference's
``par_slot_grad`` / ``fleet_round_par``).  Per local step every occupied
slot runs a forward and backward: the units before its cut from its own
replica, the rest from its serving RSU's model as it stood at the start of
the step.  Each RSU then takes ONE optimizer step on the |D_n|-weighted
mean of its slots' server-side gradients, ``sum_j gw_j g_j`` with ``gw_j =
w_j / max(sum_seg w, 1)``, and every replica its own step on its prefix.
An RSU without an occupied slot keeps its model.  After the local steps
the unit-wise FedAvg merges each unit over the replicas that own it and
the RSU copy at the remaining weight, ``(num + w_srv * sv) / den``; the
head and every unit no replica owns merge as ``(w_seg * sv) / den``.
Optimizer states are fresh every round.

**Formulation.**  The reference makes the cut data on one flat (P,)
parameter plane and selects a codec candidate at every unit boundary, so
that every shape is static for XLA.  The port groups the slots by cut
instead, as ``CohortEngine._bucket_vmap`` does.  Per local step and cut
bucket c (ascending; the bucket's slots in slot order, so RSU-major):

* the vehicle side runs as ``torch.func.vmap`` over the replicas (units
  ``[0, c)``, stacked) under ``torch.func.vjp``;
* the smashed tensors of the bucket go up the wire in one codec call per
  direction (and, on ``topk_int8``, the error-feedback residual of every
  slot is added before the pack and renewed from one unpack);
* the server side (units ``[c, U)`` and the head) runs as
  ``torch.func.vmap`` over the slots, each with its RSU's model gathered,
  under ``torch.func.vjp``: every slot's own gradient, as the reference's
  ``par_slot_grad`` gives it;
* each RSU's share, ``sum_j gw_j g_j`` over its run of the bucket, is a
  ``torch.sum`` over that run's slots;
* the cut-layer gradients come back down in one codec call and one
  ``vjp`` gives every replica its gradient; ``torch.func.vmap`` of the
  optimizer steps them all.

Models and replicas ride as flat float32 vectors (:class:`FlatPlane`:
units in order, then the head): a replica is the prefix of its cut, the
server side of a slot the suffix.  On ``topk_int8`` a model with a packed
RSU entry (mlp9) reads the buffer itself: one ``unpack_dequant_matmul``
per RSU with slots in the bucket (its rows, its first weight); the dense
floats of the same words, which the vehicle decodes for its residual,
give each slot's first-weight gradient ``dense^T g`` (what the fused
matmul's backward decodes).  Codec launches per (cut bucket, local step):
``int8`` 2 ``quantize_int8`` and 2 ``dequantize_int8``; ``topk_int8`` 2
``sparsify_quant_pack`` (up, down), 2 ``unpack_dequant`` (the residual,
the downlink) and, with a packed entry, one ``unpack_dequant_matmul`` per
RSU in the bucket (else a third unpack for the RSU's input).

**Determinism and the layouts.**  Every sum is a ``torch.sum`` or a
matmul over tensors of fixed shape (no ``index_add_``, whose CUDA kernel
adds with float atomics), so two runs of a window give the same bits.
Phantom slots have no cut bucket to run in: neither layout computes them,
so their contribution is the exact zero the reference multiplies in, and
the two layouts run the same operations on the same occupied slots: bit
for bit the same training.  The layout decides the slot table, its
capacity checks and :meth:`occupancy_stats` of the engine.

**The window** (``superstep`` K).  The engine plans K rounds on the host
(fleet states, cuts, slot tables, the capacity checks, which raise before
any state changes), stages their index arrays on the device in one copy,
runs them back to back with the per-round losses left on the device, and
reads them back in one transfer at the end of the window.  K rounds in one
window are the same operations as K windows of one round, so they agree
bit for bit.  The reference's CUDA-graph counterpart (``lax.scan`` over
rounds with donation) is not ported, nor its in-program (threefry)
mobility: the port's mobility is the host scenario.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import optim
from repro_torch.kernels import wire as wire_kernels
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

SERVER_SCHEDULES = ("sequential", "parallel", "streaming")
SUPERSTEP_LAYOUTS = ("ragged", "dense")
SLOT_CAPACITIES = ("pow2", "tight8")


def cut_prefix_bucket(c_max: int, n_units: int) -> int:
    """pow2-bucket the strategy's static max cut: the smallest power of two
    >= c_max, clipped to U-1 (no vehicle can own the last unit)."""
    c = max(int(c_max), 1)
    b = 1
    while b < c:
        b *= 2
    return min(b, max(int(n_units) - 1, 1))


def owned_window(unit_ids: np.ndarray, bucket: int):
    """(offset, width) of the contiguous plane window holding every
    position with ``unit_ids < bucket``: all positions a vehicle can own at
    any cut <= bucket.  Contiguity is asserted, not assumed."""
    ids = np.asarray(unit_ids)
    owned = np.nonzero(ids < int(bucket))[0]
    if owned.size == 0:
        return 0, 0
    off, width = int(owned[0]), int(owned.size)
    if not np.array_equal(owned, np.arange(off, off + width)):
        raise AssertionError(
            "owned plane positions are not contiguous; the ragged layout "
            "requires the ravel order to keep units < bucket adjacent")
    return off, width


def round_capacity(count: int, slot_capacity: str) -> int:
    """A slot count rounded as ``slot_capacity`` says: ``pow2`` (the
    smallest power of two >= count) or ``tight8`` (the next multiple of
    8); at least 1."""
    if slot_capacity not in SLOT_CAPACITIES:
        raise ValueError(f"slot_capacity must be one of {SLOT_CAPACITIES}, "
                         f"got {slot_capacity!r}")
    mx = max(int(count), 1)
    if slot_capacity == "tight8":
        return ((mx + 7) // 8) * 8
    return 1 << max(mx - 1, 0).bit_length()


# ---------------------------------------------------------------- slots
def slot_sort(serving: np.ndarray, cuts: np.ndarray, n_rsus: int,
              n_units: int):
    """One sort of (serving, cut, vehicle) keys.  Returns (order (n,),
    segment per vehicle (n,): its RSU, or R when unscheduled, counts per
    RSU (R,))."""
    serving = np.asarray(serving, np.int64)
    cuts = np.asarray(cuts, np.int64)
    n = len(cuts)
    seg = np.where(cuts > 0, serving, n_rsus).astype(np.int64)
    key = seg * (n_units * n) + cuts * n + np.arange(n, dtype=np.int64)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(seg[seg < n_rsus], minlength=n_rsus)
    return order, seg, counts[:n_rsus].astype(np.int64)


def slot_table_seq(order: np.ndarray, counts: np.ndarray, capacity: int):
    """Per-RSU (R, C) member slots and their mask (the sequential
    schedule's table; a cohort past C is cut off, as in the reference)."""
    n = len(order)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = np.clip(starts[:, None] + np.arange(capacity)[None, :], 0,
                   max(n - 1, 0))
    members = np.asarray(order)[flat] if n else np.zeros_like(flat)
    mask = np.arange(capacity)[None, :] < counts[:, None]
    return members, mask


def slot_table_flat(order: np.ndarray, seg: np.ndarray, counts: np.ndarray,
                    layout: str, capacity: int, slots: int):
    """The flat slot table of the parallel schedule: (members (S,), slot
    segment (S,), R = phantom).  ``ragged``: the sorted order's prefix,
    padded to ``slots``; ``dense``: the flattened (R, ``capacity``) table.
    The occupied slots appear in the same order under both."""
    n_rsus = len(counts)
    if layout == "ragged":
        seg_sorted = np.asarray(seg)[order]
        if slots <= len(order):
            return np.asarray(order)[:slots], seg_sorted[:slots]
        pad = slots - len(order)
        return (np.concatenate([order, np.zeros(pad, np.int64)]),
                np.concatenate([seg_sorted, np.full(pad, n_rsus, np.int64)]))
    members, mask = slot_table_seq(order, counts, capacity)
    rows = np.repeat(np.arange(n_rsus), capacity)
    slot_seg = np.where(mask.reshape(-1), rows, n_rsus)
    return members.reshape(-1), slot_seg


# -------------------------------------------------------------- the plane
class FlatPlane:
    """The ``{units, head}`` tree as one flat float32 vector: the units in
    order, then the head, each one's leaves in tree order.  A replica at
    cut c is the prefix ``[0, offsets[c])``, the server side the suffix."""

    def __init__(self, units: Sequence[Any], head: Any):
        self.n_units = len(units)
        self._templates = []        # the tree structure of each part
        self._parts = []            # per unit, then the head: (rebuild,
        off = 0                     # [(offset, numel, shape)], dict keys)
        self.offsets = []
        for part in list(units) + [head]:
            self.offsets.append(off)
            leaves, rebuild = tree_flatten(part)
            spec = []
            for leaf in leaves:
                if leaf.dtype != torch.float32:
                    raise TypeError(f"the parameter plane needs float32 "
                                    f"parameters, got {leaf.dtype}")
                spec.append((off, leaf.numel(), tuple(leaf.shape)))
                off += leaf.numel()
            keys = list(part) if isinstance(part, dict) else None
            self._parts.append((rebuild, spec, keys))
            self._templates.append(tree_map(lambda _: None, part))
        self.size = off
        ids = np.empty(off, np.int32)
        for u in range(self.n_units + 1):
            ids[self.offsets[u]:self._end(u)] = u
        self.unit_ids = ids              # U marks the head

    def _end(self, u: int) -> int:
        return self.offsets[u + 1] if u < self.n_units else self.size

    def flatten(self, units, head) -> torch.Tensor:
        """The plane of (units, head), leaves in the plane's order whatever
        the order of the keys of the dicts handed in."""
        leaves = [t.reshape(-1)
                  for tmpl, part in zip(self._templates, list(units) + [head])
                  for t in tree_leaves(tree_map(lambda _, a: a, tmpl, part))]
        return torch.cat(leaves)

    def _part(self, flat: torch.Tensor, u: int, base: int):
        rebuild, spec, _ = self._parts[u]
        return rebuild([flat[o - base:o - base + k].view(shape)
                        for o, k, shape in spec])

    def units(self, flat: torch.Tensor, lo: int, hi: int, base: int = 0):
        """Units ``[lo, hi)`` as views of ``flat``, whose first element is
        plane position ``base``."""
        return [self._part(flat, u, base) for u in range(lo, hi)]

    def tree(self, flat: torch.Tensor, lo: int = 0):
        """(units ``[lo, U)``, head) as views of the suffix ``flat`` that
        starts at unit ``lo``."""
        base = self.offsets[lo]
        return (self.units(flat, lo, self.n_units, base),
                self._part(flat, self.n_units, base))

    def leaf_range(self, u: int, key: str) -> Tuple[int, int]:
        """Plane positions of leaf ``key`` of unit ``u`` (a dict unit)."""
        _, spec, keys = self._parts[u]
        if keys is None or len(keys) != len(spec) or key not in keys:
            raise ValueError(f"unit {u} has no leaf {key!r}")
        o, k, _ = spec[keys.index(key)]
        return o, o + k


# ------------------------------------------------------------- the plans
@dataclasses.dataclass
class Bucket:
    """The occupied slots of one cut in one round, in slot order."""
    cut: int
    members: np.ndarray                 # (n_c,) vehicles
    seg: np.ndarray                     # (n_c,) their RSUs
    w: np.ndarray                       # (n_c,) float32 |D_n|
    gw: np.ndarray                      # (n_c,) float32 w / max(w_seg, 1)
    runs: List[Tuple[int, int, int]]    # (rsu, start, stop) in the bucket


@dataclasses.dataclass
class ParallelPlan:
    """Host side of one parallel round: its buckets (ascending cut) and
    the per-RSU weights of the FedAvg."""
    buckets: List[Bucket]
    w_seg: np.ndarray                   # (R,) float32
    own_w: np.ndarray                   # (R, U + 1) float32, head column 0
    n_slots: int


def plan_parallel(members: np.ndarray, slot_seg: np.ndarray,
                  cuts: np.ndarray, lengths: np.ndarray, n_rsus: int,
                  n_units: int) -> ParallelPlan:
    """The occupied slots of a flat slot table (either layout), grouped by
    cut in slot order, with their weights (float32, as the reference)."""
    occ = np.asarray(slot_seg) < n_rsus
    mem = np.asarray(members)[occ]
    seg = np.asarray(slot_seg)[occ]
    cut = np.asarray(cuts)[mem]
    w = np.asarray(lengths)[mem].astype(np.float32)
    w_seg = np.zeros(n_rsus, np.float32)
    for r in range(n_rsus):              # integer counts: exact in f32
        w_seg[r] = np.sum(w[seg == r], dtype=np.float32)
    den = np.maximum(w_seg, np.float32(1.0))
    gw = (w / den[seg]).astype(np.float32)
    own = np.zeros((n_rsus, n_units + 1), np.float32)
    buckets = []
    for c in np.unique(cut):
        pos = np.nonzero(cut == c)[0]
        bseg = seg[pos]
        runs = []
        for r in np.unique(bseg):
            idx = np.nonzero(bseg == r)[0]
            runs.append((int(r), int(idx[0]), int(idx[-1]) + 1))
            own[r, :int(c)] += np.sum(w[pos][idx], dtype=np.float32)
        buckets.append(Bucket(int(c), mem[pos], bseg, w[pos], gw[pos], runs))
    return ParallelPlan(buckets, w_seg, own, int(occ.sum()))


class Staged:
    """Host arrays copied to the device in one transfer per dtype (float32
    for floating arrays, int64 for the rest); :meth:`get` returns
    views."""

    def __init__(self, arrays: Dict[Any, np.ndarray], device: torch.device):
        self._views: Dict[Any, torch.Tensor] = {}
        groups: Dict[Any, list] = {}
        for key, a in arrays.items():
            a = np.asarray(a)
            kind = (np.float32 if np.issubdtype(a.dtype, np.floating)
                    else np.int64)
            groups.setdefault(kind, []).append((key, a.astype(kind)))
        for kind, items in groups.items():
            flat = np.concatenate([a.reshape(-1) for _, a in items])
            dev = torch.from_numpy(flat).to(device)
            off = 0
            for key, a in items:
                self._views[key] = dev[off:off + a.size].view(a.shape)
                off += a.size

    def get(self, key) -> torch.Tensor:
        return self._views[key]


def stage_parallel(plan: ParallelPlan, key, arrays: Dict[Any, np.ndarray]):
    """Add a round's device arrays to ``arrays`` under ``(key, ...)``."""
    for b, bk in enumerate(plan.buckets):
        arrays[(key, b, "members")] = bk.members
        arrays[(key, b, "seg")] = bk.seg
        arrays[(key, b, "w")] = bk.w
        arrays[(key, b, "gw")] = bk.gw
    arrays[(key, "w_seg")] = plan.w_seg
    arrays[(key, "own_w")] = plan.own_w


# ------------------------------------------------------- the parallel round
class ParallelSchedule:
    """Runs parallel rounds for one engine: ``model``, its flat plane, the
    optimizer, the engine's stacked client data, and ``trip(cfg, x) ->
    (received, bytes)``, one stateless trip over the configured wire (the
    downlink, and the uplink off ``topk_int8``)."""

    def __init__(self, model, cfg, opt: optim.Optimizer, stacked,
                 plane: FlatPlane, device: torch.device, trip):
        self.model, self.cfg, self.opt = model, cfg, opt
        self._trip = trip                    # (cfg, x) -> (received, bytes)
        self.stacked, self.plane = stacked, plane
        self.unit_ids = torch.as_tensor(plane.unit_ids, dtype=torch.long,
                                        device=device)
        self.wire = cfg.wire_scheme()
        self.k_frac = cfg.wire_k
        self.packed = (self.wire == "topk_int8"
                       and hasattr(model, "apply_units_packed"))

    # ---- the wire, on a bucket's stacked tensor -------------------------
    def _uplink(self, sent: torch.Tensor):
        """topk_int8 with error feedback: (buffer, its dense floats,
        bytes)."""
        d = sent.shape[-1]
        buf = wire_kernels.sparsify_quant_pack(sent.contiguous(),
                                               self.k_frac)
        dense = wire_kernels.unpack_dequant(buf, d, self.k_frac,
                                            dtype=sent.dtype)
        return buf, dense, 4 * buf.numel()

    # ---- the server side of one bucket ---------------------------------
    def _server(self, c: int, p_srv, inp, y):
        """Per-slot losses and gradients of the server side: ``p_srv``
        (n, P - offsets[c]) the slots' RSU models from unit c on, ``inp``
        (n, B, ...) what each slot's RSU reads (the fused matmul's output
        on a packed entry).  Returns (losses (n,), gradient (n, P -
        offsets[c]), gradient at ``inp``)."""
        model, plane = self.model, self.plane
        packed = self.packed

        def slot_loss(p, a, yy):
            units, head = plane.tree(p, c)
            if packed:
                feats = model.apply_entry(units, a, c)
            else:
                feats = model.apply_units(units, a, c)
            return model.head_loss(head, feats, yy)[0]

        losses, vjp = torch.func.vjp(
            lambda p, a: torch.func.vmap(slot_loss)(p, a, y), p_srv, inp)
        g_p, g_inp = vjp(torch.ones_like(losses))
        return losses.detach(), g_p, g_inp

    def _bucket_step(self, bk: Bucket, dev: Dict[str, torch.Tensor], sv,
                     cu, x, y, res):
        """One local step of one bucket.  Returns (replica gradient, loss
        sum, the RSUs' gradient shares as [(rsu, share)], renewed
        residual, bytes)."""
        model, plane, c = self.model, self.plane, bk.cut
        off = plane.offsets[c]

        def client_fwd(p):
            return torch.func.vmap(
                lambda pi, xi: model.apply_units(plane.units(pi, 0, c), xi,
                                                 0))(p, x)

        smashed, client_vjp = torch.func.vjp(client_fwd, cu)
        sent = smashed.detach()
        p_srv = sv[:, off:][dev["seg"]]                  # (n, P - off)
        if self.wire == "topk_int8":
            if res is None:
                res = torch.zeros_like(sent)
            sent = sent + res
            buf, dense, up = self._uplink(sent)
            res = sent - dense
            if self.packed:
                lo, hi = plane.leaf_range(c, model.packed_entry)
                d = sent.shape[-1]
                entry = torch.cat([
                    wire_kernels.unpack_dequant_matmul(
                        buf[a:b].reshape(-1, buf.shape[-1]),
                        sv[r, lo:hi].view(d, -1), self.k_frac
                    ).view(b - a, sent.shape[1], -1)
                    for r, a, b in bk.runs])
                losses, g_p, g_entry = self._server(c, p_srv, entry, y)
                g_w = torch.bmm(dense.transpose(1, 2), g_entry)
                g_p[:, lo - off:hi - off] = g_w.reshape(len(g_w), -1)
                g_cut = torch.func.vmap(
                    lambda p, g: model.entry_input_grad(
                        plane.tree(p, c)[0], g))(p_srv, g_entry)
            else:
                losses, g_p, g_cut = self._server(c, p_srv, dense, y)
        else:
            recv, up = self._trip(self.cfg, sent)
            losses, g_p, g_cut = self._server(c, p_srv, recv, y)
        g_recv, down = self._trip(self.cfg, g_cut)
        (g_cu,) = client_vjp(g_recv)
        contrib = g_p * dev["gw"][:, None]
        shares = [(r, contrib[a:b].sum(0)) for r, a, b in bk.runs]
        return g_cu, losses.sum(), shares, res, up + down

    # ---- the round -----------------------------------------------------
    def run_round(self, planes: torch.Tensor, plan: ParallelPlan,
                  dev, idx: torch.Tensor, residuals: Optional[list]):
        """One parallel round over the RSU models ``planes`` (R, P).
        ``dev(name)`` / ``dev(b, name)`` give the round's staged arrays,
        ``idx`` (steps, n, B) the batch indices, ``residuals`` the
        per-vehicle error-feedback residuals (topk_int8; renewed in place).
        Returns (new planes, loss sum on the device, wire bytes)."""
        opt, plane = self.opt, self.plane
        steps = idx.shape[0]
        sv = planes
        so = torch.func.vmap(opt.init)(sv)
        w_seg = dev("w_seg")
        active = plan.w_seg > 0
        act_t = w_seg > 0
        states = []
        for b, bk in enumerate(plan.buckets):
            d = {k: dev(b, k) for k in ("members", "seg", "w", "gw")}
            cu = sv[:, :plane.offsets[bk.cut]][d["seg"]]
            res = None
            if residuals is not None and any(
                    residuals[v] is not None for v in bk.members):
                z = next(residuals[v] for v in bk.members
                         if residuals[v] is not None)
                zero = torch.zeros_like(z)
                res = torch.stack([zero if residuals[v] is None
                                   else residuals[v] for v in bk.members])
            states.append([d, cu, torch.func.vmap(opt.init)(cu),
                           idx[:, d["members"]], res])
        loss = torch.zeros((), dtype=torch.float32, device=planes.device)
        nbytes = 0
        images, labels = self.stacked.images, self.stacked.labels
        for s in range(steps):
            g_srv = torch.zeros_like(sv)
            for bk, st in zip(plan.buckets, states):
                d, cu, co, idx_b, res = st
                rows = d["members"][:, None]
                x, y = images[rows, idx_b[s]], labels[rows, idx_b[s]]
                g_cu, ls, shares, st[4], nb = self._bucket_step(
                    bk, d, sv, cu, x, y, res)
                off = plane.offsets[bk.cut]
                for r, share in shares:
                    g_srv[r, off:] += share
                upd, st[2] = torch.func.vmap(opt.update)(g_cu, co, cu)
                st[1] = optim.apply_updates(cu, upd)
                loss = loss + ls
                nbytes += nb
            upd, so2 = torch.func.vmap(opt.update)(g_srv, so, sv)
            sv2 = optim.apply_updates(sv, upd)
            if active.all():
                sv, so = sv2, so2
            else:
                sv = torch.where(act_t[:, None], sv2, sv)
                so = {k: torch.where(act_t.view((-1,) + (1,) * (v.dim() - 1)),
                                     v, so[k]) for k, v in so2.items()}
        # unit-wise FedAvg: replicas of every unit they own, the RSU copy
        # at the remaining weight; the rest of the plane as (w_seg sv)/den
        num = torch.zeros_like(sv)
        for bk, (d, cu, _, _, res) in zip(plan.buckets, states):
            off = plane.offsets[bk.cut]
            for r, a, b in bk.runs:
                num[r, :off] += torch.tensordot(d["w"][a:b], cu[a:b],
                                                dims=([0], [0]))
            if residuals is not None:
                for i, v in enumerate(bk.members):
                    residuals[v] = res[i]
        own_pos = dev("own_w")[:, self.unit_ids]        # (R, P)
        den = torch.clamp(w_seg, min=1.0)[:, None]
        merged = (num + (w_seg[:, None] - own_pos) * sv) / den
        if not active.all():
            merged = torch.where(act_t[:, None], merged, planes)
        return merged, loss, nbytes
