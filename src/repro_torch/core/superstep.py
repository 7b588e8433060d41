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
* each RSU's share, ``sum_j gw_j g_j`` over its run of the bucket, is
  one row of a one-hot (run, slot) matrix weighted by ``gw`` times the
  slots' gradients: one matmul for every run of the bucket;
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
matmul's backward decodes).  Codec launches per (cut bucket page, local
step): ``int8`` 2 ``quantize_int8`` and 2 ``dequantize_int8``;
``topk_int8`` 2 ``sparsify_quant_pack`` (up, down), 2 ``unpack_dequant``
(the residual, the downlink) and, with a packed entry, one
``unpack_dequant_matmul`` per RSU run in the page (else a third unpack
for the RSU's input).

**Paging** (``page_slots`` > 0 on the ``ragged`` layout; the
reference's ``paged_sweep``).  Each local step walks a bucket's slots
(under the fault plane its active ones) in windows of that many, the
last one shorter (:class:`Page`): the vehicle forward and its vjp, the codec
trips, the server vjp, the RSUs' shares and the replica step run for one
window at a time, so the (n, P - offsets[c]) gather of RSU models, its
gradient and the activations exist for one window, never for the
bucket.  Replicas, optimizer states and residuals stay whole per bucket
and each window writes its rows back in place.  A run of one RSU that a
window splits is summed in two parts added in window order: the only
reassociation that reaches a parameter, so paged and unpaged train the
same bits where every run lies inside one window.  A bucket that fits
one window is not paged.

**Determinism and the layouts.**  Every sum is a ``torch.sum`` or a
matmul over tensors of fixed shape (no ``index_add_``, whose CUDA kernel
adds with float atomics; a run's row goes to its RSU by an indexed add
whose indices are distinct), so two runs of a window give the same bits.
Phantom slots have no cut bucket to run in: neither layout computes them,
so their contribution is the exact zero the reference multiplies in, and
the two layouts run the same operations on the same occupied slots: bit
for bit the same training.  The layout decides the slot table, its
capacity checks and :meth:`occupancy_stats` of the engine.

**The fault plane** (:class:`FaultPlan`; the reference's
``superstep.py:1027-1110``).  A dropout runs only its first ``dstep``
local steps: per local step only the slots still active run, so a bucket's
step gathers its active rows (``pos``) and copies their updated replicas,
moments and residuals back; a (cut bucket, local step) with no active slot
launches nothing, a (cut bucket, RSU, local step) without one no fused
matmul.  Each step's gradient weights renormalise over the active slots
(``gw = w / max(w_step[seg], 1)``) and an RSU with none keeps its model.
The FedAvg weighs the survivors only (a failed replica folds in at weight
exactly 0) plus last round's staleness bank at the discount,
``(num + (w - own) sv + disc st_num) / (w + disc st_den)`` where that
denominator is positive, else the RSU's model before the round; this
round's deadline stragglers form the next bank on the same plane.

**The StreamBuffer** (``server_schedule="streaming"``,
:func:`plan_stream`): the parallel round's result is not committed; each
RSU that merged sample weight pushes ``merged - planes`` into its next
free slot of B, and a full buffer moves the RSU to ``planes + sum_b kw_b
delta_b / den`` with ``kw`` = weight x staleness kernel(age) (empty slots
at weight 0).  The bookkeeping (weights, ages, fill, which buffers fire)
is planned on the host with the round; the deltas live on the device.

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
from repro_torch.core import streaming
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

    def unit_vector(self, tree, u: int) -> torch.Tensor:
        """Unit ``u`` (a tree like the plane's unit u) as its flat slice
        of the plane, positions ``[offsets[u], offsets[u + 1])``."""
        return torch.cat([t.reshape(-1) for t in tree_leaves(
            tree_map(lambda _, a: a, self._templates[u], tree))])

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
class Page:
    """A window of one bucket's slots: positions ``[start, stop)``, the
    runs of the bucket it cuts (indices ``[run_lo, run_hi)``), and those
    runs clipped to it as (rsu, start, stop) relative to ``start``."""
    start: int
    stop: int
    run_lo: int
    run_hi: int
    runs: List[Tuple[int, int, int]]


@dataclasses.dataclass
class Bucket:
    """The occupied slots of one cut in one round, in slot order, with
    their RSU runs and the pages a local step walks them in (one page
    unpaged)."""
    cut: int
    members: np.ndarray                 # (n_c,) vehicles
    seg: np.ndarray                     # (n_c,) their RSUs
    w: np.ndarray                       # (n_c,) float32 |D_n|
    gw: np.ndarray                      # (n_c,) float32 w / max(w_seg, 1)
    runs: List[Tuple[int, int, int]]    # (rsu, start, stop) in the bucket
    run_id: np.ndarray                  # (n_c,) index of each slot's run
    pages: List[Page]


def _bucket(cut: int, members, seg, w, gw, page: int) -> Bucket:
    runs = _runs(seg)
    run_id = np.repeat(np.arange(len(runs)), [e - a for _, a, e in runs])
    return Bucket(int(cut), members, seg, w, gw, runs, run_id,
                  _pages(runs, len(members), page))


@dataclasses.dataclass
class StepBucket:
    """Under the fault plane, the slots of bucket ``bucket`` that run one
    local step: ``pos`` their positions in the bucket (None: all) and
    ``sub`` their members, RSUs, weights, this step's gradient weights and
    runs."""
    bucket: int
    pos: Optional[np.ndarray]
    sub: Bucket


@dataclasses.dataclass
class FaultPlan:
    """The fault plane's part of a parallel round.  ``steps[s]`` lists the
    buckets with a slot still active at local step s (a dropout stops at
    its drop step); ``w_step`` (steps, R) is each RSU's active weight per
    step; ``w_surv`` / ``w_strag`` per bucket the slots' weights in the
    FedAvg (survivors) and in the staleness bank (deadline stragglers)."""
    steps: List[List[StepBucket]]
    w_step: np.ndarray
    w_surv: List[np.ndarray]
    w_strag: List[np.ndarray]


@dataclasses.dataclass
class ParallelPlan:
    """Host side of one parallel round: its buckets (ascending cut) and
    the per-RSU weights of the FedAvg (of the survivors under the fault
    plane, whose part is ``fault``)."""
    buckets: List[Bucket]
    w_seg: np.ndarray                   # (R,) float32
    own_w: np.ndarray                   # (R, U + 1) float32, head column 0
    n_slots: int
    fault: Optional[FaultPlan] = None


def _runs(seg: np.ndarray) -> List[Tuple[int, int, int]]:
    """(rsu, start, stop) of each RSU's run in slots sorted RSU-major."""
    seg = np.asarray(seg)
    if not len(seg):
        return []
    cut = np.flatnonzero(np.diff(seg)) + 1
    starts = np.concatenate([[0], cut])
    stops = np.concatenate([cut, [len(seg)]])
    return [(int(seg[a]), int(a), int(e)) for a, e in zip(starts, stops)]


def _pages(runs, n: int, page: int) -> List[Page]:
    """Windows of ``page`` slots over a bucket of ``n`` (the last one
    shorter); one window of all ``n`` when ``page`` is 0 or covers them.
    A run that crosses a window is split between the two."""
    bounds = ([(0, n)] if page <= 0 or n <= page
              else [(a, min(a + page, n)) for a in range(0, n, page)])
    out = []
    for a, e in bounds:
        idx = [j for j, (_, s, t) in enumerate(runs) if s < e and t > a]
        out.append(Page(a, e, idx[0], idx[-1] + 1,
                        [(r, max(s, a) - a, min(t, e) - a)
                         for r, s, t in runs[idx[0]:idx[-1] + 1]]))
    return out


def page_padded_slots(slots: int, page: int) -> int:
    """The compacted slot count padded to a whole number of pages when it
    exceeds one page (the reference's ``signature()``; the padding is
    phantom slots, which no schedule computes)."""
    if page > 0 and slots > page:
        return -(-slots // page) * page
    return slots


def _seg_sums(w: np.ndarray, seg: np.ndarray, n_rsus: int) -> np.ndarray:
    out = np.zeros(n_rsus, np.float32)
    for r in range(n_rsus):              # integer counts: exact in f32
        out[r] = np.sum(w[seg == r], dtype=np.float32)
    return out


def own_weights(w: np.ndarray, seg: np.ndarray, cut: np.ndarray,
                n_rsus: int, n_units: int) -> np.ndarray:
    """(R, U + 1) float32: per RSU, the weight of its slots that own each
    unit (cut > u); the head column U is 0."""
    own = np.zeros((n_rsus, n_units + 1), np.float32)
    for c in np.unique(cut):
        for r in np.unique(seg[cut == c]):
            own[r, :int(c)] += np.sum(w[(cut == c) & (seg == r)],
                                      dtype=np.float32)
    return own


def plan_parallel(members: np.ndarray, slot_seg: np.ndarray,
                  cuts: np.ndarray, lengths: np.ndarray, n_rsus: int,
                  n_units: int, fault=None, steps: int = 1,
                  page: int = 0) -> ParallelPlan:
    """The occupied slots of a flat slot table (either layout), grouped by
    cut in slot order, with their weights (float32, as the reference).
    ``fault = (dstep, surv, strag)``, fleet-indexed: each vehicle's
    performed local steps, and whether its update merges or is banked.
    ``page`` > 0 walks each bucket's (active) slots in windows of that
    many; the table must then hold a whole number of pages."""
    S = len(members)
    if page > 0 and S > page and S % page:
        raise ValueError(
            f"page_slots={page} must divide the per-device compacted slot "
            f"block {S} (the engine pads planned slots to a page multiple "
            f"— pass slots through superstep.page_padded_slots)")
    occ = np.asarray(slot_seg) < n_rsus
    mem = np.asarray(members)[occ]
    seg = np.asarray(slot_seg)[occ]
    cut = np.asarray(cuts)[mem]
    w = np.asarray(lengths)[mem].astype(np.float32)
    w_seg = _seg_sums(w, seg, n_rsus)
    den = np.maximum(w_seg, np.float32(1.0))
    gw = (w / den[seg]).astype(np.float32)
    buckets = []
    for c in np.unique(cut):
        pos = np.nonzero(cut == c)[0]
        buckets.append(_bucket(c, mem[pos], seg[pos], w[pos], gw[pos], page))
    if fault is None:
        return ParallelPlan(buckets, w_seg,
                            own_weights(w, seg, cut, n_rsus, n_units),
                            int(occ.sum()))
    dstep, surv, strag = (np.asarray(a) for a in fault)
    w_surv = (w * surv[mem]).astype(np.float32)
    w_step = np.zeros((steps, n_rsus), np.float32)
    per_step = []
    for s in range(steps):
        act = dstep[mem] > s
        w_step[s] = _seg_sums((w * act).astype(np.float32), seg, n_rsus)
        den_s = np.maximum(w_step[s], np.float32(1.0))
        step = []
        for b, bk in enumerate(buckets):
            a = dstep[bk.members] > s
            if not a.any():
                continue
            gw_s = (bk.w / den_s[bk.seg]).astype(np.float32)
            if a.all():
                step.append(StepBucket(b, None, dataclasses.replace(
                    bk, gw=gw_s)))
                continue
            p = np.nonzero(a)[0]
            step.append(StepBucket(b, p, _bucket(
                bk.cut, bk.members[p], bk.seg[p], bk.w[p], gw_s[p], page)))
        per_step.append(step)
    fp = FaultPlan(per_step, w_step,
                   [(bk.w * surv[bk.members]).astype(np.float32)
                    for bk in buckets],
                   [(bk.w * strag[bk.members]).astype(np.float32)
                    for bk in buckets])
    return ParallelPlan(buckets, _seg_sums(w_surv, seg, n_rsus),
                        own_weights(w_surv, seg, cut, n_rsus, n_units),
                        int(occ.sum()), fp)


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


def _run_rsus(bk: Bucket) -> np.ndarray:
    return np.array([r for r, _, _ in bk.runs], np.int64)


def stage_parallel(plan: ParallelPlan, key, arrays: Dict[Any, np.ndarray]):
    """Add a round's device arrays to ``arrays`` under ``(key, ...)``."""
    for b, bk in enumerate(plan.buckets):
        arrays[(key, b, "members")] = bk.members
        arrays[(key, b, "seg")] = bk.seg
        arrays[(key, b, "w")] = bk.w
        arrays[(key, b, "gw")] = bk.gw
        arrays[(key, b, "run_id")] = bk.run_id
        arrays[(key, b, "run_rsu")] = _run_rsus(bk)
    # run indices, for the one-hot run matrices of the per-RSU sums
    arrays[(key, "ar")] = np.arange(max([len(bk.runs)
                                         for bk in plan.buckets] + [1]))
    arrays[(key, "w_seg")] = plan.w_seg
    arrays[(key, "own_w")] = plan.own_w
    fp = plan.fault
    if fp is None:
        return
    for b in range(len(plan.buckets)):
        arrays[(key, b, "w_surv")] = fp.w_surv[b]
        arrays[(key, b, "w_strag")] = fp.w_strag[b]
    arrays[(key, "w_step")] = fp.w_step
    for s, step in enumerate(fp.steps):
        for j, sb in enumerate(step):
            arrays[(key, "s", s, j, "gw")] = sb.sub.gw
            if sb.pos is not None:
                arrays[(key, "s", s, j, "pos")] = sb.pos
                arrays[(key, "s", s, j, "members")] = sb.sub.members
                arrays[(key, "s", s, j, "seg")] = sb.sub.seg
                arrays[(key, "s", s, j, "run_id")] = sb.sub.run_id
                arrays[(key, "s", s, j, "run_rsu")] = _run_rsus(sb.sub)


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

    def _page_step(self, c: int, pg: Page, dev: Dict[str, torch.Tensor],
                   sv, g_srv, cu, x, y, res):
        """One local step of one page of a cut-``c`` bucket: ``dev`` holds
        the page's staged arrays, ``cu`` / ``x`` / ``y`` / ``res`` its
        slots' replicas, batch and residuals.  Adds each RSU's gradient
        share ``sum_j gw_j g_j`` over its run in the page to ``g_srv``.
        Returns (replica gradient, loss sum, renewed residual, bytes)."""
        model, plane = self.model, self.plane
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
                    for r, a, b in pg.runs])
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
        # the RSUs' shares: a one-hot (run, slot) matrix weighted by gw
        # times the gradients, one row per run, added to its RSU's row
        rows = _run_matrix(dev, pg.run_lo, pg.run_hi, dev["gw"]) @ g_p
        g_srv[:, off:][dev["run_rsu"][pg.run_lo:pg.run_hi]] += rows
        return g_cu, losses.sum(), res, up + down

    # ---- the round -----------------------------------------------------
    def run_round(self, planes: torch.Tensor, plan: ParallelPlan,
                  dev, idx: torch.Tensor, residuals: Optional[list],
                  bank: Optional[Tuple[float, torch.Tensor]] = None):
        """One parallel round over the RSU models ``planes`` (R, P).
        ``dev(name)`` / ``dev(b, name)`` give the round's staged arrays,
        ``idx`` (steps, n, B) the batch indices, ``residuals`` the
        per-vehicle error-feedback residuals (topk_int8; renewed in place).
        Under the fault plane (``plan.fault``) ``bank`` is the staleness
        discount and last round's bank numerator (R, P), or None when it
        is empty.  Returns (new planes, loss sum on the device, wire bytes,
        this round's bank numerator or None)."""
        opt, plane = self.opt, self.plane
        fp = plan.fault
        steps = idx.shape[0]
        sv = planes
        so = torch.func.vmap(opt.init)(sv)
        w_seg = dev("w_seg")
        active = plan.w_seg > 0
        act_t = w_seg > 0
        states = []
        for b, bk in enumerate(plan.buckets):
            d = {k: dev(b, k) for k in ("members", "seg", "w", "gw",
                                        "run_id", "run_rsu")}
            d["ar"] = dev("ar")
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
            if fp is None:
                runs = [(b, None, bk, states[b][0])
                        for b, bk in enumerate(plan.buckets)]
            else:
                runs = [(sb.bucket, sb.pos, sb.sub,
                         self._step_dev(dev, states[sb.bucket][0], s, j,
                                        sb.pos))
                        for j, sb in enumerate(fp.steps[s])]
            for b, pos, bk, d in runs:
                st = states[b]
                _, cu, co, idx_b, res = st
                if pos is not None:      # the bucket's slots still active
                    p = d["pos"]
                    cu, co = cu[p], {k: v[p] for k, v in co.items()}
                    res = None if res is None else res[p]
                    idx_s = idx_b[s][p]
                else:
                    idx_s = idx_b[s]
                paged = len(bk.pages) > 1
                if paged:                # written page by page below
                    cu = cu.contiguous()
                    co = {k: v.contiguous() for k, v in co.items()}
                for pg in bk.pages:      # one page unless paged
                    a, e = pg.start, pg.stop
                    dp = {k: d[k][a:e]
                          for k in ("members", "seg", "gw", "run_id")}
                    dp.update(run_rsu=d["run_rsu"], ar=d["ar"])
                    cu_p = cu[a:e]
                    co_p = {k: v[a:e] for k, v in co.items()}
                    rows = dp["members"][:, None]
                    x, y = images[rows, idx_s[a:e]], labels[rows, idx_s[a:e]]
                    g_cu, ls, res_p, nb = self._page_step(
                        bk.cut, pg, dp, sv, g_srv, cu_p, x, y,
                        None if res is None else res[a:e])
                    upd, co_p = torch.func.vmap(opt.update)(g_cu, co_p, cu_p)
                    cu_p = optim.apply_updates(cu_p, upd)
                    loss = loss + ls
                    nbytes += nb
                    if not paged:
                        cu, co, res = cu_p, co_p, res_p
                        continue
                    # a page writes its slots back into the bucket's state
                    # (its own, or this step's gather of the active rows):
                    # no second bucket-wide copy is held
                    cu[a:e] = cu_p
                    for k, v in co_p.items():
                        co[k][a:e] = v
                    if res_p is not None:
                        if res is None:
                            res = res_p.new_zeros((len(bk.members),)
                                                  + res_p.shape[1:])
                        res[a:e] = res_p
                if pos is None:
                    st[1], st[2], st[4] = cu, co, res
                else:
                    st[1] = st[1].index_copy(0, p, cu)
                    st[2] = {k: st[2][k].index_copy(0, p, v)
                             for k, v in co.items()}
                    if res is not None:
                        full = st[4] if st[4] is not None else \
                            res.new_zeros((len(idx_b[s]),) + res.shape[1:])
                        st[4] = full.index_copy(0, p, res)
            upd, so2 = torch.func.vmap(opt.update)(g_srv, so, sv)
            sv2 = optim.apply_updates(sv, upd)
            if fp is not None:           # RSUs with a slot active this step
                active = fp.w_step[s] > 0
                act_t = dev("w_step")[s] > 0
            if active.all():
                sv, so = sv2, so2
            else:
                sv = torch.where(act_t[:, None], sv2, sv)
                so = {k: torch.where(act_t.view((-1,) + (1,) * (v.dim() - 1)),
                                     v, so[k]) for k, v in so2.items()}
        # unit-wise FedAvg: replicas of every unit they own, the RSU copy
        # at the remaining weight; the rest of the plane as (w_seg sv)/den
        # (under the fault plane the survivors' weights, a failed replica
        # folding in as an exact +0, and last round's bank at the discount)
        num = torch.zeros_like(sv)
        banked = None
        if fp is not None and any(w.any() for w in fp.w_strag):
            banked = torch.zeros_like(sv)
        for b, (bk, (d, cu, _, _, res)) in enumerate(zip(plan.buckets,
                                                         states)):
            off = plane.offsets[bk.cut]
            w = d["w"] if fp is None else dev(b, "w_surv")
            n_runs = len(bk.runs)
            num[:, :off][d["run_rsu"]] += _run_matrix(d, 0, n_runs, w) @ cu
            if banked is not None and fp.w_strag[b].any():
                banked[:, :off][d["run_rsu"]] += _run_matrix(
                    d, 0, n_runs, dev(b, "w_strag")) @ cu
            if residuals is not None and res is not None:
                for i, v in enumerate(bk.members):
                    residuals[v] = res[i]
        own_pos = dev("own_w")[:, self.unit_ids]        # (R, P)
        if fp is None:
            den = torch.clamp(w_seg, min=1.0)[:, None]
            merged = (num + (w_seg[:, None] - own_pos) * sv) / den
            if not active.all():
                merged = torch.where(act_t[:, None], merged, planes)
            return merged, loss, nbytes, None
        top = num + (w_seg[:, None] - own_pos) * sv
        den = w_seg[:, None].expand_as(sv)
        if bank is not None:
            disc, st_num = bank
            den = den + disc * dev("st_den")[:, self.unit_ids]
            top = top + disc * st_num
        pos_den = den > 0
        merged = torch.where(pos_den, top / torch.where(pos_den, den, 1.0),
                             planes)
        return merged, loss, nbytes, banked

    @staticmethod
    def _step_dev(dev, full, s: int, j: int, pos):
        """The staged arrays of the j-th active bucket of local step s."""
        d = dict(full, gw=dev("s", s, j, "gw"))
        if pos is not None:
            d.update({k: dev("s", s, j, k)
                      for k in ("pos", "members", "seg", "run_id",
                                "run_rsu")})
        return d


def _run_matrix(d: Dict[str, torch.Tensor], lo: int, hi: int,
                weights: torch.Tensor) -> torch.Tensor:
    """(hi - lo, n) one-hot of runs ``[lo, hi)`` over the slots of
    ``d["run_id"]``, each slot's entry its weight: times a slot-major
    tensor it gives every run's weighted sum in one matmul (float32, TF32
    off; fixed shapes, so the bits repeat, unlike an atomic scatter)."""
    hit = d["run_id"][None, :] == d["ar"][lo:hi, None]
    return torch.where(hit, weights[None, :], 0.0)


# ---------------------------------------------------------- the StreamBuffer
@dataclasses.dataclass
class StreamStep:
    """Host side of one round's StreamBuffer commit: the pushed deltas as
    (rsu, buffer slot), which RSUs' buffers fire, the merge weights
    ``kw`` (R, B) = weight x staleness kernel(age) x occupied and their
    guarded sums ``den`` (R,), the merge telemetry (read before the
    post-fire reset) and the buffer's bookkeeping after the round."""
    pushes: List[Tuple[int, int]]
    fire: np.ndarray
    kw: np.ndarray
    den: np.ndarray
    absorbed: float
    fires: int
    occupancy: float
    stale: float
    post: Tuple[np.ndarray, np.ndarray, np.ndarray]   # weights, ages, fill


def plan_stream(weights: np.ndarray, ages: np.ndarray, fill: np.ndarray,
                w_tot: np.ndarray, buffer_size: int, kernel: str,
                alpha: float) -> StreamStep:
    """One round of the per-RSU StreamBuffer (the reference's
    ``superstep.py:1355-1431``, in float32): every RSU that merged sample
    weight this round pushes its delta into its next free slot; a buffer
    holding ``buffer_size`` deltas fires a staleness-weighted survivor
    FedAvg of them (empty slots fold in at weight 0); fired buffers clear
    and the others' pending deltas age by one round."""
    B = int(buffer_size)
    w, age = weights.copy(), ages.copy()
    pushed = w_tot > 0.0
    pushes = [(int(r), int(fill[r])) for r in np.nonzero(pushed)[0]]
    for r, slot in pushes:
        w[r, slot] = w_tot[r]
        age[r, slot] = 0
    fill2 = (fill + pushed).astype(np.int32)
    fire = fill2 >= B
    valid = np.arange(B, dtype=np.int32)[None, :] < fill2[:, None]
    kw = (w * streaming.staleness_kernel(kernel, alpha, age)
          * valid.astype(np.float32)).astype(np.float32)
    tot = kw.sum(axis=1, dtype=np.float32)
    den = np.where(tot > 0.0, tot, np.float32(1.0)).astype(np.float32)
    absorbed = np.sum(np.where(fire[:, None], w * valid, 0.0),
                      dtype=np.float32)
    stale = np.sum(np.where(fire[:, None],
                            age.astype(np.float32) * valid, 0.0),
                   dtype=np.float32)
    post = (np.where(fire[:, None], np.float32(0.0), w).astype(np.float32),
            np.where(fire[:, None], 0,
                     np.where(valid, age + 1, age)).astype(np.int32),
            np.where(fire, 0, fill2).astype(np.int32))
    return StreamStep(pushes, fire, kw, den, float(absorbed),
                      int(fire.sum()), float(np.where(fire, 0, fill2).sum()),
                      float(stale), post)
