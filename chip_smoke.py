"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin) and the repo's
``src/`` tree beside this file; exits non-zero otherwise.  It imports
neither ``jax`` nor ``repro``.  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the codec's CUDA kernels (``kernels/csrc/codec.cu``) and prints
   the build time and the ptxas report;
3. holds each of the four kernels (quantize_int8, dequantize_int8,
   sparsify_quant_pack, unpack_dequant) ``torch.equal`` to its plain
   PyTorch version on the card, at the four ResNet18 cut shapes of the main
   path (batch 16) and the edge shapes of the CPU tests; at the cut shapes
   it times kernel and plain version on the device (``torch.profiler``
   kernel time per call) and the wrapper call (CUDA events), beside the
   bytes bound;
4. drives the main path — ``repro_torch.api.run`` of the paper's case study
   (resnet18, asfl, 4 vehicles, batch 16, adam) — for two rounds over the
   ``topk_int8`` wire, with the launch counters zeroed just before and read
   just after: pack and unpack each launch twice per client batch step;
   each round's wall time excludes building the engine;
5. one round over the ``int8`` wire: the quant kernels launch;
6. one sgd SFL batch step per cut on the CPU and on the card from the same
   weights (``wire="none"``, TF32 off): the card's update agrees with the
   CPU's within 1 % of the largest update;
7. prints the per-kernel JSON line, then ``{"ok": true, "device": ...}``
   as the last line.

Any failure raises and the script exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BATCH = 16
CUT_SHAPES = {2: (BATCH, 32, 32, 64), 4: (BATCH, 16, 16, 128),
              6: (BATCH, 8, 8, 256), 8: (BATCH, 4, 4, 512)}
# (label, shape, k_frac, fill): the cut shapes, then the CPU tests' edges
CASES = ([(f"cut{c}", s, 0.25, "normal") for c, s in CUT_SHAPES.items()]
         + [("d200_k0.1", (64, 200), 0.1, "normal"),
            ("d200_k0.3", (64, 200), 0.3, "normal"),
            ("d200_k1.0", (64, 200), 1.0, "normal"),
            ("ties_cut6", (BATCH, 8, 8, 256), 0.25, "ties"),
            ("zeros_d128", (4, 128), 0.25, "zeros")])
KERNEL_META = {
    "quantize_int8": "src/repro/kernels/quant.py:37",
    "dequantize_int8": "src/repro/kernels/quant.py:76",
    "sparsify_quant_pack": "src/repro/kernels/wire.py:110",
    "unpack_dequant": "src/repro/kernels/wire.py:141",
}
SOURCE = "src/repro_torch/kernels/csrc/codec.cu"
SGD_LR = 1e-2                   # phase 6: updates far above f32 rounding
STEP_RTOL = 1e-2                # phase 6: card vs CPU, of the largest update


def _call_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` back-to-back calls (CUDA
    events): at the codec's sizes this is the Python wrapper and launch."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters, symbol=None):
    """Device milliseconds per call: the kernel time (CUPTI, through
    ``torch.profiler``) of every device kernel that ``iters`` calls
    launched, over ``iters``.  With ``symbol``, exactly one kernel name
    matches it, and the result is its mean time per recorded launch (CUPTI
    may drop a record: on the card one of 200 went missing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if symbol is not None:
        # not preceded by a name character: quantize_int8_kernel must not
        # match dequantize_int8_kernel (mangled or demangled names)
        pat = re.compile(r"(^|[^A-Za-z_])" + symbol)
        hits = [e for e in dev if pat.search(e.key)]
        if len(hits) != 1 or not 0 < hits[0].count <= iters:
            raise AssertionError(
                f"profiler: expected up to {iters} launches of {symbol}, got "
                f"{[(e.key, e.count) for e in hits]} among "
                f"{[e.key for e in dev]}")
        return hits[0].self_device_time_total / hits[0].count / 1e3
    return sum(e.self_device_time_total for e in dev) / iters / 1e3


def _make_input(shape, fill, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "ties":
        a = rng.integers(-3, 4, size=shape)
    else:
        a = np.zeros(shape)
    return torch.from_numpy(a.astype(np.float32)).cuda()


def _bound_ms(name, shape, k_frac):
    """Bytes each input read once and each output written once, over HBM
    bandwidth.  Each function does a few f32 operations per element, which
    over the card's f32 rate take far less than its bytes, so bytes bound."""
    from repro_torch.core import compression as C
    d = shape[-1]
    n = math.prod(shape)
    rows = n // d
    g, ng, k, wpg = C.wire_layout(d, k_frac)
    scales = 4 * rows * ng
    wire = 4 * rows * ng * wpg
    nbytes = {"quantize_int8": 4 * n + n + scales,
              "dequantize_int8": n + scales + 4 * n,
              "sparsify_quant_pack": 4 * n + wire,
              "unpack_dequant": wire + 4 * n}[name]
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_kernels():
    """Phase 3: every kernel equal to its plain version on the card, at
    every case; times at the cut shapes.  Returns {kernel: {label: row}}."""
    import torch
    from repro_torch.core import compression as C
    from repro_torch.kernels import quant, wire
    out = {name: {} for name in KERNEL_META}
    for ci, (label, shape, kf, fill) in enumerate(CASES):
        x = _make_input(shape, fill, seed=ci)
        d = shape[-1]
        q, s = quant.quantize_int8(x)
        q_ref, s_ref = (t.contiguous() for t in C.quantize_int8(x))
        buf = wire.sparsify_quant_pack(x, kf)
        buf_ref = C.sparsify_quant_pack_ref(x, kf)
        pairs = {
            "quantize_int8": ((q, s), (q_ref, s_ref),
                              lambda: quant.quantize_int8(x),
                              lambda: C.quantize_int8(x)),
            "dequantize_int8": ((quant.dequantize_int8(q_ref, s_ref),),
                                (C.dequantize_int8(q_ref, s_ref),),
                                lambda: quant.dequantize_int8(q_ref, s_ref),
                                lambda: C.dequantize_int8(q_ref, s_ref)),
            "sparsify_quant_pack": ((buf,), (buf_ref,),
                                    lambda: wire.sparsify_quant_pack(x, kf),
                                    lambda: C.sparsify_quant_pack_ref(x, kf)),
            "unpack_dequant": ((wire.unpack_dequant(buf_ref, d, kf),),
                               (C.wire_dequant_ref(buf_ref, d, kf),),
                               lambda: wire.unpack_dequant(buf_ref, d, kf),
                               lambda: C.wire_dequant_ref(buf_ref, d, kf)),
        }
        torch.cuda.synchronize()
        for name, (got, want, run_k, run_p) in pairs.items():
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            err = max(float((a.to(torch.float64) - b.to(torch.float64))
                            .abs().max()) for a, b in zip(got, want))
            row = {"shape": list(shape), "k_frac": kf, "fill": fill,
                   "equal": equal, "max_abs_err": err}
            if label.startswith("cut"):
                row["ms"] = _device_ms(run_k, 200, f"{name}_kernel")
                row["plain_ms"] = _device_ms(run_p, 100)
                row["call_ms"] = _call_ms(run_k, 200)
                row["bound_ms"] = _bound_ms(name, shape, kf)
            out[name][label] = row
            print(f"kernel {name:20s} {label:11s} shape={list(shape)} "
                  f"k_frac={kf} equal={equal} max_abs_err={err:g}"
                  + (f" ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                     f"call_ms={row['call_ms']:.6f} "
                     f"bound_ms={row['bound_ms']:.6f}"
                     if "ms" in row else ""), flush=True)
            if not equal:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {label} {shape}")
    return out


def build_kernels():
    """Phase 2: build the codec library from the checkout's sources."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {lib.path.name} "
          f"nvcc_s={lib.build_s:.3f} load_s={time.perf_counter() - t0:.3f}",
          flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"build: {line.strip()}", flush=True)
    return lib


def card_line():
    """Phase 1: the card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = res.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def drive_path(wire, rounds, kernel_names):
    """Phases 4/5: the paper's case study through ``repro_torch.api.run``
    on the card, launch counters zeroed just before and read just after.
    Returns (launches of ``kernel_names``, cuts of every round)."""
    import torch
    from repro_torch import api, kernels
    spec = api.ExperimentSpec(train=api.TrainConfig(rounds=rounds,
                                                    wire=wire))
    marks = []

    def on_round(m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if not (math.isfinite(m.loss) and 0.0 <= m.test_acc <= 1.0
                and set(m.cuts) <= {2, 4, 6, 8} and len(m.cuts) == 4):
            raise AssertionError(f"bad round metrics: {m}")

    kernels.reset_launches()
    res = api.run(spec, on_round=on_round)
    counts = kernels.launch_counts()
    # run_s spans the rounds alone (engine built before it, ends with the
    # last round's synchronize), so round 0 is run_s less the later rounds
    run_s = res.timing["run_s"]
    walls = [run_s - (marks[-1] - marks[0])] + [
        b - a for a, b in zip(marks, marks[1:])]
    for m, wall in zip(res.history, walls):
        print(f"path {wire} round={m.round} loss={m.loss!r} "
              f"acc={m.test_acc!r} cuts={m.cuts} wall_s={wall:.6f}",
              flush=True)
    steps = res.diagnostics["client_batch_steps"]
    print(f"path {wire} device={res.diagnostics['device']!r} "
          f"client_batch_steps={steps} launches={counts} "
          f"run_s={run_s:.6f} wire_bytes={res.diagnostics['wire_bytes']}",
          flush=True)
    if len(res.history) != rounds or steps <= 0:
        raise AssertionError(f"{wire}: {len(res.history)} rounds, "
                             f"{steps} client batch steps")
    for name in KERNEL_META:
        want = 2 * steps if name in kernel_names else 0
        if counts[name] != want:
            raise AssertionError(f"{wire}: {name} launched {counts[name]} "
                                 f"times, expected {want} (2 x {steps} "
                                 f"client batch steps)")
    return ({k: counts[k] for k in kernel_names},
            [m.cuts for m in res.history])


def cpu_vs_card():
    """Phase 6: one sgd SFL batch step per cut (wire="none") from the same
    weights and batch on the CPU and on the card, TF32 off.  The card's
    update of every parameter agrees with the CPU's within STEP_RTOL of the
    largest update: the gradients differ only by float32 summation order
    (cuDNN and oneDNN sum the convolutions differently).  A card step that
    skipped its update is off by the whole update, so it fails."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.core import fedsim
    from repro_torch.device import resolve_device
    from repro_torch.tree import tree_leaves, tree_map
    dev = resolve_device("cuda")
    model = fedsim.ResNetModel()
    units, head = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(BATCH, 32, 32, 3))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=BATCH))
    cfg = fedsim.SimConfig(optimizer="sgd", lr=SGD_LR, wire="none")
    init = tree_leaves([units, head])
    worst = 0.0
    for cut in (2, 4, 6, 8):
        step = fedsim.make_sfl_batch_step(model, cfg, cut)
        outs = {}
        for where in ("cpu", dev):
            u = [tree_map(lambda a: a.to(where), p) for p in units]
            h = tree_map(lambda a: a.to(where), head)
            opt = optim.from_name("sgd", SGD_LR)
            outs[str(where)] = step(
                u[:cut], u[cut:], h, opt.init(u[:cut]),
                opt.init({"units": u[cut:], "head": h}),
                {"images": x.to(where), "labels": y.to(where)})
        a, b = outs["cpu"], outs[str(dev)]
        la = tree_leaves([a[0], a[1], a[2]])
        lb = [t.cpu() for t in tree_leaves([b[0], b[1], b[2]])]
        if not all(bool(torch.isfinite(t).all()) for t in lb):
            raise AssertionError(f"non-finite parameters at cut {cut}")
        diff = max(float((p - q).abs().max()) for p, q in zip(la, lb))
        moved = max(float((p - p0).abs().max()) for p, p0 in zip(la, init))
        rel = diff / moved if moved > 0 else math.inf
        dloss = abs(float(a[5]) - float(b[5]))
        worst = max(worst, rel)
        print(f"cpu_vs_card cut={cut} loss_cpu={float(a[5])!r} "
              f"loss_card={float(b[5])!r} max_param_diff={diff:g} "
              f"max_update={moved:g} diff_over_update={rel:g}", flush=True)
        if rel > STEP_RTOL or dloss > 1e-4:
            raise AssertionError(f"cut {cut}: card and CPU disagree (params "
                                 f"{diff:g} = {rel:g} of the largest update "
                                 f"{moved:g} > {STEP_RTOL:g}, or loss "
                                 f"{dloss:g} > 1e-4)")
    return worst


def _main_cut(cuts_per_round):
    """The cut the path used most often (ties to the smaller cut)."""
    flat = [c for cuts in cuts_per_round for c in cuts]
    return min(set(flat), key=lambda c: (-flat.count(c), c))


def kernel_report(checks, launches, main_cuts):
    """Phase 7: one entry per kernel, timed at its path's main shape."""
    out = []
    for name, replaces in KERNEL_META.items():
        label = f"cut{main_cuts[name]}"
        row = checks[name][label]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in checks[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": row["shape"]})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the port must be importable from this checkout before anything runs
    from repro_torch.device import set_float32_precision
    set_float32_precision()
    card_line()
    build_kernels()
    checks = check_kernels()
    topk_launches, topk_cuts = drive_path(
        "topk_int8", 2, ("sparsify_quant_pack", "unpack_dequant"))
    int8_launches, int8_cuts = drive_path(
        "int8", 1, ("quantize_int8", "dequantize_int8"))
    cpu_vs_card()
    main_cuts = {"sparsify_quant_pack": _main_cut(topk_cuts),
                 "unpack_dequant": _main_cut(topk_cuts),
                 "quantize_int8": _main_cut(int8_cuts),
                 "dequantize_int8": _main_cut(int8_cuts)}
    print(json.dumps(kernel_report(checks, {**topk_launches,
                                            **int8_launches}, main_cuts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
