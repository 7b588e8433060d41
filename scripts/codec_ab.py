"""Time the codec kernels of several checkouts on one card, in turns.

    python3 scripts/codec_ab.py CHECKOUT_A CHECKOUT_B [CHECKOUT_C ...]

e.g. the parent against the working tree (``build/`` is ignored by git)::

    git archive <parent-commit> | tar -x -C build/parent
    python3 scripts/codec_ab.py build/parent .

Each checkout runs in a process of its own, in the order A, B, ... and then
in reverse (A, B, B, A for two), so every checkout is read twice and no
checkout always runs first.  A process imports ``repro_torch`` from
``<checkout>/src`` (which builds that checkout's kernels into its own
``build/kernels/``), records whether every timed call's output equals its
plain version (NaN-aware, as ``chip_smoke.py`` phase 3; kernel 5 within
1e-5; a timing build that is knowingly inexact reads ``equal: false``),
and times each kernel
with ``chip_smoke.py``'s ``_device_ms`` (``torch.profiler`` kernel time per
launch, 200 launches):

- ``quantize_int8`` in float32 at the four ResNet18 cut shapes (batch 16),
  the scenario path's ``(8, 64)`` and smollm-360m's smashed tensor under
  ``compress_smashed`` ``(8, 1024, 960)``; in bfloat16 at ``cut6``,
  ``(8, 64)`` and ``(8, 1024, 960)`` (null where a checkout's wrapper
  refuses bfloat16);
- the other codec kernels in float32 at ``cut6`` and ``(8, 64)``, kernel 5
  (n = 64) at the scenario path's shape (rows 8, d = 64) and at rows 4096,
  d = 512 and d = 130 (a ragged last group);
- the launch floor (``zero_()`` on one element).

Each timed case prints its bytes bound (``chip_smoke.py``'s ``_bound_ms``).
Needs one CUDA card.  Prints the card's name and power limit, one JSON line
per run and a table; writes ``chiprun_out/codec_ab.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 200
CUT6, PATH, LM = (16, 8, 8, 256), (8, 64), (8, 1024, 960)
# (kernel, shape, dtype)
CASES = ([("quantize_int8", s, "float32") for s in
          [(16, 32, 32, 64), (16, 16, 16, 128), CUT6, (16, 4, 4, 512), PATH,
           LM]]
         + [("quantize_int8", s, "bfloat16") for s in (CUT6, PATH, LM)]
         + [(n, s, "float32") for n in ("dequantize_int8",
                                        "sparsify_quant_pack",
                                        "unpack_dequant")
            for s in (CUT6, PATH)]
         + [("unpack_dequant_matmul", s, "float32")
            for s in (PATH, (4096, 512), (4096, 130))])


def run_one(checkout: str) -> dict:
    """Time every case with ``checkout``'s kernels (this process)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS                 # puts ROOT/src on sys.path
    sys.path.insert(0, os.path.join(os.path.abspath(checkout), "src"))
    import numpy as np
    import torch
    from repro_torch.core import compression as C
    from repro_torch.kernels import _build, quant, wire
    if not os.path.abspath(C.__file__).startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {C.__file__}, not {checkout}'s")
    from repro_torch.device import set_float32_precision
    set_float32_precision()
    lib = _build.load()
    rows_out = []
    for name, shape, dtype in CASES:
        dt = getattr(torch, dtype)
        x = CS._make_input(shape, "normal", seed=len(rows_out)).to(dt)
        d = shape[-1]
        q, s = C.quantize_int8(x)
        if name in ("sparsify_quant_pack", "unpack_dequant",
                    "unpack_dequant_matmul"):
            buf = C.sparsify_quant_pack_ref(x)
        if name == "quantize_int8":
            def run_k():
                return quant.quantize_int8(x)
            want = (q, s)
        elif name == "dequantize_int8":
            def run_k():
                return (quant.dequantize_int8(q, s),)
            want = (C.dequantize_int8(q, s),)
        elif name == "sparsify_quant_pack":
            def run_k():
                return (wire.sparsify_quant_pack(x),)
            want = (buf,)
        elif name == "unpack_dequant":
            def run_k():
                return (wire.unpack_dequant(buf, d),)
            want = (C.wire_dequant_ref(buf, d),)
        else:
            rng = np.random.default_rng(7)
            w = torch.from_numpy((rng.normal(size=(d, 64)) / 8.0)
                                 .astype(np.float32)).cuda()

            def run_k():
                return (wire.unpack_dequant_matmul(buf, w),)
            want = (C.wire_dequant_matmul_ref(buf, w),)
        row = {"kernel": name, "shape": list(shape), "dtype": dtype,
               "bound_ms": (None if name == "unpack_dequant_matmul" else
                            CS._bound_ms(name, shape, 0.25,
                                         x.element_size()))}
        try:
            got = run_k()
        except TypeError as err:            # this checkout refuses dtype
            row.update(ms=None, refused=str(err))
            rows_out.append(row)
            continue
        torch.cuda.synchronize()
        if name == "unpack_dequant_matmul":
            ok = bool(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5))
        else:
            ok = all(CS._same(a, b)[0] for a, b in zip(got, want))
        row["equal"] = ok
        row["ms"] = CS._device_ms(run_k, ITERS, f"{name}_kernel")
        rows_out.append(row)
    z = torch.empty(1, device="cuda")
    floor = CS._device_ms(lambda: z.zero_(), ITERS)
    return {"checkout": checkout, "build_s": lib.build_s,
            "launch_floor_ms": floor, "cases": rows_out}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print("codec_ab " + json.dumps(run_one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("codec_ab: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for checkout in argv + argv[::-1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", checkout], capture_output=True,
                             text=True, timeout=900)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("codec_ab ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"codec_ab: {checkout} failed "
                             f"({res.returncode})")
        run = json.loads(line[0][len("codec_ab "):])
        runs.append(run)
        print(line[0], flush=True)
    print(f"{'kernel':22s} {'shape':20s} {'dtype':9s} {'bound_ms':>9s} "
          + " ".join(f"{r['checkout'][-12:]:>12s}" for r in runs))
    for i, case in enumerate(runs[0]["cases"]):
        cells = [r["cases"][i] for r in runs]
        print(f"{case['kernel']:22s} {str(case['shape']):20s} "
              f"{case['dtype']:9s} {case['bound_ms'] or math.nan:9.6f} "
              + " ".join("        null" if c["ms"] is None else
                         f"{c['ms']:11.6f}{' ' if c['equal'] else '!'}"
                         for c in cells))
    print("launch floor " + " ".join(f"{r['launch_floor_ms']:.6f}"
                                     for r in runs))
    print("(! : output not equal to the plain version's)")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "codec_ab.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
