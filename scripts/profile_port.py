"""Profile the PyTorch port on a CUDA card (torch.profiler).

    python3 scripts/profile_port.py [--out chiprun_out/profile_port.json]

1. One profiled ASFL round of the paper's case study on the topk_int8 wire
   (resnet18, 4 vehicles, batch 16, adam; ``local_steps=2`` to keep the
   trace small) after one warm-up round, under each replica schedule: the
   per-replica loop (``unroll``) and the vectorised ``vmap``.
2. One profiled round of the multi-RSU scenario path (mlp9 on
   ``highway_corridor``, 256 vehicles, 4 RSUs, local_steps 2, batch 8,
   sgd, ``paper`` cuts, the ``topk_int8`` wire with error feedback) after
   one warm-up round, on the sequential server schedule and on the
   parallel one (``server_schedule="parallel"``); with ``planes`` the same
   round under ``chip_smoke.py`` phase 10k's faults on both schedules, and
   the first round of its ``streaming`` schedule with presence churn.
3. Split-inference serving of smollm-360m, mamba2-780m, gemma3-4b,
   recurrentgemma-2b, internvl2-1b, musicgen-large, deepseek-v2-lite-16b
   and the bfloat16 qwen3-14b and command-r-35b at full width
   (batch 8, prompt 1024, the default cut) after a warm-up at prompt 64,
   as ``chip_smoke.py`` serves: a profiled prefill (the first run is the
   process's first at full size), then 8 profiled decode steps.
4. One sync-SFL train step of each run of ``chip_smoke.py`` phase 10g
   (``TRAIN_RUNS`` without int8 smashed data), at full width, at that
   phase's depth, batch and dtype (smollm-360m, mamba2-780m, internvl2-1b
   and musicgen-large whole at batch 8, recurrentgemma-2b one period and
   its tail, gemma3-4b one period at batch 4, deepseek-v2-lite-16b at its
   cut depth; in bfloat16 qwen3-14b and command-r-35b at their cut depth,
   gemma3-4b whole at batch 4, dbrx-132b one layer at batch 4; mamba2-780m
   whole in bfloat16 and float16, smollm-360m whole in float16 and in
   float32 under the "dots" remat policy; seq 1024, the default cut,
   adamw, clip 1.0, remat, the donated step) after one warm-up step.
5. With ``city``: one round of ``chip_smoke.py`` phase 10l's city cell
   (4096 vehicles, 256 RSUs, mlp9, ``none``, parallel ragged, mobility
   churn) after one warm-up round, unpaged and at ``page_slots=128``,
   with the kernels that launch most often.

``--only round,scenario,planes,serve,train,city`` picks the parts to run
(all but ``city`` by default).  ``--repeat N`` profiles the scenario and
planes rounds N times, taking the cells in turns, so that their wall
times per client batch step can be compared within one process.

For each: wall time, device busy share (summed kernel time / wall), and
the kernels that take the most device time, by name; for serving also the
host's time in ``cudaMalloc`` and its calls (the caching allocator growing
its pool, in the first run).  CUPTI drops runs of kernel records, so each
profile traces its run twice (from the same start) and reads the trace
that kept the most launches, printing both counts when they differ.  The
kernels' own times are measured by ``chip_smoke.py``.

Needs a CUDA card and nvcc; imports neither jax nor repro.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _is_device_kernel(evt) -> bool:
    import torch
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _fresh_runs(sim, counter):
    """(reset, run) for :func:`_profiled` of an engine's rounds from a
    fresh start: ``reset`` resets ``sim`` and the launch counters; ``run``
    returns the rounds' metrics, the client batch steps ``counter`` took
    and the launches."""
    from repro_torch import kernels
    base = {}

    def reset():
        sim.reset()
        kernels.reset_launches()
        base["steps"] = counter.batch_steps

    def run():
        hist = sim.run()
        return (hist, counter.batch_steps - base["steps"],
                kernels.launch_counts())
    reset()
    return reset, run


def round_profile(mode: str, top: int = 12):
    from repro_torch import api
    spec = api.ExperimentSpec(
        train=api.TrainConfig(rounds=1, local_steps=2, wire="topk_int8",
                              eval_every=0),
        runtime=api.RuntimeConfig(cohort_parallel=mode))
    sim = api.build_engine(spec)
    sim.run()                                  # warm-up round
    reset, run = _fresh_runs(sim, sim.engine)
    ((m,), steps, launches), res = _profiled(run, top, reset)
    res.update(mode=sim.engine.mode, cuts=m.cuts, client_batch_steps=steps,
               codec_launches=launches)
    print(f"round mode={res['mode']} wall_s={res['wall_s']:.6f} "
          f"device_busy_s={res['device_busy_s']:.6f} "
          f"busy_share={res['device_busy_share']:.4f} cuts={m.cuts} "
          f"client_batch_steps={steps} "
          f"device_kernels={res['n_device_kernels']}", flush=True)
    for r in res["top"]:
        print(f"round {res['mode']} top count={r['count']:6d} "
              f"device_ms={r['device_ms']:.3f} {r['kernel']}", flush=True)
    return res


def scenario_profile(top: int = 12, vehicles: int = 256,
                     schedule: str = "sequential", label: str = "",
                     **groups):
    """One profiled topk_int8 round of the multi-RSU path after a warm-up
    round (the same spec as ``chip_smoke.py``'s highway phase) on the
    server ``schedule``; ``groups`` (``faults``, ``stream``) as in its
    phase 10k."""
    from repro_torch import api
    spec = api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(rounds=1, local_steps=2, batch_size=8,
                              lr=1e-3, optimizer="sgd", eval_every=0,
                              wire="topk_int8", server_schedule=schedule),
        fleet=api.FleetConfig(n_vehicles=vehicles,
                              scenario="highway_corridor",
                              scenario_kwargs={"seed": vehicles},
                              round_interval_s=10.0, per_vehicle_samples=64,
                              data_seed=vehicles), **groups)
    eng = api.build_engine(spec)
    eng.run()                                  # warm-up round
    reset, run = _fresh_runs(eng, eng)
    (hist, steps, launches), res = _profiled(run, top, reset)
    res.update(schedule=schedule, cuts=hist[-1].cuts,
               rsu_loads=hist[-1].rsu_loads, client_batch_steps=steps,
               launches=launches)
    schedule = schedule + label
    res["ms_per_step"] = 1e3 * res["wall_s"] / max(
        res["client_batch_steps"], 1)
    print(f"scenario {schedule} wall_s={res['wall_s']:.6f} "
          f"ms_per_step={res['ms_per_step']:.6f} "
          f"device_busy_s={res['device_busy_s']:.6f} "
          f"busy_share={res['device_busy_share']:.4f} "
          f"client_batch_steps={res['client_batch_steps']} "
          f"loads={res['rsu_loads']} "
          f"device_kernels={res['n_device_kernels']}", flush=True)
    for r in res["top"]:
        print(f"scenario {schedule} top count={r['count']:6d} "
              f"device_ms={r['device_ms']:.3f} {r['kernel']}", flush=True)
    return res


def city_profile(page: int, top: int = 12):
    """One profiled round of phase 10l's city cell after a warm-up round,
    at ``page_slots=page``."""
    sys.path.insert(0, os.path.dirname(HERE))
    from chip_smoke import _city_spec

    from repro_torch import api
    eng = api.build_engine(_city_spec(page=page, rounds=1, k=1))
    eng.run()                                  # warm-up round
    eng.reset()
    hist, res = _profiled(eng.run, top, eng.reset)
    res.update(page_slots=page, scheduled=hist[-1].n_scheduled,
               occupancy=eng.occupancy_stats())
    print(f"city page_slots={page} wall_s={res['wall_s']:.6f} "
          f"device_busy_s={res['device_busy_s']:.6f} "
          f"busy_share={res['device_busy_share']:.4f} "
          f"scheduled={res['scheduled']} "
          f"device_kernels={res['n_device_kernels']}", flush=True)
    for key in ("top", "most_launched"):
        for r in res[key]:
            print(f"city page_slots={page} {key} count={r['count']:6d} "
                  f"device_ms={r['device_ms']:.3f} {r['kernel']}",
                  flush=True)
    return res


# CUPTI drops runs of kernel records (chip_smoke.py's _per_call_ms): a
# profile takes this many traces of its run and reads the one that kept
# the most kernel launches
TRACES = 2


def _profiled(fn, top, reset=None):
    """Run ``fn`` under the profiler TRACES times (``reset``, where given,
    before every run but the first, outside the trace); read the trace
    that kept the most kernel launches and print the counts when the
    traces differ (the shorter lost records).  Returns (``fn``'s output
    of that run, {wall s, busy s, kernel count, every trace's count, host
    time in and number of ``cudaMalloc`` calls of the first run, which
    grows the allocator's pool, top rows})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    runs = []
    for i in range(TRACES):
        if i and reset is not None:
            reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evts = prof.key_averages()
        dev = [e for e in evts if _is_device_kernel(e)]
        runs.append((sum(e.count for e in dev), out, wall, dev,
                     [e for e in evts if e.key == "cudaMalloc"]))
    traced = [r[0] for r in runs]
    if len(set(traced)) > 1:
        print(f"profiler: traces of one run kept {traced} kernel records; "
              f"the longest is read", flush=True)
    mallocs = runs[0][4]
    _, out, wall, dev, _ = max(runs, key=lambda r: r[0])
    busy_us = sum(_device_us(e) for e in dev)

    def rows_of(evs):
        return [{"kernel": e.key[:120], "count": e.count,
                 "device_ms": _device_us(e) / 1e3} for e in evs[:top]]

    most = rows_of(sorted(dev, key=lambda e: e.count, reverse=True))
    dev.sort(key=_device_us, reverse=True)
    rows = rows_of(dev)
    return out, {"wall_s": wall, "device_busy_s": busy_us / 1e6,
                 "device_busy_share": busy_us / 1e6 / wall,
                 "n_device_kernels": sum(e.count for e in dev),
                 "traced_kernels": traced,
                 "cuda_malloc_s": sum(e.self_cpu_time_total
                                      for e in mallocs) / 1e6,
                 "cuda_mallocs": sum(e.count for e in mallocs),
                 "top": rows, "most_launched": most}


def serve_profile(arch, top: int = 10, batch: int = 8, prompt: int = 1024,
                  steps: int = 8):
    """One profiled prefill and ``steps`` profiled decode steps of ``arch``
    at full width, after a warm-up."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    dev = torch.device("cuda")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    serve.serve(cfg, params, batch=batch, prompt_len=64, decode_steps=2)
    opts = D.DistOptions(cut=cfg.default_cut)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch0 = serve.prompt_batch(cfg, gen, batch, prompt)
    n = serve.prompt_length(cfg, batch0)
    cap = n + steps
    prefill = D.make_prefill_step(cfg, opts, cap)
    decode = D.make_decode_step(cfg, opts, cap)
    shape = (batch, cfg.n_codebooks) if cfg.frontend == "audio" else (batch,)
    step_batches = [serve.step_batch(cfg, torch.randint(
        0, cfg.vocab_size, shape, generator=gen, device=dev))
        for _ in range(steps)]
    (logits, caches), pre = _profiled(lambda: prefill(params, batch0), top)

    def run_decode():
        c = caches
        for i in range(steps):
            _, c = decode(params, step_batches[i], c, n + i)
    _, dec = _profiled(run_decode, top)
    res = {"arch": arch, "batch": batch, "prompt": prompt,
           "decode_steps": steps, "prefill": pre, "decode": dec}
    for phase, r in (("prefill", pre), ("decode", dec)):
        print(f"serve {arch} {phase} wall_s={r['wall_s']:.6f} "
              f"device_busy_s={r['device_busy_s']:.6f} "
              f"busy_share={r['device_busy_share']:.4f} "
              f"device_kernels={r['n_device_kernels']} "
              f"cuda_malloc_s={r['cuda_malloc_s']:.6f} "
              f"cuda_mallocs={r['cuda_mallocs']}", flush=True)
        for row in r["top"]:
            print(f"serve {arch} {phase} top count={row['count']:6d} "
                  f"device_ms={row['device_ms']:.3f} {row['kernel']}",
                  flush=True)
    del params, caches, logits
    torch.cuda.empty_cache()
    return res


def train_profile(arch, top: int = 20, batch: int = 8, seq: int = 1024,
                  changes=None):
    """One profiled train step of ``arch`` at full width, its config
    changed by ``changes`` (a depth cut, a dtype; ``remat_policy`` sets
    ``transformer.set_remat_policy`` for the step), after a warm-up step;
    the donated step, so each traced step updates the one state in
    place."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import transformer as T
    changes = dict(changes or {})
    policy = changes.pop("remat_policy", None)
    T.set_remat_policy(policy)
    try:
        return _train_profile(arch, dataclasses.replace(get_config(arch),
                                                        **changes),
                              policy, top, batch, seq)
    finally:
        T.set_remat_policy(None)


def _train_profile(arch, cfg, policy, top, batch, seq):
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.launch.train import synth_batch
    dev = torch.device("cuda")
    opts = D.DistOptions(cut=cfg.default_cut)
    state = D.init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                         opts)
    step = D.make_train_step(cfg, opts)
    batches = [synth_batch(cfg, torch.Generator(device=dev).manual_seed(i),
                           batch, seq, 4) for i in range(2)]
    held = {"state": step(state, batches[0])[0]}
    del state

    def run():
        held["state"], m = step(held["state"], batches[1])
        return m

    _, r = _profiled(run, top)
    res = {"arch": arch, "dtype": cfg.param_dtype, "remat_policy": policy,
           "batch": batch, "seq": seq, "cut": opts.cut,
           "layers": cfg.n_layers, "step": r}
    print(f"train {arch} dtype={cfg.param_dtype} remat_policy={policy} "
          f"layers={cfg.n_layers} batch={batch} "
          f"wall_s={r['wall_s']:.6f} "
          f"device_busy_s={r['device_busy_s']:.6f} "
          f"busy_share={r['device_busy_share']:.4f} "
          f"device_kernels={r['n_device_kernels']} "
          f"cuda_malloc_s={r['cuda_malloc_s']:.6f} "
          f"cuda_mallocs={r['cuda_mallocs']}", flush=True)
    for row in r["top"]:
        print(f"train {arch} top count={row['count']:6d} "
              f"device_ms={row['device_ms']:.3f} {row['kernel']}",
              flush=True)
    del held, batches
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_port.json")
    ap.add_argument("--only", default="round,scenario,planes,serve,train")
    ap.add_argument("--repeat", type=int, default=1,
                    help="profile the scenario / planes rounds this many "
                         "times, the cells in turns")
    args = ap.parse_args()
    parts = set(args.only.split(","))
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    from repro_torch.device import set_float32_precision
    set_float32_precision()
    archs = ("smollm-360m", "mamba2-780m")
    result = {"card": card}
    if "round" in parts:
        result.update(round=round_profile("unroll"),
                      round_vmap=round_profile("vmap"))
    cells = []
    if "scenario" in parts:
        cells += [("scenario", {}),
                  ("scenario_parallel", {"schedule": "parallel"})]
    if "planes" in parts:
        # chip_smoke.py's phase 10k: the fault plane on both schedules,
        # the streaming schedule with churn (its first round: no fire)
        from repro_torch import api
        faults = api.FaultsConfig(dropout_rate=0.1, upload_loss_rate=0.05,
                                  rsu_outage_rate=0.1, straggler_factor=0.01)
        cells += [("scenario_faults", {"label": "+faults", "faults": faults}),
                  ("scenario_parallel_faults",
                   {"schedule": "parallel", "label": "+faults",
                    "faults": faults}),
                  ("scenario_streaming",
                   {"schedule": "streaming", "stream": api.StreamConfig(
                       churn_rate=0.2, buffer_size=4, kernel="poly",
                       alpha=0.5)})]
    for rep in range(max(args.repeat, 1)):
        for key, kw in cells:
            res = scenario_profile(**kw)
            if rep == 0:
                result[key] = res
            result.setdefault("repeats", {}).setdefault(key, []).append(
                {k: res[k] for k in ("wall_s", "client_batch_steps",
                                     "ms_per_step", "n_device_kernels",
                                     "device_busy_share")})
    if "serve" in parts:
        result["serve"] = [serve_profile(a) for a in archs + (
            "gemma3-4b", "recurrentgemma-2b", "internvl2-1b",
            "musicgen-large", "deepseek-v2-lite-16b", "qwen3-14b",
            "command-r-35b")]
    if "train" in parts:
        sys.path.insert(0, os.path.dirname(HERE))
        import chip_smoke                  # phase 10g's depth and batch
        result["train"] = [
            train_profile(arch, batch=batch, changes=changes)
            for arch, compress, _, batch, changes in chip_smoke.TRAIN_RUNS
            if not compress]
    if "city" in parts:
        result["city"] = [city_profile(page) for page in (0, 128)]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
