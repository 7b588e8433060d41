"""Vehicular mobility simulation with the PyTorch port: watch the adaptive
cut-layer rule react as vehicles drive past the RSU (twin of
``examples/vehicular_sim.py``).

Vehicles approach, pass and leave the RSU's coverage; at each time the
channel model (``repro_torch.core.channel``) yields per-vehicle Shannon
rates (one vectorized draw for the whole fleet), and the three cut
strategies of ``repro_torch.core.adaptive`` (paper Eq. 3, latency-optimal,
energy-aware) pick cut layers; ``repro_torch.core.cost`` prices a round at
each rule's cuts.  It also shows the memory-constrained clamp, fleet-wide
and per vehicle.  ``--train`` then trains the fleet for a few ASFL rounds
through the port's front door, ``repro_torch.api.run``, under the
``memory`` strategy with per-vehicle memory budgets.  The strategy trace is
host arithmetic; the training runs on the CUDA card by default and on the
CPU with ``--device cpu``.

  PYTHONPATH=src python examples/vehicular_sim_torch.py        # the trace
  PYTHONPATH=src python examples/vehicular_sim_torch.py --train
  PYTHONPATH=src python examples/vehicular_sim_torch.py --train \\
      --device cpu --vehicles 4 --rounds 1 --model mlp9      # tiny
"""
import argparse
import time

import numpy as np

from repro_torch import api
from repro_torch.core import adaptive, channel
from repro_torch.core.cost import resnet_profile, sfl_client_round_cost

CUTS = (2, 4, 6, 8)


def strategy_trace(n_vehicles: int) -> dict:
    """The three rules' cuts at seven times over 30 s, the round latency
    of a fixed cut against the adaptive ones at t = 15 s, and the memory
    clamp; returns the cuts it printed."""
    prof = resnet_profile()
    fleet = channel.make_fleet(n_vehicles, seed=7)
    ch = channel.ChannelConfig()
    flops = [v.compute_flops for v in fleet]
    n_batches, batch, sf = 32, 16, 2e12
    trace = []

    print("t(s) | vehicle rates (Mbit/s) -> cuts [paper Eq.3] "
          "[latency-opt] [energy-aware]")
    for t in np.linspace(0, 30, 7):
        rates = channel.sample_round_rates(ch, fleet, float(t), seed=int(t))
        in_rng = channel.in_range_mask(ch, fleet, float(t))
        cuts_p = adaptive.paper_threshold(rates)
        cuts_l = adaptive.latency_optimal(prof, rates, flops, sf, n_batches,
                                          batch, candidate_cuts=CUTS)
        cuts_e = adaptive.energy_aware(prof, rates, flops, sf, n_batches,
                                       batch, candidate_cuts=CUTS)
        rstr = " ".join(f"{r / 1e6:5.1f}{'' if ok else '!'}"
                        for r, ok in zip(rates, in_rng))
        print(f"{t:4.0f} | {rstr} -> {cuts_p} {cuts_l} {cuts_e}")
        trace.append((float(t), list(cuts_p), list(cuts_l), list(cuts_e)))
    print("('!' marks vehicles outside RSU coverage: they skip the round --")
    print(" the mobility interruption problem the paper highlights)")

    rates = channel.sample_round_rates(ch, fleet, 15.0, seed=15)
    latency = {}
    for name, cuts in [
            ("fixed cut 4 (SFL)", [4] * n_vehicles),
            ("paper Eq.3 (ASFL)", adaptive.paper_threshold(rates)),
            ("latency-optimal  ", adaptive.latency_optimal(
                prof, rates, flops, sf, n_batches, batch,
                candidate_cuts=CUTS))]:
        lat = max(sfl_client_round_cost(prof, c, n_batches, batch, r, f, sf,
                                        local_epochs=5).latency
                  for c, r, f in zip(cuts, rates, flops))
        latency[name.strip()] = lat
        print(f"round latency {name}: {lat:7.1f}s  cuts={list(cuts)}")

    budget = 64 * 1024 * 1024           # a 64 MiB on-vehicle budget
    clamped = adaptive.memory_constrained(prof, budget,
                                          adaptive.paper_threshold, rates)
    print(f"with a {budget >> 20} MiB vehicle budget the cuts clamp to "
          f"{clamped}")
    het = channel.make_fleet(n_vehicles, seed=7,
                             memory_budget_bytes=(1e5, 8e6))
    per_vehicle = adaptive.memory_constrained(
        prof, channel.fleet_arrays(het)["memory_budget_bytes"],
        adaptive.paper_threshold, rates)
    print(f"with per-vehicle budgets (0.1-8 MB) they clamp to    "
          f"{per_vehicle}")
    return {"trace": trace, "latency": latency, "clamped": clamped,
            "per_vehicle": per_vehicle}


def train(n_vehicles: int, rounds: int, model: str, device) -> api.RunResult:
    """ASFL rounds over the fleet through ``repro_torch.api.run``: one
    :class:`ExperimentSpec` with the ``memory`` strategy (paper Eq. 3's
    cuts clamped to per-vehicle budgets); ``on_round`` prints each round's
    metrics as it completes."""
    spec = api.ExperimentSpec(
        model=model,
        train=api.TrainConfig(scheme="asfl", rounds=rounds, local_steps=2,
                              batch_size=8, lr=1e-3),
        adaptive=api.AdaptiveConfig(strategy="memory"),
        fleet=api.FleetConfig(n_vehicles=n_vehicles,
                              per_vehicle_samples=32, test_samples=128,
                              memory_budget_bytes=(5e5, 5e7)))
    print(f"\ntraining {n_vehicles} vehicles through api.run: "
          f"model={spec.model}, scheme=asfl(memory)")
    t0 = time.time()
    result = api.run(spec, device=device, on_round=lambda m: print(
        f"round {m.round}: loss={m.loss:.3f} acc={m.test_acc:.3f} "
        f"cuts={m.cuts}"))
    d = result.diagnostics
    print(f"({time.time() - t0:.1f}s wall on {d['device']}; schedule "
          f"{d['mode']}, total comm={result.totals['comm_bytes'] / 1e6:.1f}"
          f" MB)")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="also run ASFL rounds through repro_torch.api.run")
    ap.add_argument("--vehicles", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--model", default="resnet18",
                    choices=["resnet18", "mlp9"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, for --train")
    args = ap.parse_args(argv)
    out = strategy_trace(args.vehicles)
    if args.train:
        out["result"] = train(args.vehicles, args.rounds, args.model,
                              args.device)
    return out


if __name__ == "__main__":
    main()
