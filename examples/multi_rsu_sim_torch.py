"""Multi-RSU scenario demo of the PyTorch port: mobility, handover,
hierarchical aggregation, driven through the port's front door
``repro_torch.api.run`` (twin of ``examples/multi_rsu_sim.py``).

A fleet drives a 4-RSU highway corridor (``core/scenario.py``).  Each
round the scenario yields the fleet's state (positions, serving cell,
Shannon rates, remaining residence time); the scenario engine lays the
scheduled vehicles out as one slot per vehicle, trains every RSU's cohort
against that RSU's edge model, and merges the edge models at a cloud tier
every ``--sync`` rounds.  ``--schedule sequential`` is the paper's RSU
(§III-B: one client batch at a time); ``parallel`` is the companion
paper's (arXiv:2405.18707: every cohort at once, one mean-gradient step
per RSU and local step); ``streaming`` commits each RSU's parallel round
through a buffer of pending deltas that merges when full (the per-round
line then shows the merges and the buffer's fill).  ``--superstep`` K
runs K rounds as one window
with one read-back; the per-round lines stream from the ``on_round``
callback after each window.  ``--scenario city`` is the scale-out
lattice (``--grid`` cells, Zipf cell popularity, orbit mobility);
``--page-slots`` walks each cut bucket's slots in windows of that many on
the parallel / streaming schedules.  Runs on the CUDA card by default;
``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/multi_rsu_sim_torch.py --device cpu
  PYTHONPATH=src python examples/multi_rsu_sim_torch.py --device cpu \
      --schedule parallel --superstep 3 --rounds 6 --sync 2
  PYTHONPATH=src python examples/multi_rsu_sim_torch.py --device cpu \
      --schedule streaming --rounds 6
  PYTHONPATH=src python examples/multi_rsu_sim_torch.py --scenario urban_grid
  PYTHONPATH=src python examples/multi_rsu_sim_torch.py --device cpu \
      --scenario city --grid 2x2 --vehicles 64 --schedule parallel \
      --page-slots 8
"""
import argparse
import time

import numpy as np

from repro_torch import api
from repro_torch.core import adaptive, cost


def show_residence_rule(sc, rounds, interval):
    """What the residence_aware rule would decide for the paper's ResNet18
    cost profile on this scenario (SKIP = the vehicle leaves its cell
    before any cut's round latency fits)."""
    prof = cost.resnet_profile()
    print("\nresidence_aware on the ResNet18 profile "
          "(cut 0 = skip the round):")
    for rnd in range(min(rounds, 4)):
        st = sc.fleet_state(rnd * interval, seed=rnd)
        cuts = np.asarray(adaptive.residence_aware(
            prof, np.maximum(st.rates_bps, 1.0), 2e10, 2e12, 4, 16, 1,
            st.residence_s))
        cuts = np.where(st.active, cuts, -1)
        n_skip = int(((cuts == 0) & st.active).sum())
        print(f"  t={rnd*interval:5.1f}s  cuts={cuts[:12]}...  "
              f"skips={n_skip}  uncovered={int((~st.active).sum())}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="highway_corridor",
                    choices=sorted(n for n, b in api.SCENARIOS.items()
                                   if b is not None))
    ap.add_argument("--vehicles", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--sync", type=int, default=2,
                    help="cloud merge every k rounds")
    ap.add_argument("--superstep", type=int, default=2,
                    help="rounds run as one window with one read-back "
                         "(1 = one round at a time)")
    ap.add_argument("--schedule", default="sequential",
                    choices=sorted(api.SCHEDULES),
                    help="RSU server schedule: paper §III-B sequential, "
                         "the parallel scheme of arXiv:2405.18707, or "
                         "streaming (parallel rounds through a buffer)")
    ap.add_argument("--grid", default="16x16",
                    help="the city lattice, GXxGY RSU cells")
    ap.add_argument("--page-slots", type=int, default=0,
                    help="slot window of the ragged parallel / streaming "
                         "schedules (0 = unpaged)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    sc_kw = {"seed": 7}
    if args.scenario == "city":
        gx, gy = (int(v) for v in args.grid.split("x"))
        sc_kw.update(grid_x=gx, grid_y=gy)

    # the registry's mlp9 split model stands in for a vehicle perception
    # model (the federation dynamics, not the FLOPs, are this demo's point)
    spec = api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(scheme="asfl", rounds=args.rounds,
                              local_steps=2, batch_size=8, lr=1e-3,
                              server_schedule=args.schedule),
        adaptive=api.AdaptiveConfig(strategy="paper"),
        fleet=api.FleetConfig(n_vehicles=args.vehicles,
                              scenario=args.scenario,
                              scenario_kwargs=sc_kw,
                              cloud_sync_every=args.sync,
                              round_interval_s=10.0,
                              per_vehicle_samples=64),
        runtime=api.RuntimeConfig(superstep=args.superstep,
                                  page_slots=args.page_slots))
    sc = api.SCENARIOS[args.scenario](args.vehicles,
                                      **spec.fleet.scenario_kwargs)
    print(f"scenario={args.scenario}: {args.vehicles} vehicles, "
          f"{len(sc.rsu_positions)} RSUs; schedule={args.schedule}, "
          f"K={args.superstep}, cloud sync every {args.sync} round(s)"
          + (f", page_slots={args.page_slots}" if args.page_slots else ""))

    def on_round(m):
        acc = f"{m.test_acc:.3f}" if np.isfinite(m.test_acc) else "  -  "
        print(f"round {m.round}: loss={m.loss:.3f} acc={acc} "
              f"sched={m.n_scheduled:3d} handover={m.n_handover:2d} "
              + (f"rsu_loads={m.rsu_loads} " if len(m.rsu_loads) <= 8 else
                 f"cells served={sum(c > 0 for c in m.rsu_loads)} "
                 f"max load={max(m.rsu_loads)} ")
              + f"comm={m.comm_bytes/1e6:6.1f}MB"
              + (f" merges={m.stream_merges} buffered="
                 f"{m.buffer_occupancy:.0f}"
                 if args.schedule == "streaming" else ""))

    t0 = time.time()
    result = api.run(spec, device=args.device, on_round=on_round,
                     on_cloud_merge=lambda rnd, eng: print(
                         f"  cloud merge after round {rnd}"))
    occ = result.diagnostics["occupancy"]
    print(f"({time.time()-t0:.1f}s wall on {result.diagnostics['device']}; "
          f"engine mode={result.diagnostics['mode']}, run "
          f"{result.timing['run_s']:.1f}s; slots {occ['executed_slots']} "
          f"executed, {occ['mean_occupied_slots']:.1f} occupied on average)")

    show_residence_rule(sc, args.rounds, spec.fleet.round_interval_s)


if __name__ == "__main__":
    main()
