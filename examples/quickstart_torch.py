"""Quickstart of the PyTorch port: the paper's case study end to end.

One of the paper's Fig. 5 schemes (CL / FL / SL / SFL at a fixed cut /
ASFL) on a CIFAR-like task with 4 vehicles, non-IID data (6-of-10 labels,
power-law sizes) and ResNet18 (or the 9-unit split MLP, ``--model mlp9``),
driven through the port's front door ``repro_torch.api.run``.  Runs on the
CUDA card by default; ``--device cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
      [--scheme cl|fl|sl|sfl|asfl] [--cohort-parallel auto|vmap|unroll] \
      [--wire none|int8|topk_int8] [--rounds 3]
"""
import argparse

from repro_torch import api


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--scheme", default="asfl",
                    choices=["cl", "fl", "sl", "sfl", "asfl"])
    ap.add_argument("--cohort-parallel", default="auto",
                    choices=["auto", "vmap", "scan", "unroll"],
                    help="replica schedule (auto: vmap on the card, the "
                         "per-replica loop on the CPU)")
    ap.add_argument("--wire", default="none",
                    choices=["none", "int8", "topk_int8"],
                    help="the cut-boundary codec (beyond-paper)")
    ap.add_argument("--model", default="resnet18",
                    choices=["resnet18", "mlp9"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    print(f"== {args.scheme} quickstart: 4 vehicles, non-IID, "
          f"{args.model} ==")
    spec = api.ExperimentSpec(
        model=args.model,
        train=api.TrainConfig(scheme=args.scheme, rounds=args.rounds,
                              local_steps=args.local_steps, lr=1e-3,
                              batch_size=16, wire=args.wire),
        fleet=api.FleetConfig(n_vehicles=4, per_vehicle_samples=512,
                              test_samples=512),
        runtime=api.RuntimeConfig(cohort_parallel=args.cohort_parallel))
    f = spec.fleet
    clients, _ = api.model_entry(spec.model).make_data(
        f.n_vehicles, f.per_vehicle_samples, f.test_samples, f.data_seed)
    for c in clients:
        labs = sorted(set(c.labels.tolist()))
        print(f"  vehicle {c.client_id}: {len(c)} samples, labels {labs}")

    res = api.run(spec, device=args.device, on_round=lambda m: print(
        f"round {m.round}: loss={m.loss:.3f} acc={m.test_acc:.3f} "
        f"comm={m.comm_bytes / 1e6:.1f}MB sim_time={m.sim_time_s:.1f}s "
        f"cuts={m.cuts}"))
    d = res.diagnostics
    print(f"done on {d['device']} (schedule {d['mode']}): "
          f"{d['client_batch_steps']} client batch steps, "
          f"{d['wire_bytes']} bytes on the wire, "
          f"{res.timing['round_s']:.3f} s/round")


if __name__ == "__main__":
    main()
