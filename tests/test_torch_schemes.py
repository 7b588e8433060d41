"""The paper's baseline schemes on the port's FederationSim (mlp9, 4
vehicles, device="cpu") against repro.core.fedsim.FederationSim from the
same initial parameters: cl (centralised; its optimizer state carried
across rounds), fl (full-model local training, stacked FedAvg) and sl (one
travelling vehicle-side model through the message flow, so the codec runs
at every step of the chain), over 2 rounds; and the numpy twins the
schemes need (cost model, stacked FedAvg, Dirichlet partition).

Tolerances: cuts equal; comm_bytes / sim_time_s / energy_j equal to
rtol=1e-12 (numpy on both sides); loss and final parameters within 1e-5
(float32 summation order; sgd, and adam held by the same trajectory) or,
for sl on the codec wires, 1e-4 (a 1-ulp input difference can move a value
across an int8 rounding or top-k boundary: one int8 step)."""
import numpy as np
import pytest

from _torch_parity import assert_sims_agree, cap_torch_threads, run_both
from repro.core import aggregation as JAgg
from repro.core import channel as JCh
from repro.core import cost as JC
from repro.data import partition as JP
from repro_torch.core import aggregation as TAgg
from repro_torch.core import cost as TC
from repro_torch.data import partition as TP

cap_torch_threads()

COST_FIELDS = ("comm_bytes_up", "comm_bytes_down", "t_client_compute",
               "t_server_compute", "t_comm", "energy_j")


@pytest.mark.parametrize("scheme,opt,lr,wire", [
    ("cl", "sgd", 1e-2, "none"), ("cl", "adam", 1e-3, "none"),
    ("fl", "sgd", 1e-2, "none"), ("fl", "adam", 1e-3, "none"),
    ("sl", "sgd", 1e-2, "none"), ("sl", "sgd", 1e-2, "int8"),
    ("sl", "sgd", 1e-2, "topk_int8")])
def test_scheme_matches_jax(scheme, opt, lr, wire):
    # unequal shards: fl's replicas run different numbers of local steps
    js, jh, ts, th = run_both(opt, wire, lr, cut=3, scheme=scheme,
                              sizes=(16, 24, 32, 40), per_vehicle=40)
    assert_sims_agree(js, jh, ts, th, wire)
    if scheme == "cl":
        assert th[0].comm_bytes == sum(c.images.nbytes for c in ts.clients)
        assert th[1].comm_bytes == 0.0
    if scheme == "sl":
        assert [m.cuts for m in th] == [[3] * 4] * 2
        assert ts.engine.wire_bytes > 0
    else:
        assert ts.engine.wire_bytes == 0 and th[0].cuts == []
    assert ts.engine.batch_steps == 2 * sum(n // 8 for n in (16, 24, 32,
                                                             40))


def test_cost_twins_match_jax():
    jp, tp = JC.resnet_profile(), TC.resnet_profile()
    for cut in range(1, 10):
        assert (jp.client_fwd_flops(cut), jp.server_fwd_flops(cut)) \
            == (tp.client_fwd_flops(cut), tp.server_fwd_flops(cut))
    assert jp.full_param_bytes() == tp.full_param_bytes()
    fa = JCh.fleet_arrays(JCh.make_fleet(4, seed=5))
    rates = JCh.sample_round_rates(JCh.ChannelConfig(), fa, 10.0, 3)
    flops, tx, cp = (fa["compute_flops"], fa["tx_power_w"],
                     fa["compute_power_w"])
    nb = [4, 1, 3, 2]
    pairs = [(JC.fl_round_cost_arrays(jp, nb, 16, rates, flops, 5, tx, cp),
              TC.fl_round_cost_arrays(tp, nb, 16, rates, flops, 5, tx, cp))]
    for wire in ("none", "int8", "topk_int8"):
        upload = np.array([True, False, True, False])
        pairs.append((
            JC.sfl_round_cost_arrays(jp, [2, 4, 6, 8], [3, 0, 2, 1], 16,
                                     rates, flops, 2e12, 1, tx, cp,
                                     wire=wire, model_upload=upload),
            TC.sfl_round_cost_arrays(tp, [2, 4, 6, 8], [3, 0, 2, 1], 16,
                                     rates, flops, 2e12, 1, tx, cp,
                                     wire=wire, model_upload=upload)))
        for cut in (2, 5):
            pairs.append((
                JC.sfl_client_round_cost(jp, cut, 3, 16, rates[0], flops[0],
                                         2e12, 5, tx[0], cp[0], wire=wire),
                TC.sfl_client_round_cost(tp, cut, 3, 16, rates[0], flops[0],
                                         2e12, 5, tx[0], cp[0], wire=wire)))
        np.testing.assert_array_equal(
            JC.effective_comm_bytes(jp, [2, 8], [3, 1], 16, wire,
                                    model_upload=np.array([False, True])),
            TC.effective_comm_bytes(tp, [2, 8], [3, 1], 16, wire,
                                    model_upload=np.array([False, True])))
    pairs += [(JC.sl_round_cost(jp, 4, nb, 16, rates, flops, 2e12, 5),
               TC.sl_round_cost(tp, 4, nb, 16, rates, flops, 2e12, 5)),
              (JC.fl_client_round_cost(jp, 3, 16, rates[1], flops[1], 5),
               TC.fl_client_round_cost(tp, 3, 16, rates[1], flops[1], 5))]
    for a, b in pairs:
        for f in COST_FIELDS + ("comm_bytes", "latency"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-12, err_msg=f)


def test_stacked_fedavg_matches_jax():
    import jax
    import torch
    rng = np.random.default_rng(4)
    tree = {"units": [{"w": rng.normal(size=(5, 7, 3)).astype(np.float32),
                       "b": rng.normal(size=(5, 3)).astype(np.float32)}],
            "head": {"w": rng.normal(size=(5, 4)).astype(np.float32)}}
    w = np.array([40.0, 0.0, 16.0, 23.0, 8.0])
    ref_sum = jax.tree.map(np.asarray, JAgg.stacked_weighted_sum(tree, w))
    ref_avg = jax.tree.map(np.asarray, JAgg.stacked_fedavg(tree, w))
    ttree = jax.tree.map(torch.from_numpy, tree)
    got_sum = jax.tree.map(lambda t: t.numpy(),
                           TAgg.stacked_weighted_sum(ttree, w))
    got_avg = jax.tree.map(lambda t: t.numpy(), TAgg.stacked_fedavg(ttree, w))
    for a, b in zip(jax.tree.leaves(ref_sum) + jax.tree.leaves(ref_avg),
                    jax.tree.leaves(got_sum) + jax.tree.leaves(got_avg)):
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed,alpha", [(0, 0.5), (3, 0.1), (11, 5.0)])
def test_dirichlet_partition_replays_jax(seed, alpha):
    labels = np.random.default_rng(seed).integers(0, 10, size=400)
    ref = JP.dirichlet_partition(seed, labels, 6, alpha)
    got = TP.dirichlet_partition(seed, labels, 6, alpha)
    assert len(ref) == len(got) == 6
    for a, b in zip(ref, got):
        assert b.dtype == np.int64 and np.array_equal(a, b)
    assert JP.partition_stats(ref, labels) == TP.partition_stats(got, labels)
