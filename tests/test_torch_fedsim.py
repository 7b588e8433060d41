"""The slice as a whole: the port's FederationSim (asfl, mlp9, 4 vehicles,
2 rounds, sgd) on device="cpu" against repro.core.fedsim.FederationSim from
the same initial parameters, for every wire; the bytes that actually
crossed the wire against the cost model; and the host control plane
(channel, cost, cut strategies) against the reference.

Tolerances: cuts equal; comm_bytes / sim_time_s / energy_j equal to
rtol=1e-12 (numpy on both sides); loss and final parameters within 1e-5 for
wire="none" (float32 summation order) and 1e-4 for the codec wires (a
1-ulp input difference can move a value across a rounding or top-k
boundary, which moves it by one int8 step)."""
import numpy as np
import pytest

from _torch_parity import assert_sims_agree, cap_torch_threads, run_both
from repro.core import adaptive as JA
from repro.core import channel as JCh
from repro.core import cost as JC
from repro.core import fedsim as JF
from repro_torch.core import adaptive as TA
from repro_torch.core import channel as TCh
from repro_torch.core import cost as TC
from repro_torch.core import fedsim as TF
from repro_torch.models import mlp_unit as TM

cap_torch_threads()


@pytest.mark.parametrize("wire", ["none", "int8", "topk_int8"])
def test_federation_sim_sgd_matches_jax(wire):
    js, jh, ts, th = run_both("sgd", wire, lr=1e-2)
    assert_sims_agree(js, jh, ts, th, wire)


@pytest.mark.parametrize("wire", ["none", "int8", "topk_int8"])
def test_wire_bytes_equal_cost_model(wire):
    """The packed buffers that crossed the wire in one round (uplink +
    downlink) hold exactly the smashed bytes the cost model charges."""
    cfg = TF.SimConfig(n_clients=4, batch_size=8, local_epochs=2, lr=1e-2,
                       rounds=1, optimizer="sgd", wire=wire, eval_every=0)
    tc, tt = TM.make_mlp_fleet_data(4, 24, seed=1, n_test=16)
    sim = TF.FederationSim(TM.MLPUnitModel(), tc, tt, cfg, device="cpu")
    before = sim.engine.wire_bytes
    (m,) = sim.run()
    crossed = sim.engine.wire_bytes - before
    steps = [max(len(c) // cfg.batch_size, 1) * cfg.local_epochs
             for c in tc]
    up, down = TC.effective_comm_bytes(sim.profile, m.cuts, steps,
                                       cfg.batch_size, wire, cfg.wire_k,
                                       include_model_transfer=False)
    assert crossed > 0
    np.testing.assert_allclose(crossed, float(np.sum(up + down)),
                               rtol=1e-12)
    if wire == "topk_int8":    # the packed wire is the cost model's 9.14x
        dense = 2 * sum(steps) * cfg.batch_size * 64 * 4
        np.testing.assert_allclose(dense / crossed, 64 * 4 / 28, rtol=1e-12)


def test_control_plane_matches_jax():
    jf, tf = JCh.make_fleet(6, seed=3), TCh.make_fleet(6, seed=3)
    ja, ta = JCh.fleet_arrays(jf), TCh.fleet_arrays(tf)
    for k in ja:
        assert np.array_equal(ja[k], ta[k])
    for t in (0.0, 5.0, 30.0):
        r = JCh.sample_round_rates(JCh.ChannelConfig(), ja, t, 11)
        assert np.array_equal(r, TCh.sample_round_rates(
            TCh.ChannelConfig(), ta, t, 11))
        assert np.array_equal(JCh.in_range_mask(JCh.ChannelConfig(), ja, t),
                              TCh.in_range_mask(TCh.ChannelConfig(), ta, t))
        assert JA.paper_threshold(r) == TA.paper_threshold(r)
        assert JA.paper_threshold(r, literal_eq3=True) \
            == TA.paper_threshold(r, literal_eq3=True)
    jp, tp = JC.resnet_profile(), TC.resnet_profile()
    rates = JCh.sample_round_rates(JCh.ChannelConfig(), ja, 5.0, 2)
    flops = ja["compute_flops"]
    assert JA.latency_optimal(jp, rates, flops, 2e12, 4, 16, 5) \
        == TA.latency_optimal(tp, rates, flops, 2e12, 4, 16, 5)
    assert JA.energy_aware(jp, rates, flops, 2e12, 4, 16, 5) \
        == TA.energy_aware(tp, rates, flops, 2e12, 4, 16, 5)
    budgets = np.array([1e5, 1e6, 3e6, 1e7, 5e7, np.inf])
    assert JA.memory_constrained(jp, budgets, JA.paper_threshold, rates) \
        == TA.memory_constrained(tp, budgets, TA.paper_threshold, rates)
    for wire in ("none", "int8", "topk_int8"):
        a = JC.sfl_round_cost_arrays(jp, [2, 4, 6, 8], [4, 4, 2, 1], 16,
                                     rates[:4], flops[:4], 2e12, 5,
                                     ja["tx_power_w"][:4],
                                     ja["compute_power_w"][:4], wire=wire)
        b = TC.sfl_round_cost_arrays(tp, [2, 4, 6, 8], [4, 4, 2, 1], 16,
                                     rates[:4], flops[:4], 2e12, 5,
                                     ta["tx_power_w"][:4],
                                     ta["compute_power_w"][:4], wire=wire)
        for f in ("comm_bytes_up", "comm_bytes_down", "t_client_compute",
                  "t_server_compute", "t_comm", "energy_j"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-12)


def test_sim_config_refuses_what_is_not_ported():
    for kw in ({"mesh_devices": 2}, {"fleet_axis": "rsu"}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            TF.SimConfig(**kw)
    # ported: slot paging, an int >= 0 as in the reference
    assert TF.SimConfig(page_slots=4).page_slots == 4
    with pytest.raises(ValueError, match="page_slots"):
        TF.SimConfig(page_slots=-1)
    # ported: the engines take or refuse these as the reference's do
    # (tests/test_torch_superstep.py, tests/test_torch_streaming.py)
    for kw in ({"superstep": 2}, {"server_schedule": "parallel"},
               {"server_schedule": "streaming"}, {"stream_buffer_size": 8},
               {"stream_churn_rate": 0.1}):
        TF.SimConfig(**kw)
    with pytest.raises(ValueError, match="stream_churn_source"):
        TF.SimConfig(stream_churn_source="gps")
    with pytest.raises(ValueError, match="churn_rate must stay 0"):
        TF.SimConfig(stream_churn_source="mobility", stream_churn_rate=0.1)
    with pytest.raises(ValueError):
        TF.SimConfig(wire="fp8")
    assert TF.SimConfig(compress_smashed=True).wire_scheme() == "int8"
    names = [f for f in JF.SimConfig.__dataclass_fields__]
    assert names == list(TF.SimConfig.__dataclass_fields__)
    for f in names:
        assert JF.SimConfig.__dataclass_fields__[f].default \
            == TF.SimConfig.__dataclass_fields__[f].default, f
