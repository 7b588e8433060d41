"""The slice as a whole under adam (the paper's optimizer): the port's
FederationSim (mlp9, 4 vehicles) on device="cpu" against
repro.core.fedsim.FederationSim from the same initial parameters — asfl for
every wire over 2 rounds, and sfl at a fixed cut.  Tolerances as in
test_torch_fedsim.py: cuts and cost numbers equal, loss and parameters
within 1e-5 (wire="none") or 1e-4 (codec wires)."""
import pytest

from _torch_parity import assert_sims_agree, cap_torch_threads, run_both

cap_torch_threads()


@pytest.mark.parametrize("wire", ["none", "int8", "topk_int8"])
def test_federation_sim_adam_matches_jax(wire):
    js, jh, ts, th = run_both("adam", wire, lr=1e-3)
    assert_sims_agree(js, jh, ts, th, wire)


def test_federation_sim_sfl_fixed_cut_matches_jax():
    js, jh, ts, th = run_both("adam", "int8", lr=1e-3, rounds=1,
                              scheme="sfl", cut=3)
    assert [m.cuts for m in th] == [[3, 3, 3, 3]]
    assert_sims_agree(js, jh, ts, th, "int8")
