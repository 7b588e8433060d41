"""The city lattice of the port (``repro_torch.core.scenario.CityGrid``,
scenario ``city``) on the CPU against the reference's
``repro.core.scenario.city``.

* The fleet state: every field bit for bit over several times and seeds,
  Zipf and uniform home cells, a fleet handed in, and the same
  ``ValueError`` on an unknown ``load_skew``.
* The reference's own checks of the fixture (tests/test_scenario.py):
  Zipf skew and coverage gaps, the O(n) lattice association against a
  brute-force nearest RSU, residence and rates consistent with coverage.
* The port's ScenarioEngine on a 64-vehicle 2 x 2 city (the lattice of
  tests/test_fleet_sharding.py) against the reference's, round by round
  from the reference's state (tests/_torch_planes.py): the ``parallel``
  schedule on the ``ragged`` layout, the ``sequential`` schedule, and
  mobility presence churn.  Cuts, loads, counts and bytes equal; losses,
  parameters and residuals within 1e-5.  Slot paging on the city is in
  tests/test_torch_paging.py.
"""
import numpy as np
import pytest

import _torch_planes as H
from _torch_parity import assert_fleet_states_equal, cap_torch_threads
from repro.core import channel as JCh
from repro.core import scenario as JS
from repro_torch.core import channel as TCh
from repro_torch.core import scenario as TS

cap_torch_threads()


@pytest.mark.parametrize("seed,skew", [(1, "zipf"), (7, None),
                                       (4096, "zipf")])
def test_city_fleet_state_equals_the_reference(seed, skew):
    kw = dict(grid_x=3, grid_y=5, load_skew=skew)
    ref, port = JS.city(300, seed=seed, **kw), TS.city(300, seed=seed, **kw)
    assert port.n_rsus == ref.n_rsus == 15
    np.testing.assert_array_equal(port.rsu_positions, ref.rsu_positions)
    assert port.fleet_arrays.keys() == ref.fleet_arrays.keys()
    for k, v in ref.fleet_arrays.items():
        np.testing.assert_array_equal(port.fleet_arrays[k], v)
    for t in (0.0, 5.0, 17.0, 123.0, 3600.0):
        for s in (0, 3):
            assert_fleet_states_equal(ref.fleet_state(t, s),
                                      port.fleet_state(t, s))


def test_city_takes_a_fleet_and_refuses_an_unknown_skew():
    arrays = TCh.fleet_arrays(TCh.make_fleet(40, 5))
    for fleet in (arrays, None):
        ref = JS.make_scenario("city", 40, seed=5, grid_x=2, grid_y=2,
                               fleet=(JCh.make_fleet(40, 5) if fleet is None
                                      else arrays))
        port = TS.make_scenario("city", 40, seed=5, grid_x=2, grid_y=2,
                                fleet=(TCh.make_fleet(40, 5) if fleet is None
                                       else arrays))
        for k, v in ref.fleet_arrays.items():
            np.testing.assert_array_equal(port.fleet_arrays[k], v)
        assert_fleet_states_equal(ref.fleet_state(30.0, 2),
                                  port.fleet_state(30.0, 2))
    for mod in (JS, TS):
        with pytest.raises(ValueError, match="unknown load_skew 'bogus'"):
            mod.city(8, seed=0, grid_x=2, grid_y=2, load_skew="bogus")
    assert TS.NOT_PORTED == () and "city" in TS.SCENARIOS


# ---------------------------------- the reference's checks of the fixture
def test_city_zipf_skew_and_coverage_gaps():
    sc = TS.city(512, seed=1, grid_x=4, grid_y=4)
    assert sc.n_rsus == 16 and sc.rsu_positions.shape == (16, 2)
    st = sc.fleet_state(0.0, seed=0)
    assert st.serving_rsu.min() >= -1 and st.serving_rsu.max() < 16
    # the pitch (900 m) exceeds twice the coverage (400 m): gaps, but the
    # orbits keep most of the fleet covered
    assert 0.5 < float(st.active.mean()) < 0.98
    counts = np.bincount(st.serving_rsu[st.active], minlength=16)
    assert counts.max() > 3 * max(np.median(counts), 1)
    # the orbits breathe across the coverage edge
    assert (st.active != sc.fleet_state(30.0, seed=0).active).sum() > 0


def test_city_lattice_association_matches_brute_force():
    sc = TS.city(256, seed=3, grid_x=3, grid_y=5)
    for t in (0.0, 17.0, 123.0):
        st = sc.fleet_state(t, seed=0)
        ref, _ = TS.nearest_rsu(st.positions, sc.rsu_positions,
                                sc.ch.rsu_range_m)
        np.testing.assert_array_equal(st.serving_rsu, ref)


def test_city_residence_and_rates_consistent():
    sc = TS.city(128, seed=2, grid_x=2, grid_y=2)
    st = sc.fleet_state(5.0, seed=0)
    assert (st.rates_bps[st.active] > 0).all()
    assert (st.rates_bps[~st.active] == 0).all()
    assert (st.residence_s[st.active] > 0).all()
    assert (st.residence_s[~st.active] == 0).all()
    flat = TS.city(128, seed=2, grid_x=2, grid_y=2, load_skew=None)
    st_f = flat.fleet_state(5.0, seed=0)
    assert len(np.unique(st_f.serving_rsu[st_f.active])) == 4


# ------------------------------------------------------- engine parity
ENGINES = [("parallel", "none", {}),
           ("sequential", "none", {"stream_churn_source": "mobility"}),
           ("parallel", "topk_int8", {"stream_churn_source": "mobility"})]


@pytest.mark.parametrize("schedule,wire,extra", ENGINES,
                         ids=["parallel-none", "sequential-mobility",
                              "parallel-topk_int8-mobility"])
def test_city_engine_matches_reference(schedule, wire, extra):
    je, te = H.build("city", wire=wire, schedule=schedule, **extra)
    hist = H.rounds_match(je, te)
    assert te.n_rsus == 4 and len(hist[0].cuts) == H.CITY_N
    # several cells and cuts a round, and the fleet moves between them
    assert min(sum(c > 0 for c in m.rsu_loads) for m in hist) >= 3
    assert min(len(set(m.cuts) - {0}) for m in hist) >= 2
    if extra:     # mobility churn: departures and (a round late) arrivals
        assert sum(m.n_arrived for m in hist) > 0
        assert len({m.n_present for m in hist}) > 1
