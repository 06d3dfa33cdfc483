"""Coordinated ADMM on the module path, both packages, CPU, f64: the loop
and the protocol.

``tests/test_coordinator.py``'s agents
(``agentlib_mpc_torch/reference_configs.coordinator_pair_configs``): an
``admm_coordinator`` driving a room (``CooledRoom``, coupled on its input
``mDot``) and a cooler (``Cooler``, no states, coupled on its output
``mDot_out``), each an ``admm_coordinated`` participant over ``jax_admm``,
and the simulated room; the plain LDLᵀ in both packages.

* the closed loop to 900 s (3 rounds of 12 ADMM iterations): per solve
  the same interior-point iterations and couplings within 1e-6, per round
  the same iterations and the stats rows (primal, dual, rho) within 1e-6
  relative, the plants alike;
* the coordinator's state carried from the JAX package's coordinator into
  the port's (``utils.convert``);
* ``tests/test_coordinator.py``'s protocol tests on the port's classes
  over the loop: the registrations, a mid-run join, a slow agent
  de-registered with its counter, the non-blocking wait and the abort on
  stop.

The unit cases (the coupling variables, convergence and penalty, the wire
messages, the residual recorders, the real-time ``terminate()``, the
de-registration telemetry and a participant set up again) are in
``tests/test_torch_coordinator_units.py``.

The JAX side of the loop forces the routing its certificate proves (room
"off", cooler "on"): "auto" would spend its sampled probe on it; the port
routes on its own certificate and must reach the same verdicts.
"""

import logging
import time

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.modules import coordinator as pc
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source
from agentlib_mpc_torch.utils.convert import coordinator_state_from_jax
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: the closed loop: three rounds
UNTIL = 900.0
#: loop parity per solve (m³/s, absolute) and per round (relative)
LOOP_TOL = 1e-6
SOLVER = {"kkt_method": "ldl"}
ROUTES = {"CooledRoom": "off", "Cooler": "on"}
PARTICIPANTS = ("CooledRoom", "Cooler")


def pair_configs(jax_side=False, solver=SOLVER):
    cfgs = rc.coordinator_pair_configs(solver=solver)
    if jax_side:
        for agent in cfgs:
            for module in agent["modules"]:
                if "optimization_backend" in module:
                    module["optimization_backend"]["solver"][
                        "qp_fast_path"] = ROUTES[agent["id"]]
    return cfgs


def _named(obj):
    """A config with every model class replaced by its name."""
    if isinstance(obj, dict):
        return {k: _named(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_named(v) for v in obj]
    return obj.__name__ if isinstance(obj, type) else obj


def test_configs_are_the_sources():
    import test_coordinator as tc
    from examples.admm_4rooms_coordinator import agent_configs as coord4
    from examples.exchange_admm_4rooms import agent_configs as exchange4

    assert rc.coordinator_pair_configs() == _named(
        [tc.COORDINATOR, tc.ROOM, tc.COOLER, tc.SIM])
    assert rc.admm_4rooms_coordinator_configs() == _named(coord4())
    assert rc.exchange_admm_4rooms_configs() == _named(exchange4())


@pytest.fixture(scope="module")
def loops():
    port = LocalMAS(pair_configs(), env={"rt": False}, device="cpu",
                    dtype=F64)
    port.run(until=UNTIL)
    ref = JLocalMAS(pair_configs(jax_side=True), env={"rt": False})
    ref.run(until=UNTIL)
    return {"port": port, "jax": ref}


def _coordinators(loops):
    return (loops["port"].agents["Coordinator"].get_module("coordinator"),
            loops["jax"].agents["Coordinator"].get_module("coordinator"))


# -- (f) the closed loop --------------------------------------------------------

@pytest.mark.parametrize("agent", PARTICIPANTS)
def test_coordinated_loop_matches_jax_per_solve(loops, agent):
    pm = loops["port"].agents[agent].get_module("admm")
    jm = loops["jax"].agents[agent].get_module("admm")
    assert pm.backend.uses_qp_fast_path == (ROUTES[agent] == "on")
    ps, js = pm.backend.stats_history, jm.backend.stats_history
    assert len(ps) == len(js) == 36
    for p, r in zip(ps, js):
        assert p["time"] == pytest.approx(float(r["time"]), abs=1e-9)
        for key in ("iterations", "success", "kkt_path"):
            assert p[key] == r[key], (agent, r["time"], key)
    assert len(pm._iter_rows) == len(jm._iter_rows) == 36
    for p, r in zip(pm._iter_rows, jm._iter_rows):
        assert p["iteration"] == r["iteration"]
        for name, value in r["couplings"].items():
            np.testing.assert_allclose(p["couplings"][name], value, rtol=0,
                                       atol=LOOP_TOL, err_msg=name)


def test_coordinated_loop_matches_jax_per_round(loops):
    port, ref = (c.results() for c in _coordinators(loops))
    assert list(port.index) == list(ref.index)
    rounds = port.groupby(level="time").size().tolist()
    assert rounds == ref.groupby(level="time").size().tolist() == [12] * 3
    for col in ("primal_residual", "dual_residual", "penalty_parameter"):
        np.testing.assert_allclose(port[col].to_numpy(),
                                   ref[col].to_numpy(), rtol=LOOP_TOL,
                                   atol=0, err_msg=col)
    prim = port.loc[port.index.get_level_values("time")[0]][
        "primal_residual"].to_numpy()
    assert prim[-1] < prim[0]


def test_coordinated_loop_plant_matches_jax(loops):
    rows = [m.agents["Simulation"].get_module("simulator")._rows
            for m in (loops["port"], loops["jax"])]
    assert len(rows[0]) == len(rows[1]) == 15
    for key in ("T_out", "mDot"):
        np.testing.assert_allclose([r[key] for r in rows[0]],
                                   [float(r[key]) for r in rows[1]],
                                   rtol=0, atol=LOOP_TOL, err_msg=key)
    assert rows[0][0]["T_out"] > rows[0][-1]["T_out"]


def test_coordinator_state_carries_across(loops):
    """The JAX package's coordinator state, through ``utils.convert``,
    equals the port's at the loop's end (the per-round parity above, in
    the coordinator's own state)."""
    port, ref = _coordinators(loops)
    got = coordinator_state_from_jax(port)
    want = coordinator_state_from_jax(ref)
    assert got["agents"] == want["agents"]
    assert got["penalty_parameter"] == want["penalty_parameter"]
    for alias, data in want["consensus"].items():
        for key in ("local", "multipliers"):
            assert data[key].keys() == got["consensus"][alias][key].keys()
            for src, value in data[key].items():
                np.testing.assert_allclose(got["consensus"][alias][key][src],
                                           value, rtol=0, atol=LOOP_TOL)


# -- (d) the protocol -------------------------------------------------------------

def test_registration(loops):
    port, ref = _coordinators(loops)
    assert len(port.agent_dict) == len(ref.agent_dict) == 2
    assert all(e.status in (pc.AgentStatus.standby, pc.AgentStatus.ready)
               for e in port.agent_dict.values())
    assert list(port._coupling_variables) == ["mDotCoolAir"]
    trajs = list(port._coupling_variables["mDotCoolAir"]
                 .local_trajectories.values())
    assert len(trajs) == 2 and np.max(np.abs(trajs[0] - trajs[1])) < 5e-3


def test_midrun_join_new_agent_handshake(loops):
    coord, _ = _coordinators(loops)
    src = Source(agent_id="LateZone", module_id="admm")
    n_before = len(coord.agent_dict)
    coord.registration_callback(AgentVariable(
        name="admm_register_a2c", alias="admm_register_a2c", value=None,
        source=src))
    try:
        assert len(coord.agent_dict) == n_before + 1
        assert coord.agent_dict[src].status is pc.AgentStatus.pending
        coord.registration_callback(AgentVariable(
            name="admm_register_a2c", alias="admm_register_a2c",
            value={"local_trajectory": {"mDotCoolAir": [0.02] * 8},
                   "local_exchange_trajectory": {}}, source=src))
        assert coord.agent_dict[src].status is pc.AgentStatus.standby
        var = coord._coupling_variables["mDotCoolAir"]
        assert src in var.local_trajectories
        np.testing.assert_array_equal(var.multipliers[src], np.zeros(8))
    finally:
        coord.agent_dict.pop(src, None)
        var = coord._coupling_variables["mDotCoolAir"]
        var.local_trajectories.pop(src, None)
        var.multipliers.pop(src, None)


def test_deregister_slow_agent_midround(loops, caplog):
    coord, _ = _coordinators(loops)
    entry = next(iter(coord.agent_dict.values()))
    old_status = entry.status
    entry.status = pc.AgentStatus.busy
    try:
        with caplog.at_level(logging.INFO):
            coord._deregister_slow()
        assert entry.status is pc.AgentStatus.standby
        assert any("de-registered slow agent" in r.message
                   for r in caplog.records)
    finally:
        entry.status = old_status


def test_wait_for_ready_nonblocking_degrades(loops):
    coord, _ = _coordinators(loops)
    entry = next(iter(coord.agent_dict.values()))
    old_status = entry.status
    entry.status = pc.AgentStatus.busy
    try:
        coord._wait_for_ready(block=False)
        assert entry.status is pc.AgentStatus.standby
    finally:
        entry.status = old_status


def test_wait_for_ready_aborts_on_stop(loops):
    coord, _ = _coordinators(loops)
    entry = next(iter(coord.agent_dict.values()))
    old_status = entry.status
    entry.status = pc.AgentStatus.busy
    coord._stop.set()
    try:
        t0 = time.time()
        coord._wait_for_ready(block=True)
        assert time.time() - t0 < coord.time_out_non_responders
        assert entry.status is pc.AgentStatus.busy
    finally:
        coord._stop.clear()
        entry.status = old_status


# -- (a) the coupling variables -----------------------------------------------------

# -- (b) convergence and penalty -------------------------------------------------

# -- (c) the wire messages ----------------------------------------------------------

# -- (e) the residual recorders ----------------------------------------------------

# -- (i) a participant set up again ------------------------------------------------
