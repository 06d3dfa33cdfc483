"""Coordinated ADMM, both packages, CPU, f64: the coordinator's units.

* (a) ``ConsensusVariable``/``ExchangeVariable`` on trajectories drawn from
  a numpy seed, against the JAX package's classes: means, deviations,
  multipliers, residuals and the shift, within 1e-15;
* (b) ``_check_convergence`` and ``_vary_penalty`` of two coordinators
  started from the same state (the JAX package's carried over by
  ``utils.convert``) along seeded trails of replies: the same verdicts,
  residual norms and penalty sequence, within 1e-15 relative;
* (c) the wire messages: the port's JSON equals the JAX package's key for
  key, and each package's ``from_payload`` reads the other's;
* (d) ``tests/test_coordinator.py``'s de-registration telemetry (one
  warning per agent, re-admission) and the real-time ``terminate()``
  joining its thread, idempotently;
* (e) ``record_residuals``/``trim_residuals`` against the JAX package's on
  the same rounds, the stale tail of a longer round removed;
* (i) a participant set up again on a coordinator whose horizon and time
  step differ from its own, against the JAX package's.

Split from ``tests/test_torch_coordinator.py``, which runs the closed loop
these cases do not need.
"""

import json
import logging
import time

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.modules import coordinator as pc
from agentlib_mpc_torch.ops.admm import record_residuals, trim_residuals
from agentlib_mpc_torch.runtime.agent import Agent
from agentlib_mpc_torch.runtime.environment import Environment
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source
from agentlib_mpc_torch.utils.convert import (
    coordinator_state_from_jax,
    load_coordinator_state,
)
from agentlib_mpc_tpu import telemetry as jtelemetry
from agentlib_mpc_tpu.modules import coordinator as jc
from agentlib_mpc_tpu.ops.admm import record_residuals as jrecord
from agentlib_mpc_tpu.ops.admm import trim_residuals as jtrim
from agentlib_mpc_tpu.runtime.agent import Agent as JAgent
from agentlib_mpc_tpu.runtime.environment import Environment as JEnvironment
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS
from agentlib_mpc_tpu.runtime.variables import Source as JSource

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: loop parity per solve (m³/s, absolute) and per round (relative)
LOOP_TOL = 1e-6
#: host numpy on both sides: the same operations in the same order
STATE_TOL = 1e-15
SOLVER = {"kkt_method": "ldl"}
ROUTES = {"CooledRoom": "off", "Cooler": "on"}
SOURCES = [("Room_a", "admm"), ("Room_b", "admm"), ("AHU", "admm")]


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


# -- (f) the closed loop --------------------------------------------------------

# -- (d) the protocol -------------------------------------------------------------

def _bare(package, rt=False):
    """A coordinator of one package on an agent of its own, no MAS."""
    env_cls, agent_cls, mod = (
        (Environment, Agent, pc) if package == "port"
        else (JEnvironment, JAgent, jc))
    env = env_cls({"rt": rt, "factor": 1.0} if rt else {"rt": False})
    kwargs = {"device": "cpu"} if package == "port" else {}
    agent = agent_cls(env=env, config={"id": "Coord", "modules": []},
                      **kwargs)
    return mod.ADMMCoordinator(
        {"module_id": "coordinator", "type": "admm_coordinator",
         "time_step": 5.0, "prediction_horizon": 4,
         "abs_tol": 1e-4, "rel_tol": 1e-3,
         "penalty_change_threshold": 10.0}, agent)


def test_realtime_coordinator_terminate_joins_worker():
    coord = _bare("port", rt=True)
    gen = coord._realtime_process()
    next(gen)
    worker = coord._thread
    assert worker is not None and worker.is_alive()
    coord.terminate()
    deadline = time.time() + 5.0
    while time.time() < deadline and worker.is_alive():
        time.sleep(0.05)
    assert not worker.is_alive() and coord._thread is None
    coord.terminate()
    assert coord.rounds_run == 0 and coord.failed_rounds == 0


def test_deregistration_telemetry_and_readmission(caplog):
    telemetry.configure(enabled=True)
    coord = _bare("port")
    src = Source(agent_id="SlowRoom", module_id="admm")
    coord.agent_dict[src] = pc.AgentEntry(source=src,
                                          status=pc.AgentStatus.busy)
    before = telemetry.metrics().get(
        "coordinator_deregistrations_total", agent="SlowRoom") or 0.0
    with caplog.at_level(logging.DEBUG):
        coord._deregister_slow()
        coord.agent_dict[src].status = pc.AgentStatus.busy
        coord._deregister_slow()
    assert telemetry.metrics().get(
        "coordinator_deregistrations_total", agent="SlowRoom") == before + 2
    assert coord.agent_dict[src].missed_rounds == 2
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING
                and "de-registered slow agent" in r.message]
    assert len(warnings) == 1
    assert coord.agent_dict[src].status is pc.AgentStatus.standby
    coord.status = pc.CoordinatorStatus.init_iterations
    coord.init_iteration_callback(AgentVariable(
        name=pc.START_ITERATION_A2C, alias=pc.START_ITERATION_A2C,
        value=True, source=src))
    assert coord.agent_dict[src].status is pc.AgentStatus.ready


# -- (a) the coupling variables -----------------------------------------------------

def _pair_of_variables(kind, rng, n=8):
    """One variable of ``kind`` in each package with the same three
    participants' trajectories."""
    port = getattr(pc, kind)()
    ref = getattr(jc, kind)()
    trajs = [rng.standard_normal(n) for _ in SOURCES]
    for (a, m), traj in zip(SOURCES, trajs):
        port.add_participant(Source(agent_id=a, module_id=m), traj)
        ref.add_participant(JSource(agent_id=a, module_id=m), traj)
    return port, ref


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), rtol=0,
                               atol=STATE_TOL)


def test_consensus_variable_matches_jax():
    rng = np.random.default_rng(7)
    port, ref = _pair_of_variables("ConsensusVariable", rng)
    psrc = [Source(agent_id=a, module_id=m) for a, m in SOURCES]
    jsrc = [JSource(agent_id=a, module_id=m) for a, m in SOURCES]
    assert port.residuals(10.0, psrc) == ([], []) == ref.residuals(10.0,
                                                                   jsrc)
    for k in range(4):
        rho = float(rng.uniform(1.0, 20.0))
        active = slice(0, 3 - k % 2)     # the last participant drops out
        port.update_mean(psrc[active])
        ref.update_mean(jsrc[active])
        _close(port.mean_trajectory, ref.mean_trajectory)
        port.update_multipliers(rho, psrc[active])
        ref.update_multipliers(rho, jsrc[active])
        for p, j in zip(psrc, jsrc):
            _close(port.multipliers[p], ref.multipliers[j])
        for got, want in zip(port.residuals(rho, psrc[active]),
                             ref.residuals(rho, jsrc[active])):
            _close(got, want)
        _close(port.flat_locals(psrc), ref.flat_locals(jsrc))
        _close(port.flat_multipliers(psrc), ref.flat_multipliers(jsrc))
        port.shift(4)
        ref.shift(4)
        for p, j in zip(psrc, jsrc):
            _close(port.local_trajectories[p], ref.local_trajectories[j])
        _close(port.mean_trajectory, ref.mean_trajectory)
        for p, j in zip(psrc, jsrc):
            traj = rng.standard_normal(8)
            port.local_trajectories[p] = traj
            ref.local_trajectories[j] = traj


def test_exchange_variable_matches_jax():
    rng = np.random.default_rng(11)
    port, ref = _pair_of_variables("ExchangeVariable", rng)
    psrc = [Source(agent_id=a, module_id=m) for a, m in SOURCES]
    jsrc = [JSource(agent_id=a, module_id=m) for a, m in SOURCES]
    for k in range(4):
        rho = float(rng.uniform(1.0, 60.0))
        port.update_diffs(psrc)
        ref.update_diffs(jsrc)
        _close(port.mean_trajectory, ref.mean_trajectory)
        for p, j in zip(psrc, jsrc):
            _close(port.diff_trajectories[p], ref.diff_trajectories[j])
        port.update_multiplier(rho)
        ref.update_multiplier(rho)
        _close(port.multiplier, ref.multiplier)
        for got, want in zip(port.residuals(rho, psrc),
                             ref.residuals(rho, jsrc)):
            _close(got, want)
        port.shift(2)
        ref.shift(2)
        _close(port.multiplier, ref.multiplier)
        for p, j in zip(psrc, jsrc):
            _close(port.diff_trajectories[p], ref.diff_trajectories[j])
            traj = rng.standard_normal(8)
            port.local_trajectories[p] = traj
            ref.local_trajectories[j] = traj


# -- (b) convergence and penalty -------------------------------------------------

def test_convergence_and_penalty_match_jax():
    """Both coordinators, started from the same registered state, take the
    same seeded replies round after round: the same verdicts, residual
    norms and penalty sequence (the JAX package's state carried over by
    ``utils.convert``)."""
    rng = np.random.default_rng(3)
    ref = _bare("jax")
    for (a, m), kind in zip(SOURCES, ("c", "c", "x")):
        src = JSource(agent_id=a, module_id=m)
        entry = jc.AgentEntry(source=src, status=jc.AgentStatus.ready)
        ref.agent_dict[src] = entry
        if kind == "c":
            ref._coupling_variables.setdefault(
                "air", jc.ConsensusVariable()).add_participant(
                src, 0.02 + 0.01 * rng.standard_normal(4))
            entry.coup_vars.append("air")
        ref._exchange_variables.setdefault(
            "balance", jc.ExchangeVariable()).add_participant(
            src, 0.01 * rng.standard_normal(4))
        entry.exchange_vars.append("balance")
    port = _bare("port")
    load_coordinator_state(port, coordinator_state_from_jax(ref))
    for coord in (port, ref):
        coord._update_mean_coupling_variables()
        coord._shift_coupling_variables()
    verdicts, rhos = [], []
    for it in range(1, 13):
        # replies shrink toward agreement, with seeded bursts that move
        # the penalty both ways
        scale = 0.01 * 0.6 ** it * (30.0 if it in (4, 9) else 1.0)
        replies = {src: {alias: 0.02 + scale * rng.standard_normal(4)
                         for alias in ("air", "balance")}
                   for src in SOURCES}
        for coord, mod, src_cls in ((port, pc, Source), (ref, jc, JSource)):
            for (a, m), values in replies.items():
                src = src_cls(agent_id=a, module_id=m)
                entry = coord.agent_dict[src]
                for alias in entry.coup_vars:
                    coord._coupling_variables[alias].local_trajectories[
                        src] = values[alias]
                coord._exchange_variables["balance"].local_trajectories[
                    src] = values["balance"] - 0.02
            coord._update_mean_coupling_variables()
            coord._update_multipliers()
        got = port._check_convergence(it)
        want = ref._check_convergence(it)
        verdicts.append(got)
        rhos.append(port.penalty_parameter)
        assert got == want, it
        assert port.penalty_parameter == ref.penalty_parameter, it
        for key in ("primal_residual", "dual_residual"):
            assert port._stats_rows[-1][key] == pytest.approx(
                ref._stats_rows[-1][key], rel=STATE_TOL, abs=0), (it, key)
    assert len(set(rhos)) >= 3, rhos     # the trail moved the penalty


# -- (c) the wire messages ----------------------------------------------------------

def test_wire_messages_match_jax():
    rng = np.random.default_rng(5)
    traj = {"a": rng.standard_normal(3).tolist(),
            "b": rng.standard_normal(3).tolist()}
    a2c = dict(local_trajectory=traj,
               local_exchange_trajectory={"x": [0.5, -0.5]})
    c2a = dict(target="Room_1", mean_trajectory=traj,
               multiplier={"a": [1.0, 2.0, 3.0]},
               mean_diff_trajectory={"x": [0.1, 0.2]},
               exchange_multiplier={"x": [3.0, 4.0]},
               penalty_parameter=12.5)
    for cls, kwargs in (("AgentToCoordinator", a2c),
                        ("CoordinatorToAgent", c2a)):
        port = getattr(pc, cls)(**kwargs)
        ref = getattr(jc, cls)(**kwargs)
        assert port.to_json() == ref.to_json()
        assert list(json.loads(port.to_json())) == list(
            json.loads(ref.to_json()))
        assert getattr(pc, cls).from_payload(ref.to_json()) == port
        assert getattr(jc, cls).from_payload(port.to_json()) == ref
        assert getattr(pc, cls).from_payload(ref.to_payload()) == port
    assert [pc.REGISTRATION_C2A, pc.REGISTRATION_A2C,
            pc.START_ITERATION_C2A, pc.START_ITERATION_A2C,
            pc.OPTIMIZATION_C2A, pc.OPTIMIZATION_A2C] == [
        jc.REGISTRATION_C2A, jc.REGISTRATION_A2C, jc.START_ITERATION_C2A,
        jc.START_ITERATION_A2C, jc.OPTIMIZATION_C2A, jc.OPTIMIZATION_A2C]
    for enum in ("CoordinatorStatus", "AgentStatus"):
        assert [e.value for e in getattr(pc, enum)] == [
            e.value for e in getattr(jc, enum)]


# -- (e) the residual recorders ----------------------------------------------------

def test_residual_recorders_match_jax():
    """Rounds of 5, 2 and 3 iterations: both registries hold the same
    gauges and counter after each round, and a shorter round leaves no
    stale tail of the longer one before it."""
    rng = np.random.default_rng(9)
    port = telemetry.MetricsRegistry()
    ref = jtelemetry.MetricsRegistry()
    prev = 0
    for n in (5, 2, 3):
        for k in range(n):
            prim, dual = rng.uniform(0, 1, 2)
            record_residuals(prim, dual, iteration=k, registry=port,
                             agent="c")
            jrecord(prim, dual, iteration=k, registry=ref, agent="c")
        if prev > n:
            trim_residuals(n, prev, registry=port, agent="c")
            jtrim(n, prev, registry=ref, agent="c")
        prev = n
        for name in ("admm_primal_residual", "admm_dual_residual"):
            got = {k: port.get(name, iteration=str(k), agent="c")
                   for k in range(6)}
            want = {k: ref.get(name, iteration=str(k), agent="c")
                    for k in range(6)}
            assert got == want, (n, name)
            assert [k for k, v in got.items() if v is not None] == list(
                range(n))
        assert port.get("admm_iterations_total", agent="c") == ref.get(
            "admm_iterations_total", agent="c")
    port.gauge("admm_primal_residual").remove(iteration="0", agent="c")
    assert port.get("admm_primal_residual", iteration="0", agent="c") is None
    disabled = telemetry.MetricsRegistry(enabled=False)
    record_residuals(1.0, 2.0, iteration=0, registry=disabled)
    assert disabled.get("admm_iterations_total") is None


# -- (i) a participant set up again ------------------------------------------------

def _set_up_again(package):
    """The cooler under a coordinator whose horizon (4) and time step
    (600 s) differ from its own (8, 300 s), one round."""
    cfgs = pair_configs(jax_side=package == "jax")
    coordinator, cooler = cfgs[0], cfgs[2]
    coordinator["modules"][1].update(prediction_horizon=4, time_step=600.0,
                                     admm_iter_max=3)
    if package == "port":
        mas = LocalMAS([coordinator, cooler], env={"rt": False},
                       device="cpu", dtype=F64)
    else:
        mas = JLocalMAS([coordinator, cooler], env={"rt": False})
    mas.run(until=1.0)
    return mas.agents["Cooler"].get_module("admm")


def test_participant_set_up_again_on_the_coordinators_horizon():
    port, ref = _set_up_again("port"), _set_up_again("jax")
    assert (port.prediction_horizon, port.time_step) == (4, 600.0)
    assert port.backend.N == ref.backend.N == 4
    assert len(port.backend.coupling_grid) == len(ref.backend.coupling_grid)
    np.testing.assert_allclose(port.backend.coupling_grid,
                               np.asarray(ref.backend.coupling_grid))
    # the lone participant agrees with itself: a Boyd exit within the 3
    assert 1 <= len(port._iter_rows) == len(ref._iter_rows) <= 3
    for p, r in zip(port._iter_rows, ref._iter_rows):
        assert p["stats"]["iterations"] == r["stats"]["iterations"]
        np.testing.assert_allclose(p["couplings"]["mDot_out"],
                                   r["couplings"]["mDot_out"], rtol=0,
                                   atol=LOOP_TOL)
