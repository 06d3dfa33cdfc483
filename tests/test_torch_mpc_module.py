"""The module path through both packages on the CPU in float64.

One MPC agent on ``LocalMAS`` — the ``mpc`` module over the ``jax``
backend, the ``simulator`` plant, the actuation guard and the
``fallback_pid`` — built from the same config dicts in both packages (the
models named by their zoo names, ``kkt_method="ldl"``: the plain LDLᵀ
versions in both) and run in closed loop:

* the two-agent one-room MAS of ``tests/test_mas_one_room.py`` at N=6,
  guarded as ``tests/test_resilience.py``'s controller (guard budget,
  ``fallback_pid``, the plant every 50 s), for 2 100 s with a scripted
  failure window (``backend.solve`` reports ``success=False`` on solves
  3–6), one run per package shared by the tests below: per-step
  trajectories (u0 among them) within 1e-8 relative, equal iteration
  counts, the simulator's rows within 1e-8, identical guard decisions,
  flag flips and FallbackPID hand-over times;
* the linear-QP agent of ``examples/linear_qp_mpc.py`` at N=3 for 900 s:
  the port's certificate routes it to the QP fast path (the JAX
  package's routing of this model is held by ``tests/test_qp.py``; here
  it is forced, which skips its 19 s sampled probe), and u0 within 1e-8;
* the port alone: a checkpointed controller resumes bitwise, a JAX warm
  state carried over by ``warm_state_from_jax`` gives the JAX package's
  next solve, every type of a later slice raises ``NotImplementedError``
  naming its ROADMAP item, and the closed loop in float32 keeps the
  float64 loop's comfort error (AIE) and cooling energy within 1 % over
  the first 900 s of the guarded loop.

The one-room configs set ``qp_fast_path`` "off" in both packages: the
nonlinear model never takes the QP path, and "auto" would spend the JAX
package's sampled LQ probe on proving it.
"""

import copy

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs
from agentlib_mpc_torch.backends.backend import (
    DEFERRED_BACKEND_TYPES,
    create_backend,
)
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.runtime.module import DEFERRED_MODULE_TYPES
from agentlib_mpc_torch.utils.convert import warm_state_from_jax
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-8
UB = 295.15
N = 6
#: the guarded one-room loop: its length, the plant's step, and the solves
#: (numbered from 1) that report failure
UNTIL, PLANT_DT, FAILED_SOLVES = 2100.0, 50, (3, 4, 5, 6)
#: the linear-QP parity's horizon and length, and the float32 loop's
LINEAR_QP_N, SHORT_UNTIL = 3, 900.0
#: float32 against float64 closed loop, relative (the JAX package's f32
#: and f64 one-room loops agree to 0.4 %, BASELINE.md)
F32_METRIC_RTOL = 0.01


def one_room_configs(horizon=N):
    """The MAS of tests/test_mas_one_room.py (the model named by its zoo
    name) with the plain LDLᵀ and no QP routing."""
    return reference_configs.one_room_configs(
        horizon, {"kkt_method": "ldl", "qp_fast_path": "off"})


def linear_qp_config(qp_fast_path="auto"):
    """examples/linear_qp_mpc.py's agent with the plain LDLᵀ at N=3."""
    cfg = reference_configs.linear_qp_config(
        {"kkt_method": "ldl", "qp_fast_path": qp_fast_path})
    cfg["modules"][1]["prediction_horizon"] = LINEAR_QP_N
    return cfg


def test_configs_are_the_tests_and_the_examples():
    """The port's reference configs are tests/test_mas_one_room.py's MAS
    and examples/linear_qp_mpc.py's agent, model classes named by their
    zoo names."""
    import test_mas_one_room as ref
    from examples.linear_qp_mpc import agent_config

    mpc, sim = copy.deepcopy((ref.AGENT_MPC, ref.AGENT_SIM))
    for module in (mpc["modules"][1]["optimization_backend"],
                   sim["modules"][1]):
        assert module["model"]["class"].__name__ == "OneRoom"
        module["model"]["class"] = "OneRoom"
    assert reference_configs.one_room_configs() == [mpc, sim]
    assert reference_configs.linear_qp_config() == agent_config()


def guarded_configs():
    """tests/test_resilience.py's controller (guard budget replay 1 +
    hold 1, recovery 2, FallbackPID) and plant, N=6."""
    ctrl, plant = copy.deepcopy(one_room_configs())
    ctrl["id"], plant["id"] = "ctrl", "plant"
    mpc = ctrl["modules"][1]
    mpc["module_id"] = "mpc"
    mpc["enable_deactivation"] = True
    mpc["resilience"] = {"replay_steps": 1, "hold_steps": 1,
                         "recovery_steps": 2}
    mpc["states"][0]["source"] = "plant"
    plant["modules"][1]["t_sample"] = PLANT_DT
    plant["modules"][1]["outputs"][0]["value"] = 298.16
    ctrl["modules"].append({
        "module_id": "pid", "type": "fallback_pid",
        "input": {"name": "T", "alias": "T", "source": "plant"},
        "output": {"name": "mDot_pid", "alias": "mDot"},
        "setpoint": UB, "Kp": 0.005, "reverse_acting": True,
        "lb": 0.0, "ub": 0.05})
    return [ctrl, plant]


def run_port(cfgs, until, dtype=F64):
    mas = LocalMAS(copy.deepcopy(cfgs), env={"rt": False}, device="cpu",
                   dtype=dtype)
    mas.run(until=until)
    return mas


def run_jax(cfgs, until):
    mas = JLocalMAS(copy.deepcopy(cfgs), env={"rt": False})
    mas.run(until=until)
    return mas


def trace(mas, agent, mpc, sim_agent, sim):
    """What a closed loop did: per solve its time, stats and trajectories,
    and the simulator's rows (copied: later tests may drive the MAS on)."""
    m = mas.agents[agent].get_module(mpc)
    return {"solves": [dict(r) for r in m.backend.stats_history],
            "history": [(row["time"],
                         {k: np.array(v) for k, v in row["traj"].items()})
                        for row in m._history_rows],
            "sim_rows": [dict(r) for r in
                         mas.agents[sim_agent].get_module(sim)._rows],
            "module": m}


def close(port, ref, what):
    port, ref = np.asarray(port, dtype=float), np.asarray(ref, dtype=float)
    np.testing.assert_allclose(
        port, ref, rtol=RTOL,
        atol=RTOL * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
        err_msg=what)


def assert_loops_match(port, ref, whole_trajectories=True):
    assert len(port["solves"]) == len(ref["solves"]) > 0
    for p, r in zip(port["solves"], ref["solves"]):
        assert p["time"] == r["time"]
        for key in ("iterations", "success", "kkt_path", "jac_path"):
            assert p[key] == r[key], (r["time"], key)
        close(p["objective"], r["objective"], f"objective t={r['time']}")
    assert [t for t, _ in port["history"]] == [t for t, _ in ref["history"]]
    for (t, p), (_, r) in zip(port["history"], ref["history"]):
        assert set(p) == set(r)
        close(p["u"][0], r["u"][0], f"u0 at t={t}")
        if whole_trajectories:
            for key in ("x", "u", "z", "y"):
                close(p[key], r[key], f"traj {key} at t={t}")
    assert len(port["sim_rows"]) == len(ref["sim_rows"]) > 0
    for p, r in zip(port["sim_rows"], ref["sim_rows"]):
        assert set(p) == set(r)
        for key in r:
            close(p[key], r[key], f"simulator {key} at t={r['time']}")


def closed_loop_metrics(sim_rows, dt):
    """AIE (K·h) and cooling energy of the one-room example's printout
    (examples/one_room_mpc.py) from the simulator's rows."""
    temps = np.array([r["T_out"] for r in sim_rows])
    mdot = np.array([r["mDot"] for r in sim_rows])
    return (float(np.sum(np.abs(temps - UB)) * dt / 3600.0),
            float(np.sum(mdot * (temps - 290.15)) * dt / 3600.0))


def _register_listener(register_module, base):
    @register_module("_test_guard_listener")
    class Listener(base):
        """Records, inside the controller's agent, the flag flips and
        every mDot command with its sender."""

        def register_callbacks(self):
            self.flags, self.mdot = [], []
            self.agent.data_broker.register_callback(
                "mpc_active", None,
                lambda v: self.flags.append((v.timestamp, v.value)))
            self.agent.data_broker.register_callback(
                "mDot", None,
                lambda v: self.mdot.append((v.timestamp, v.value,
                                            v.source.module_id)))


def _failure_window_run(mas_cls, until, dtype=F64, calls=FAILED_SOLVES):
    """The guarded controller and its plant for ``until`` seconds, with
    ``backend.solve`` reporting ``success=False`` on the solves numbered
    ``calls`` (from 1); the guard's decisions, the flag flips and every
    mDot command are recorded."""
    cfgs = guarded_configs()
    cfgs[0]["modules"].append({"module_id": "listen",
                               "type": "_test_guard_listener"})
    kwargs = ({"device": "cpu", "dtype": dtype} if mas_cls is LocalMAS
              else {})
    mas = mas_cls(cfgs, env={"rt": False}, **kwargs)
    module = mas.agents["ctrl"].get_module("mpc")
    solve, assess = module.backend.solve, module.guard.assess
    decisions, count = [], [0]

    def scripted_solve(now, variables):
        result = solve(now, variables)
        count[0] += 1
        if count[0] in calls:
            result = dict(result, stats=dict(result["stats"],
                                             success=False))
        return result

    def recorded_assess(*args, **kwargs):
        d = assess(*args, **kwargs)
        decisions.append((module.env.now, d.action, d.healthy, d.reasons,
                          d.entered_fallback, d.reengaged,
                          module.guard.level))
        return d

    module.backend.solve = scripted_solve
    module.guard.assess = recorded_assess
    mas.run(until=until)
    listen = mas.agents["ctrl"].get_module("listen")
    return {"mas": mas, "decisions": decisions, "flags": listen.flags,
            "mdot": listen.mdot, "level": module.guard.level,
            **trace(mas, "ctrl", "mpc", "plant", "room")}


@pytest.fixture(scope="module")
def one_room():
    """The guarded one-room loop in both packages, once for every test that
    reads it."""
    from agentlib_mpc_torch.runtime.module import BaseModule
    from agentlib_mpc_torch.runtime.module import register_module
    from agentlib_mpc_tpu.runtime.module import BaseModule as JBaseModule
    from agentlib_mpc_tpu.runtime.module import (
        register_module as jregister_module,
    )

    _register_listener(register_module, BaseModule)
    _register_listener(jregister_module, JBaseModule)
    return {"port": _failure_window_run(LocalMAS, UNTIL),
            "jax": _failure_window_run(JLocalMAS, UNTIL)}


def test_one_room_matches_jax_step_by_step(one_room):
    assert_loops_match(one_room["port"], one_room["jax"])
    assert all(r["success"] for r in one_room["port"]["solves"])
    assert all(r["kkt_path"] == "ldl" for r in one_room["port"]["solves"])
    # the loop is closed: the room cools, the actuation moves
    rows = one_room["port"]["sim_rows"]
    assert rows[-1]["T_out"] < rows[0]["T_out"]
    assert np.std([r["mDot"] for r in rows]) > 0


def test_linear_qp_agent_matches_jax():
    """The port's certificate routes the agent to the QP fast path; u0,
    iterations and the plant within 1e-8 at every step. The tail of the
    predicted trajectory is compared by nothing: the LQ optimum is flat
    there (r_Q = 1e-3 against the comfort slack), and the warm start
    carries each solve's round-off into the next, so the two packages'
    last predicted controls part by watts-scale 1e-4 within a few solves,
    while u0 stays at 500 W within 2e-7 W."""
    port = run_port([linear_qp_config()], SHORT_UNTIL)
    ref = run_jax([linear_qp_config("on")], SHORT_UNTIL)
    pm = port.agents["LinearZone"].get_module("mpc")
    jm = ref.agents["LinearZone"].get_module("mpc")
    assert pm.backend.uses_qp_fast_path is True
    assert jm.backend.uses_qp_fast_path is True
    assert_loops_match(trace(port, "LinearZone", "mpc", "LinearZone", "sim"),
                       trace(ref, "LinearZone", "mpc", "LinearZone", "sim"),
                       whole_trajectories=False)


def test_guard_failure_window_matches_jax(one_room):
    port, ref = one_room["port"], one_room["jax"]
    # solve 3 (t=600) replays, 4 holds, 5 hands over to the FallbackPID
    # (t=1200), 6 stays there; healthy probes at 1800 and 2100 re-engage
    assert [d[1] for d in port["decisions"]] == [
        "actuate", "actuate", "replay", "hold", "fallback", "fallback",
        "fallback", "actuate"]
    assert port["decisions"] == ref["decisions"]
    assert port["flags"] == ref["flags"] == [(1200.0, False),
                                             (2100.0, True)]
    assert port["level"] == ref["level"] == 0
    assert [(t, src) for t, _, src in port["mdot"]] == \
        [(t, src) for t, _, src in ref["mdot"]]
    close([v for _, v, _ in port["mdot"]], [v for _, v, _ in ref["mdot"]],
          "mDot commands")
    pid = [t for t, _, src in port["mdot"] if src == "pid"]
    assert pid and 1200.0 <= min(pid) and max(pid) <= 2100.0


def test_checkpointed_controller_resumes_bitwise(one_room, tmp_path):
    module = one_room["port"]["module"]
    path = str(tmp_path / "ctrl")
    module.save_checkpoint(path)
    cfgs = guarded_configs()
    cfgs[0]["modules"][1]["checkpoint_path"] = path
    fresh = LocalMAS(cfgs, env={"rt": False}, device="cpu", dtype=F64)
    resumed = fresh.agents["ctrl"].get_module("mpc")
    for key, value in module.backend.warm_state().items():
        restored = resumed.backend.warm_state()[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(restored, value), key
        else:
            assert restored == value is False, key
    variables = module.collect_variables_for_optimization()
    now = float(module.env.now) + 300.0
    a = module.backend.solve(now, variables)
    b = resumed.backend.solve(now, variables)
    assert a["u0"] == b["u0"]
    for key in a["traj"]:
        assert np.array_equal(a["traj"][key], b["traj"][key]), key
    assert a["stats"]["iterations"] == b["stats"]["iterations"]


def test_warm_state_from_jax_gives_the_same_next_solve(one_room):
    jm = one_room["jax"]["module"]
    pm = one_room["port"]["module"]
    warm = {k: (v if k == "cold" else np.asarray(v))
            for k, v in jm.backend.warm_state().items()}
    pm.backend.set_warm_state(warm_state_from_jax(warm, "cpu", F64))
    variables = jm.collect_variables_for_optimization()
    now = float(jm.env.now) + 300.0
    ref = jm.backend.solve(now, variables)
    out = pm.backend.solve(now, variables)
    assert out["stats"]["iterations"] == ref["stats"]["iterations"]
    close(out["u0"]["mDot"], ref["u0"]["mDot"], "u0")
    for key in ("x", "u"):
        close(out["traj"][key], ref["traj"][key], f"traj {key}")


#: the types the ML slice brought, deferred until it (ROADMAP item 3)
ML_MODULE_TYPES = ("ann_trainer", "gpr_trainer", "keras_ann_trainer",
                   "linreg_trainer", "ml_simulator")
ML_BACKEND_TYPES = ("casadi_admm_ml", "casadi_ml", "casadi_nn",
                    "jax_admm_ml", "jax_ml")


@pytest.mark.parametrize("type_name", ML_MODULE_TYPES)
def test_deferred_module_types_name_their_item(type_name):
    """No module type is deferred any more: the ML slice's resolve to the
    port's modules, as the JAX package's names do."""
    import agentlib_mpc_tpu.modules  # noqa: F401 - registers the types
    import agentlib_mpc_torch.modules  # noqa: F401 - registers the types
    from agentlib_mpc_tpu.runtime.module import MODULE_TYPES as JAX_TYPES
    from agentlib_mpc_torch.runtime.module import MODULE_TYPES

    assert not DEFERRED_MODULE_TYPES
    assert MODULE_TYPES[type_name].__name__ == JAX_TYPES[type_name].__name__
    assert MODULE_TYPES[type_name].__module__.startswith(
        "agentlib_mpc_torch.")


@pytest.mark.parametrize("type_name", ML_BACKEND_TYPES)
def test_deferred_backend_types_name_their_item(type_name):
    """No backend type is deferred any more: a config naming an ML type
    builds the port's ML backend."""
    from agentlib_mpc_torch.backends.ml_backend import (
        MLADMMBackend,
        MLBackend,
    )

    assert not DEFERRED_BACKEND_TYPES
    backend = create_backend({"type": type_name}, device="cpu")
    assert type(backend) is (MLADMMBackend if "admm" in type_name
                             else MLBackend)


def test_unknown_types_stay_key_errors():
    with pytest.raises(KeyError, match="unknown module type"):
        LocalMAS([{"id": "a", "modules": [{"type": "no_such_module"}]}],
                 device="cpu")
    with pytest.raises(KeyError, match="unknown backend type"):
        create_backend({"type": "no_such_backend"}, device="cpu")


def test_deferred_backend_features_name_their_item(one_room):
    from agentlib_mpc_torch.backends.mpc_backend import (
        robust_scenario_controls,
        scenario_engine,
    )

    from agentlib_mpc_torch.scenario import ScenarioFleet, fan_tree

    backend = one_room["port"]["module"].backend
    # the serving slice brought the fingerprint: a memoized structural
    # fingerprint of the backend's transcribed problem
    fp = backend.problem_fingerprint()
    assert fp.digest and fp.n_w == backend.ocp.n_w
    assert backend.problem_fingerprint() is fp
    # the scenario helpers (item 4) came with the scenario-tree slice: one
    # cached engine per structure, device and dtype
    tree = fan_tree(2, robust_horizon=1)
    engine = scenario_engine(backend.ocp, tree, backend.solver_options,
                             device="cpu", dtype=torch.float64)
    assert isinstance(engine, ScenarioFleet)
    assert engine.device == torch.device("cpu")
    assert scenario_engine(backend.ocp, tree, backend.solver_options,
                           device="cpu", dtype=torch.float64) is engine
    assert scenario_engine(backend.ocp, tree, backend.solver_options,
                           device="cpu", dtype=torch.float32) is not engine
    assert callable(robust_scenario_controls)


def test_float32_loop_keeps_the_float64_metrics(one_room):
    f32 = _failure_window_run(LocalMAS, SHORT_UNTIL, dtype=torch.float32)
    rows32 = f32["sim_rows"]
    rows64 = one_room["port"]["sim_rows"][:len(rows32)]
    assert [r["time"] for r in rows64] == [r["time"] for r in rows32]
    assert [d[1] for d in f32["decisions"]] == \
        [d[1] for d in one_room["port"]["decisions"]][:len(f32["decisions"])]
    aie32, energy32 = closed_loop_metrics(rows32, PLANT_DT)
    aie64, energy64 = closed_loop_metrics(rows64, PLANT_DT)
    stats = f32["module"].backend
    assert all(r["success"] for r in stats.stats_history)
    assert stats.warm_start_resets == 0
    assert abs(aie32 - aie64) <= F32_METRIC_RTOL * aie64
    assert abs(energy32 - energy64) <= F32_METRIC_RTOL * energy64


@pytest.mark.cuda
def test_module_path_on_the_card():
    """The one-room MAS at N=15 on the card for 900 s: every solve on the
    LDLᵀ kernels at (1, 137), one factor and three solves per
    interior-point iteration, every solve successful."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    from agentlib_mpc_torch.ops import kkt

    mas = LocalMAS(reference_configs.one_room_configs(), env={"rt": False})
    module = mas.agents["myMPCAgent"].get_module("myMPC")
    kkt.reset_launch_counts()
    mas.run(until=900.0)
    stats = module.backend.stats_history
    iterations = sum(r["iterations"] for r in stats)
    assert all(r["success"] and r["kkt_path"] == "ldl" for r in stats)
    assert kkt.ldl_factor.launches == iterations
    assert kkt.ldl_solve.launches == 3 * iterations
    assert kkt.ldl_factor.shapes == kkt.ldl_solve.shapes == {(1, 137)}
