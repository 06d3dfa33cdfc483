"""Moving-horizon estimation through both packages on the CPU in float64.

* ``make_mhe_model``: the estimation model the port derives from
  ``tests/test_mhe.py``'s ``RoomWithLoadParam`` and from
  ``examples/mhe_one_room.py``'s ``RoomLoadParam`` has the JAX package's
  structure (names, roles, free and differential states, constraint count,
  ``objective_term_names``);
* ``examples/mhe_one_room.py``'s two agents (an ``mhe`` module beside an
  ``mpc`` that consumes its load estimate, and the plant) in closed loop
  for 480 s in both packages (``agentlib_mpc_torch/reference_configs.py``,
  the plain LDLᵀ in both): per solve the MHE's estimates and iterations,
  the MPC's u0, objective and iterations, and the plant's rows within 1e-8
  relative;
* ``MHEBackend``: a cold and then a warm solve from the same measurement
  history give the JAX package's estimated trajectories and parameters
  within 1e-6, and the routing verdicts (``uses_qp_fast_path``) of the
  port's certificate are the JAX package's certificate's;
* the example's MPC in float32 (the module path's default type) from a
  state at its float32 precision floor (``tests/data/
  torch_mhe_mpc_f32_state.json``): the solve succeeds inside its budget,
  through the wedged-search escape (the JAX package's float32 solves
  every state of this loop; ``scripts/module_f32_witness.py``).

The JAX side forces the routing its certificate proves (the MHE OCP "on",
the example's MPC "off"): "auto" would spend its sampled LQ probe (about
20 s on this CPU) on confirming it. Its certifier runs through the shim of
``tests/test_torch_certify.py``.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.backends.mhe_backend import make_mhe_model
from agentlib_mpc_torch.ops import kkt
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.utils.convert import warm_state_from_jax
from agentlib_mpc_tpu.backends.mhe_backend import (
    make_mhe_model as jmake_mhe_model,
)
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: the closed loop: five MHE and MPC solves (every 120 s) and 9 plant steps
UNTIL = 480.0
#: loop parity, relative
RTOL = 1e-8
#: the MHE QP's objective, absolute: the QP path evaluates it as a
#: quadratic in the states (~300 K), whose terms cancel to ~1e-13 of their
#: ~1e5 size, so a near-zero tracking cost carries ~5e-8 of rounding in
#: either package (trajectories agree to 1e-10 K)
MHE_OBJECTIVE_ATOL = 1e-6
#: one MHE solve from the same history and warm state, absolute (K and W)
SOLVE_TOL = 1e-6
SOLVER = {"kkt_method": "ldl"}


def _jax_model_classes():
    from examples.mhe_one_room import RoomLoadParam
    from test_mhe import RoomWithLoadParam

    return {"RoomLoadParam": RoomLoadParam,
            "RoomWithLoadParam": RoomWithLoadParam}


def _named(obj):
    """A config with every model class replaced by its name."""
    if isinstance(obj, dict):
        return {k: _named(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_named(v) for v in obj]
    return obj.__name__ if isinstance(obj, type) else obj


def test_configs_are_the_example_and_the_test():
    """reference_configs holds examples/mhe_one_room.py's agents and
    tests/test_mhe.py's estimator and plant, with the port's model
    classes of the same names."""
    import test_mhe
    from examples.mhe_one_room import agent_configs

    assert _named(rc.mhe_one_room_configs()) == _named(agent_configs())
    assert _named(rc.mhe_estimator_configs()) == _named(
        [test_mhe.MHE_AGENT, test_mhe.PLANT])


@pytest.mark.parametrize("name, estimated, tracked", [
    ("RoomLoadParam", ["load"], ["T"]),
    ("RoomWithLoadParam", ["load"], ["T"]),
    ("RoomWithLoadParam", [], ["T", "T_slack"]),
])
def test_mhe_model_structure_matches_jax(name, estimated, tracked):
    port = make_mhe_model(getattr(rc, name)(), estimated, tracked)
    ref = jmake_mhe_model(_jax_model_classes()[name](), estimated, tracked)
    assert type(port).__name__ == type(ref).__name__ == f"MHE_{name}"
    for attr in ("input_names", "state_names", "parameter_names",
                 "output_names", "diff_state_names", "free_state_names",
                 "objective_term_names", "n_constraints"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.objective_term_names == ["mhe_tracking"]
    for group in ("inputs", "states", "parameters"):
        for p, r in zip(getattr(port, group), getattr(ref, group)):
            assert (p.name, p.role, p.value, p.lb, p.ub) == \
                (r.name, r.role, r.value, r.lb, r.ub)


def test_mhe_model_rejects_unknown_names():
    base = rc.RoomWithLoadParam()
    with pytest.raises(ValueError, match="estimated parameter"):
        make_mhe_model(base, ["nope"], ["T"])
    with pytest.raises(ValueError, match="tracked state"):
        make_mhe_model(base, ["load"], ["nope"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("M", [142, 92])
def test_auto_routes_the_mhe_example_shapes_to_the_kernels(monkeypatch,
                                                           dtype, M):
    """On an H100 (232 448 bytes of opt-in shared memory per block) "auto"
    sends the MHE QP's KKT (1, 142) and the example MPC's (1, 92) to the
    LDLᵀ kernels in either type; on the CPU to LU."""
    monkeypatch.setattr(kkt, "_smem_optin", lambda device: 232448)
    dt = getattr(torch, dtype)
    assert kkt.ldl_fits(M, "cuda", dt)
    assert kkt.resolve_kkt_method("auto", M, "cuda", dtype=dt) == "ldl"
    assert kkt.resolve_kkt_method("auto", M, "cpu", dtype=dt) == "lu"


# -- the example's two agents in closed loop, both packages ------------------


def example_configs(jax_side=False):
    """examples/mhe_one_room.py's agents with the plain LDLᵀ; the JAX side
    with its own model class and the routing its certificate proves."""
    cfgs = rc.mhe_one_room_configs(solver=SOLVER)
    if jax_side:
        cls = _jax_model_classes()["RoomLoadParam"]
        ctrl, plant = cfgs
        for module, route in ((ctrl["modules"][1], "on"),
                              (ctrl["modules"][2], "off")):
            backend = module["optimization_backend"]
            backend["model"]["class"] = cls
            backend["solver"] = {**backend["solver"], "qp_fast_path": route}
        plant["modules"][1]["model"]["class"] = cls
    return cfgs


def _trace(mas):
    ctrl = mas.agents["Controller"]
    mhe, mpc = ctrl.get_module("mhe"), ctrl.get_module("mpc")
    return {"mhe": mhe, "mpc": mpc,
            "mhe_solves": [dict(r) for r in mhe.backend.stats_history],
            "mhe_history": [(row["time"], {k: np.array(v) for k, v in
                                           row["traj"].items()})
                            for row in mhe._history_rows],
            "mpc_solves": [dict(r) for r in mpc.backend.stats_history],
            "mpc_history": [(row["time"], np.array(row["traj"]["u"]))
                            for row in mpc._history_rows],
            "rows": [dict(r) for r in
                     mas.agents["Plant"].get_module("room")._rows]}


@pytest.fixture(scope="module")
def loops():
    port = LocalMAS(example_configs(), env={"rt": False}, device="cpu",
                    dtype=F64)
    port.run(until=UNTIL)
    ref = JLocalMAS(example_configs(jax_side=True), env={"rt": False})
    ref.run(until=UNTIL)
    return {"port": _trace(port), "jax": _trace(ref)}


def _close(port, ref, what, rtol=RTOL):
    port, ref = np.asarray(port, dtype=float), np.asarray(ref, dtype=float)
    np.testing.assert_allclose(
        port, ref, rtol=rtol,
        atol=rtol * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
        err_msg=what)


def test_example_loop_matches_jax_step_by_step(loops):
    port, ref = loops["port"], loops["jax"]
    for kind in ("mhe_solves", "mpc_solves"):
        assert len(port[kind]) == len(ref[kind]) == 5
        for p, r in zip(port[kind], ref[kind]):
            assert p["time"] == r["time"]
            for key in ("iterations", "success", "kkt_path"):
                assert p[key] == r[key], (kind, r["time"], key)
            if kind == "mhe_solves":
                assert abs(p["objective"] - r["objective"]) \
                    <= MHE_OBJECTIVE_ATOL, r["time"]
            else:
                _close(p["objective"], r["objective"], "MPC objective")
    for (t, p), (_, r) in zip(port["mhe_history"], ref["mhe_history"]):
        for key in ("x", "u", "y"):
            _close(p[key], r[key], f"MHE traj {key} at t={t}")
    for (t, p), (_, r) in zip(port["mpc_history"], ref["mpc_history"]):
        _close(p[0], r[0], f"MPC u0 at t={t}")
    assert len(port["rows"]) == len(ref["rows"]) > 0
    for p, r in zip(port["rows"], ref["rows"]):
        for key in r:
            _close(p[key], r[key], f"plant {key} at t={r['time']}")
    _close(port["mhe"].get_value("load"), ref["mhe"].get_value("load"),
           "published load estimate")


def test_example_loop_estimates_the_load_and_cools(loops):
    """The estimate leaves the 100 W guess and, after its first
    overshoot, closes in on the plant's 260 W; the MPC, fed with it, cools
    the room."""
    port = loops["port"]
    loads = [row[1]["x"][-1, -1] for row in port["mhe_history"]]
    assert loads[0] > rc.MHE_GUESS_LOAD
    errors = np.abs(np.array(loads[1:]) - rc.MHE_TRUE_LOAD)
    assert np.all(np.diff(errors) < 0)
    assert port["rows"][-1]["T_out"] < port["rows"][0]["T_out"]
    frame = port["mhe"].estimation_frame()
    assert frame.index.get_level_values(1).min() == -10 * rc.MHE_DT
    assert {"mDot", "T"} <= set(port["mhe"].measurements_frame().columns)


def test_routing_verdicts_match_the_jax_certificate(loops, jax_certifier):
    """The port's "auto" routed the MHE OCP to the QP, as the JAX
    package's certificate of its MHE OCP says, and kept the example's MPC
    (bilinear in mDot and T) on the NLP."""
    assert loops["port"]["mhe"].backend.uses_qp_fast_path is True
    assert loops["port"]["mpc"].backend.uses_qp_fast_path is False
    ocp = loops["jax"]["mhe"].backend.ocp
    theta0 = ocp.default_params()
    cert = jax_certifier.certify_lq(ocp.nlp, theta0,
                                    int(ocp.initial_guess(theta0).shape[0]))
    assert cert.status == "lq", cert.describe()


def test_cold_and_warm_mhe_solves_match_jax(loops):
    """Both MHE backends from a cold start, then warm, on the history the
    JAX package's estimator collected; then the port from the JAX
    package's warm state (``warm_state_from_jax``)."""
    pm, jm = loops["port"]["mhe"], loops["jax"]["mhe"]
    variables = jm.collect_variables_for_optimization()
    now = float(jm.env.now)
    for backend in (pm.backend, jm.backend):
        backend._reset_warm_start()
    for step in range(2):
        t = now + step * rc.MHE_DT
        out = pm.backend.solve(t, variables)
        ref = jm.backend.solve(t, variables)
        assert out["stats"]["iterations"] == ref["stats"]["iterations"]
        assert out["estimates"].keys() == ref["estimates"].keys()
        for name, value in ref["estimates"].items():
            assert abs(out["estimates"][name] - value) <= SOLVE_TOL, name
        for key in ("x", "u"):
            np.testing.assert_allclose(out["traj"][key], ref["traj"][key],
                                       rtol=0, atol=SOLVE_TOL)
    warm = {k: (v if k == "cold" else np.asarray(v))
            for k, v in jm.backend.warm_state().items()}
    pm.backend.set_warm_state(warm_state_from_jax(warm, "cpu", F64))
    t = now + 2 * rc.MHE_DT
    out, ref = pm.backend.solve(t, variables), jm.backend.solve(t, variables)
    assert abs(out["estimates"]["load"] - ref["estimates"]["load"]) \
        <= SOLVE_TOL


def test_unknown_state_weights_are_rejected():
    ctrl = copy.deepcopy(rc.mhe_one_room_configs()[0])
    ctrl["modules"][1]["state_weights"] = {"nope": 1.0}
    with pytest.raises(ValueError, match="unknown states"):
        LocalMAS([ctrl], env={"rt": False}, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def jax_certifier():
    """The JAX package's ``lint.jaxpr`` on the installed jax (the shim of
    tests/test_torch_certify.py)."""
    import jax.core
    from jax._src import core as jcore

    from agentlib_mpc_tpu.lint import jaxpr as jlint
    from agentlib_mpc_tpu.lint.jaxpr import interp as jinterp

    mp = pytest.MonkeyPatch()
    if not hasattr(jax.core, "Literal"):
        mp.setattr(jax.core, "Literal", jcore.Literal, raising=False)
    eqn = jinterp._Interpreter.eqn

    def eqn_with_jit(self, e, args):
        if e.primitive.name == "jit" and "jaxpr" in e.params:
            return self.run(e.params["jaxpr"], args)
        return eqn(self, e, args)

    mp.setattr(jinterp._Interpreter, "eqn", eqn_with_jit)
    yield jlint
    mp.undo()


#: the MPC's inputs and float32 warm state at t = 1 320 s of the port's
#: float32 loop of the example, where its line search accepted merit rises
#: inside the noise allowance iteration after iteration and ran out of its
#: 50 iterations
F32_STATE = os.path.join(os.path.dirname(__file__), "data",
                         "torch_mhe_mpc_f32_state.json")


def test_f32_mpc_solve_at_the_precision_floor_converges(monkeypatch):
    from agentlib_mpc_torch.backends.backend import (
        VariableReference,
        create_backend,
    )
    from agentlib_mpc_torch.ops import solver

    with open(F32_STATE) as fh:
        state = json.load(fh)
    # "off": the routing the certificate proves for this OCP (non-LQ)
    cfg = copy.deepcopy(rc.mhe_one_room_configs(
        solver={**SOLVER, "qp_fast_path": "off"})[0]["modules"][2]
        ["optimization_backend"])
    backend = create_backend(cfg, device="cpu", dtype=torch.float32)
    backend.setup_optimization(VariableReference(
        states=["T"], controls=["mDot"], inputs=["T_in", "T_upper"],
        parameters=["load", "s_T", "r_mDot"]), 120.0, 10)
    backend.set_warm_state(
        {k: (v if k == "cold" else torch.tensor(v, dtype=torch.float32))
         for k, v in state["warm"].items()})
    seen = []
    monkeypatch.setattr(solver, "ITERATION_TRACE", lambda d: seen.append(
        (bool(d["accepted"][0]), bool(d["progressed"][0]))))
    stats = backend.solve(state["now"], state["variables"])["stats"]
    assert stats["success"] and stats["iterations"] < 50, stats
    # steps taken only within the noise allowance, counted as no progress
    assert seen.count((True, False)) >= 4
