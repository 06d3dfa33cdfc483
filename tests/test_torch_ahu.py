"""The AHU of the four-room coordinator example on the module path, both
packages, CPU, f64.

(g) ``examples/admm_4rooms_coordinator.py``'s air-handling unit
(``reference_configs.admm_4rooms_coordinator_configs``; an
``admm_coordinated`` participant on ``AirHandlingUnit``: no states, four
controls, the shared capacity ``0 <= sum(mDot_i) <= mDot_max`` as a path
inequality, four output couplings), set up beside its coordinator:

* its transcription's sizes and inequality residuals against the JAX
  package's (the capacity is a row pair at every collocation point);
* the routing: the port's "auto" sends its augmented problem to the QP
  fast path, on the port's certificate, and the JAX package's certifier
  proves its own augmented problem LQ;
* one augmented solve cold and one warm from means, multipliers and rho
  drawn from a numpy seed: the same iterations, couplings and u0 within
  1e-8;
* the solve the JAX package's own f64 loop fails at t = 300 s, from its
  inputs and warm state (``tests/data/torch_ahu_failed_300.json``, written
  by ``scripts/admm_f32_witness.py --fixture``): the port takes the same
  exit, at the iteration cap.

The plain LDLᵀ in both packages. The JAX side's backend is built on the
QP fast path ("on", the routing its certificate proves); "auto" would
spend its sampled LQ probe on it, the slowest part of its setup.
"""

import json
import os

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.utils.convert import warm_state_from_jax
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS
from test_torch_admm_module import (  # noqa: F401 - a fixture
    _jax_augmented_nlp,
    jax_certifier,
)

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
SOLVER = {"kkt_method": "ldl"}
#: one augmented AHU solve from the same state, absolute (m³/s)
SOLVE_TOL = 1e-8
AHU_FAILED = os.path.join(os.path.dirname(__file__), "data",
                          "torch_ahu_failed_300.json")


@pytest.fixture(scope="module")
def ahu():
    """The AHU participant of each package, set up beside its coordinator
    (no round run)."""
    def configs(solver):
        return [a for a in rc.admm_4rooms_coordinator_configs(solver=solver)
                if a["id"] in ("Coordinator", "AHU")]

    port = LocalMAS(configs(SOLVER), env={"rt": False}, device="cpu",
                    dtype=F64)
    ref = JLocalMAS(configs({**SOLVER, "qp_fast_path": "on"}),
                    env={"rt": False})
    return {"port": port.agents["AHU"].get_module("admm"),
            "jax": ref.agents["AHU"].get_module("admm")}


def test_ahu_transcription_matches_jax(ahu):
    """Zero states, four controls on 8 intervals, the capacity's two sides
    at each of the 2 collocation points of each interval."""
    po, jo = ahu["port"].backend.ocp, ahu["jax"].backend.ocp
    assert (po.n_w, po.n_g, po.n_h) == (jo.n_w, jo.n_g, jo.n_h) == (32, 0, 32)
    rng = np.random.default_rng(2)
    jth = jo.default_params()
    pth = po.default_params(device="cpu", dtype=F64)
    for _ in range(3):
        w = rng.uniform(0.0, 0.05, po.n_w)
        np.testing.assert_allclose(
            po.nlp.h(torch.as_tensor(w), pth).numpy(),
            np.asarray(jo.nlp.h(w, jth)), rtol=0, atol=1e-15)


def _seeded_inputs(module, rng):
    """The module's inputs with means, multipliers and rho drawn from
    ``rng`` (the same draws for either package's module)."""
    variables = dict(module.collect_variables_for_optimization())
    n = len(module.backend.coupling_grid)
    for entry in module.couplings:
        variables[entry.mean] = 0.02 + 0.005 * rng.standard_normal(n)
        variables[entry.multiplier] = 0.05 * rng.standard_normal(n)
    variables["penalty_factor"] = float(rng.uniform(5.0, 20.0))
    variables["admm_iteration"] = 0
    return variables


def test_ahu_routes_to_the_qp_in_both_packages(ahu, jax_certifier):
    from agentlib_mpc_torch.lint.fx import certify_lq

    pb, jb = ahu["port"].backend, ahu["jax"].backend
    assert pb.uses_qp_fast_path and jb.uses_qp_fast_path
    port = certify_lq(pb.nlp, pb._augmented_theta(F64), pb.ocp.n_w)
    nlp, theta = _jax_augmented_nlp(jb)
    ref = jax_certifier.certify_lq(nlp, theta, pb.ocp.n_w)
    assert port.status == ref.status == "lq", (port.describe(),
                                               ref.describe())


def test_ahu_augmented_solves_match_jax(ahu):
    port, ref = ahu["port"], ahu["jax"]
    rngs = {"port": np.random.default_rng(4), "jax": np.random.default_rng(4)}
    for step in range(2):               # cold, then warm from the first
        out = {name: m.backend.solve(300.0 * step,
                                     _seeded_inputs(m, rngs[name]))
               for name, m in (("port", port), ("jax", ref))}
        p, r = out["port"], out["jax"]
        assert p["stats"]["success"] and bool(r["stats"]["success"])
        assert p["stats"]["iterations"] == int(r["stats"]["iterations"])
        for name, value in r["couplings"].items():
            np.testing.assert_allclose(p["couplings"][name], value, rtol=0,
                                       atol=SOLVE_TOL, err_msg=name)
        for name, value in r["u0"].items():
            assert p["u0"][name] == pytest.approx(float(value), rel=0,
                                                  abs=SOLVE_TOL)


def test_ahu_failed_solve_takes_the_jax_exit(ahu):
    """The AHU solve the JAX package's f64 coordinator loop fails at
    t = 300 s (its iteration cap of 60, a KKT error far above tol): from
    the same inputs and warm state the port stops at the same cap, and
    so does the JAX package's backend here."""
    with open(AHU_FAILED) as fh:
        data = json.load(fh)
    variables = {k: (int(v) if k == "admm_iteration" else
                     np.asarray(v, dtype=np.float64) if isinstance(v, list)
                     else v) for k, v in data["variables"].items()}
    warm = {k: (v if k == "cold" else np.asarray(v, dtype=np.float64))
            for k, v in data["warm"].items()}
    port, ref = ahu["port"].backend, ahu["jax"].backend
    port.set_warm_state(warm_state_from_jax(warm, "cpu", F64))
    ref.set_warm_state(warm)
    p = port.solve(data["now"], variables)["stats"]
    r = ref.solve(data["now"], variables)["stats"]
    recorded = data["stats"]
    assert not recorded["success"] and recorded["iterations"] == 60
    assert (bool(r["success"]), int(r["iterations"])) == (False, 60)
    assert (p["success"], p["iterations"]) == (False, 60)
    assert p["kkt_error"] > 1e-3 and float(r["kkt_error"]) > 1e-3
