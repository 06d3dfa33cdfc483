"""The surrogate room's float32 solves part from float64 alike in both
packages (ROADMAP Queue 3, closed as shared numerics).

``examples/ml_mpc_one_room.py``'s loop on ``jax_ml`` in float32 fails the
solves at t = 0, 300 and 600 s in the port and only the one at t = 0 in
the JAX package. ``scripts/module_f32_witness.py --only ml_replay`` replays
every solve of each package's loop in both packages from the same plant
and warm state: from the port's states the JAX package fails exactly the
port's three; from the JAX package's, the port fails t = 0 and 300 and the
JAX package t = 0 alone, its t = 300 solve converging in 53 of its 60
iterations; from the JAX package's states with the warm primal perturbed
by 1e-6 relative, both fail 9 of 100. The JAX package's state before
t = 300 s and the surrogate are stored in
``tests/data/torch_ml_room_f32_300.json`` (the witness's ``--fixture``).

From that state this file holds what makes the difference numerics rather
than a port fault: the NARX derivatives are as accurate in float32 in the
port as in the JAX package; both packages' float64 solves agree iterate
for iterate; and each package's float32 iterates leave its float64 path
at the same rate, the two float32 paths staying closer to each other than
to float64 while that departure grows about threefold per iteration.
Which of the two reaches the optimum inside 60 iterations then depends on
rounding (the JAX package's own answer changes with the program it
compiles), so no float32 outcome is asserted here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacrev

from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.backends.backend import VariableReference
from agentlib_mpc_torch.backends.backend import create_backend
from agentlib_mpc_torch.ops.solver import solve_nlp
from agentlib_mpc_tpu.backends.backend import (
    VariableReference as JVariableReference,
)
from agentlib_mpc_tpu.backends.backend import create_backend as jcreate
from agentlib_mpc_tpu.ml import load_serialized_model
from agentlib_mpc_tpu.ops.solver import solve_nlp as jsolve_nlp

from _torch_threads import one_torch_thread  # noqa: F401

STATE = os.path.join(os.path.dirname(__file__), "data",
                     "torch_ml_room_f32_300.json")
ROLES = dict(states=["T"], controls=["Q"], inputs=["T_upper"],
             parameters=["s_T", "r_Q"])
#: the examples' solver in both packages (the card's factor); the budget
#: is overridden per call
SOLVER = {"max_iter": 1, "kkt_method": "ldl"}
#: interior-point iterations the departure is followed for
STEPS = 4
#: float64 agreement of the two packages' iterates, relative
F64_RTOL = 1e-10
#: float32 derivative error against float64, relative (both packages show
#: 3e-8 to 9e-8; float32's eps is 1.2e-7)
DERIV_F32_RTOL = 5e-7
#: the two packages' departures from float64 at one iteration agree within
#: this factor (measured: within 1.3x over the first ten iterations)
DEPARTURE_RATIO = 3.0


@pytest.fixture(scope="module")
def state():
    with open(STATE) as fh:
        return json.load(fh)


def _warm(state, convert):
    return {k: (v if k == "cold" else convert(np.asarray(v, np.float32)))
            for k, v in state["warm"].items()}


class _Captured(Exception):
    pass


def _step_arguments(backend, state, run_step: bool):
    """The arguments the backend's solve at t = 300 s hands its step (the
    backend's own input assembly). The JAX package's step is not run
    (nothing to compile); the port's runs its one-iteration budget (an
    exception raised inside it would leave torch.func's levels open)."""
    step = backend._step
    caught = {}

    def capture(*args):
        caught["args"] = args
        if not run_step:
            raise _Captured
        return step(*args)

    backend._step = capture
    try:
        backend.solve(state["now"], {"T": state["T"]})
    except _Captured:
        pass
    return caught["args"]


def _port_problem(state, dtype):
    """The port's NLP, theta, bounds, options and warm start of the solve
    at t = 300 s (the backend's own assembly, captured)."""
    doc = json.dumps(state["surrogate"])
    backend = create_backend({"type": "jax_ml", "model": rc.ml_mpc_backend_config(
        doc)["model"], "solver": SOLVER}, device="cpu", dtype=dtype)
    backend.setup_optimization(VariableReference(**ROLES),
                               time_step=rc.ML_DT, prediction_horizon=10)
    backend.set_warm_state(_warm(state, lambda a: torch.tensor(
        a.astype(np.float64), dtype=dtype)))
    (x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub, ml_params, w, y, z,
     mu0, t0) = _step_arguments(backend, state, run_step=True)
    theta = backend._theta0._replace(
        x0=x0, u_prev=u_prev, past=past, d_traj=d_traj, p=p, x_lb=x_lb,
        x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0, ml_params=ml_params)
    lb, ub = backend.ocp.bounds(theta)
    return backend.ocp.nlp, theta, lb, ub, backend.solver_options, w, y, z, \
        mu0


def _jax_problem(state, x64):
    from examples import ml_mpc_one_room as ex_mpc

    doc = json.dumps(state["surrogate"])
    dt = jnp.float64 if x64 else jnp.float32
    backend = jcreate({"type": "jax_ml", "model": {
        "class": ex_mpc.SurrogateRoom,
        "ml_model_sources": [load_serialized_model(doc)]},
        "solver": SOLVER})
    backend.setup_optimization(JVariableReference(**ROLES),
                               time_step=rc.ML_DT, prediction_horizon=10)
    backend.set_warm_state(_warm(state, lambda a: jnp.asarray(
        a.astype(np.float64), dt)))
    (x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub, ml_params, w, y, z,
     mu0, t0) = _step_arguments(backend, state, run_step=False)
    ocp = backend.ocp
    theta = ocp.default_params(
        x0=x0, u_prev=u_prev, past=past, d_traj=d_traj, p=p, x_lb=x_lb,
        x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0, ml_params=ml_params)
    lb, ub = ocp.bounds(theta)
    return ocp.nlp, theta, lb, ub, backend.solver_options, w, y, z, mu0


@pytest.fixture(scope="module")
def runs(state):
    """Per package and type: the derivatives at the warm start and the
    iterates after 1..STEPS interior-point iterations, as float64 numpy."""
    out = {}
    for name, dtype in (("port32", torch.float32), ("port64", torch.float64)):
        nlp, th, lb, ub, opts, w, y, z, mu0 = _port_problem(state, dtype)
        lag = lambda ww: (nlp.f(ww, th) + (y * nlp.g(ww, th)).sum()
                          + (z * nlp.h(ww, th)).sum())
        out[name] = {
            "gf": jacrev(lambda ww: nlp.f(ww, th))(w),
            "Jg": jacrev(lambda ww: nlp.g(ww, th))(w),
            "H": hessian(lag)(w),
            "w": [solve_nlp(nlp, w, th, lb, ub, opts, y0=y, z0=z, mu0=mu0,
                            max_iter=k).w for k in range(1, STEPS + 1)]}
        out[name] = {k: ([t.double().numpy() for t in v] if k == "w"
                         else v.double().numpy())
                     for k, v in out[name].items()}
    for name, x64 in (("jax32", False), ("jax64", True)):
        with jax.enable_x64(x64):
            nlp, th, lb, ub, opts, w, y, z, mu0 = _jax_problem(state, x64)
            lag = lambda ww: (nlp.f(ww, th) + jnp.sum(y * nlp.g(ww, th))
                              + jnp.sum(z * nlp.h(ww, th)))
            solve = jax.jit(lambda k: jsolve_nlp(
                nlp, w, th, lb, ub, opts, y0=y, z0=z, mu0=mu0,
                max_iter=k).w)
            out[name] = {
                "gf": np.asarray(jax.jit(jax.grad(
                    lambda ww: nlp.f(ww, th)))(w), np.float64),
                "Jg": np.asarray(jax.jit(jax.jacrev(
                    lambda ww: nlp.g(ww, th)))(w), np.float64),
                "H": np.asarray(jax.jit(jax.hessian(lag))(w), np.float64),
                "w": [np.asarray(solve(jnp.asarray(k)), np.float64)
                      for k in range(1, STEPS + 1)]}
    return out


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("what", ["gf", "Jg", "H"])
def test_narx_derivatives_are_as_accurate_in_both_packages(runs, what):
    assert _rel(runs["port64"][what], runs["jax64"][what]) < F64_RTOL
    for pkg in ("port", "jax"):
        assert _rel(runs[f"{pkg}32"][what], runs[f"{pkg}64"][what]) \
            < DERIV_F32_RTOL, pkg


def test_float64_iterates_agree(runs):
    for k in range(STEPS):
        assert _rel(runs["port64"]["w"][k], runs["jax64"]["w"][k]) < F64_RTOL


def test_float32_iterates_leave_float64_alike(runs):
    ref = runs["jax64"]["w"]
    dep = {pkg: [_rel(runs[f"{pkg}32"]["w"][k], ref[k])
                 for k in range(STEPS)] for pkg in ("port", "jax")}
    for k in range(STEPS):
        lo, hi = sorted((dep["port"][k], dep["jax"][k]))
        assert hi <= DEPARTURE_RATIO * lo, (k, dep)
    # the departure grows with the iterations, in both packages
    for pkg in ("port", "jax"):
        assert dep[pkg][-1] > 10 * dep[pkg][0], (pkg, dep)
    # after one iteration the two float32 paths are closer to each other
    # than to float64 (the same rounding of the same arithmetic)
    assert _rel(runs["port32"]["w"][0], runs["jax32"]["w"][0]) \
        < 0.1 * dep["jax"][0]
