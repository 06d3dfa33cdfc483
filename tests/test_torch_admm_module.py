"""Decentralized consensus ADMM on the module path, both packages, CPU, f64.

``examples/admm_cooled_room.py``'s three agents
(``agentlib_mpc_torch/reference_configs.py``): a room (``CooledRoom``,
coupled on its input ``mDot``) and a cooler (``Cooler``, no states,
coupled on its output ``mDot_out``), each an ``admm_local`` module over
``jax_admm``, and the simulated room; the plain LDLᵀ in both packages.

* (f) the closed loop to 900 s (3 control steps of 6 ADMM iterations, 18
  solves per agent): per solve the same iterations, per ADMM iteration
  the coupling trajectories within 1e-6, the plant's rows within 1e-6;
* (a) one augmented solve of each agent, cold and then warm, from the
  JAX package's state at the loop's end (warm start carried by
  ``warm_state_from_jax``, the module state by ``admm_values_from_jax``)
  with means, multipliers and rho drawn from a numpy seed: the same
  iterations, u0, ``w`` and coupling trajectories within 1e-8;
* (b) the two coupling kinds and the zero-state ``Cooler``: the
  transcriptions' sizes and the extractors on random points;
* (c) the routing verdicts: the room's augmented NLP stays on the NLP
  path, the cooler's (LQ with its penalty) goes to the QP fast path; the
  port's certificates and the JAX package's of its own augmented problems
  say ``not_lq`` and ``lq``.

The JAX side forces the routing its certificate proves (room "off",
cooler "on") in the loop: "auto" would spend its sampled probe on
confirming it. Its certifier runs through the shim of
``tests/test_torch_certify.py``.
"""

import copy

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.utils.convert import (
    admm_values_from_jax,
    warm_state_from_jax,
)
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: the closed loop: three control steps
UNTIL = 900.0
#: loop parity per solve and per ADMM iteration, absolute (m³/s, K)
LOOP_TOL = 1e-6
#: one augmented solve from the same state, absolute
SOLVE_TOL = 1e-8
SOLVER = {"kkt_method": "ldl"}
AGENTS = ("CooledRoom", "Cooler")
#: the routing each augmented problem's certificate proves
ROUTES = {"CooledRoom": "off", "Cooler": "on"}


def example_configs(jax_side=False):
    cfgs = rc.admm_cooled_room_configs(solver=SOLVER)
    if jax_side:
        for agent in cfgs[:2]:
            backend = agent["modules"][1]["optimization_backend"]
            backend["solver"]["qp_fast_path"] = ROUTES[agent["id"]]
    return cfgs


def _named(obj):
    """A config with every model class replaced by its name."""
    if isinstance(obj, dict):
        return {k: _named(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_named(v) for v in obj]
    return obj.__name__ if isinstance(obj, type) else obj


def test_configs_are_the_example():
    from examples.admm_cooled_room import agent_configs

    assert _named(rc.admm_cooled_room_configs()) == _named(agent_configs())


@pytest.fixture(scope="module")
def loops():
    port = LocalMAS(example_configs(), env={"rt": False}, device="cpu",
                    dtype=F64)
    port.run(until=UNTIL)
    ref = JLocalMAS(example_configs(jax_side=True), env={"rt": False})
    ref.run(until=UNTIL)
    return {"port": port, "jax": ref}


def _modules(loops, agent):
    return (loops["port"].agents[agent].get_module("admm"),
            loops["jax"].agents[agent].get_module("admm"))


@pytest.mark.parametrize("agent", AGENTS)
def test_local_admm_loop_matches_jax_per_solve(loops, agent):
    pm, jm = _modules(loops, agent)
    ps, js = pm.backend.stats_history, jm.backend.stats_history
    assert len(ps) == len(js) == 18
    for p, r in zip(ps, js):
        assert p["time"] == r["time"]
        for key in ("iterations", "success", "kkt_path"):
            assert p[key] == r[key], (agent, r["time"], key)
    assert len(pm._iter_rows) == len(jm._iter_rows) == 18
    for p, r in zip(pm._iter_rows, jm._iter_rows):
        assert (p["time"], p["iteration"]) == (r["time"], r["iteration"])
        assert p["couplings"].keys() == r["couplings"].keys()
        for name, value in r["couplings"].items():
            np.testing.assert_allclose(p["couplings"][name], value, rtol=0,
                                       atol=LOOP_TOL, err_msg=name)
    for key, value in jm._admm_values.items():
        np.testing.assert_allclose(pm._admm_values[key], value, rtol=0,
                                   atol=LOOP_TOL, err_msg=key)


def test_local_admm_loop_plant_matches_jax_and_cools(loops):
    prow = loops["port"].agents["Simulation"].get_module("simulator")._rows
    jrow = loops["jax"].agents["Simulation"].get_module("simulator")._rows
    assert len(prow) == len(jrow) > 0
    for p, r in zip(prow, jrow):
        for key, value in r.items():
            assert abs(p[key] - value) <= LOOP_TOL, (key, r["time"])
    assert prow[-1]["T_out"] < prow[0]["T_out"]
    assert max(r["mDot"] for r in prow) <= 0.05 + 1e-9
    room = loops["port"].get_results()["CooledRoom"]["admm"]["admm"]
    assert room.index.names == ["time", "iteration", "grid"]
    assert room.index.get_level_values("iteration").nunique() == 6


def _draw(seed, names, n):
    rng = np.random.default_rng(seed)
    out = {}
    for name in names:
        out[f"admm_coupling_mean_{name}"] = 0.025 + 0.01 * \
            rng.standard_normal(n)
        out[f"admm_lambda_{name}"] = 0.05 * rng.standard_normal(n)
    out["penalty_factor"] = float(5.0 + 10.0 * rng.random())
    return out


@pytest.mark.parametrize("agent, seed", [("CooledRoom", 3), ("Cooler", 4)])
def test_augmented_solve_matches_jax_from_the_same_state(loops, agent,
                                                         seed):
    """Cold and then warm (``admm_iteration`` 1: the warm option set)
    from the JAX package's module and backend state at the loop's end."""
    pm, jm = _modules(loops, agent)
    pm._admm_values = admm_values_from_jax(jm._admm_values)
    warm = {k: (v if k == "cold" else np.asarray(v))
            for k, v in jm.backend.warm_state().items()}
    pm.backend.set_warm_state(warm_state_from_jax(warm, "cpu", F64))
    variables = jm.collect_variables_for_optimization()
    assert pm.collect_variables_for_optimization().keys() == \
        variables.keys()
    variables.update(_draw(seed, jm.backend.coupling_names, jm.backend.N))
    now = float(jm.env.now)
    for admm_iter in (0, 1):
        variables["admm_iteration"] = admm_iter
        out = pm.backend.solve(now, copy.deepcopy(variables))
        ref = jm.backend.solve(now, copy.deepcopy(variables))
        assert out["stats"]["iterations"] == ref["stats"]["iterations"]
        assert out["stats"]["success"] and ref["stats"]["success"]
        assert out["u0"].keys() == ref["u0"].keys()
        for name, value in ref["u0"].items():
            assert abs(out["u0"][name] - value) <= SOLVE_TOL, name
        for name, value in ref["couplings"].items():
            np.testing.assert_allclose(out["couplings"][name], value,
                                       rtol=0, atol=SOLVE_TOL)
        np.testing.assert_allclose(
            pm.backend.warm_state()["w"].numpy(),
            np.asarray(jm.backend.warm_state()["w"]), rtol=0,
            atol=SOLVE_TOL * max(1.0, float(np.abs(warm["w"]).max())))


def test_coupling_kinds_and_the_zero_state_cooler(loops):
    """The room's coupling is an optimized input (a control column), the
    cooler's an output of a model with no states; both transcriptions have
    the JAX package's sizes, and the extractors agree on random points."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    sizes = {}
    for agent, name, kind in (("CooledRoom", "mDot", "input"),
                              ("Cooler", "mDot_out", "output")):
        pb, jb = (m.backend for m in _modules(loops, agent))
        assert pb._coup_kinds == jb._coup_kinds == {name: kind}
        for attr in ("n_w", "n_g", "n_h"):
            assert getattr(pb.ocp, attr) == getattr(jb.ocp, attr), attr
        assert tuple(pb.ocp.control_names) == tuple(jb.ocp.control_names)
        sizes[agent] = (pb.ocp.n_w, pb.ocp.n_g, pb.ocp.n_h)
        theta = pb.ocp.default_params(device="cpu", dtype=F64)
        jtheta = jb.ocp.default_params()
        for _ in range(3):
            w = rng.standard_normal(pb.ocp.n_w)
            port = pb._coupling_extractors()[name](torch.as_tensor(w),
                                                   theta)
            ref = jb._coupling_extractors()[name](jnp.asarray(w), jtheta)
            np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-14)
    assert sizes == {"CooledRoom": (49, 25, 32), "Cooler": (8, 0, 0)}
    assert loops["port"].agents["Cooler"].get_module(
        "admm").backend.model.n_diff == 0


def _jax_augmented_nlp(jb):
    """The JAX package's augmented problem of one consensus participant,
    from its own transcription, extractors and penalty (its backend keeps
    the problem inside the compiled step), with the zero theta its
    backend certifies at."""
    import jax.numpy as jnp

    from agentlib_mpc_tpu.ops.admm import consensus_penalty
    from agentlib_mpc_tpu.ops.solver import NLPFunctions

    ocp, names = jb.ocp, list(jb.coupling_names)
    extract = jb._coupling_extractors()

    def f_aug(w, theta):
        base, means, lams, rho = theta
        val = ocp.nlp.f(w, base)
        for k, name in enumerate(names):
            val = val + ocp.dt * consensus_penalty(
                extract[name](w, base), means[k], lams[k], rho)
        return val

    nlp = NLPFunctions(f=f_aug, g=lambda w, th: ocp.nlp.g(w, th[0]),
                       h=lambda w, th: ocp.nlp.h(w, th[0]))
    zeros = jnp.zeros((len(names), jb.N))
    return nlp, (ocp.default_params(), zeros, zeros, jnp.asarray(1.0))


def test_routing_verdicts_match_the_jax_certificate(loops, jax_certifier):
    """The port's "auto" keeps the room's augmented problem (bilinear
    mDot·T) on the NLP and sends the cooler's to the QP, on its
    certificates; the JAX package's certifier says the same of its own
    augmented problems."""
    from agentlib_mpc_torch.lint.fx import certify_lq

    want = {"CooledRoom": "not_lq", "Cooler": "lq"}
    for agent in AGENTS:
        pm, jm = _modules(loops, agent)
        pb = pm.backend
        assert pb.uses_qp_fast_path is (want[agent] == "lq"), agent
        port = certify_lq(pb.nlp, pb._augmented_theta(F64), pb.ocp.n_w)
        nlp, theta = _jax_augmented_nlp(jm.backend)
        ref = jax_certifier.certify_lq(nlp, theta, pb.ocp.n_w)
        assert port.status == ref.status == want[agent], (
            agent, port.describe(), ref.describe())


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
