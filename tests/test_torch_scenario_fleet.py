"""The port's ScenarioFleet against the JAX package's, on the CPU in
float64.

``agentlib_mpc_torch/scenario/fleet.py`` and ``agentlib_mpc_tpu/scenario/
fleet.py`` on the tracker OCP of the JAX package's gate workload
(``agentlib_mpc_torch.reference_configs.tracker_ocp``, its copy of
``agentlib_mpc_tpu/lint/retrace_budget.py:104-124``), 4 agents × 4
scenarios coupled on ``shared_u`` with the options of
``tests/test_scenario_fleet.py``, for a fan tree with robust horizon 1
and 0 and for one scenario: a cold round from each package's own initial
state, then a warm round from the JAX package's shifted state carried
into the port (``utils.convert.scenario_state_from_jax``), then the same
warm round with one branch's warm start set to NaN. State, trajectories
and statistics agree leaf by leaf within 1e-8 relative, with equal
iteration counts, ``converged``, ``local_solves_ok`` and quarantine
counts. Also: the one-scenario batch solve is the flat solve bitwise,
``pad_scenarios`` equals the JAX package's, the round's telemetry is
recorded, and every deferred argument names its ROADMAP item
(``robust_scenario_controls`` on the tracker is in
``tests/test_torch_scenario_zone.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_tpu import scenario as J
from agentlib_mpc_tpu.lint.retrace_budget import tracker_ocp as jtracker_ocp
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.parallel.fused_admm import AgentGroup as JAG
from agentlib_mpc_torch import scenario as T
from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.ops.solver import SolverOptions as TSO
from agentlib_mpc_torch.ops.solver import solve_nlp
from agentlib_mpc_torch.parallel.fused_admm import AgentGroup as TAG
from agentlib_mpc_torch.parallel.fused_admm import stack_params
from agentlib_mpc_torch.reference_configs import tracker_ocp
from agentlib_mpc_torch.utils.convert import (
    load_scenario_state,
    scenario_state_from_jax,
    to_numpy,
)

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-8
N_AGENTS = 4
N_SCEN = 4
OPTS = dict(max_iterations=12, rho=2.0, rho_na=4.0)
#: absolute tolerance of residual norms at round-off (the controls are
#: O(1), float64's eps 2.2e-16)
RESIDUAL_ATOL = 1e-12
#: the (agent, scenario) branch whose warm start is poisoned
NAN_BRANCH = (1, 2)


def assert_tree_close(port, ref, rtol=RTOL, path="tree"):
    """Walk both trees by structure and compare leaves: floats within
    ``rtol`` of the leaf's largest magnitude (NaN where NaN), integers and
    booleans exactly."""
    if ref is None:
        assert port is None, path
        return
    if hasattr(ref, "_fields"):
        for f in ref._fields:
            assert_tree_close(getattr(port, f), getattr(ref, f), rtol,
                              f"{path}.{f}")
        return
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            assert_tree_close(port[k], ref[k], rtol, f"{path}[{k!r}]")
        return
    a = np.asarray(ref)
    b = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=path)
        return
    scale = np.nanmax(np.abs(a)) if np.isfinite(a).any() else 0.0
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                               err_msg=path)


def assert_round_equal(jout, tout):
    (js, jt, jst), (ts, tt, tst) = jout, tout
    assert int(tst.iterations) == int(jst.iterations)
    assert bool(tst.converged) == bool(jst.converged)
    assert bool(tst.local_solves_ok) == bool(jst.local_solves_ok)
    assert_tree_close(ts, js, path="state")
    assert_tree_close(tt, jt, path="trajectories")
    assert_tree_close(tst, jst, path="stats")


def jthetas(ocp, n_scen=N_SCEN, spread=0.5):
    """(n_agents, S) tracker targets: agent a wants a + 1, scenario s
    offsets it by s·spread (the JAX package's test data)."""
    rows = [jax.tree.map(lambda *xs: jnp.stack(xs), *[
        ocp.default_params(p=jnp.array([float(i + 1) + spread * s]))
        for s in range(n_scen)]) for i in range(N_AGENTS)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


def tthetas(ocp, n_scen=N_SCEN, spread=0.5):
    return stack_params([stack_params([
        ocp.default_params(device="cpu", dtype=F64, p=torch.tensor(
            [float(i + 1) + spread * s], dtype=F64))
        for s in range(n_scen)]) for i in range(N_AGENTS)])


TREES = {"fan_r1": lambda M: M.fan_tree(N_SCEN, robust_horizon=1),
         "fan_r0": lambda M: M.fan_tree(N_SCEN, robust_horizon=0),
         "single": lambda M: M.single_scenario()}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ocps():
    return jtracker_ocp(), tracker_ocp()


@pytest.fixture(scope="module")
def rounds(ocps):
    """Per tree: the cold round, the warm round from the JAX package's
    shifted state, and (fan_r1) the warm round with a NaN branch, of both
    packages, and the port's engine."""
    jocp, tocp = ocps
    out = {}
    for name, make in TREES.items():
        n_scen = 1 if name == "single" else N_SCEN
        jth, tth = jthetas(jocp, n_scen), tthetas(tocp, n_scen)
        jf = J.ScenarioFleet(
            JAG(name="scenario-test", ocp=jocp, n_agents=N_AGENTS,
                couplings={"shared_u": "u"},
                solver_options=JSO(max_iter=30)),
            make(J), J.ScenarioFleetOptions(**OPTS))
        tf = T.ScenarioFleet(
            TAG(name="scenario-test", ocp=tocp, n_agents=N_AGENTS,
                couplings={"shared_u": "u"},
                solver_options=TSO(max_iter=30)),
            make(T), T.ScenarioFleetOptions(**OPTS), device="cpu")
        cold = (_numpy(jf.step(jf.init_state(jth), jth)),
                tf.step(tf.init_state(tth), tth))
        jshift = jf.shift_state(jax.tree.map(jnp.asarray, cold[0][0]))
        tshift = scenario_state_from_jax(_numpy(jshift), "cpu", F64)
        case = {"cold": cold, "engine": tf, "thetas": (jth, tth),
                "warm": (_numpy(jf.step(jshift, jth)),
                         tf.step(tshift, tth)),
                "shift": (_numpy(jshift), tf.shift_state(cold[1][0]))}
        if name == "fan_r1":
            a, s = NAN_BRANCH
            jbad = jshift._replace(w=jshift.w.at[a, s].set(jnp.nan))
            tbad = tshift._replace(w=tshift.w.clone())
            tbad.w[a, s] = float("nan")
            case["nan"] = (_numpy(jf.step(jbad, jth)), tf.step(tbad, tth))
        out[name] = case
    return out


@pytest.mark.parametrize("which", ["cold", "warm"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_tracker_rounds_match_jax(rounds, name, which):
    assert_round_equal(*rounds[name][which])


@pytest.mark.parametrize("name", sorted(TREES))
def test_shift_state_matches_jax(rounds, name):
    jshift, tshift = rounds[name]["shift"]
    assert_tree_close(tshift, jshift)


def test_non_anticipativity_projection(rounds):
    """The actuated u0 is identical across the fan's scenarios by
    construction, the branch controls sit within the reported spread of
    it, and the uncoupled tree reports no spread."""
    tf = rounds["fan_r1"]["engine"]
    state, _trajs, stats = rounds["fan_r1"]["warm"][1]
    u0 = tf.actuated_u0(state)
    assert tuple(u0.shape) == (N_AGENTS, N_SCEN, 1)
    assert torch.equal(u0, u0[:, :1].expand_as(u0))
    u_raw = tf.group.ocp.unflatten(state.w)["u"][:, :, 0, :]
    assert float((u_raw - u0).abs().max()) <= float(stats.na_spread) + 1e-12
    assert float(rounds["fan_r0"]["warm"][1][2].na_spread) == 0.0
    free = rounds["fan_r0"]["engine"]
    s0 = rounds["fan_r0"]["warm"][1][0]
    assert torch.equal(free.actuated_u0(s0),
                       free.group.ocp.unflatten(s0.w)["u"][:, :, 0, :])


def test_nan_branch_is_quarantined_on_its_lane(rounds):
    jout, tout = rounds["fan_r1"]["nan"]
    assert_round_equal(jout, tout)
    state, trajs, stats = tout
    counts = stats.lane_quarantined
    a, s = NAN_BRANCH
    assert int(counts[a, s]) >= 1
    others = counts.clone()
    others[a, s] = 0
    assert int(others.sum()) == 0
    tf = rounds["fan_r1"]["engine"]
    assert tf.lane_of(a, s) == a * N_SCEN + s
    for leaf in (state.w, state.y, state.z, state.nu, state.na_target,
                 *state.zbar.values(), *state.lam.values(), trajs["u"]):
        assert bool(torch.isfinite(leaf).all())


def test_round_telemetry_is_recorded(rounds):
    tf = rounds["fan_r1"]["engine"]
    jth, tth = rounds["fan_r1"]["thetas"]
    reg = telemetry.metrics()
    group = tf.group.name
    before = reg.get("scenario_rounds_total", group=group) or 0.0
    spreads = reg.get("scenario_spread") or 0.0
    q_before = reg.get("scenario_quarantined_iters", group=group) or 0.0
    state = rounds["fan_r1"]["shift"][1]
    a, s = NAN_BRANCH
    state = state._replace(w=state.w.clone())
    state.w[a, s] = float("nan")
    _, _, stats = tf.step(state, tth)
    assert reg.get("scenario_rounds_total", group=group) == before + 1
    assert reg.get("scenario_spread") == spreads + 1
    assert reg.get("scenario_count") == float(N_SCEN)
    assert reg.get("scenario_quarantined_iters", group=group) == \
        q_before + int(stats.lane_quarantined.sum())
    spans = [r for r in telemetry.recorder().spans()
             if r.name == "scenario.fused_step"]
    assert spans and spans[-1].labels == {"group": group,
                                          "scenarios": str(N_SCEN)}


def test_scenario_state_loads_into_its_fleet(rounds):
    tf = rounds["fan_r1"]["engine"]
    jshift = rounds["fan_r1"]["shift"][0]
    loaded = load_scenario_state(tf, jshift, dtype=F64)
    assert_tree_close(loaded, jshift, rtol=0.0)
    bad = jshift._replace(nu=np.zeros((N_AGENTS, N_SCEN, 2, 1)))
    with pytest.raises(ValueError, match="nu"):
        load_scenario_state(tf, bad, dtype=F64)
    with pytest.raises(ValueError, match="couples"):
        load_scenario_state(tf, jshift._replace(zbar={}, lam={}), F64)
    assert_tree_close(to_numpy(loaded), jshift, rtol=0.0)


def test_pad_scenarios_matches_jax(ocps):
    jocp, tocp = ocps
    for make in (lambda M: M.fan_tree(3, robust_horizon=1),
                 lambda M: M.branching_tree((3, 2))):
        jtree, jb = J.fleet.pad_scenarios(make(J), jthetas(jocp, make(J)
                                                            .n_scenarios), 4)
        ttree, tb = T.fleet.pad_scenarios(make(T), tthetas(tocp, make(T)
                                                            .n_scenarios), 4)
        assert tuple(ttree) == tuple(jtree)
        assert_tree_close(tb, _numpy(jb), rtol=0.0)
    same = T.fan_tree(4)
    th = tthetas(tocp)
    assert T.fleet.pad_scenarios(same, th, 2) == (same, th)


def _scenario_problem(ocp, S, jax_side):
    if jax_side:
        thetas = [ocp.default_params(p=jnp.array([float(s + 1)]))
                  for s in range(S)]
        theta_b = jax.tree.map(lambda *xs: jnp.stack(xs), *thetas)
        stack = jnp.stack
    else:
        thetas = [ocp.default_params(device="cpu", dtype=F64, p=torch.tensor(
            [float(s + 1)], dtype=F64)) for s in range(S)]
        theta_b = stack_params(thetas)
        stack = torch.stack
    w0 = stack([ocp.initial_guess(t) for t in thetas])
    lbub = [ocp.bounds(t) for t in thetas]
    return (w0, theta_b, stack([b[0] for b in lbub]),
            stack([b[1] for b in lbub]))


def test_solve_nlp_scenarios(ocps):
    jocp, tocp = ocps
    w0, th, lb, ub = _scenario_problem(tocp, 1, False)
    res_b = T.solve_nlp_scenarios(tocp.nlp, w0, th, lb, ub, TSO(max_iter=25),
                                  tree=T.single_scenario())
    res = solve_nlp(tocp.nlp, w0[0], tree_map(lambda l: l[0], th), lb[0],
                    ub[0], TSO(max_iter=25))
    for a, b in zip((res_b.w[0], res_b.y[0], res_b.z[0]),
                    (res.w, res.y, res.z)):
        assert torch.equal(a, b)
    jres = J.solve_nlp_scenarios(jocp.nlp, *_scenario_problem(jocp, 3, True),
                                 JSO(max_iter=25))
    tres = T.solve_nlp_scenarios(tocp.nlp, *_scenario_problem(tocp, 3, False),
                                 TSO(max_iter=25), tree=T.fan_tree(3))
    assert_tree_close(tres.w, np.asarray(jres.w))
    np.testing.assert_array_equal(tres.stats.iterations.numpy(),
                                  np.asarray(jres.stats.iterations))
    with pytest.raises(ValueError, match="scenarios"):
        T.solve_nlp_scenarios(tocp.nlp, w0, th, lb, ub, TSO(),
                              tree=T.fan_tree(3))


DEFERRED = {
    "mesh": ({"mesh": object()}, "item 5"),
    "watchdog": ({"watchdog_timeout_s": 1.0}, "item 5"),
    "warmstart": ({"warmstart": object()}, "item 5"),
    "collective_require": ({"collective_certify": "require"}, "item 7"),
    "memory_require": ({"memory_certify": "require"}, "item 7"),
    "dispatch_require": ({"dispatch_certify": "require"}, "item 7"),
    "precision_require": ({"precision_certify": "require"}, "item 7"),
}


@pytest.mark.parametrize("name", sorted(DEFERRED))
def test_deferred_arguments_name_their_item(ocps, name):
    _, tocp = ocps
    kw, item = DEFERRED[name]
    group = TAG(name="g", ocp=tocp, n_agents=2, couplings={"c": "u"})
    with pytest.raises(NotImplementedError, match=item):
        T.ScenarioFleet(group, T.fan_tree(2), device="cpu", **kw)


def test_build_errors(ocps, rounds):
    _, tocp = ocps
    group = TAG(name="g", ocp=tocp, n_agents=2, couplings={"c": "u"})
    with pytest.raises(NotImplementedError, match="item 7"):
        T.ScenarioFleet(dataclass_replace(group, TSO(fusion="require")),
                        T.fan_tree(2), device="cpu")
    with pytest.raises(ValueError, match="'auto', 'require' or 'off'"):
        T.ScenarioFleet(group, T.fan_tree(2), memory_certify="sometimes",
                        device="cpu")
    with pytest.raises(ValueError, match="exchanges"):
        T.ScenarioFleet(TAG(name="x", ocp=tocp, n_agents=2,
                            exchanges={"p": "u"}), T.fan_tree(2),
                        device="cpu")
    with pytest.raises(ValueError, match="active mask"):
        T.ScenarioFleet(group, T.fan_tree(2), active=[True], device="cpu")
    fleet = T.ScenarioFleet(group, T.fan_tree(2), collective_certify="off",
                            device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        fleet.shard_args(None, None, None)


def dataclass_replace(group, opts):
    import dataclasses

    return dataclasses.replace(group, solver_options=opts)
