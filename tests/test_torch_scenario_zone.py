"""The port's ScenarioFleet on the zone OCP against the JAX package's, on
the CPU in float64.

``bench.py``'s ``--scenario-ab`` workload (``bench.py:1266-1431``) cut to
2 zones × 3 scenarios: ``ZoneWithSupply`` (N=10, degree-2 collocation,
KKT 92) coupled on ``mDotCoolAir``, the slice's solver (``SOLVER_BASE``,
cold barrier ``COLD_MU``) with inner budgets 10 / 1, ρ = ρ_na = 20, loads
perturbed per scenario by ``ensemble_thetas`` (seed = zone, scale 0.15 of
the zone's load, the load channel), a fan tree with robust horizon 1. One
cold round from each package's own initial state, then one warm round
from the JAX package's shifted state carried into the port: state,
trajectories and statistics within 1e-8 relative, iterations,
``converged`` and ``local_solves_ok`` equal, the actuated ``u0`` identical
across each zone's branches. And the backend seam
``robust_scenario_controls`` on one tracker agent of
``tests/test_torch_scenario_fleet.py`` (4 scenarios), cold and then warm
from the state it returned, against the JAX package's within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_tpu import scenario as J
from agentlib_mpc_tpu.models.zoo import ZoneWithSupply as JZone
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
from agentlib_mpc_tpu.parallel.fused_admm import AgentGroup as JAG
from agentlib_mpc_torch import scenario as T
from agentlib_mpc_torch.ops.solver import SolverOptions as TSO
from agentlib_mpc_torch.parallel import admm_step
from agentlib_mpc_torch.parallel.fused_admm import AgentGroup as TAG
from agentlib_mpc_torch.parallel.fused_admm import stack_params
from agentlib_mpc_torch.utils.convert import scenario_state_from_jax

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_scenario_fleet import (
    N_SCEN as TRACKER_SCEN,
    OPTS,
    RESIDUAL_ATOL,
    RTOL,
    assert_round_equal,
    assert_tree_close,
    jthetas,
    tthetas,
)

F64 = torch.float64
N_ZONES = 2
N_SCEN = 3
ALIAS = "mDotCoolAir"
FLEET = dict(max_iterations=admm_step.ADMM_ITERS, rho=20.0, rho_na=20.0,
             warm_budget=admm_step.WARM_BUDGET, warm_mu=admm_step.WARM_MU)


def zone_thetas(M, ocp, jax_side):
    """Per zone: its x0 and load (``fleet_inputs``), the load channel
    perturbed per scenario, stacked (n_zones, S)."""
    x0s, loads = admm_step.fleet_inputs(N_ZONES)
    tree = M.fan_tree(N_SCEN, robust_horizon=1)
    rows = []
    for i in range(N_ZONES):
        d = np.tile([loads[i], *admm_step.ZONE_D_ROW_TAIL], (ocp.N, 1))
        if jax_side:
            th = ocp.default_params(x0=jnp.array([x0s[i]]),
                                    d_traj=jnp.asarray(d))
        else:
            th = ocp.default_params(device="cpu", dtype=F64,
                                    x0=torch.tensor([x0s[i]], dtype=F64),
                                    d_traj=torch.tensor(d, dtype=F64))
        rows.append(M.ensemble_thetas(th, tree, seed=i,
                                      scale=0.15 * loads[i], channels=(0,)))
    if jax_side:
        return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
    return stack_params(rows)


@pytest.fixture(scope="module")
def rounds():
    kw = dict(N=admm_step.HORIZON, dt=admm_step.DT, method="collocation",
              collocation_degree=2)
    jocp = jtr(JZone(), ["mDot"], **kw)
    tocp = admm_step.zone_ocp()
    jf = J.ScenarioFleet(
        JAG(name="zones", ocp=jocp, n_agents=N_ZONES,
            couplings={ALIAS: "mDot"},
            solver_options=JSO(**admm_step.SOLVER_BASE,
                               mu_init=admm_step.COLD_MU)),
        J.fan_tree(N_SCEN, robust_horizon=1), J.ScenarioFleetOptions(**FLEET))
    tf = T.ScenarioFleet(
        TAG(name="zones", ocp=tocp, n_agents=N_ZONES,
            couplings={ALIAS: "mDot"},
            solver_options=TSO(**admm_step.SOLVER_BASE,
                               mu_init=admm_step.COLD_MU)),
        T.fan_tree(N_SCEN, robust_horizon=1), T.ScenarioFleetOptions(**FLEET),
        device="cpu")
    jth, tth = zone_thetas(J, jocp, True), zone_thetas(T, tocp, False)
    step = jax.jit(jf._step_fn)

    def jstep(state):
        out = step(state, jth, jf.active, jf._membership, jf._scen_weight)
        return jax.tree.map(np.asarray, out)

    cold = (jstep(jf.init_state(jth)), tf.step(tf.init_state(tth), tth))
    jshift = jf.shift_state(jax.tree.map(jnp.asarray, cold[0][0]))
    warm = (jstep(jshift), tf.step(scenario_state_from_jax(
        jax.tree.map(np.asarray, jshift), "cpu", F64), tth))
    return {"cold": cold, "warm": warm, "engine": tf, "thetas": (jth, tth)}


def test_zone_thetas_equal_jax(rounds):
    jth, tth = rounds["thetas"]
    for f in jth._fields:
        np.testing.assert_array_equal(getattr(tth, f).numpy(),
                                      np.asarray(getattr(jth, f)), err_msg=f)


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_zone_rounds_match_jax(rounds, which):
    assert_round_equal(*rounds[which])


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_zone_robust_controls_are_group_identical(rounds, which):
    tf = rounds["engine"]
    state, _trajs, stats = rounds[which][1]
    u0 = tf.actuated_u0(state)
    assert tuple(u0.shape) == (N_ZONES, N_SCEN, 1)
    assert torch.equal(u0, u0[:, :1].expand_as(u0))
    assert float(stats.na_spread) >= 0.0
    zbar = state.zbar[ALIAS]
    assert tuple(zbar.shape) == (N_SCEN, admm_step.HORIZON)
    assert bool(torch.isfinite(zbar).all())


def test_robust_scenario_controls_match_jax():
    """The backend seam: one agent's tree solved for its robust controls,
    then re-solved warm from the returned state, in both packages."""
    from agentlib_mpc_tpu.backends.mpc_backend import (
        robust_scenario_controls as jrobust,
    )
    from agentlib_mpc_tpu.lint.retrace_budget import tracker_ocp as jtracker
    from agentlib_mpc_torch.backends.mpc_backend import (
        robust_scenario_controls,
    )
    from agentlib_mpc_torch.reference_configs import tracker_ocp

    jocp, tocp = jtracker(), tracker_ocp()
    jth = jax.tree.map(lambda leaf: leaf[0], jthetas(jocp))
    tth = tree_map(lambda leaf: leaf[0], tthetas(tocp))
    jstate = tstate = None
    for _ in range(2):
        ju0, jstate, jstats = jrobust(
            jocp, jth, J.fan_tree(TRACKER_SCEN), JSO(max_iter=30),
            J.ScenarioFleetOptions(**OPTS), state=jstate)
        tu0, tstate, tstats = robust_scenario_controls(
            tocp, tth, T.fan_tree(TRACKER_SCEN), TSO(max_iter=30),
            T.ScenarioFleetOptions(**OPTS), state=tstate)
        assert isinstance(tu0, np.ndarray) and tu0.shape == (1,)
        assert_tree_close(tu0, np.asarray(ju0))
        assert_tree_close(tstate, jax.tree.map(np.asarray, jstate))
        assert int(tstats.iterations) == int(jstats.iterations)
        assert bool(tstats.converged) == bool(jstats.converged)
        # the warm call converges at once, its residuals at round-off of
        # the O(1) controls: compared absolutely there
        for f in ("primal_residuals", "dual_residuals", "na_spread"):
            np.testing.assert_allclose(getattr(tstats, f).numpy(),
                                       np.asarray(getattr(jstats, f)),
                                       rtol=RTOL, atol=RESIDUAL_ATOL,
                                       err_msg=f)
