"""The port's FusedADMM on the benchmark's fleets against the JAX package's,
on the CPU in float64.

Four ``ZoneWithSupply`` zones with ``bench.py``'s ``--mesh-ab`` options
(N=10, cold budget 10 with the Mehrotra corrector, warm budget 1 at
barrier 1e-2, 10 ADMM iterations at ρ 20) and four ``LinearRCZone``
zones routed to the QP by the certificate (ρ 5e-3), each through both
packages with ``kkt_method="ldl"`` (the plain LDLᵀ versions): a cold and
a shifted warm round; state, trajectories and IterationStats within 1e-8
relative of each leaf's largest magnitude (same algorithms in float64,
round-off carried through 10 ADMM iterations of budget-limited solves),
equal iteration counts and routing verdicts. Also: one lane's x0 set to
NaN quarantines nothing in either package (the solver keeps the lane's
iterate), with equal results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from agentlib_mpc_tpu.models import zoo as jzoo
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
from agentlib_mpc_tpu.parallel import fused_admm as J
from agentlib_mpc_torch.models import zoo as tzoo
from agentlib_mpc_torch.ops.solver import SolverOptions as TSO
from agentlib_mpc_torch.ops.transcription import transcribe as ttr
from agentlib_mpc_torch.parallel import admm_step
from agentlib_mpc_torch.parallel import fused_admm as T
from test_torch_fused_admm import assert_round_equal, run_both

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
N_ZONES = 4

FLEETS = {"zone": ("ZoneWithSupply", "mDot", "mDotCoolAir", 20.0),
          "linear": ("LinearRCZone", "Q", "Q", admm_step.LINEAR_RHO0)}


def build(pkg, model, n_zones=N_ZONES, dtype=F64, pinned=False):
    """(engine, thetas, alias) of one package's fleet. The JAX package
    takes its precision from the x64 flag in force; the port from
    ``dtype``. ``pinned`` zeroes the Boyd exits."""
    jax_side = pkg == "j"
    tr, M, SO, zoo = (jtr, J, JSO, jzoo) if jax_side else \
        (ttr, T, TSO, tzoo)
    cls, control, alias, rho = FLEETS[model]
    ocp = tr(getattr(zoo, cls)(), [control], N=admm_step.HORIZON,
             dt=admm_step.DT, method="collocation", collocation_degree=2)
    cold = SO(**admm_step.SOLVER_BASE, mu_init=admm_step.COLD_MU,
              kkt_method="ldl")
    group = M.AgentGroup(
        name="zones", ocp=ocp, n_agents=n_zones, couplings={alias: control},
        solver_options=cold,
        warm_solver_options=cold._replace(max_iter=admm_step.WARM_BUDGET,
                                          mu_init=admm_step.WARM_MU))
    exits = dict(abs_tol=0.0, rel_tol=0.0, primal_tol=0.0,
                 dual_tol=0.0) if pinned else {}
    opts = M.FusedADMMOptions(max_iterations=admm_step.ADMM_ITERS, rho=rho,
                              **exits)
    kw = {} if jax_side else {"device": "cpu"}
    engine = M.FusedADMM([group], opts, **kw)
    tail = admm_step.MODELS[model][1]
    x0s, loads = bench.fleet_inputs(n_zones)
    rows = []
    for x0, load in zip(x0s, loads):
        d = np.broadcast_to([load, *tail], (admm_step.HORIZON, 3))
        if jax_side:
            rows.append(ocp.default_params(x0=jnp.array([x0]),
                                           d_traj=jnp.asarray(d)))
        else:
            rows.append(ocp.default_params(
                device="cpu", dtype=dtype, x0=torch.tensor([x0], dtype=dtype),
                d_traj=torch.tensor(d.copy(), dtype=dtype)))
    return engine, [M.stack_params(rows)], alias


def rounds(model):
    (je, jth, alias), (te, tth, _) = build("j", model), build("t", model)
    cold = run_both(je, je.init_state(jth), jth, te, te.init_state(tth),
                    tth)
    warm = run_both(je, je.shift_state(jax.tree.map(jnp.asarray,
                                                    cold[0][0])), jth,
                    te, te.shift_state(cold[1][0]), tth)
    return (je, te, jth, tth, alias), cold, warm


@pytest.fixture(scope="module")
def zone_fleet():
    return rounds("zone")


@pytest.fixture(scope="module")
def linear_fleet():
    return rounds("linear")


@pytest.mark.parametrize("which", [1, 2], ids=["cold", "warm"])
def test_zone_fleet_matches_jax(zone_fleet, which):
    jout, tout = zone_fleet[which]
    assert_round_equal(jout, tout)


@pytest.mark.parametrize("which", [1, 2], ids=["cold", "warm"])
def test_linear_fleet_matches_jax(linear_fleet, which):
    jout, tout = linear_fleet[which]
    assert_round_equal(jout, tout)


def test_routing_verdicts_match_jax(zone_fleet, linear_fleet):
    for fleet, expected in ((zone_fleet, (False,)), (linear_fleet, (True,))):
        je, te = fleet[0][:2]
        assert te.group_uses_qp == je.group_uses_qp == expected
        assert te.shared_trace


def test_nan_x0_quarantines_nothing_in_either_package(zone_fleet):
    """A NaN initial state leaves the lane's iterate finite in both
    packages (the solver's step guard keeps the warm start), so the
    quarantine does not fire; the rounds agree."""
    (je, te, jth, tth, alias), _, warm = zone_fleet
    jbad = [jth[0]._replace(x0=jth[0].x0.at[1].set(jnp.nan))]
    x0 = tth[0].x0.clone()
    x0[1] = float("nan")
    tbad = [tth[0]._replace(x0=x0)]
    jstate = jax.tree.map(jnp.asarray, warm[0][0])
    jout, tout = run_both(je, jstate, jbad, te, warm[1][0], tbad)
    assert tout[2].lane_quarantined[0].tolist() == \
        np.asarray(jout[2].lane_quarantined[0]).tolist() == [0] * N_ZONES
    assert int(tout[2].iterations) == int(jout[2].iterations)
    for leaf in torch.utils._pytree.tree_leaves(tout[0]):
        assert bool(torch.isfinite(leaf).all())
    np.testing.assert_allclose(tout[0].zbar[alias].numpy(),
                               np.asarray(jout[0].zbar[alias]),
                               rtol=1e-8, atol=1e-10)
