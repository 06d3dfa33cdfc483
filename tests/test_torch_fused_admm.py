"""The port's FusedADMM against the JAX package's, on the CPU in float64.

The same seeded fleets go through ``agentlib_mpc_tpu/parallel/
fused_admm.py`` and ``agentlib_mpc_torch/parallel/fused_admm.py``: the
consensus trackers (with the adaptive penalty, recorded locals, a shifted
warm start carried over from the JAX package's state, and a NaN warm
start under quarantine), and consensus and exchange couplings together on
the split cold/warm schedule with per-alias penalties (the room/cooler
pair and the padded fleet are in ``tests/test_torch_fused_admm_pair.py``).
State, trajectories and
IterationStats must agree leaf by leaf within 1e-8 relative (each leaf's
largest magnitude; same algorithms in float64, the tolerance covers
round-off carried through tens of interior-point solves) with equal
iteration counts, quarantine counts and QP routing verdicts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.models.model import Model as JModel
from agentlib_mpc_tpu.models.model import ModelEquations as JEq
from agentlib_mpc_tpu.models.objective import SubObjective as JSub
from agentlib_mpc_tpu.models.variables import control_input as jci
from agentlib_mpc_tpu.models.variables import parameter as jpar
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
from agentlib_mpc_tpu.parallel import fused_admm as J
from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.objective import SubObjective
from agentlib_mpc_torch.models.variables import control_input, parameter
from agentlib_mpc_torch.ops.solver import SolverOptions as TSO
from agentlib_mpc_torch.ops.transcription import transcribe as ttr
from agentlib_mpc_torch.parallel import fused_admm as T
from agentlib_mpc_torch.utils.convert import fused_state_from_numpy

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-8
N = 5
DT = 300.0


def assert_tree_close(port, ref, rtol=RTOL, path="tree"):
    """Walk both trees by structure (NamedTuple fields, dict keys, tuple
    positions) and compare leaves: floats within ``rtol`` of the leaf's
    largest magnitude (NaN where NaN), integers and booleans exactly."""
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
    if isinstance(ref, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_tree_close(a, b, rtol, f"{path}[{i}]")
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


def run_both(jengine, jstate, jthetas, tengine, tstate, tthetas, **kw):
    jout = jengine.step(jstate, jthetas, **kw)
    tout = tengine.step(tstate, tthetas, **kw)
    return jax.tree.map(np.asarray, jout), tout


def assert_round_equal(jout, tout):
    (js, jtrajs, jst), (ts, ttrajs, tst) = jout, tout
    assert int(tst.iterations) == int(jst.iterations)
    assert bool(tst.converged) == bool(jst.converged)
    assert bool(tst.local_solves_ok) == bool(jst.local_solves_ok)
    assert_tree_close(ts, js, path="state")
    assert_tree_close(ttrajs, jtrajs, path="trajectories")
    assert_tree_close(tst, jst, path="stats")


# ---- models of both packages ---------------------------------------------------

def _tracker(base, ci, par, eq_cls, sub):
    class Tracker(base):
        inputs = [ci("u", 0.0, lb=-5.0, ub=5.0)]
        parameters = [par("a", 1.0)]

        def setup(self, v):
            eq = eq_cls()
            eq.objective = sub((v.u - v.a) ** 2, name="track")
            return eq

    return Tracker


def _two_channel(base, ci, par, eq_cls, sub):
    class TwoChannelTracker(base):
        inputs = [ci("u1", 0.0, lb=-5.0, ub=5.0),
                  ci("u2", 0.0, lb=-5.0, ub=5.0)]
        parameters = [par("a", 1.0), par("b", 0.0)]

        def setup(self, v):
            eq = eq_cls()
            eq.objective = (sub((v.u1 - v.a) ** 2, name="track1")
                            + sub((v.u2 - v.b) ** 2, name="track2"))
            return eq

    return TwoChannelTracker


JARGS = (JModel, jci, jpar, JEq, JSub)
TARGS = (Model, control_input, parameter, ModelEquations, SubObjective)


def jparams(ocp, **kw):
    return ocp.default_params(**{k: jnp.asarray(np.asarray(v, float))
                                 for k, v in kw.items()})


def tparams(ocp, **kw):
    return ocp.default_params(device="cpu", dtype=F64, **{
        k: torch.tensor(np.asarray(v, float), dtype=F64)
        for k, v in kw.items()})


def both_engines(build):
    """``build(pkg)`` returns (engine, thetas) for "j" and "t"."""
    return build("j"), build("t")


# ---- consensus trackers ----------------------------------------------------------

TARGETS = (0.0, 1.0, 5.0)


@pytest.fixture(scope="module")
def trackers():
    def build(pkg):
        jax_side = pkg == "j"
        tr, M, SO = (jtr, J, JSO) if jax_side else (ttr, T, TSO)
        ocp = tr(_tracker(*(JARGS if jax_side else TARGS))(), ["u"], N=N,
                 dt=DT, method="multiple_shooting")
        group = M.AgentGroup(
            name="trackers", ocp=ocp, n_agents=len(TARGETS),
            couplings={"shared_u": "u"},
            solver_options=SO(tol=1e-8, max_iter=40))
        opts = M.FusedADMMOptions(max_iterations=12, rho=0.2, abs_tol=1e-6,
                                  rel_tol=1e-5, penalty_change_threshold=2.0,
                                  penalty_change_factor=1.5)
        kw = {} if jax_side else {"device": "cpu"}
        engine = M.FusedADMM([group], opts, record_locals=True, **kw)
        par = jparams if jax_side else tparams
        thetas = M.stack_params([par(ocp, p=[a]) for a in TARGETS])
        return engine, [thetas]

    (je, jth), (te, tth) = both_engines(build)
    cold = run_both(je, je.init_state(jth), jth, te, te.init_state(tth),
                    tth)
    # warm: both start from the JAX package's shifted state
    jshift = je.shift_state(jax.tree.map(jnp.asarray, cold[0][0]))
    tshift = fused_state_from_numpy(jax.tree.map(np.asarray, jshift), "cpu",
                                    F64)
    warm = run_both(je, jshift, jth, te, tshift, tth)
    # a NaN warm start on lane 1, from the same state
    jbad = jshift._replace(w=(jshift.w[0].at[1].set(jnp.nan),))
    tbad = tshift._replace(w=(tshift.w[0].index_put(
        (torch.tensor([1]),), torch.tensor(float("nan"), dtype=F64)),))
    nan = run_both(je, jbad, jth, te, tbad, tth)
    return {"engines": (je, te), "cold": cold, "warm": warm, "nan": nan,
            "shift": (jshift, te.shift_state(cold[1][0]))}


@pytest.mark.parametrize("which", ["cold", "warm", "nan"])
def test_tracker_rounds_match_jax(trackers, which):
    jout, tout = trackers[which]
    assert_round_equal(jout, tout)


def test_tracker_routing_and_schedule(trackers):
    je, te = trackers["engines"]
    assert te.group_uses_qp == je.group_uses_qp == (True,)
    assert te.shared_trace
    assert trackers["cold"][1][2].coupling_locals["shared_u"].shape == \
        (12, len(TARGETS), N)


def test_tracker_shift_state_matches_jax(trackers):
    jshift, tshift = trackers["shift"]
    assert_tree_close(tshift, jax.tree.map(np.asarray, jshift), rtol=RTOL)


def test_tracker_penalty_adapts(trackers):
    """The residual-balancing penalty moved in the cold round (so the
    history comparison above covers vary_penalty in the loop)."""
    pen = trackers["cold"][1][2].penalty["shared_u"].numpy()
    ran = int(trackers["cold"][1][2].iterations)
    assert len(set(np.round(pen[:ran], 12))) > 1


def test_nan_warm_start_is_quarantined(trackers):
    _, (state, trajs, stats) = trackers["nan"]
    lane_q = stats.lane_quarantined[0].numpy()
    assert lane_q[1] >= 1 and lane_q[0] == lane_q[2] == 0
    assert lane_q.sum() == int(stats.quarantined.sum())
    for leaf in torch.utils._pytree.tree_leaves(state):
        assert bool(torch.isfinite(leaf).all())
    assert bool(torch.isfinite(trajs[0]["u"]).all())


# ---- exchange trackers ------------------------------------------------------------

@pytest.fixture(scope="module")
def exchange():
    def build(pkg):
        jax_side = pkg == "j"
        tr, M, SO = (jtr, J, JSO) if jax_side else (ttr, T, TSO)
        ocp = tr(_tracker(*(JARGS if jax_side else TARGS))(), ["u"], N=N,
                 dt=DT, method="multiple_shooting")
        group = M.AgentGroup(name="trackers", ocp=ocp, n_agents=2,
                             exchanges={"power": "u"},
                             solver_options=SO(tol=1e-8, max_iter=40))
        opts = M.FusedADMMOptions(max_iterations=50, rho=1.0, abs_tol=1e-6,
                                  rel_tol=1e-5)
        kw = {} if jax_side else {"device": "cpu"}
        engine = M.FusedADMM([group], opts, **kw)
        par = jparams if jax_side else tparams
        return engine, [M.stack_params([par(ocp, p=[2.0]),
                                        par(ocp, p=[-1.0])])]

    (je, jth), (te, tth) = both_engines(build)
    return run_both(je, je.init_state(jth), jth, te, te.init_state(tth),
                    tth)


def test_exchange_trackers_match_jax(exchange):
    jout, tout = exchange
    assert_round_equal(jout, tout)
    u = tout[1][0]["u"][:, :, 0].numpy()
    np.testing.assert_allclose(u.sum(axis=0), 0.0, atol=5e-3)
    np.testing.assert_allclose(u[0], 1.5, atol=5e-3)


# ---- consensus and exchange together, split schedule ---------------------------

@pytest.fixture(scope="module")
def mixed():
    def build(pkg):
        jax_side = pkg == "j"
        tr, M, SO = (jtr, J, JSO) if jax_side else (ttr, T, TSO)
        ocp = tr(_two_channel(*(JARGS if jax_side else TARGS))(),
                 ["u1", "u2"], N=N, dt=DT, method="multiple_shooting")
        cold = SO(tol=1e-8, max_iter=40)
        group = M.AgentGroup(
            name="duo", ocp=ocp, n_agents=2, couplings={"shared": "u1"},
            exchanges={"balance": "u2"}, solver_options=cold,
            # differs beyond budget and barrier: the split schedule
            warm_solver_options=cold._replace(tol=1e-6, max_iter=6),
            qp_fast_path="off")
        opts = M.FusedADMMOptions(max_iterations=25,
                                  rho={"shared": 1.5, "balance": 1.0},
                                  abs_tol=1e-6, rel_tol=1e-5)
        kw = {} if jax_side else {"device": "cpu"}
        engine = M.FusedADMM([group], opts, record_locals=True, **kw)
        par = jparams if jax_side else tparams
        thetas = M.stack_params([par(ocp, p=[1.0, 2.0]),
                                 par(ocp, p=[3.0, -1.0])])
        return engine, [thetas]

    (je, jth), (te, tth) = both_engines(build)
    out = run_both(je, je.init_state(jth), jth, te, te.init_state(tth), tth)
    return (je, te), out


def test_mixed_couplings_match_jax(mixed):
    (je, te), (jout, tout) = mixed
    assert not te.shared_trace
    assert te.group_uses_qp == je.group_uses_qp == (False,)
    assert_round_equal(jout, tout)
    stats = tout[2]
    assert set(stats.exchange_locals) == {"balance"}
    assert set(stats.coupling_locals) == {"shared"}


def test_mixed_couplings_reach_the_fixed_points(mixed):
    _, (_, (state, trajs, stats)) = mixed
    u = trajs[0]["u"].numpy()
    np.testing.assert_allclose(state.zbar["shared"].numpy(), 2.0, atol=5e-3)
    np.testing.assert_allclose(u[:, :, 1].sum(axis=0), 0.0, atol=1e-2)


# ---- the room/cooler pair: two groups, two transcriptions ----------------------

# ---- a padded fleet --------------------------------------------------------------
