"""The port's FusedADMM against the JAX package's, on the CPU in float64.

The same seeded fleets go through ``agentlib_mpc_tpu/parallel/
fused_admm.py`` and ``agentlib_mpc_torch/parallel/fused_admm.py``: the
room/cooler pair (two groups: collocation and multiple shooting, the
cooler routed to the QP) and a padded fleet against the unpadded one
(split from ``tests/test_torch_fused_admm.py``, which holds the trackers
and the mixed couplings). State, trajectories and
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

from agentlib_mpc_tpu.models import zoo as jzoo
from agentlib_mpc_tpu.models.model import Model as JModel
from agentlib_mpc_tpu.models.model import ModelEquations as JEq
from agentlib_mpc_tpu.models.objective import SubObjective as JSub
from agentlib_mpc_tpu.models.variables import control_input as jci
from agentlib_mpc_tpu.models.variables import parameter as jpar
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
from agentlib_mpc_tpu.parallel import fused_admm as J
from agentlib_mpc_torch.models import zoo as tzoo
from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.objective import SubObjective
from agentlib_mpc_torch.models.variables import control_input, parameter
from agentlib_mpc_torch.ops.solver import SolverOptions as TSO
from agentlib_mpc_torch.ops.transcription import transcribe as ttr
from agentlib_mpc_torch.parallel import fused_admm as T

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


# ---- exchange trackers ------------------------------------------------------------

# ---- consensus and exchange together, split schedule ---------------------------

# ---- the room/cooler pair: two groups, two transcriptions ----------------------

@pytest.fixture(scope="module")
def pair():
    def build(pkg):
        jax_side = pkg == "j"
        tr, M, SO, zoo = (jtr, J, JSO, jzoo) if jax_side else \
            (ttr, T, TSO, tzoo)
        so = SO(tol=1e-8, max_iter=40)
        room_ocp = tr(zoo.CooledRoom(overrides={"s_T": 0.1}), ["mDot"], N=N,
                      dt=DT, method="collocation", collocation_degree=2)
        cooler_ocp = tr(zoo.Cooler(overrides={"r_mDot": 0.01}), ["mDot"],
                        N=N, dt=DT, method="multiple_shooting")
        groups = [M.AgentGroup(name="room", ocp=room_ocp, n_agents=1,
                               couplings={"mDot": "mDot"}, solver_options=so),
                  M.AgentGroup(name="cooler", ocp=cooler_ocp, n_agents=1,
                               couplings={"mDot": "mDot"}, solver_options=so)]
        opts = M.FusedADMMOptions(max_iterations=30, rho=50.0, abs_tol=1e-5,
                                  rel_tol=1e-4)
        kw = {} if jax_side else {"device": "cpu"}
        engine = M.FusedADMM(groups, opts, **kw)
        par = jparams if jax_side else tparams
        thetas = [M.stack_params([par(
            room_ocp, x0=[298.15],
            d_traj=np.broadcast_to([150.0, 290.15, 295.15], (N, 3)))]),
            M.stack_params([par(cooler_ocp)])]
        return engine, thetas

    (je, jth), (te, tth) = both_engines(build)
    cold = run_both(je, je.init_state(jth), jth, te, te.init_state(tth),
                    tth)
    warm = run_both(je, je.shift_state(jax.tree.map(jnp.asarray,
                                                    cold[0][0])), jth,
                    te, te.shift_state(cold[1][0]), tth)
    return (je, te), cold, warm


def test_pair_routing_matches_jax(pair):
    (je, te), _, _ = pair
    assert te.group_uses_qp == je.group_uses_qp == (False, True)


@pytest.mark.parametrize("which", [1, 2], ids=["cold", "warm"])
def test_pair_rounds_match_jax(pair, which):
    jout, tout = pair[which]
    assert_round_equal(jout, tout)


def test_pair_agrees_and_cools(pair):
    _, (_, (state, trajs, stats)), _ = pair
    u_room = trajs[0]["u"][0, :, 0].numpy()
    u_cooler = trajs[1]["u"][0, :, 0].numpy()
    np.testing.assert_allclose(u_room, u_cooler, atol=1e-3)
    assert u_room[0] > 1e-3
    T_room = trajs[0]["x"][0, :, 0].numpy()
    assert T_room[-1] < T_room[0]


# ---- a padded fleet --------------------------------------------------------------

@pytest.fixture(scope="module")
def padded():
    targets = ((0.0, 1.0, 2.0), (5.0,))
    opts_kw = dict(max_iterations=30, rho=2.0, abs_tol=1e-6, rel_tol=1e-5)

    def build(pkg, pad):
        jax_side = pkg == "j"
        tr, M, SO = (jtr, J, JSO) if jax_side else (ttr, T, TSO)
        ocp = tr(_tracker(*(JARGS if jax_side else TARGS))(), ["u"], N=N,
                 dt=DT, method="multiple_shooting")
        par = jparams if jax_side else tparams
        groups, thetas, masks = [], [], []
        for name, tg in zip("ab", targets):
            g = M.AgentGroup(name=name, ocp=ocp, n_agents=len(tg),
                             couplings={"c": "u"},
                             solver_options=SO(tol=1e-8, max_iter=40))
            th = M.stack_params([par(ocp, p=[a]) for a in tg])
            if pad:
                g, th, mask = M.pad_group_to_devices(g, th, 4)
                masks.append(mask)
            groups.append(g)
            thetas.append(th)
        kw = {} if jax_side else {"device": "cpu"}
        engine = M.FusedADMM(groups, M.FusedADMMOptions(**opts_kw),
                             active=masks or None, **kw)
        return engine, thetas

    (je, jth) = build("j", True)
    (te, tth) = build("t", True)
    out = run_both(je, je.init_state(jth), jth, te, te.init_state(tth), tth)
    tu, tuth = build("t", False)
    unpadded = tu.step(tu.init_state(tuth), tuth)
    # the same padded engine with the padding lanes switched ON by a
    # per-call override: five real agents' mean
    on = te.step(te.init_state(tth), tth,
                 active=[torch.ones(4, dtype=torch.bool)] * 2)
    return out, unpadded, on


def test_padded_fleet_matches_jax(padded):
    (jout, tout), _, _ = padded
    assert_round_equal(jout, tout)


def test_padded_fleet_matches_unpadded(padded):
    (_, (state, _, stats)), (ustate, _, ustats), _ = padded
    assert bool(stats.converged) and bool(ustats.converged)
    np.testing.assert_allclose(state.zbar["c"].numpy(),
                               ustate.zbar["c"].numpy(), atol=1e-4)
    np.testing.assert_allclose(state.zbar["c"].numpy().mean(), 2.0,
                               atol=1e-2)


def test_active_override_changes_the_mean(padded):
    _, _, (state, _, _) = padded
    # lanes of group a: 0, 1, 2, 2 (pad); group b: 5, 5, 5, 5 (pads)
    np.testing.assert_allclose(state.zbar["c"].numpy().mean(),
                               np.mean([0, 1, 2, 2, 5, 5, 5, 5]), atol=1e-2)
