"""The port's scenario-tree metadata, tree KKT solve, tree-banded
derivatives and scenario generation against the JAX package's, on the CPU.

``agentlib_mpc_torch/scenario/{tree,generate}.py``, the ``tree_*``
functions of ``ops/stagejac.py``, ``resilience/chaos.disturbance_model``
and the two forecast-ensemble hooks, from the same numpy inputs:

* bitwise: the tree metadata, the tree partitions of the zone OCP and
  their coupling layouts, the synthetic tree systems, the disturbance
  draws (both kinds), ``scenario_thetas``/``ensemble_thetas`` and the
  forecast ensembles; the port's one-scenario tree solve against its own
  flat ``factor_kkt_stage``/``resolve_kkt_stage``, and its one-scenario
  ``tree_*`` derivatives against the flat calls;
* within 1e-10 relative (float64; the same eliminations, other reduction
  orders): ``solve_kkt_tree`` for a fan and a branching tree, and the
  ``tree_*`` derivative functions on three scenarios of the OneRoom OCP;
* the tree structure certificate's verdict and row count, and the probe.

On the CPU every factor and solve runs the plain LDLᵀ; ``chip_smoke.py``
holds the kernels against it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_tpu import scenario as J
from agentlib_mpc_tpu.ops import stagejac as jsj
from agentlib_mpc_tpu.resilience.chaos import disturbance_model as jdraws
from agentlib_mpc_tpu.scenario import generate as jgen
from agentlib_mpc_tpu.scenario import tree as jtree
from agentlib_mpc_torch import scenario as T
from agentlib_mpc_torch.ops import stagejac as tsj
from agentlib_mpc_torch.ops import stagewise as tsw
from agentlib_mpc_torch.resilience.chaos import disturbance_model
from agentlib_mpc_torch.scenario import generate as tgen
from agentlib_mpc_torch.scenario import tree as ttree

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-10

TREES = {
    "fan4_r1": lambda M: M.fan_tree(4, robust_horizon=1),
    "fan3_r0": lambda M: M.fan_tree(3, robust_horizon=0),
    "fan3_r2_weighted": lambda M: M.fan_tree(3, robust_horizon=2,
                                             probabilities=(0.5, 0.3, 0.2)),
    "branching_3x2": lambda M: M.branching_tree((3, 2)),
    "branching_4x2": lambda M: M.branching_tree((4, 2)),
    "single": lambda M: M.single_scenario(),
    "subtree": lambda M: M.branching_tree((3, 2)).subtree((0, 2, 3, 5)),
}


def _zone_pair(N=10):
    from agentlib_mpc_tpu.models.zoo import ZoneWithSupply as JZone
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
    from agentlib_mpc_torch.models.zoo import ZoneWithSupply as TZone
    from agentlib_mpc_torch.ops.transcription import transcribe as ttr

    kw = dict(N=N, dt=300.0, method="collocation", collocation_degree=2)
    return jtr(JZone(), ["mDot"], **kw), ttr(TZone(), ["mDot"], **kw)


@pytest.fixture(scope="module")
def zone():
    return _zone_pair()


def close(port, ref, rtol=RTOL, what=""):
    a = np.asarray(ref)
    b = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = np.max(np.abs(a)) if a.size else 0.0
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


# ---- tree metadata ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_metadata_matches_jax(name):
    jt, tt = TREES[name](J), TREES[name](T)
    assert tuple(tt) == tuple(jt)
    assert tt.robust_horizon == jt.robust_horizon
    for t in range(jt.robust_horizon):
        assert tt.groups_at(t) == jt.groups_at(t)
    assert hash(tt) == hash(tuple(tt))


BAD_TREES = {
    "probabilities_sum": lambda M: M.fan_tree(2, probabilities=(0.5, 0.4)),
    "probabilities_len": lambda M: M.fan_tree(2, probabilities=(1.0,)),
    "no_scenario": lambda M: M.ScenarioTree(0, (), ()).validate(),
    "node_len": lambda M: M.ScenarioTree(2, ((0,),), (0.5, 0.5)).validate(),
    "deep_horizon": lambda M: M.fan_tree(2, robust_horizon=5).validate(4),
    "factor": lambda M: M.branching_tree((2, 0)),
    "subtree_empty": lambda M: M.fan_tree(3).subtree(()),
    "subtree_order": lambda M: M.fan_tree(3).subtree((2, 1)),
    "subtree_range": lambda M: M.fan_tree(3).subtree((0, 3)),
}


@pytest.mark.parametrize("name", sorted(BAD_TREES))
def test_tree_validation_errors_match_jax(name):
    msgs = []
    for M in (J, T):
        with pytest.raises(ValueError) as err:
            BAD_TREES[name](M)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("name", ["fan4_r1", "fan3_r2_weighted",
                                  "branching_4x2", "single", "subtree"])
def test_partitions_and_coupling_layout_match_jax(zone, name):
    jocp, tocp = zone
    jtp = J.tree_partition_for_ocp(jocp, TREES[name](J))
    ttp = T.tree_partition_for_ocp(tocp, TREES[name](T))
    assert tuple(ttp.base) == tuple(jtp.base)
    assert ttp.na_indices == jtp.na_indices
    assert ttp.n_coupling_rows == jtp.n_coupling_rows
    for a, b in zip(ttree._coupling_layout(ttp), jtree._coupling_layout(jtp)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="non-primal"):
        T.build_tree_partition(ttp.base, TREES["fan4_r1"](T),
                               ((ttp.base.n_w,),))


# ---- the tree KKT solve --------------------------------------------------------

TREE_SHAPES = {"fan8_r1": lambda M: M.fan_tree(8, robust_horizon=1),
               "branching_4x2": lambda M: M.branching_tree((4, 2))}


@pytest.fixture(scope="module")
def tree_solves(zone):
    """Per tree: the synthetic system of both packages, the JAX solve and
    the port's (float64)."""
    jocp, tocp = zone
    out = {}
    for name, make in TREE_SHAPES.items():
        jtp = J.tree_partition_for_ocp(jocp, make(J))
        ttp = T.tree_partition_for_ocp(tocp, make(T))
        jK, jr = J.synthetic_tree_kkt(jtp, seed=3)
        tK, tr = T.synthetic_tree_kkt(ttp, seed=3)
        jx = jax.jit(lambda K, r, tp=jtp: J.solve_kkt_tree(K, r, tp))(
            jnp.asarray(jK), jnp.asarray(jr))
        jx0 = jax.jit(lambda K, r, tp=jtp: J.solve_kkt_tree(
            K, r, tp, delta_c=0.0))(jnp.asarray(jK), jnp.asarray(jr))
        Kt, rt = torch.tensor(tK, dtype=F64), torch.tensor(tr, dtype=F64)
        tx = T.solve_kkt_tree(Kt, rt, ttp)
        tx0 = T.solve_kkt_tree(Kt, rt, ttp, delta_c=0.0)
        out[name] = {"numpy": (jK, jr, tK, tr), "x": (np.asarray(jx), tx),
                     "x_exact": (np.asarray(jx0), tx0),
                     "tp": ttp, "K": Kt, "rhs": rt}
    return out


@pytest.mark.parametrize("name", sorted(TREE_SHAPES))
def test_synthetic_tree_systems_equal_jax(tree_solves, name):
    jK, jr, tK, tr = tree_solves[name]["numpy"]
    np.testing.assert_array_equal(tK, jK)
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("name", sorted(TREE_SHAPES))
def test_solve_kkt_tree_matches_jax(tree_solves, name):
    """With the default coupling regularization δ_c = 1e-8 (where A x
    equals δ_c·ν, not 0) and with δ_c = 0 (the exact coupled system, whose
    Schur complement is SPD on its own): equal to the JAX package's, and
    the exact system's residual at round-off."""
    case = tree_solves[name]
    for key in ("x", "x_exact"):
        jx, tx = case[key]
        close(tx, jx, what=f"{name} {key}")
    res = float(ttree.tree_kkt_residual(case["K"], case["rhs"],
                                        case["x_exact"][1], case["tp"]))
    assert res < 1e-10


def test_coupled_solve_pins_the_groups(tree_solves):
    """A x = 0: every scenario of a node group holds the same coupled
    controls, to round-off."""
    case = tree_solves["branching_4x2"]
    tp, x = case["tp"], case["x_exact"][1]
    for t in range(tp.tree.robust_horizon):
        for grp in tp.tree.groups_at(t):
            rows = x[list(grp)][:, list(tp.na_indices[t])]
            assert float((rows - rows[:1]).abs().max()) < 1e-12


def test_one_scenario_tree_solve_is_the_flat_solve(zone):
    _, tocp = zone
    tp = T.tree_partition_for_ocp(tocp, T.single_scenario())
    K, r = T.synthetic_tree_kkt(tp, seed=5)
    K, r = torch.tensor(K, dtype=F64), torch.tensor(r, dtype=F64)
    factor = T.factor_kkt_tree(K, tp)
    assert factor[1] is None and factor[2] is None
    x = T.resolve_kkt_tree(factor, r, tp)
    flat = tsw.resolve_kkt_stage(tsw.factor_kkt_stage(K, tp.base), r,
                                 tp.base)
    assert torch.equal(x, flat)


def test_tree_method_available_on_the_cpu(zone):
    _, tocp = zone
    tp = T.tree_partition_for_ocp(tocp, T.fan_tree(3, robust_horizon=1))
    for dtype in (torch.float32, F64):
        assert T.tree_method_available(tp, device="cpu", dtype=dtype)
        assert ttree._TREE_PROBE[("cpu", dtype, tp)] is True
    with pytest.raises(ValueError, match="scenarios"):
        T.factor_kkt_tree(torch.zeros((2, tp.base.n_total,
                                       tp.base.n_total), dtype=F64), tp)


# ---- certificate and tree-banded derivatives ------------------------------------

@pytest.fixture(scope="module")
def oneroom():
    """OneRoom by degree-2 collocation (N=5, dt 60 s) in both packages,
    three scenarios of it (x0 and the load per branch), the port's
    certified plan and the JAX plan built from its h rows."""
    from agentlib_mpc_tpu.models.zoo import OneRoom as JRoom
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
    from agentlib_mpc_torch.models.zoo import OneRoom as TRoom
    from agentlib_mpc_torch.ops.transcription import transcribe as ttr

    kw = dict(N=5, dt=60.0, method="collocation", collocation_degree=2)
    jocp, tocp = jtr(JRoom(), ["mDot"], **kw), ttr(TRoom(), ["mDot"], **kw)
    ttp = T.tree_partition_for_ocp(tocp, T.fan_tree(3, robust_horizon=1))
    tth = tocp.default_params(device="cpu", dtype=F64)
    cert = T.certify_tree_structure(tocp.nlp, tth, tocp.n_w, ttp)
    tplan = tsj.tree_plan_from_certificate(tocp.nlp, tth, tocp.n_w, ttp)
    jplan = jsj.build_stage_jacobian_plan(jocp.stage_partition,
                                          tplan.h_row_stages)
    x0s = np.array([[296.0], [298.5], [301.0]])
    jth = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jocp.default_params(x0=jnp.asarray(x)) for x in x0s])
    tthb = tgen.stack_scenario_params([
        tocp.default_params(device="cpu", dtype=F64,
                            x0=torch.tensor(x, dtype=F64)) for x in x0s])
    rng = np.random.default_rng(11)
    w = np.stack([np.asarray(jocp.initial_guess(jax.tree.map(
        lambda l, s=s: l[s], jth))) for s in range(3)])
    w = w * (1.0 + 0.01 * rng.standard_normal(w.shape))
    return {"jocp": jocp, "tocp": tocp, "jplan": jplan, "tplan": tplan,
            "cert": cert, "ttp": ttp, "jth": jth, "tth": tthb, "w": w,
            "tth1": tth}


def test_certify_tree_structure(oneroom):
    cert = oneroom["cert"]
    assert cert.ok
    assert (cert.n_scenarios, cert.robust_horizon, cert.n_coupling_rows) \
        == (3, 1, 2)
    assert "x 3 scenario branch(es), 2 non-anticipativity row(s)" in \
        cert.describe()
    tocp = oneroom["tocp"]
    assert oneroom["tplan"] is tsj.plan_from_certificate(
        tocp.nlp, oneroom["tth1"], tocp.n_w, tocp.stage_partition)


def _lagrangian_grads(jocp, tocp):
    """Branch-shared gradients of f + 0.3·Σg + 0.2·Σh in both packages."""
    def jgrad(w, th):
        return jax.grad(lambda ww: jocp.nlp.f(ww, th)
                        + 0.3 * jnp.sum(jocp.nlp.g(ww, th))
                        + 0.2 * jnp.sum(jocp.nlp.h(ww, th)))(w)

    def tgrad(w, th):
        return torch.func.grad(lambda ww: tocp.nlp.f(ww, th)
                               + 0.3 * tocp.nlp.g(ww, th).sum()
                               + 0.2 * tocp.nlp.h(ww, th).sum())(w)

    return jgrad, tgrad


def _tree_derivatives(oneroom, S):
    jocp, tocp = oneroom["jocp"], oneroom["tocp"]
    jplan, tplan = oneroom["jplan"], oneroom["tplan"]
    jth = jax.tree.map(lambda l: l[:S], oneroom["jth"])
    tth = tree_map(lambda l: l[:S], oneroom["tth"])
    w = oneroom["w"][:S]
    jfgh = lambda ww, th: jsj.stacked_fgh(jocp.nlp, th)(ww)
    tfgh = lambda ww, th: tsj.stacked_fgh(tocp.nlp, th)(ww)
    jgrad, tgrad = _lagrangian_grads(jocp, tocp)
    jw, tw = jnp.asarray(w), torch.tensor(w, dtype=F64)
    rng = np.random.default_rng(S)
    sigma = rng.uniform(0.5, 2.0, (S, jplan.m_h))
    wd = rng.uniform(0.1, 1.0, (S, jocp.n_w))

    @jax.jit
    def jax_side(w_, th, sg, wd_):
        out = jsj.tree_banded_fgh_jac(jplan, jfgh, w_, th)
        CH = jsj.tree_banded_lagrangian_hessian(jplan, jgrad, w_, th)
        D, E = jsj.tree_assemble_kkt_banded(jplan, CH, out[2], out[3], sg,
                                            wd_, 1e-8)
        return (*out, CH, D, E)

    jouts = jax_side(jw, jth, jnp.asarray(sigma), jnp.asarray(wd))
    tout = tsj.tree_banded_fgh_jac(tplan, tfgh, tw, tth)
    tCH = tsj.tree_banded_lagrangian_hessian(tplan, tgrad, tw, tth)
    tD, tE = tsj.tree_assemble_kkt_banded(
        tplan, tCH, tout[2], tout[3], torch.tensor(sigma, dtype=F64),
        torch.tensor(wd, dtype=F64), 1e-8)
    return jouts, (*tout, tCH, tD, tE), (tgrad, tfgh, tth, tw, sigma, wd)


NAMES = ("vals", "gf", "Jg_rows", "Jh_rows", "CH", "D", "E")


def test_tree_banded_derivatives_match_jax(oneroom):
    jouts, touts, _ = _tree_derivatives(oneroom, 3)
    for name, j, t in zip(NAMES, jouts, touts):
        assert t.shape[0] == 3
        close(t, j, what=name)


def test_one_scenario_tree_derivatives_are_the_flat_calls(oneroom):
    jouts, touts, (tgrad, tfgh, tth, tw, sigma, wd) = _tree_derivatives(
        oneroom, 1)
    plan = oneroom["tplan"]
    th0 = tree_map(lambda l: l[0], tth)
    flat = tsj.banded_fgh_jac(plan, lambda w: tfgh(w, th0), tw)
    CH = tsj.banded_lagrangian_hessian(plan, lambda w: tgrad(w, th0), tw)
    D, E = tsj.assemble_kkt_banded(
        plan, CH, flat[2], flat[3], torch.tensor(sigma, dtype=F64),
        torch.tensor(wd, dtype=F64), 1e-8)
    for name, a, b in zip(NAMES, touts, (*flat, CH, D, E)):
        assert torch.equal(a, b), name
    for name, j, t in zip(NAMES, jouts, touts):
        close(t, j, what=name)


# ---- scenario generation -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["gaussian", "walk"])
@pytest.mark.parametrize("nominal_first", [True, False])
def test_disturbance_model_matches_jax(kind, nominal_first):
    for args in ((7, 10, 4), (0, 96, 8), (123, 5, 1)):
        kw = dict(n_channels=2, scale=0.5, kind=kind,
                  nominal_first=nominal_first)
        np.testing.assert_array_equal(disturbance_model(*args, **kw),
                                      jdraws(*args, **kw))
    with pytest.raises(ValueError, match="unknown disturbance kind"):
        disturbance_model(0, 4, 2, kind="uniform")
    with pytest.raises(ValueError, match=">= 1"):
        disturbance_model(0, 4, 0)


def _zone_thetas(jocp, tocp):
    d = np.tile(np.array([150.0, 290.15, 294.15]), (jocp.N, 1))
    jth = jocp.default_params(x0=jnp.array([297.0]), d_traj=jnp.asarray(d))
    tth = tocp.default_params(device="cpu", dtype=F64,
                              x0=torch.tensor([297.0], dtype=F64),
                              d_traj=torch.tensor(d, dtype=F64))
    return jth, tth


def _assert_batch_equal(tb, jb):
    for f in jb._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


@pytest.mark.parametrize("kind", ["gaussian", "walk"])
def test_ensemble_thetas_match_jax(zone, kind):
    jocp, tocp = zone
    jth, tth = _zone_thetas(jocp, tocp)
    for make, channels in ((TREES["fan4_r1"], (0,)),
                           (TREES["branching_3x2"], (0, 2)),
                           (TREES["single"], (0,))):
        jb = jgen.ensemble_thetas(jth, make(J), seed=4, scale=22.5,
                                  channels=channels, kind=kind)
        tb = tgen.ensemble_thetas(tth, make(T), seed=4, scale=22.5,
                                  channels=channels, kind=kind)
        _assert_batch_equal(tb, jb)
        assert tb.d_traj.dtype == F64


def test_scenario_thetas_match_jax(zone):
    jocp, tocp = zone
    jth, tth = _zone_thetas(jocp, tocp)
    draws = np.random.default_rng(2).normal(size=(3, jocp.N, 2))
    jb = jgen.scenario_thetas(jth, J.fan_tree(3), draws, channels=(1, 2))
    tb = tgen.scenario_thetas(tth, T.fan_tree(3), draws, channels=(1, 2))
    _assert_batch_equal(tb, jb)
    one = tgen.scenario_thetas(tth, T.fan_tree(3), draws[:, :, 0])
    np.testing.assert_array_equal(
        one.d_traj[:, :, 0].numpy(),
        np.asarray(jgen.scenario_thetas(jth, J.fan_tree(3), draws[:, :, 0])
                   .d_traj)[:, :, 0])
    bad = {"scenarios": (draws[:2], None), "intervals": (draws[:, :3], None),
           "channel indices": (draws, (0,)), "outside d_traj": (draws, (0, 5))}
    for match, (dr, ch) in bad.items():
        msgs = []
        for gen, th, M in ((jgen, jth, J), (tgen, tth, T)):
            with pytest.raises(ValueError, match=match) as err:
                gen.scenario_thetas(th, M.fan_tree(3), dr, channels=ch)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


class _Host:
    """Minimal agent stand-in for the predictor module."""

    id = "weather"
    device = torch.device("cpu")
    dtype = F64

    class _Env:
        now = 0.0

    class _Broker:
        def register_callback(self, *a, **k):
            pass

        def send_variable(self, v):
            pass

    env = _Env()
    data_broker = _Broker()


@pytest.mark.parametrize("spread", [None, 0.7, {"T_amb": 0.4}])
def test_prediction_ensembles_match_jax(spread):
    from agentlib_mpc_tpu.modules.input_prediction import InputPredictor as JP
    from agentlib_mpc_torch.modules.input_prediction import (
        InputPredictor as TP,
    )

    table = {"T_amb": {float(t): 280.0 + t / 100.0
                       for t in range(0, 7200, 600)},
             "flat": {float(t): 3.0 for t in range(0, 7200, 600)}}
    cfg = {"module_id": "weather", "data": table, "t_sample": 600,
           "prediction_horizon": 1800, "prediction_sample": 600}
    ref = JP(dict(cfg), _Host()).get_prediction_ensemble_at_time(
        1200.0, 5, seed=3, spread=spread)
    port = TP(dict(cfg), _Host()).get_prediction_ensemble_at_time(
        1200.0, 5, seed=3, spread=spread)
    assert sorted(port) == sorted(ref) == ["T_amb", "flat"]
    for c in ref:
        assert port[c][0] == ref[c][0]
        np.testing.assert_array_equal(port[c][1], ref[c][1])
    assert np.any(np.asarray(port["T_amb"][1])[1:]
                  != np.asarray(port["T_amb"][1])[0])


def test_try_forecast_ensembles_match_jax():
    import pandas as pd

    from agentlib_mpc_tpu.utils.try_format import try_forecast_ensemble as jf
    from agentlib_mpc_torch.utils.try_format import try_forecast_ensemble

    idx = np.arange(24) * 3600.0
    df = pd.DataFrame({"T_oda": 273.15 + 10 * np.sin(idx / 7e3)}, index=idx)
    for kw in ({}, {"spread": 0.3}, {"dt": 1800.0}):
        np.testing.assert_array_equal(
            try_forecast_ensemble(df, "T_oda", 3600.0, 6, 4, seed=2, **kw),
            jf(df, "T_oda", 3600.0, 6, 4, seed=2, **kw))
    with pytest.raises(KeyError, match="not in the TRY table"):
        try_forecast_ensemble(df, "nope", 0.0, 4, 2)
