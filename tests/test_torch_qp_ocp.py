"""The port's Mehrotra QP fast path against the JAX package's ``solve_qp``.

The linear OCP (``LinearRCZone``, degree-2 collocation) goes through both
packages in float64 on the CPU from the same numpy inputs: the iteration
counts and the success flag must be equal and w, y, z agree to 1e-8
absolute (the port's "ldl" path is the plain LDLᵀ on the CPU, the JAX
side pivoted LU, both refined). The sparse pipeline (banded extraction,
banded stage factor) is held against LU the same way, the LQ probe of
both packages on the transcriptions, and the QP against the NLP solver on
the linear MPC problem (the JAX package's ``--qp-ab`` agreement,
``tests/test_qp.py:276``). Split from ``tests/test_torch_qp.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_tpu.ops import qp as jqp
from agentlib_mpc_tpu.ops import solver as jsolver
from agentlib_mpc_tpu.ops import stagejac as jsj
from agentlib_mpc_torch.ops import qp as tqp
from agentlib_mpc_torch.ops import solver as tsolver
from agentlib_mpc_torch.ops import stagejac as tsj
from agentlib_mpc_torch.utils.convert import stage_partition_from_fields

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
ATOL = 1e-8


def _assert_same(jres, tres, lane=0, atol=ATOL):
    assert int(tres.stats.iterations[lane]) == int(jres.stats.iterations)
    assert bool(tres.stats.success[lane]) == bool(jres.stats.success)
    for name in ("w", "y", "z", "s"):
        a = np.asarray(getattr(jres, name))
        b = getattr(tres, name)[lane].numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=atol * max(
            1.0, np.abs(a).max(initial=0.0)), err_msg=name)
    np.testing.assert_allclose(float(tres.stats.objective[lane]),
                               float(jres.stats.objective), rtol=1e-10)


# --------------------------------------------------------------------------
# the linear OCP: dense, sparse, forced stage, against the NLP solver
# --------------------------------------------------------------------------

def _linear_pair(N=8, **kw):
    from agentlib_mpc_tpu.models.zoo import LinearRCZone as JLin
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtranscribe
    from agentlib_mpc_torch.models.zoo import LinearRCZone as TLin
    from agentlib_mpc_torch.ops.transcription import transcribe

    kw = dict(method="collocation", collocation_degree=2, **kw)
    return (jtranscribe(JLin(), ["Q"], N=N, dt=300.0, **kw),
            transcribe(TLin(), ["Q"], N=N, dt=300.0, **kw))


def _lane(t):
    return tree_map(lambda x: x[None] if isinstance(x, torch.Tensor) else x,
                    t)


@pytest.fixture(scope="module")
def linear8():
    jocp, tocp = _linear_pair()
    jth = jocp.default_params()
    tth = tocp.default_params(device="cpu", dtype=F64)
    jb, tb = jocp.bounds(jth), tocp.bounds(tth)
    return (jocp, jth, jocp.initial_guess(jth), jb), \
        (tocp, tth, tocp.initial_guess(tth), tb)


def _tsolve(tside, opts, **kw):
    tocp, tth, tw0, (tlb, tub) = tside
    return tqp.solve_qp(tocp.nlp, tw0[None], _lane(tth), tlb[None],
                        tub[None], opts, **kw)


@pytest.fixture(scope="module")
def linear8_lu(linear8):
    jocp, jth, jw0, (jlb, jub) = linear8[0]
    return jqp.solve_qp(jocp.nlp, jw0, jth, jlb, jub,
                        jsolver.SolverOptions(tol=1e-8, max_iter=60,
                                              kkt_method="lu"))


@pytest.mark.parametrize("method", ["lu", "ldl", "stage"])
def test_linear_ocp_dense_matches_jax(linear8, linear8_lu, method):
    tocp = linear8[1][0]
    opts = tsolver.attach_stage_partition(
        tsolver.SolverOptions(tol=1e-8, max_iter=60, kkt_method=method),
        tocp.stage_partition)
    tres = _tsolve(linear8[1], opts)
    assert tsolver.KKT_PATHS[tres.stats.kkt_path] == method
    assert tsolver.JAC_PATHS[tres.stats.jac_path] == "dense"
    _assert_same(linear8_lu, tres)


def test_linear_ocp_sparse_matches_jax_lu_and_jax_sparse(linear8,
                                                         linear8_lu):
    """Banded extraction + banded stage factor against the JAX package's
    dense LU QP, and against the JAX package's own sparse QP on the same
    plan (the JAX plan built from the port's certified h_row_stages)."""
    jocp, jth, jw0, (jlb, jub) = linear8[0]
    tocp, tth = linear8[1][0], linear8[1][1]
    plan = tsj.plan_from_certificate(tocp.nlp, tth, tocp.n_w,
                                     tocp.stage_partition)
    assert plan is not None
    opts = tsolver.attach_jacobian_plan(tsolver.attach_stage_partition(
        tsolver.SolverOptions(tol=1e-8, max_iter=60, jacobian="sparse"),
        tocp.stage_partition), plan)
    tres = _tsolve(linear8[1], opts)
    assert tsolver.JAC_PATHS[tres.stats.jac_path] == "sparse"
    assert tsolver.KKT_PATHS[tres.stats.kkt_path] == "stage"
    _assert_same(linear8_lu, tres)
    jplan = jsj.build_stage_jacobian_plan(jocp.stage_partition,
                                          plan.h_row_stages)
    assert stage_partition_from_fields(jocp.stage_partition) == \
        tocp.stage_partition
    jopts = jsolver.attach_jacobian_plan(jsolver.attach_stage_partition(
        jsolver.SolverOptions(tol=1e-8, max_iter=60, jacobian="sparse"),
        jocp.stage_partition), jplan)
    _assert_same(jqp.solve_qp(jocp.nlp, jw0, jth, jlb, jub, jopts), tres)


@pytest.mark.parametrize("N", [6, 8])
def test_forced_stage_tiny_sizes_converge_and_match_lu(N):
    """The JAX package's TestForcedStageTinySizes: the forced pivot-free
    stage path at tiny sizes terminates with an honest verdict and the LU
    optimum (direction-health guard + Levenberg delta + stall exit)."""
    _, tocp = _linear_pair(N)
    th = tocp.default_params(device="cpu", dtype=F64)
    side = (tocp, th, tocp.initial_guess(th), tocp.bounds(th))
    results = {}
    for method in ("lu", "stage"):
        opts = tsolver.SolverOptions(tol=1e-6, max_iter=60,
                                     kkt_method=method,
                                     stage_partition=tocp.stage_partition)
        res = _tsolve(side, opts)
        assert bool(res.stats.success[0]), method
        assert int(res.stats.iterations[0]) < 50
        results[method] = res
    np.testing.assert_allclose(results["stage"].w.numpy(),
                               results["lu"].w.numpy(), atol=1e-4)


def test_is_lq_matches_jax_on_transcriptions():
    from agentlib_mpc_tpu.models.zoo import OneRoom as JOne
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtranscribe
    from agentlib_mpc_torch.models.zoo import OneRoom as TOne
    from agentlib_mpc_torch.ops.transcription import transcribe

    jlin, tlin = _linear_pair(4)
    jone = jtranscribe(JOne(), ["mDot"], N=4, dt=300.0)
    tone = transcribe(TOne(), ["mDot"], N=4, dt=300.0)
    for jocp, tocp, expected in ((jlin, tlin, True), (jone, tone, False)):
        got = tqp.is_lq(tocp.nlp, tocp.default_params(device="cpu",
                                                      dtype=F64), tocp.n_w)
        ref = jqp.is_lq(jocp.nlp, jocp.default_params(), jocp.n_w)
        assert got == ref == expected


def test_f32_probe_runs_in_f64():
    """The probe's verdict does not depend on the solve's dtype: f32
    parameters are probed in float64 with float64 tolerances."""
    _, tlin = _linear_pair(4)
    th = tlin.default_params(device="cpu", dtype=torch.float32)
    assert tqp.is_lq(tlin.nlp, th, tlin.n_w)


def test_qp_and_nlp_agree_on_lq_mpc(linear8):
    """The JAX package's --qp-ab agreement (tests/test_qp.py:276): the same
    LQ MPC problem through both inner solvers, 1 mW on a 500 W scale."""
    tocp = linear8[1][0]
    opts = tsolver.SolverOptions(tol=1e-6, max_iter=60, kkt_method="ldl")
    rq = _tsolve(linear8[1], opts)
    tth, tw0, (tlb, tub) = linear8[1][1:]
    rn = tsolver.solve_nlp_batched(tocp.nlp, tw0[None], _lane(tth),
                                   tlb[None], tub[None], opts)
    assert bool(rq.stats.success[0]) and bool(rn.stats.success[0])
    np.testing.assert_allclose(tocp.unflatten(rq.w)["u"].numpy(),
                               tocp.unflatten(rn.w)["u"].numpy(), atol=1e-3)
    scale = max(1.0, abs(float(rn.stats.objective[0])))
    assert abs(float(rq.stats.objective[0])
               - float(rn.stats.objective[0])) < 1e-5 * scale
