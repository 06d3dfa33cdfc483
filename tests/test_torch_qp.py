"""The port's Mehrotra QP fast path against the JAX package's ``solve_qp``.

Random convex QPs (the construction of ``tests/test_qp.py``) and the
linear OCP (``LinearRCZone``, degree-2 collocation) go through both
packages in float64 on the CPU from the same numpy inputs: the iteration
counts and the success flag must be equal and w, y, z agree to 1e-8
absolute (the two solvers run the same algorithm; the port's "ldl" path is
the plain LDLᵀ on the CPU, the JAX side pivoted LU, both refined). The
sparse pipeline (banded extraction, banded stage factor) is held against
LU the same way, the batch-first loop against lane-by-lane solves, and the
QP against the NLP solver on the linear MPC problem (the JAX package's
``--qp-ab`` agreement, ``tests/test_qp.py:276``).
"""

import jax.numpy as jnp
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

F64 = torch.float64
ATOL = 1e-8
OPTS = dict(tol=1e-8, max_iter=60)


def _random_qp(rng, n, m_eq, m_in):
    A = rng.normal(size=(n, n))
    Q = A @ A.T + n * np.eye(n)
    c = rng.normal(size=n) * 2.0
    lb = -1.0 - rng.random(n)
    ub = 1.0 + rng.random(n)
    x_feas = lb + (ub - lb) * rng.random(n)
    Aeq = rng.normal(size=(m_eq, n)) if m_eq else np.zeros((0, n))
    beq = Aeq @ x_feas
    G = rng.normal(size=(m_in, n)) if m_in else np.zeros((0, n))
    hvec = G @ x_feas - rng.random(m_in) if m_in else np.zeros(0)
    J = jnp.asarray
    jnlp = jsolver.NLPFunctions(
        f=lambda w, t: 0.5 * w @ J(Q) @ w + J(c) @ w,
        g=lambda w, t: J(Aeq) @ w - J(beq),
        h=lambda w, t: J(G) @ w - J(hvec))
    T = lambda a: torch.as_tensor(a, dtype=F64)
    tnlp = tsolver.NLPFunctions(
        f=lambda w, t: 0.5 * w @ (T(Q) @ w) + T(c) @ w,
        g=lambda w, t: T(Aeq) @ w - T(beq),
        h=lambda w, t: T(G) @ w - T(hvec))
    return jnlp, tnlp, lb, ub, x_feas


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


@pytest.mark.parametrize("n,m_eq,m_in", [(4, 0, 0), (8, 3, 0), (8, 0, 4),
                                         (12, 4, 5)])
@pytest.mark.parametrize("method", ["lu", "ldl"])
def test_random_qps_match_jax(n, m_eq, m_in, method):
    rng = np.random.default_rng(1000 * n + 10 * m_eq + m_in)
    for _ in range(3):
        jnlp, tnlp, lb, ub, x = _random_qp(rng, n, m_eq, m_in)
        jres = jqp.solve_qp(jnlp, jnp.asarray(x), None, jnp.asarray(lb),
                            jnp.asarray(ub),
                            jsolver.SolverOptions(kkt_method="lu", **OPTS))
        tres = tqp.solve_qp(
            tnlp, torch.as_tensor(x)[None], None, torch.as_tensor(lb)[None],
            torch.as_tensor(ub)[None],
            tsolver.SolverOptions(kkt_method=method, **OPTS))
        assert bool(tres.stats.success[0])
        _assert_same(jres, tres)


def test_batch_equals_lane_by_lane():
    """Per-lane freezing: lanes that finish at different iterations give
    exactly what each gives alone."""
    rng = np.random.default_rng(7)
    n = 6
    A = rng.normal(size=(n, n))
    Q = torch.as_tensor(A @ A.T + n * np.eye(n))
    cs = torch.as_tensor(rng.normal(size=(4, n)) * np.array(
        [[0.1], [1.0], [3.0], [10.0]]))
    nlp = tsolver.NLPFunctions(
        f=lambda w, c: 0.5 * w @ (Q @ w) + c @ w,
        g=lambda w, c: w[:0] * 0.0, h=lambda w, c: w[:2] + 1.0)
    lb, ub = -torch.ones(4, n, dtype=F64), torch.ones(4, n, dtype=F64)
    w0 = torch.zeros(4, n, dtype=F64)
    opts = tsolver.SolverOptions(kkt_method="ldl", **OPTS)
    batched = tqp.solve_qp(nlp, w0, cs, lb, ub, opts)
    assert len(set(batched.stats.iterations.tolist())) > 1
    for k in range(4):
        one = tqp.solve_qp(nlp, w0[k:k + 1], cs[k:k + 1], lb[k:k + 1],
                           ub[k:k + 1], opts)
        assert int(one.stats.iterations[0]) == \
            int(batched.stats.iterations[k])
        for name in ("w", "y", "z"):
            np.testing.assert_allclose(getattr(batched, name)[k].numpy(),
                                       getattr(one, name)[0].numpy(),
                                       rtol=0, atol=1e-12)


def test_warm_budget_override():
    rng = np.random.default_rng(5)
    _, tnlp, lb, ub, x = _random_qp(rng, 6, 0, 3)
    args = (tnlp, torch.as_tensor(x)[None], None, torch.as_tensor(lb)[None],
            torch.as_tensor(ub)[None], tsolver.SolverOptions(**OPTS))
    full = tqp.solve_qp(*args)
    budget2 = tqp.solve_qp(*args, max_iter=2)
    assert int(budget2.stats.iterations[0]) <= 2 < \
        int(full.stats.iterations[0])
    resumed = tqp.solve_qp(tnlp, budget2.w, None, args[3], args[4],
                           args[5], y0=budget2.y, z0=budget2.z)
    np.testing.assert_allclose(resumed.w.numpy(), full.w.numpy(), atol=2e-6)


@pytest.mark.parametrize("precision", ["mixed", "require"])
def test_unported_precision_raises(precision):
    rng = np.random.default_rng(3)
    _, tnlp, lb, ub, x = _random_qp(rng, 4, 0, 0)
    with pytest.raises(NotImplementedError):
        tqp.solve_qp(tnlp, torch.as_tensor(x)[None], None,
                     torch.as_tensor(lb)[None], torch.as_tensor(ub)[None],
                     tsolver.SolverOptions(precision=precision))


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
