"""The port's Mehrotra QP fast path against the JAX package's ``solve_qp``.

Random convex QPs (the construction of ``tests/test_qp.py``) go through
both packages in float64 on the CPU from the same numpy inputs: the
iteration counts and the success flag must be equal and w, y, z agree to
1e-8 absolute (the two solvers run the same algorithm; the port's "ldl"
path is the plain LDLᵀ on the CPU, the JAX side pivoted LU, both
refined), and the batch-first loop agrees with lane-by-lane solves. The
linear OCP's cases are in ``tests/test_torch_qp_ocp.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_tpu.ops import qp as jqp
from agentlib_mpc_tpu.ops import solver as jsolver
from agentlib_mpc_torch.ops import qp as tqp
from agentlib_mpc_torch.ops import solver as tsolver

from _torch_threads import one_torch_thread  # noqa: F401

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
