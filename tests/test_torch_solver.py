"""The port's interior-point solver against the JAX package's ``solve_nlp``.

Problems from ``tests/test_solver.py`` and
``tests/test_solver_robustness.py``, written once per framework, solved in
float64 on the CPU with both KKT paths ("ldl": the plain LDLᵀ versions on
the CPU; "lu": pivoted LU). The two solvers run the same algorithm, so the
iteration counts and the success flag must be equal and the iterates agree
to 1e-7 relative (round-off of the two frameworks' reductions, amplified
by at most a few tens of Newton steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.ops import solver as jsolver
from agentlib_mpc_torch.ops import solver as tsolver

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
BIG = 1e6
RTOL = 1e-7


class _JaxNS:
    stack = staticmethod(jnp.stack)

    @staticmethod
    def const(a):
        return jnp.asarray(a)


class _TorchNS:
    stack = staticmethod(torch.stack)

    @staticmethod
    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=F64)


def _none(w, t):
    return w[:0] * 0.0


def hs071(xp):
    return dict(
        f=lambda w, t: w[0] * w[3] * (w[0] + w[1] + w[2]) + w[2],
        g=lambda w, t: xp.stack([(w ** 2).sum() - 40.0]),
        h=lambda w, t: xp.stack([w[0] * w[1] * w[2] * w[3] - 25.0]),
    ), [1.0, 5.0, 5.0, 1.0], [1.0] * 4, [5.0] * 4


def equality_qp(xp):
    return dict(f=lambda w, t: (w ** 2).sum(),
                g=lambda w, t: xp.stack([w[0] + w[1] - 1.0]), h=_none), \
        [3.0, -2.0], [-BIG] * 2, [BIG] * 2


def rosenbrock_disc(xp):
    return dict(
        f=lambda w, t: (1 - w[0]) ** 2 + 100 * (w[1] - w[0] ** 2) ** 2,
        g=_none, h=lambda w, t: xp.stack([1.5 - w[0] ** 2 - w[1] ** 2]),
    ), [-1.0, 1.0], [-BIG] * 2, [BIG] * 2


def active_box_bound(xp):
    return dict(f=lambda w, t: ((w - 1.0) ** 2).sum(), g=_none, h=_none), \
        [5.0], [2.0], [BIG]


def infeasible_start(xp):
    return dict(f=lambda w, t: (w ** 2).sum(), g=_none,
                h=lambda w, t: xp.stack([w[0] + w[1] - 2.0])), \
        [-5.0, -5.0], [-BIG] * 2, [BIG] * 2


def _qp(xp, Q, c, Aeq=None, beq=None):
    Qx, cx = xp.const(Q), xp.const(c)
    if Aeq is None:
        g = _none
    else:
        Ax, bx = xp.const(Aeq), xp.const(beq)
        g = lambda w, t: Ax @ w - bx
    return dict(f=lambda w, t: 0.5 * w @ (Qx @ w) + cx @ w, g=g, h=_none)


def licq_duplicated(xp):
    rng = np.random.default_rng(0)
    n = 6
    M = rng.normal(size=(n, n))
    a = rng.normal(size=(1, n))
    return _qp(xp, M @ M.T + n * np.eye(n), rng.normal(size=n),
               np.vstack([a, a, a]), np.ones(3)), \
        [0.0] * n, [-10.0] * n, [10.0] * n


def brutal_scaling(xp):
    scales = np.array([1e-4, 1.0, 1e4])
    return _qp(xp, np.diag(scales), -scales * np.array([1.0, 2.0, 3.0])), \
        [0.1] * 3, [-10.0] * 3, [10.0] * 3


def contradictory_equalities(xp):
    return _qp(xp, np.eye(2), np.zeros(2), np.array([[1.0, 1.0]] * 2),
               np.array([0.0, 1.0])), [0.0, 0.0], [-5.0] * 2, [5.0] * 2


PROBLEMS = [hs071, equality_qp, rosenbrock_disc, active_box_bound,
            infeasible_start, licq_duplicated, brutal_scaling,
            contradictory_equalities]


def _solve_both(problem, opts_kw, w0=None, **kw):
    jfns, w0_, lb, ub = problem(_JaxNS)
    tfns, _, _, _ = problem(_TorchNS)
    w0 = w0_ if w0 is None else w0
    jres = jsolver.solve_nlp(
        jsolver.NLPFunctions(**jfns), jnp.asarray(w0), None,
        jnp.asarray(lb), jnp.asarray(ub), jsolver.SolverOptions(**opts_kw),
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    tres = tsolver.solve_nlp(
        tsolver.NLPFunctions(**tfns), torch.as_tensor(w0, dtype=F64), None,
        torch.as_tensor(lb, dtype=F64), torch.as_tensor(ub, dtype=F64),
        tsolver.SolverOptions(**opts_kw),
        **{k: torch.as_tensor(v, dtype=F64) if isinstance(v, np.ndarray)
           else v for k, v in kw.items()})
    return jres, tres


def _assert_same(jres, tres, rtol=RTOL):
    assert int(tres.stats.iterations) == int(jres.stats.iterations)
    assert bool(tres.stats.success) == bool(jres.stats.success)
    for name in ("w", "y", "z", "s"):
        a = np.asarray(getattr(jres, name))
        b = getattr(tres, name).numpy()
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(a).max(
                                       initial=0.0)), err_msg=name)
    np.testing.assert_allclose(float(tres.stats.objective),
                               float(jres.stats.objective), rtol=rtol,
                               atol=rtol)


@pytest.mark.parametrize("kkt_method", ["ldl", "lu"])
@pytest.mark.parametrize("problem", PROBLEMS, ids=lambda p: p.__name__)
def test_solve_nlp_matches_jax(problem, kkt_method):
    jres, tres = _solve_both(problem, dict(tol=1e-8, max_iter=120,
                                           kkt_method=kkt_method))
    _assert_same(jres, tres)
    assert tres.stats.kkt_path == tsolver.KKT_PATHS.index(kkt_method)


@pytest.mark.parametrize("problem", [hs071, rosenbrock_disc],
                         ids=lambda p: p.__name__)
def test_corrector_and_warm_start_match_jax(problem):
    """Mehrotra corrector, a traced budget, mu0 and dual warm starts."""
    jfns, w0, lb, ub = problem(_JaxNS)
    m_e = int(np.asarray(jfns["g"](jnp.asarray(w0), None)).shape[0])
    m_h = int(np.asarray(jfns["h"](jnp.asarray(w0), None)).shape[0])
    jres, tres = _solve_both(
        problem, dict(tol=1e-8, max_iter=40, corrector=True,
                      kkt_method="ldl"),
        y0=np.full(m_e, 0.3), z0=np.full(m_h, 0.2), mu0=1e-2, max_iter=7)
    _assert_same(jres, tres)


def test_fused_line_search_jacobian_walks_the_same_iterates():
    tfns, w0, lb, ub = hs071(_TorchNS)
    args = (tsolver.NLPFunctions(**tfns), torch.as_tensor(w0, dtype=F64),
            None, torch.as_tensor(lb, dtype=F64),
            torch.as_tensor(ub, dtype=F64))
    base = tsolver.SolverOptions(tol=1e-6, kkt_method="lu")
    off = tsolver.solve_nlp(*args, base._replace(fused_ls_jacobian="off"))
    on = tsolver.solve_nlp(*args, base._replace(fused_ls_jacobian="on"))
    assert bool(off.stats.success) and bool(on.stats.success)
    assert int(off.stats.iterations) == int(on.stats.iterations)
    np.testing.assert_allclose(on.w.numpy(), off.w.numpy(), atol=1e-9)


def test_batched_lanes_finishing_at_different_iterations():
    """The batch-first loop freezes a finished lane exactly as the JAX
    package's vmapped while loop does: per-lane iteration counts and
    iterates equal the vmapped reference, and equal the per-lane solves."""
    jfns, _, lb, ub = hs071(_JaxNS)
    tfns, _, _, _ = hs071(_TorchNS)
    w0s = np.array([[1.0, 5.0, 5.0, 1.0], [2.0, 4.0, 4.0, 2.0],
                    [1.5, 4.5, 4.0, 1.2], [3.0, 3.0, 3.0, 3.0]])
    opts = dict(tol=1e-8, max_iter=60, kkt_method="ldl")
    jopts = jsolver.SolverOptions(**opts)
    jres = jax.vmap(lambda w0: jsolver.solve_nlp(
        jsolver.NLPFunctions(**jfns), w0, None, jnp.asarray(lb),
        jnp.asarray(ub), jopts))(jnp.asarray(w0s))
    B = len(w0s)
    tres = tsolver.solve_nlp_batched(
        tsolver.NLPFunctions(**tfns), torch.as_tensor(w0s, dtype=F64), None,
        torch.as_tensor(lb, dtype=F64).expand(B, 4),
        torch.as_tensor(ub, dtype=F64).expand(B, 4),
        tsolver.SolverOptions(**opts))
    iters = np.asarray(jres.stats.iterations)
    assert len(set(iters.tolist())) > 1, "lanes must finish apart"
    np.testing.assert_array_equal(tres.stats.iterations.numpy(), iters)
    np.testing.assert_array_equal(tres.stats.success.numpy(),
                                  np.asarray(jres.stats.success))
    for name in ("w", "y", "z"):
        a = np.asarray(getattr(jres, name))
        np.testing.assert_allclose(getattr(tres, name).numpy(), a,
                                   rtol=RTOL, atol=RTOL * np.abs(a).max())
    for i in range(B):
        single = tsolver.solve_nlp(
            tsolver.NLPFunctions(**tfns), torch.as_tensor(w0s[i], dtype=F64),
            None, torch.as_tensor(lb, dtype=F64),
            torch.as_tensor(ub, dtype=F64), tsolver.SolverOptions(**opts))
        assert int(single.stats.iterations) == int(iters[i])
        np.testing.assert_allclose(single.w.numpy(), tres.w[i].numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("override,exc", [
    ({"kkt_method": "stage"}, ValueError),
    # ported: forced without a certified plan it is refused as in the JAX
    # package (tests/test_torch_stagejac.py covers the rest of the chain)
    ({"jacobian": "sparse"}, ValueError),
    ({"precision": "mixed"}, NotImplementedError),
    ({"precision": "require"}, NotImplementedError),
    ({"fusion": "require"}, NotImplementedError),
    ({"fused_ls_jacobian": True}, ValueError),
    ({"precision": "bf16"}, ValueError),
])
def test_unported_options_raise(override, exc):
    tfns, w0, lb, ub = equality_qp(_TorchNS)
    with pytest.raises(exc):
        tsolver.solve_nlp(tsolver.NLPFunctions(**tfns),
                          torch.as_tensor(w0, dtype=F64), None,
                          torch.as_tensor(lb, dtype=F64),
                          torch.as_tensor(ub, dtype=F64),
                          tsolver.SolverOptions(**override))


def test_auto_options_resolve_as_off_tpu():
    """On the CPU "auto" is LU, full precision, dense derivatives, and the
    solver leaves the caller's TF32 setting as it found it."""
    tfns, w0, lb, ub = equality_qp(_TorchNS)
    prev = torch.backends.cuda.matmul.allow_tf32
    res = tsolver.solve_nlp(tsolver.NLPFunctions(**tfns),
                            torch.as_tensor(w0, dtype=F64), None,
                            torch.as_tensor(lb, dtype=F64),
                            torch.as_tensor(ub, dtype=F64))
    assert torch.backends.cuda.matmul.allow_tf32 == prev
    assert res.stats.kkt_path == tsolver.KKT_PATHS.index("lu")
    assert res.stats.precision_path == tsolver.PRECISION_PATHS.index("full")
    assert res.stats.jac_path == tsolver.JAC_PATHS.index("dense")
    np.testing.assert_allclose(res.w.numpy(), [0.5, 0.5], atol=1e-6)


def _zone_problem(N, method="collocation"):
    """The zone OCP at horizon N (dt 900 s) in both packages, with one
    zone's parameters made in numpy: (jax ocp, port ocp, jax theta, port
    theta)."""
    from agentlib_mpc_tpu.models.zoo import ZoneWithSupply as JZone
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtranscribe
    from agentlib_mpc_torch.models.zoo import ZoneWithSupply as TZone
    from agentlib_mpc_torch.ops.transcription import transcribe
    from agentlib_mpc_torch.utils.convert import ocp_params_from_numpy

    kw = {"collocation_degree": 2} if method == "collocation" else {}
    jocp = jtranscribe(JZone(), ["mDot"], N=N, dt=900.0, method=method, **kw)
    tocp = transcribe(TZone(), ["mDot"], N=N, dt=900.0, method=method, **kw)
    rng = np.random.default_rng(N)
    d = np.stack([rng.uniform(80.0, 250.0, size=N), np.full(N, 290.15),
                  np.full(N, 294.15)], -1)
    jth = jocp.default_params(x0=jnp.asarray([297.5]), d_traj=jnp.asarray(d))
    tth = ocp_params_from_numpy({k: np.asarray(v) for k, v in
                                 jth._asdict().items()}, "cpu", F64)
    return jocp, tocp, jth, tth


@pytest.mark.parametrize("N,method,kkt_method", [
    (6, "collocation", "stage"), (22, "collocation", "auto")],
    ids=["colloc-N6-stage", "colloc-N22-auto"])
def test_stage_path_matches_jax(N, method, kkt_method):
    """solve_nlp on the stage sweep, forced at N=6 and chosen by "auto" at
    N=22 (KKT 200 >= stage_min_size), each package with its own partition
    attached: equal iteration counts and factor path, and w, y, z to 1e-8
    of their scale (f64 round-off through the sweep's 2S-1 block solves
    per resolve and some 20 Newton steps)."""
    jocp, tocp, jth, tth = _zone_problem(N, method)
    opts = dict(tol=1e-4, max_iter=30, corrector=True, kkt_method=kkt_method)
    jopts = jsolver.attach_stage_partition(jsolver.SolverOptions(**opts),
                                           jocp.stage_partition)
    topts = tsolver.attach_stage_partition(tsolver.SolverOptions(**opts),
                                           tocp.stage_partition)
    lb, ub = jocp.bounds(jth)
    jres = jsolver.solve_nlp(jocp.nlp, jocp.initial_guess(jth), jth, lb, ub,
                             jopts)
    tlb, tub = tocp.bounds(tth)
    tres = tsolver.solve_nlp(tocp.nlp, tocp.initial_guess(tth), tth, tlb,
                             tub, topts)
    assert jsolver.kkt_path_name(jres.stats.kkt_path) == "stage"
    assert tsolver.KKT_PATHS[tres.stats.kkt_path] == "stage"
    assert bool(tres.stats.success) == bool(jres.stats.success)
    assert int(tres.stats.iterations) == int(jres.stats.iterations)
    for name in ("w", "y", "z"):
        a = np.asarray(getattr(jres, name))
        np.testing.assert_allclose(getattr(tres, name).numpy(), a, rtol=1e-8,
                                   atol=1e-8 * np.abs(a).max(), err_msg=name)
