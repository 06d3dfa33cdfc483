"""The port's stage-sparse derivative pipeline against the JAX package's.

``agentlib_mpc_torch/ops/stagejac.py`` on ``MENU_QUICK`` of
``tests/test_stagejac.py:79-85`` (OneRoom by degree-2 collocation,
LinearRCZone by multiple shooting with a free initial state; N=5,
dt=60 s), in float64 on the CPU from the same numpy inputs:

* the plan's index and seed arrays equal the JAX package's entry for
  entry (the JAX plan built by its own ``build_stage_jacobian_plan`` from
  the same partition and the port's certified ``h_row_stages``, which
  ``tests/test_torch_certify.py`` holds equal to the JAX certificate's);
* ``banded_fgh_jac``, ``banded_lagrangian_hessian``/``hessian_rows`` and
  ``assemble_kkt_banded`` agree with the JAX package's to 1e-12 relative
  (the same sums in another order) and with the dense derivatives
  (``jacrev``/``hessian``, the dense stage blocks);
* ``solve_nlp`` on the sparse pipeline against dense (port) and against
  the JAX package's sparse solve; the forced-sparse ``ValueError``s and
  the "auto" routing chain of ``_resolve_jacobian``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.ops import solver as jsolver
from agentlib_mpc_tpu.ops import stagejac as jsj
from agentlib_mpc_torch.ops import solver as tsolver
from agentlib_mpc_torch.ops import stagejac as tsj
from agentlib_mpc_torch.ops import stagewise as tsw
from agentlib_mpc_torch.utils.convert import (
    PLAN_ARRAYS,
    plan_arrays,
    stage_jacobian_plan_from_fields,
)

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-12

MENU_QUICK = [
    ("OneRoom", ["mDot"], dict(method="collocation", collocation_degree=2)),
    ("LinearRCZone", ["Q"], dict(method="multiple_shooting",
                                 fix_initial_state=False)),
]
IDS = ["OneRoom-colloc2", "LinearRCZone-shooting-free-x0"]


def _pair(model_name, controls, N=5, **kw):
    from agentlib_mpc_tpu.models import zoo as jzoo
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtranscribe
    from agentlib_mpc_torch.models import zoo as tzoo
    from agentlib_mpc_torch.ops.transcription import transcribe

    return (jtranscribe(getattr(jzoo, model_name)(), controls, N=N, dt=60.0,
                        **kw),
            transcribe(getattr(tzoo, model_name)(), controls, N=N, dt=60.0,
                       **kw))


_CASES: dict = {}


def _case(i):
    """(jax ocp, jax theta, jax plan, port ocp, port theta, port plan)."""
    if i not in _CASES:
        jocp, tocp = _pair(*MENU_QUICK[i][:2], **MENU_QUICK[i][2])
        tth = tocp.default_params(device="cpu", dtype=F64)
        tplan = tsj.plan_from_certificate(tocp.nlp, tth, tocp.n_w,
                                          tocp.stage_partition)
        assert tplan is not None, "menu entry must certify banded"
        jplan = jsj.build_stage_jacobian_plan(jocp.stage_partition,
                                              tplan.h_row_stages)
        _CASES[i] = (jocp, jocp.default_params(), jplan, tocp, tth, tplan)
    return _CASES[i]


def _point(tocp, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=tocp.n_w), rng.normal(size=tocp.n_g),
            np.abs(rng.normal(size=tocp.n_h)))


@pytest.mark.parametrize("i", [0, 1], ids=IDS)
def test_plan_arrays_equal_jax(i):
    jocp, _, jplan, tocp, _, tplan = _case(i)
    for k in ("n_w", "m_e", "m_h", "v_s", "e_s", "h_s", "n_ct", "W_g",
              "W_h", "W_H", "kkt_band_entries"):
        assert getattr(tplan, k) == getattr(jplan, k), k
    tarr, jarr = plan_arrays(tplan), plan_arrays(jplan)
    for k in PLAN_ARRAYS:
        assert tarr[k].shape == jarr[k].shape, k
        np.testing.assert_array_equal(tarr[k], jarr[k], err_msg=k)
    # the JAX plan carried across as fields gives the port's own plan
    assert stage_jacobian_plan_from_fields(jplan) is tplan


@pytest.mark.parametrize("i", [0, 1], ids=IDS)
def test_banded_fgh_jac_matches_jax_and_dense(i):
    jocp, jth, jplan, tocp, tth, tplan = _case(i)
    w_np, _, _ = _point(tocp, 0)
    n, m_e, m_h = tocp.n_w, tocp.n_g, tocp.n_h
    jvals, jgf, jJg, jJh = jsj.banded_fgh_jac(
        jplan, jsj.stacked_fgh(jocp.nlp, jth), jnp.asarray(w_np))
    fgh = lambda w, th: tsj.stacked_fgh(tocp.nlp, th)(w)
    w = torch.as_tensor(w_np)[None]
    lane = lambda t: torch.utils._pytree.tree_map(lambda x: x[None], t)
    vals, gf, Jg, Jh = tsj.banded_fgh_jac(tplan, fgh, w, lane(tth))
    for a, b in ((jvals, vals), (jgf, gf), (jJg, Jg), (jJh, Jh)):
        a = np.asarray(a)
        np.testing.assert_allclose(b[0].numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max(initial=1.0))
    # loss-free compression: equal to the dense Jacobian's rows
    J = torch.func.jacrev(tsj.stacked_fgh(tocp.nlp, tth))(w[0]).numpy()

    def expand(rows, cols, m):
        out = np.zeros((m, n))
        for r in range(m):
            for k, c in enumerate(cols[r]):
                if c >= 0:
                    out[r, c] += rows[r, k]
        return out
    np.testing.assert_array_equal(gf[0].numpy(), J[0])
    np.testing.assert_array_equal(expand(Jg[0].numpy(), tplan.g_cols, m_e),
                                  J[1:1 + m_e])
    np.testing.assert_array_equal(expand(Jh[0].numpy(), tplan.h_cols, m_h),
                                  J[1 + m_e:])


def _lagrangians(jocp, jth, tocp, tth, y, z):
    import jax

    def jl(ww):
        return (jocp.nlp.f(ww, jth) + jnp.asarray(y) @ jocp.nlp.g(ww, jth)
                - jnp.asarray(z) @ jocp.nlp.h(ww, jth))

    def tl(ww):
        return (tocp.nlp.f(ww, tth) + torch.as_tensor(y) @ tocp.nlp.g(ww, tth)
                - torch.as_tensor(z) @ tocp.nlp.h(ww, tth))

    return jax.grad(jl), tl


@pytest.mark.parametrize("i", [0, 1], ids=IDS)
def test_banded_hessian_matches_jax_and_dense(i):
    jocp, jth, jplan, tocp, tth, tplan = _case(i)
    w_np, y, z = _point(tocp, 1)
    jgrad, tl = _lagrangians(jocp, jth, tocp, tth, y, z)
    jrows = np.asarray(jsj.hessian_rows(
        jplan, jsj.banded_lagrangian_hessian(jplan, jgrad,
                                             jnp.asarray(w_np))))
    w = torch.as_tensor(w_np)
    CH = tsj.banded_lagrangian_hessian(
        tplan, lambda ww: torch.func.grad(tl)(ww), w[None])
    rows = tsj.hessian_rows(tplan, CH)[0].numpy()
    np.testing.assert_allclose(rows, jrows, rtol=RTOL,
                               atol=RTOL * np.abs(jrows).max())
    H = torch.func.hessian(tl)(w).numpy()
    dense = np.zeros_like(H)
    for r in range(tocp.n_w):
        for k, c in enumerate(tplan.hrow_cols[r]):
            if c >= 0:
                dense[r, c] += rows[r, k]
    np.testing.assert_allclose(dense, H, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(H).max()))


@pytest.mark.parametrize("i", [0, 1], ids=IDS)
def test_assembly_matches_jax_and_dense_stage_blocks(i):
    jocp, jth, jplan, tocp, tth, tplan = _case(i)
    w_np, y, z = _point(tocp, 2)
    rng = np.random.default_rng(3)
    sigma = np.abs(rng.normal(size=tocp.n_h)) + 0.1
    w_diag = np.abs(rng.normal(size=tocp.n_w)) + 1e-4
    delta_c = 1e-8
    jgrad, tl = _lagrangians(jocp, jth, tocp, tth, y, z)
    jw = jnp.asarray(w_np)
    _, _, jJg, jJh = jsj.banded_fgh_jac(
        jplan, jsj.stacked_fgh(jocp.nlp, jth), jw)
    jD, jE = jsj.assemble_kkt_banded(
        jplan, jsj.banded_lagrangian_hessian(jplan, jgrad, jw), jJg, jJh,
        jnp.asarray(sigma), jnp.asarray(w_diag), delta_c)
    w = torch.as_tensor(w_np)[None]
    _, _, Jg, Jh = tsj.banded_fgh_jac(
        tplan, lambda ww: tsj.stacked_fgh(tocp.nlp, tth)(ww), w)
    CH = tsj.banded_lagrangian_hessian(
        tplan, lambda ww: torch.func.grad(tl)(ww), w)
    D, E = tsj.assemble_kkt_banded(tplan, CH, Jg, Jh,
                                   torch.as_tensor(sigma)[None],
                                   torch.as_tensor(w_diag)[None], delta_c)
    scale = np.abs(np.asarray(jD)).max()
    for a, b in ((jD, D), (jE, E)):
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=0,
                                   atol=RTOL * scale)
    # the dense path's own stage blocks of the materialised matrix
    Hd = torch.func.hessian(tl)(w[0])
    Jgd = torch.func.jacrev(lambda ww: tocp.nlp.g(ww, tth))(w[0])
    Jhd = torch.func.jacrev(lambda ww: tocp.nlp.h(ww, tth))(w[0])
    Wd = Hd + torch.diag(torch.as_tensor(w_diag)) + Jhd.T @ (
        torch.as_tensor(sigma)[:, None] * Jhd)
    K = torch.cat([torch.cat([Wd, Jgd.T], 1), torch.cat(
        [Jgd, -delta_c * torch.eye(tocp.n_g, dtype=F64)], 1)], 0)
    Dd, Ed = tsw._stage_blocks(K[None], tocp.stage_partition)
    np.testing.assert_allclose(D.numpy(), Dd.numpy(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(E.numpy(), Ed.numpy(), rtol=0,
                               atol=1e-12 * scale)


def test_band_matvecs_match_dense():
    _, _, _, tocp, tth, tplan = _case(0)
    w = torch.as_tensor(_point(tocp, 4)[0])
    _, _, Jg, Jh = tsj.banded_fgh_jac(
        tplan, lambda ww: tsj.stacked_fgh(tocp.nlp, tth)(ww), w[None])
    Jgd = torch.func.jacrev(lambda ww: tocp.nlp.g(ww, tth))(w)
    ix = tplan.tensors("cpu")
    x = torch.as_tensor(np.random.default_rng(5).normal(size=tocp.n_w))
    v = torch.as_tensor(np.random.default_rng(6).normal(size=tocp.n_g))
    d = torch.as_tensor(np.random.default_rng(7).random(tocp.n_w) + 0.5)
    np.testing.assert_allclose(
        tsj.band_matvec(Jg, ix["g_cols"], x[None])[0].numpy(),
        (Jgd @ x).numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tsj.band_rmatvec(Jg, ix["g_cols"], v[None], tocp.n_w)[0].numpy(),
        (Jgd.T @ v).numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tsj.band_row_absmax(Jg, ix["g_cols"], d[None])[0].numpy(),
        (Jgd * d).abs().amax(-1).numpy(), rtol=1e-12, atol=0)
    assert tsj.band_row_absmax(Jh[:, :0], ix["h_cols"][:0],
                               d[None]).shape == (1, 0)


# --------------------------------------------------------------------------
# end to end through solve_nlp, and the routing chain
# --------------------------------------------------------------------------

def _sparse_opts(tocp, tplan, **kw):
    return tsolver.attach_jacobian_plan(tsolver.attach_stage_partition(
        tsolver.SolverOptions(jacobian="sparse", **kw),
        tocp.stage_partition), tplan)


def test_solve_nlp_sparse_matches_dense_and_jax_sparse():
    jocp, jth, jplan, tocp, tth, tplan = _case(0)
    tw0 = tocp.initial_guess(tth)
    tlb, tub = tocp.bounds(tth)
    base = dict(tol=1e-6, max_iter=40)
    dense = tsolver.solve_nlp(tocp.nlp, tw0, tth, tlb, tub,
                              tsolver.attach_stage_partition(
                                  tsolver.SolverOptions(
                                      jacobian="dense", kkt_method="stage",
                                      **base), tocp.stage_partition))
    sparse = tsolver.solve_nlp(tocp.nlp, tw0, tth, tlb, tub,
                               _sparse_opts(tocp, tplan, **base))
    assert tsolver.JAC_PATHS[int(sparse.stats.jac_path)] == "sparse"
    assert tsolver.KKT_PATHS[int(sparse.stats.kkt_path)] == "stage"
    assert int(sparse.stats.iterations) == int(dense.stats.iterations)
    assert bool(sparse.stats.success) and bool(dense.stats.success)
    np.testing.assert_allclose(sparse.w.numpy(), dense.w.numpy(), rtol=0,
                               atol=1e-8 * dense.w.abs().max().item())
    jopts = jsolver.attach_jacobian_plan(jsolver.attach_stage_partition(
        jsolver.SolverOptions(jacobian="sparse", **base),
        jocp.stage_partition), jplan)
    jlb, jub = jocp.bounds(jth)
    jres = jsolver.solve_nlp(jocp.nlp, jocp.initial_guess(jth), jth, jlb,
                             jub, jopts)
    assert int(jres.stats.iterations) == int(sparse.stats.iterations)
    for name in ("w", "y", "z"):
        a = np.asarray(getattr(jres, name))
        np.testing.assert_allclose(getattr(sparse, name).numpy(), a, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(a).max()),
                                   err_msg=name)


def _solve(tocp, tth, opts):
    lb, ub = tocp.bounds(tth)
    return tsolver.solve_nlp(tocp.nlp, tocp.initial_guess(tth), tth, lb, ub,
                             opts)


def test_forced_sparse_without_plan_raises():
    _, _, _, tocp, tth, _ = _case(0)
    opts = tsolver.attach_stage_partition(
        tsolver.SolverOptions(jacobian="sparse", max_iter=2),
        tocp.stage_partition)
    with pytest.raises(ValueError, match="requires a stage_jacobian_plan"):
        _solve(tocp, tth, opts)


@pytest.mark.parametrize("bad", ["kkt_method", "fused_ls", "size",
                                 "partition"])
def test_forced_sparse_contradictions_raise(bad):
    _, _, _, tocp, tth, tplan = _case(0)
    _, other = _pair(*MENU_QUICK[0][:2], N=4, **MENU_QUICK[0][2])
    opts = _sparse_opts(tocp, tplan, max_iter=2)
    if bad == "kkt_method":
        opts, match = opts._replace(kkt_method="lu"), "contradicts"
    elif bad == "fused_ls":
        opts, match = opts._replace(fused_ls_jacobian="on"), "incompatible"
    elif bad == "size":
        # the plan of another horizon on this problem
        tocp, tth = other, other.default_params(device="cpu", dtype=F64)
        opts, match = opts._replace(stage_partition=None), "covers a"
    else:
        opts = opts._replace(stage_partition=other.stage_partition)
        match = "different partitions"
    with pytest.raises(ValueError, match=match):
        _solve(tocp, tth, opts)


def test_auto_routing_is_size_aware():
    """"auto" goes sparse only where a plan is attached, the stage sweep is
    the resolved KKT path and the size clears jacobian_min_size (the JAX
    package's chain; on the CPU "auto" resolves stage from
    stage_min_size)."""
    _, _, _, tocp, tth, tplan = _case(0)
    size = tocp.stage_partition.n_total
    r = lambda **kw: tsolver._resolve_jacobian(
        tsolver.attach_stage_partition(
            tsolver.SolverOptions(**kw), tocp.stage_partition), size, "cpu")
    assert r(stage_jacobian_plan=tplan) == "dense"           # 90 < 384
    assert r(stage_jacobian_plan=tplan, jacobian_min_size=0,
             stage_min_size=0) == "sparse"
    assert r(stage_jacobian_plan=tplan, jacobian_min_size=0) == "dense"
    assert r(jacobian_min_size=0, stage_min_size=0) == "dense"  # no plan
    assert r(stage_jacobian_plan=tplan, jacobian_min_size=0,
             stage_min_size=0, kkt_method="lu") == "dense"
    assert r(stage_jacobian_plan=tplan, jacobian="dense",
             jacobian_min_size=0, stage_min_size=0) == "dense"
    with pytest.raises(ValueError, match="jacobian must be"):
        r(jacobian="fast")


def test_plan_cache_and_equality():
    _, _, _, tocp, _, tplan = _case(0)
    again = tsj.build_stage_jacobian_plan(tocp.stage_partition,
                                          tplan.h_row_stages)
    assert again is tplan and hash(again) == hash(tplan)
    other = tsj.build_stage_jacobian_plan(tocp.stage_partition,
                                          (0,) * tplan.m_h)
    assert other != tplan


def test_refuted_certificate_yields_no_plan(caplog):
    """An out-of-band coupling refutes the certificate: no plan, the dense
    pipeline stays, with a log line."""
    _, _, _, tocp, tth, _ = _case(0)
    nlp = tsolver.NLPFunctions(
        f=lambda w, th: tocp.nlp.f(w, th) + w[0] * w[-1], g=tocp.nlp.g,
        h=tocp.nlp.h)
    with caplog.at_level(logging.WARNING):
        plan = tsj.plan_from_certificate(nlp, tth, tocp.n_w,
                                         tocp.stage_partition,
                                         label="the refuted problem")
    assert plan is None
    assert "keeping the dense derivative pipeline" in caplog.text


def test_attach_only_when_worthwhile():
    _, _, _, tocp, tth, tplan = _case(0)
    part = tocp.stage_partition
    base = tsolver.attach_stage_partition(tsolver.SolverOptions(), part)
    # 90 < jacobian_min_size: the certifier does not even run
    boom = tsolver.NLPFunctions(f=None, g=None, h=None)
    assert tsj.attach_plan_if_worthwhile(base, part, boom, tth, tocp.n_w,
                                         device="cpu") is base
    forced = tsj.attach_plan_if_worthwhile(
        base._replace(jacobian="sparse"), part, tocp.nlp, tth, tocp.n_w,
        device="cpu")
    assert forced.stage_jacobian_plan is tplan
    low = tsj.attach_plan_if_worthwhile(
        base._replace(jacobian_min_size=0, stage_min_size=0), part,
        tocp.nlp, tth, tocp.n_w, device="cpu")
    assert low.stage_jacobian_plan is tplan
    dense = base._replace(jacobian="dense", jacobian_min_size=0,
                          stage_min_size=0)
    assert tsj.attach_plan_if_worthwhile(dense, part, boom, tth, tocp.n_w,
                                         device="cpu") is dense
