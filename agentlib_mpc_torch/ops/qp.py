"""Convex-QP fast path: structure routing + Mehrotra predictor-corrector.

Port of ``agentlib_mpc_tpu/ops/qp.py`` (``resolve_qp_routing :69-142``,
``is_lq :145-209``, ``_solve_qp_impl :239-644``). For a linear-quadratic
program

    min ½ wᵀH w + cᵀw   s.t.  A w + g₀ = 0,  C w + h₀ ≥ 0,  lb ≤ w ≤ ub

every derivative is constant, so :func:`solve_qp` extracts (H, c, A, C)
once per call and lane with ``torch.func`` and then runs pure linear
algebra: no model evaluations, no line search (convex ⇒
fraction-to-boundary steps suffice), one KKT factorization and two
re-solves (predictor, corrector) per iteration. The KKT system is the NLP
solver's reduced quasi-definite form and goes through the same
``_factor_kkt``/``_resolve_kkt`` (``ops/solver.py``), so "auto" takes the
LDLᵀ kernels on the card at the N=10 size. On the sparse derivative
pipeline the constant (H, A, C) are extracted as banded rows by the
stage-sparse pipeline (``ops/stagejac.py``) and factored by
``factor_kkt_stage_banded``; the dense matrices never exist.

Routing (:func:`resolve_qp_routing`) keeps the JAX package's authority
chain: the sound certificate ``lint/fx/certify_lq`` decides, the sampled
probe :func:`is_lq` cross-checks it, and only an inconclusive certificate
routes on the probe — loudly. On a non-LQ problem :func:`solve_qp`
converges to the wrong point; gate it behind the routing.

Batch-first, like ``solve_nlp_batched``: every iterate carries a leading
lane axis, and the predictor/corrector loop is written out with per-lane
freezing — a lane runs while ``~done & (it < budget) & (frozen < 8)``
held on the OLD state, and keeps new values only by ``torch.where``.
Same signature, ``SolverResult``/``SolverStats`` contract, dual
conventions and scaling as ``solve_nlp_batched``, so warm starts carry
across. Runs with TF32 off (the JAX entry runs under
``default_matmul_precision("highest")``). The heavy parts run under the
NLP solver's ``torch.profiler`` range names (``ipm.eval_jac`` for the
one-time extraction, ``ipm.assemble``, ``ipm.factor``, ``ipm.resolve``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, hessian, jacrev, jvp, vjp, vmap
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_map

from agentlib_mpc_torch.ops import stagejac as sjac
from agentlib_mpc_torch.ops import stagewise as stage_ops
from agentlib_mpc_torch.ops.solver import (
    JAC_PATHS,
    KKT_PATHS,
    PRECISION_PATHS,
    NLPFunctions,
    SolverOptions,
    SolverResult,
    SolverStats,
    _clip,
    _factor_kkt,
    _max_step,
    _mv,
    _resolve_kkt,
    _resolve_paths,
    _resolve_precision,
    _rmv,
    _row_scaling,
    _safe_max,
    _theta_dims,
    _true_f32_matmul,
)

__all__ = ["is_lq", "resolve_qp_routing", "solve_qp"]


def resolve_qp_routing(mode: str, probe, logger=None,
                       label: str = "problem", certifier=None) -> bool:
    """Shared auto/on/off routing decision of the QP fast path.

    ``certifier`` is a zero-arg callable returning a
    :class:`agentlib_mpc_torch.lint.fx.LQCertificate`; ``probe`` a zero-arg
    callable returning the :func:`is_lq` verdict. Neither runs except for
    ``"auto"``. Routing authority:

    * certificate ``"lq"`` — proof for all theta; the probe runs as a
      cross-check only (a probe refutation is concrete evidence of an
      interpreter bug, so it wins and the fast path stays off);
    * certificate ``"not_lq"`` — never route; the probe is skipped (it can
      only produce the false positive the certificate just ruled out);
    * certificate ``"unknown"`` (opaque ops, a failed trace), a certifier
      that raises, or no certifier — fall back to the sampled probe,
      loudly.
    """
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(
            f"qp_fast_path must be 'auto', 'on' or 'off', got {mode!r}")
    cert = None
    if certifier is not None:
        try:
            cert = certifier()
        except Exception:  # noqa: BLE001 — the probe still routes, loudly
            cert = None
            if logger is not None:
                logger.warning(
                    "LQ certification raised for %s; falling back to the "
                    "sampled probe", label, exc_info=True)
    if cert is not None and cert.status == "not_lq":
        if logger is not None:
            logger.info(
                "LQ structure refuted for %s (%s): staying on the "
                "general NLP path", label, cert.describe())
        return False
    if cert is not None and cert.status == "lq":
        if not bool(probe()):
            if logger is not None:
                logger.warning(
                    "LQ certificate and sampled probe DISAGREE for %s "
                    "(%s, probe says non-LQ) — not routing to the QP "
                    "fast path; please report this as a certifier bug",
                    label, cert.describe())
            return False
        if logger is not None:
            logger.info("LQ structure proved for %s (%s; probe "
                        "cross-check passed): dispatching to the "
                        "Mehrotra QP fast path", label, cert.describe())
        return True
    use = bool(probe())
    if cert is not None and logger is not None:
        logger.warning(
            "LQ certificate inconclusive for %s (%s): routing on the "
            "sampled probe (%s) — the probe only sees default-theta "
            "structure", label, cert.describe(),
            "LQ" if use else "non-LQ")
    elif use and logger is not None:
        logger.info("LQ structure certified for %s: dispatching to the "
                    "Mehrotra QP fast path", label)
    return use


def is_lq(nlp: NLPFunctions, theta, n: int, *, seed: int = 0,
          n_probes: int = 2, rtol: float = 1e-5, atol: float = 1e-7) -> bool:
    """Probabilistic certificate that the NLP is linear-quadratic in ``w``.

    At ``n_probes`` pairs of random points, with a random probe direction:
    the objective's Hessian-vector product is constant, the g/h
    vector-Jacobian products are constant, and the objective equals its
    own second-order Taylor model exactly between the two points — all
    O(1) model evaluations. Polynomials of higher degree fail at random
    points with probability 1; transcendental nonlinearities fail
    outright. ``theta`` is ONE problem's parameters; the probe runs in
    float64 on the device of theta's tensors, with points drawn from a
    ``torch.Generator`` seeded by ``seed``, and its tolerances floored at
    float64's eps."""
    leaves, _ = tree_flatten(theta)
    dev = next((t.device for t in leaves if isinstance(t, torch.Tensor)),
               torch.device("cpu"))
    f64 = torch.float64
    th = tree_map(lambda t: t.to(f64) if isinstance(t, torch.Tensor)
                  and t.is_floating_point() else t, theta)
    f = lambda w: nlp.f(w, th)
    g = lambda w: nlp.g(w, th)
    h = lambda w: nlp.h(w, th)
    zero = torch.zeros((n,), dtype=f64, device=dev)
    m_e = int(g(zero).shape[0])
    m_h = int(h(zero).shape[0])
    # dtype-aware tolerances: an exactly-quadratic function still shows
    # O(eps·scale) differences between its HVPs at two points; a
    # bilinear/nonlinear term shows O(1)
    eps = torch.finfo(f64).eps
    rtol = max(rtol, 2e4 * eps)
    atol = max(atol, 1e3 * eps)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen,
                                       dtype=f64).to(dev)

    def close(a, b):
        return bool(torch.isfinite(a).all() and torch.isfinite(b).all()
                    and torch.allclose(a, b, rtol=rtol, atol=atol))

    def hvp(w, v):
        return grad(lambda ww: grad(f)(ww) @ v)(w)

    for _ in range(n_probes):
        w1 = randn(n)
        w2 = 2.0 * randn(n) + 0.5
        d = w2 - w1
        # Hessian constancy along d AND a random direction v
        v = randn(n)
        if not (close(hvp(w1, d), hvp(w2, d))
                and close(hvp(w1, v), hvp(w2, v))):
            return False
        # exact quadratic model between the two probe points
        df = f(w2) - f(w1)
        model = grad(f)(w1) @ d + 0.5 * d @ hvp(w1, d)
        scale = torch.clamp_min(df.abs(), 1.0)
        if not close(df / scale, model / scale):
            return False
        # constraint affineness: constant VJP against a random cotangent
        # plus the exact linear model fn(w2) − fn(w1) = J·d
        for fn, m in ((g, m_e), (h, m_h)):
            if not m:
                continue
            ct = randn(m)
            _, pb1 = vjp(fn, w1)
            _, pb2 = vjp(fn, w2)
            if not close(pb1(ct)[0], pb2(ct)[0]):
                return False
            _, jd = jvp(fn, (w1,), (d,))
            if not close(fn(w2) - fn(w1), jd):
                return False
    return True


class _QPState(NamedTuple):
    w: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    zL: torch.Tensor
    zU: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    err: torch.Tensor
    best: torch.Tensor
    stall: torch.Tensor
    delta: torch.Tensor
    #: consecutive REJECTED directions (the factorization-breakdown signal)
    frozen: torch.Tensor


def solve_qp(nlp: NLPFunctions, w0, theta, w_lb, w_ub,
             options: SolverOptions = SolverOptions(), y0=None, z0=None,
             mu0=None, max_iter=None) -> SolverResult:
    """Solve a batch of structure-identical LQ programs with a Mehrotra
    predictor-corrector IPM.

    Same signature and result contract as ``solve_nlp_batched``: ``w0``,
    ``w_lb``, ``w_ub`` are (B, n), every tensor leaf of ``theta`` is
    batched on axis 0, ``y0``/``z0`` warm-start the duals and ``max_iter``
    overrides ``options.max_iter``. ``mu0`` is accepted for signature
    compatibility and ignored: Mehrotra's σ heuristic sets the barrier from
    the iterate's own complementarity. Correctness requires the problem to
    BE LQ (route with :func:`resolve_qp_routing`)."""
    with _true_f32_matmul():
        return _solve_qp(nlp, w0, theta, w_lb, w_ub, options, y0, z0,
                         max_iter)


def _solve_qp(nlp, w0, theta, w_lb, w_ub, opts, y0, z0, max_iter_arg):
    dtype, device = w0.dtype, w0.device
    eps = torch.finfo(dtype).eps
    B, n = w0.shape
    th_dims = _theta_dims(theta)
    lane0 = tree_map(lambda t: t[0] if isinstance(t, torch.Tensor) else t,
                     theta)
    m_e = int(nlp.g(w0[0], lane0).shape[0])
    m_h = int(nlp.h(w0[0], lane0).shape[0])

    # derivative pipeline + factor path resolved once (constant structure:
    # the QP KKT has the NLP solver's stage-banded form)
    kkt_size = n + m_e if m_e else n
    jac_path, kkt_path, plan = _resolve_paths(opts, kkt_size, device, dtype)
    precision_path = _resolve_precision(opts)
    # dtype-aware feasibility target, shared definition with solve_nlp
    viol_tol = max(opts.constr_viol_tol, 1e3 * eps)

    # ---- scaling (same scheme as solve_nlp, so duals transfer) -------------
    if opts.scale_variables:
        d_w = torch.clamp_min(w0.abs(), 1.0)
    else:
        d_w = torch.ones_like(w0)
    s_f, s_g, s_h = _row_scaling(nlp, w0, theta, th_dims, d_w,
                                 opts.scaling_grad_max, m_e, m_h, plan)
    lb = w_lb / d_w
    ub = w_ub / d_w
    sc = (d_w, s_f, s_g, s_h, theta)
    sc_dims = (0, 0, 0, 0, th_dims)

    def f_lane(w, d_w_, s_f_, s_g_, s_h_, th):
        return s_f_ * nlp.f(w * d_w_, th)

    def g_lane(w, d_w_, s_f_, s_g_, s_h_, th):
        return s_g_ * nlp.g(w * d_w_, th)

    def h_lane(w, d_w_, s_f_, s_g_, s_h_, th):
        return s_h_ * nlp.h(w * d_w_, th)

    batched = lambda fn: vmap(fn, in_dims=(0, *sc_dims))
    empty = w0.new_zeros((B, 0))

    # ---- one-time structure extraction (exact for LQ) ----------------------
    wz = torch.zeros_like(w0)
    with record_function("ipm.eval_jac"):
        if plan is not None:
            # banded extraction: compressed pullbacks give (c, A, C) as row
            # windows, compressed forward seeds give H as banded columns
            ix = plan.tensors(device)

            def fgh_lane(w, *sc_):
                return torch.cat([f_lane(w, *sc_).reshape(1),
                                  g_lane(w, *sc_), h_lane(w, *sc_)])

            vals_z, c, A_rows, C_rows = sjac.banded_fgh_jac(
                plan, fgh_lane, wz, *sc, in_dims=sc_dims)
            f0 = vals_z[:, 0]
            g0 = vals_z[:, 1:1 + m_e]
            h0 = vals_z[:, 1 + m_e:]
            CH = sjac.banded_lagrangian_hessian(plan, grad(f_lane), wz, *sc,
                                                in_dims=sc_dims)
            H_rows = sjac.hessian_rows(plan, CH)
            h_mv = lambda x: sjac.band_matvec(H_rows, ix["hrow_cols"], x)
            a_mv = lambda x: sjac.band_matvec(A_rows, ix["g_cols"], x)
            a_t_mv = lambda v: sjac.band_rmatvec(A_rows, ix["g_cols"], v, n)
            c_mv = lambda x: sjac.band_matvec(C_rows, ix["h_cols"], x)
            c_t_mv = lambda v: sjac.band_rmatvec(C_rows, ix["h_cols"], v, n)
        else:
            f0 = batched(f_lane)(wz, *sc)
            c = batched(grad(f_lane))(wz, *sc)              # ∇f(0)
            H = batched(hessian(f_lane))(wz, *sc)           # constant
            if m_e:
                A = batched(jacrev(g_lane))(wz, *sc)
                g0 = batched(g_lane)(wz, *sc)               # g = A w + g0
            else:
                A, g0 = w0.new_zeros((B, 0, n)), empty
            if m_h:
                C = batched(jacrev(h_lane))(wz, *sc)
                h0 = batched(h_lane)(wz, *sc)               # h = C w + h0
            else:
                C, h0 = w0.new_zeros((B, 0, n)), empty
            h_mv = lambda x: _mv(H, x)
            a_mv = lambda x: _mv(A, x)
            a_t_mv = lambda v: _rmv(A, v)
            c_mv = lambda x: _mv(C, x)
            c_t_mv = lambda v: _rmv(C, v)

    def f_val(w):
        return f0 + (c * w).sum(-1) + 0.5 * (w * h_mv(w)).sum(-1)

    def comp_mean(w, s, z, zL, zU):
        """Duality measure per lane."""
        return ((s * z).sum(-1) + ((w - lb) * zL).sum(-1)
                + ((ub - w) * zU).sum(-1)) / n_comp

    # ---- initial point ------------------------------------------------------
    span = torch.clamp_min(ub - lb, 1e-8)
    push = opts.bound_push * torch.clamp_max(span, 1.0)
    w = _clip(w0 / d_w, lb + push, ub - push)
    if m_h:
        s = torch.clamp_min(c_mv(w) + h0, 1e-2)
        z = torch.clamp(0.1 / s, 1e-8, 1e8)
        if z0 is not None:
            z = torch.clamp_min(s_f[:, None] * z0
                                / torch.clamp_min(s_h, 1e-12), 1e-8)
    else:
        s = z = empty
    if y0 is not None and m_e:
        y = s_f[:, None] * y0 / torch.clamp_min(s_g, 1e-12)
    else:
        y = w0.new_zeros((B, m_e))
    zL = torch.clamp(0.1 / (w - lb), 1e-12, 1e8)
    zU = torch.clamp(0.1 / (ub - w), 1e-12, 1e8)

    def kkt_error(w, s, y, z, zL, zU):
        """Scaled optimality error at mu=0 (same scaling as solve_nlp)."""
        r_w = c + h_mv(w) - zL + zU
        if m_e:
            r_w = r_w + a_t_mv(y)
        if m_h:
            r_w = r_w - c_t_mv(z)
        r_g = a_mv(w) + g0 if m_e else g0
        r_h = (c_mv(w) + h0 - s) if m_h else h0
        comp = torch.cat([s * z if m_h else h0, (w - lb) * zL,
                          (ub - w) * zU], dim=-1)
        s_max = 100.0
        dual_sum = (y.abs().sum(-1) + z.abs().sum(-1) + zL.abs().sum(-1)
                    + zU.abs().sum(-1))
        s_d = torch.clamp_min(dual_sum / (m_e + m_h + 2 * n), s_max) / s_max
        dual_inf = _safe_max(r_w.abs()) / s_d
        viol = torch.maximum(_safe_max(r_g.abs()), _safe_max(r_h.abs()))
        compl_inf = _safe_max(comp.abs()) / s_d
        return (torch.maximum(torch.maximum(dual_inf, viol), compl_inf),
                viol, dual_inf, compl_inf)

    n_comp = m_h + 2 * n    # complementarity pairs
    ones_b = w0.new_ones((B,))

    def all_finite(t):
        return torch.isfinite(t).all(dim=-1) if t.shape[-1] else \
            torch.ones(t.shape[:-1], dtype=torch.bool, device=device)

    def body(st: _QPState) -> _QPState:
        w, s, y, z, zL, zU = st.w, st.s, st.y, st.z, st.zL, st.zU
        dL = torch.clamp_min(w - lb, 1e-12)
        dU = torch.clamp_min(ub - w, 1e-12)
        sigma_s = z / torch.clamp_min(s, 1e-12) if m_h else s
        sigma_L = zL / dL
        sigma_U = zU / dU

        gv = a_mv(w) + g0 if m_e else g0
        hv = c_mv(w) + h0 if m_h else h0
        r_h = hv - s
        r_w = c + h_mv(w) - zL + zU
        if m_e:
            r_w = r_w + a_t_mv(y)
        if m_h:
            r_w = r_w - c_t_mv(z)
        mu_now = comp_mean(w, s, z, zL, zU)

        # adaptive Levenberg regularization: delta grows when a direction
        # is rejected and decays back toward delta_init while steps are
        # healthy, so the converged solution is unperturbed
        reg = st.delta[:, None] + sigma_L + sigma_U
        if plan is not None:
            with record_function("ipm.assemble"):
                D, E = sjac.assemble_kkt_banded(plan, CH, A_rows, C_rows,
                                                sigma_s, reg, opts.delta_c)
            with record_function("ipm.factor"):
                factor = ("stage_banded",
                          (stage_ops.factor_kkt_stage_banded(D, E),
                           plan.partition))
        else:
            with record_function("ipm.assemble"):
                W = H + torch.diag_embed(reg)
                if m_h:
                    W = W + torch.matmul(C.transpose(-1, -2),
                                         sigma_s[..., None] * C)
                if m_e:
                    creg = -opts.delta_c * torch.eye(m_e, dtype=dtype,
                                                     device=device)
                    K = torch.cat([torch.cat([W, A.transpose(-1, -2)],
                                             dim=-1),
                                   torch.cat([A, creg.expand(B, m_e, m_e)],
                                             dim=-1)], dim=-2)
                else:
                    K = W
            with record_function("ipm.factor"):
                factor = _factor_kkt(K, kkt_path, opts.stage_partition)

        def newton_dir(mu_s, mu_L, mu_U):
            """Direction for per-entry complementarity targets (bound
            duals and slacks eliminated as in solve_nlp), plus the relative
            residual of the reduced linear solve through the operators
            that built the system — the health signal of the factor."""
            rhs = -r_w + (mu_L / dL - zL) - (mu_U / dU - zU)
            if m_h:
                corr = mu_s / torch.clamp_min(s, 1e-12) - z - sigma_s * r_h
                rhs = rhs + c_t_mv(corr)
            with record_function("ipm.resolve"):
                if m_e:
                    sol = _resolve_kkt(factor, torch.cat([rhs, -gv], dim=-1))
                    dw, dy = sol[:, :n], sol[:, n:]
                else:
                    dw = _resolve_kkt(factor, rhs)
                    dy = empty
            # residual of K [dw; dy] = [rhs; -gv]: a pivot-free factor can
            # break down at the extreme near-convergence conditioning; its
            # direction must be rejected like a non-finite one
            r_top = h_mv(dw) + reg * dw - rhs
            if m_h:
                r_top = r_top + c_t_mv(sigma_s * c_mv(dw))
            if m_e:
                r_top = r_top + a_t_mv(dy)
                r_bot = a_mv(dw) - opts.delta_c * dy + gv
            else:
                r_bot = empty
            scale = torch.clamp_min(torch.maximum(_safe_max(rhs.abs()),
                                                  _safe_max(gv.abs())), 1.0)
            resid = torch.maximum(_safe_max(r_top.abs()),
                                  _safe_max(r_bot.abs())) / scale
            ds = (c_mv(dw) + r_h) if m_h else s
            dz = (mu_s / torch.clamp_min(s, 1e-12) - z - sigma_s * ds) \
                if m_h else z
            dzL = mu_L / dL - zL - sigma_L * dw
            dzU = mu_U / dU - zU + sigma_U * dw
            return dw, dy, ds, dz, dzL, dzU, resid

        def steps(dw, ds, dz, dzL, dzU, tau):
            a_p = torch.minimum(_max_step(dL, dw, tau),
                                _max_step(dU, -dw, tau))
            a_d = torch.minimum(_max_step(zL, dzL, tau),
                                _max_step(zU, dzU, tau))
            if m_h:
                a_p = torch.minimum(a_p, _max_step(s, ds, tau))
                a_d = torch.minimum(a_d, _max_step(z, dz, tau))
            return a_p, a_d

        # ---- affine predictor (mu target 0) --------------------------------
        zero = w0.new_zeros((B, 1))
        dw_a, dy_a, ds_a, dz_a, dzL_a, dzU_a, _ = newton_dir(zero, zero,
                                                             zero)
        a_p, a_d = steps(dw_a, ds_a, dz_a, dzL_a, dzU_a, ones_b)
        ap, ad = a_p[:, None], a_d[:, None]
        mu_aff = comp_mean(w + ap * dw_a, s + ap * ds_a if m_h else s,
                           z + ad * dz_a if m_h else z, zL + ad * dzL_a,
                           zU + ad * dzU_a)
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu_now, 1e-30)) ** 3,
                            1e-4, 1.0)
        mu_t = (sigma * mu_now)[:, None]

        # ---- corrector: fold the predictor's Δ∘Δ into the targets ----------
        # (Gondzio-clipped so a wild predictor cannot poison the step)
        cap = 10.0 * torch.maximum(mu_t, mu_now[:, None])
        mu_L = _clip(mu_t - dw_a * dzL_a, zero, cap)
        mu_U = _clip(mu_t + dw_a * dzU_a, zero, cap)
        mu_s = _clip(mu_t - ds_a * dz_a, zero, cap) if m_h else zero
        dw, dy, ds, dz, dzL, dzU, resid = newton_dir(mu_s, mu_L, mu_U)

        tau = torch.clamp_min(1.0 - mu_now, opts.tau_min)
        a_p, a_d = steps(dw, ds, dz, dzL, dzU, tau)
        # direction-health guard: a failed factorization (non-finite
        # direction, or a finite one whose linear-solve residual shows the
        # factor broke down) keeps the iterate and escalates delta. 1e-2
        # sits orders of magnitude above a healthy f32 solve (~1e-5) and
        # below a broken factor's O(1)+.
        finite = (all_finite(dw) & all_finite(dy) & all_finite(ds)
                  & all_finite(dz) & (resid < 1e-2))
        ok = finite[:, None]

        def pick(v, dv, a):
            return torch.where(ok, v + a[:, None] * dv, v)

        w_n, s_n, y_n = pick(w, dw, a_p), pick(s, ds, a_p), pick(y, dy, a_d)
        z_n, zL_n, zU_n = pick(z, dz, a_d), pick(zL, dzL, a_d), \
            pick(zU, dzU, a_d)
        delta_n = torch.where(
            finite, torch.clamp_min(st.delta / 3.0, opts.delta_init),
            torch.clamp_max(st.delta * 10.0 + 1e-6, opts.delta_max))
        frozen_n = torch.where(finite, torch.zeros_like(st.frozen),
                               st.frozen + 1)

        err_n, viol_n, dual_n, compl_n = kkt_error(w_n, s_n, y_n, z_n, zL_n,
                                                   zU_n)
        # stall-acceptance: when the error stopped improving (the f32
        # floor, typically), accept a feasible point with loose-tolerance
        # complementarity and stationarity instead of burning the budget
        improved = err_n < 0.95 * st.best
        stall_n = torch.where(improved, torch.zeros_like(st.stall),
                              st.stall + 1)
        best_n = torch.minimum(st.best, err_n)
        acceptable = ((viol_n <= viol_tol) & (dual_n <= opts.dual_inf_tol)
                      & (compl_n <= max(opts.tol, 1e3 * eps)))
        # the stall gate scales with the REQUESTED tolerance and the dtype
        # floor, capped by the configured complementarity gate
        stalled_ok = ((stall_n >= 4) & (viol_n <= viol_tol)
                      & (dual_n <= opts.dual_inf_tol)
                      & (compl_n <= min(opts.compl_inf_tol,
                                        max(100.0 * opts.tol, 1e4 * eps))))
        done_n = (err_n <= opts.tol) | acceptable | stalled_ok
        return _QPState(w=w_n, s=s_n, y=y_n, z=z_n, zL=zL_n, zU=zU_n,
                        it=st.it + 1, done=done_n, err=err_n, best=best_n,
                        stall=stall_n, delta=delta_n, frozen=frozen_n)

    budget = int(opts.max_iter if max_iter_arg is None else max_iter_arg)
    err0, _, _, _ = kkt_error(w, s, y, z, zL, zU)
    zeros_i = torch.zeros((B,), dtype=torch.int64, device=device)
    st = _QPState(w=w, s=s, y=y, z=z, zL=zL, zU=zU, it=zeros_i,
                  done=err0 <= opts.tol, err=err0, best=err0, stall=zeros_i,
                  delta=torch.full((B,), opts.delta_init, dtype=dtype,
                                   device=device),
                  frozen=zeros_i)
    # the batched loop: a lane keeps the new state only where its own
    # condition held on the OLD state. Wedge exit: 8 consecutive REJECTED
    # directions with delta escalating means the factor cannot produce a
    # usable step at this conditioning — stop and let the final test
    # judge the held point
    while True:
        active = ~st.done & (st.it < budget) & (st.frozen < 8)
        if not bool(active.any()):
            break
        new = body(st)
        st = _QPState(*(
            torch.where(active.reshape((B,) + (1,) * (old.ndim - 1)), nw, old)
            for nw, old in zip(new, st)))

    _, viol_f, dual_f, compl_f = kkt_error(st.w, st.s, st.y, st.z, st.zL,
                                           st.zU)
    acceptable_f = ((viol_f <= viol_tol) & (dual_f <= opts.dual_inf_tol)
                    & (compl_f <= opts.compl_inf_tol))

    # ---- unscale ------------------------------------------------------------
    gv_f = a_mv(st.w) + g0 if m_e else g0
    hv_f = c_mv(st.w) + h0 if m_h else h0
    g_raw_v = gv_f / torch.clamp_min(s_g, 1e-12) if m_e else gv_f
    h_raw_v = hv_f / torch.clamp_min(s_h, 1e-12) if m_h else hv_f
    viol_raw = torch.maximum(_safe_max(g_raw_v.abs()),
                             _safe_max(torch.clamp_min(-h_raw_v, 0.0)))
    sf_c = s_f[:, None]
    stats = SolverStats(
        iterations=st.it,
        kkt_error=st.err,
        success=st.done | acceptable_f,
        objective=f_val(st.w) / s_f,
        mu=comp_mean(st.w, st.s, st.z, st.zL, st.zU),
        constraint_violation=viol_raw,
        kkt_path=KKT_PATHS.index(kkt_path),
        jac_path=JAC_PATHS.index(jac_path),
        precision_path=PRECISION_PATHS.index(precision_path),
    )
    return SolverResult(
        w=st.w * d_w,
        y=(s_g * st.y / sf_c) if m_e else st.y,
        z=(s_h * st.z / sf_c) if m_h else st.z,
        s=st.s / torch.clamp_min(s_h, 1e-12) if m_h else st.s,
        stats=stats)
