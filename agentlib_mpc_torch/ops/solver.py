"""Primal-dual interior-point NLP solver, batch-first.

Port of ``agentlib_mpc_tpu/ops/solver.py`` (lines 71-205, 266-611,
614-663, 666-1276): the same method, options, stats and acceptance logic.

Problem form:
    min f(w)   s.t.  g(w) = 0,   h(w) >= 0,   w_lb <= w <= w_ub

Method (IPOPT structure, Waechter & Biegler 2006): log-barrier on the box
of ``w`` with bound duals, slacks for ``h``, monotone Fiacco–McCormick
barrier schedule, fraction-to-boundary steps, an l1-merit line search that
evaluates all ``ls_samples`` backtracking candidates in one batched call,
adaptive Levenberg regularization, variable and gradient-based row scaling,
and the optional Mehrotra corrector re-solving against the same factor.

Batch-first. The JAX package writes the solver per problem and vmaps a
``lax.while_loop`` over the zones. Here every state field carries a leading
batch axis and the loop is written out: each pass computes
``active = ~done & (it < budget)`` from the OLD state, runs the body on all
lanes, and keeps the new value of every field only where the lane was
active (``torch.where``, never a mask product: a frozen lane's body may
produce NaN). The loop stops when no lane is active — one host sync per
interior-point iteration. The model functions stay per-problem; their
values and derivatives are batched with ``torch.func.vmap`` (``jacrev`` for
the carried Jacobians, ``hessian`` for the Lagrangian). The heavy parts of
an iteration run under ``torch.profiler.record_function`` ranges named
after the JAX package's phases (``ipm.eval_jac``, ``ipm.assemble``,
``ipm.factor``, ``ipm.resolve``, ``ipm.line_search``), so a profile reads
per phase; the rest is elementwise step arithmetic.

KKT paths. ``kkt_method`` resolves statically (``ops/kkt.
resolve_kkt_method``): "ldl" is the dense LDLᵀ kernels, "stage" the
block-tridiagonal sweep of ``ops/stagewise.py`` over the stage partition
attached with :func:`attach_stage_partition` (the sweep's stage blocks go
through the same two kernels on CUDA), "lu" pivoted LU. The factor carries
its path's tag, so a resolve can never take another path than its factor.

Derivative pipelines. ``jacobian`` resolves statically
(:func:`_resolve_jacobian`, the JAX package's chain): "dense" evaluates
the stacked Jacobian by ``jacrev`` and the Lagrangian Hessian by
``hessian``; "sparse" takes the stage-sparse pipeline of
``ops/stagejac.py`` — compressed pullbacks and Hessian seeds, banded row
windows carried instead of dense Jacobians, and the KKT system assembled
straight into stage blocks for ``factor_kkt_stage_banded``. "sparse" needs
a ``stage_jacobian_plan``, which only a proved stage-structure certificate
builds (:func:`attach_jacobian_plan`, ``stagejac.attach_plan_if_
worthwhile``); "auto" takes it where a plan is attached, the KKT path
resolves to the stage sweep and the size clears ``jacobian_min_size``.

Options this port does not serve yet raise ``NotImplementedError``:
``precision="mixed"`` / ``"require"`` and ``fusion="require"``. "auto"
values resolve as the JAX package does off a TPU: ``precision`` → "full",
``fused_ls_jacobian`` → "off".
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacrev, vmap
from torch.profiler import record_function
from torch.utils._pytree import tree_map

from agentlib_mpc_torch.ops import kkt as kkt_ops
from agentlib_mpc_torch.ops import stagejac as sjac
from agentlib_mpc_torch.ops import stagewise as stage_ops
from agentlib_mpc_torch.utils.device import resolve_device


class NLPFunctions(NamedTuple):
    """f, g, h as pure functions of (w_flat, theta) for ONE problem."""

    f: Callable
    g: Callable
    h: Callable


class SolverOptions(NamedTuple):
    max_iter: int = 100
    tol: float = 1e-6
    #: secondary convergence criteria (IPOPT acceptable_* semantics)
    dual_inf_tol: float = 1.0e4
    constr_viol_tol: float = 1e-4
    compl_inf_tol: float = 1e-2
    mu_init: float = 1e-1
    mu_linear_decrease: float = 0.2     # kappa_mu
    mu_superlinear_power: float = 1.5   # theta_mu
    barrier_tol_factor: float = 10.0    # kappa_epsilon
    tau_min: float = 0.99               # fraction-to-boundary
    armijo_eta: float = 1e-4
    #: number of parallel backtracking candidates alpha_max * 0.5^k
    ls_samples: int = 25
    delta_init: float = 1e-8
    delta_max: float = 1e6
    delta_c: float = 1e-8
    bound_push: float = 1e-2            # kappa_1: push w0 off its bounds
    scaling_grad_max: float = 10.0
    scale_variables: bool = True
    #: centrality clip for all dual variables (IPOPT kappa_sigma)
    kappa_sigma: float = 1e10
    #: KKT linear solver: "auto" → the LDLᵀ kernels on CUDA where the
    #: system fits a block's shared memory; else the stage sweep when a
    #: matching ``stage_partition`` is attached and the system has at
    #: least ``stage_min_size`` rows; else pivoted LU. "ldl" / "lu" /
    #: "stage" force a path ("stage" requires a matching partition)
    kkt_method: str = "auto"
    #: evaluate values+Jacobians of ALL line-search candidates in the one
    #: batched trial call and select the accepted one; "auto" → "off"
    fused_ls_jacobian: str = "auto"
    #: Mehrotra-style second-order corrector (one extra back-substitution
    #: per iteration against the same factor)
    corrector: bool = False
    #: stage metadata of the transcribed OCP's KKT system
    #: (``TranscribedOCP.stage_partition``, attached by
    #: :func:`attach_stage_partition`); required by ``kkt_method="stage"``,
    #: consulted by "auto"
    stage_partition: Any = None
    #: "auto" crossover: smallest KKT dimension routed to the stage sweep
    #: (the JAX package's, measured against dense LU)
    stage_min_size: int = 192
    #: derivative pipeline: "dense" (jacrev/hessian), "sparse" (the
    #: stage-sparse pipeline; needs ``stage_jacobian_plan``) or "auto"
    #: (sparse where a plan is attached, the KKT path resolves to the stage
    #: sweep and the size is at least ``jacobian_min_size``)
    jacobian: str = "auto"
    jacobian_min_size: int = 384
    #: certificate-backed ``stagejac.StageJacobianPlan``, attached by
    #: :func:`attach_jacobian_plan`
    stage_jacobian_plan: Any = None
    #: "auto"/"off" run the same eager program; "require" needs the
    #: certifiers (not ported)
    fusion: str = "auto"
    #: "auto"/"f64" → full precision; "mixed"/"require" not ported
    precision: str = "auto"


#: factor-path codes carried in ``SolverStats.kkt_path``
KKT_PATHS = ("lu", "ldl", "stage")
#: derivative-pipeline codes carried in ``SolverStats.jac_path``
JAC_PATHS = ("dense", "sparse")
#: precision-routing codes carried in ``SolverStats.precision_path``
PRECISION_PATHS = ("full", "mixed")
#: codes of ``SolverStats.init_point_source`` (the learned warm start of
#: ROADMAP Queue 1 item 5 sets 1 and 2; the port's solves report -1)
INIT_POINT_SOURCES = ("plain", "predicted", "predicted_rejected")


def _path_name(code, table) -> "str | None":
    """Decode a path code (int or tensor, possibly batched) against
    ``table``; None for -1."""
    if isinstance(code, torch.Tensor):
        code = code.reshape(-1)[0]
    i = int(code)
    return table[i] if 0 <= i < len(table) else None


def kkt_path_name(code) -> "str | None":
    """Human-readable factor path from a ``SolverStats.kkt_path`` value."""
    return _path_name(code, KKT_PATHS)


def jac_path_name(code) -> "str | None":
    """Human-readable derivative path from ``SolverStats.jac_path``."""
    return _path_name(code, JAC_PATHS)


def init_point_source_name(code) -> "str | None":
    """Human-readable provenance from one ``init_point_source`` value;
    None for -1 (callers label those "plain")."""
    return _path_name(code, INIT_POINT_SOURCES)


class SolverStats(NamedTuple):
    iterations: torch.Tensor
    kkt_error: torch.Tensor
    success: torch.Tensor
    objective: torch.Tensor
    mu: torch.Tensor
    constraint_violation: torch.Tensor
    kkt_path: int = -1
    jac_path: int = -1
    init_point_source: int = -1
    precision_path: int = -1


class SolverResult(NamedTuple):
    w: torch.Tensor
    y: torch.Tensor       # equality multipliers
    z: torch.Tensor       # inequality multipliers for h
    s: torch.Tensor       # slacks for h
    stats: SolverStats


class _IPState(NamedTuple):
    w: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    zL: torch.Tensor
    zU: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    kkt0: torch.Tensor
    best_err: torch.Tensor
    stall: torch.Tensor
    #: consecutive iterations whose line search made no Armijo progress
    #: (no candidate accepted, or one accepted only within the noise)
    frozen: torch.Tensor
    # carried first-order information of the current iterate
    fv: torch.Tensor      # (B,) objective value
    gf: torch.Tensor      # (B, n) objective gradient
    gv: torch.Tensor      # (B, m_e) equality residuals
    Jg: torch.Tensor      # (B, m_e, n); banded rows (B, m_e, W_g) if sparse
    hv: torch.Tensor      # (B, m_h) inequality residuals
    Jh: torch.Tensor      # (B, m_h, n); banded rows (B, m_h, W_h) if sparse


#: a callable that receives, per interior-point iteration, a dict of the
#: line search's and the barrier update's tensors (one entry per lane);
#: None (the default) records nothing. ``scripts/module_f32_witness.py``
#: sets it to trace a solve.
ITERATION_TRACE = None


# ---- option resolution ------------------------------------------------------

def attach_stage_partition(options: SolverOptions,
                           partition) -> SolverOptions:
    """Attach a transcribed OCP's stage partition to solver options when
    they could use it (``kkt_method`` "auto"/"stage" and none attached
    yet)."""
    if (partition is not None and options.stage_partition is None
            and options.kkt_method in ("auto", "stage")):
        return options._replace(stage_partition=partition)
    return options


def attach_jacobian_plan(options: SolverOptions, plan) -> SolverOptions:
    """Attach a certificate-backed stage-sparse derivative plan when the
    options could use it (``jacobian`` "auto"/"sparse" and none attached
    yet) — the sibling of :func:`attach_stage_partition` for the
    derivative side of the stage pipeline."""
    if (plan is not None and options.stage_jacobian_plan is None
            and options.jacobian in ("auto", "sparse")):
        return options._replace(stage_jacobian_plan=plan)
    return options


def plan_worthwhile(options: SolverOptions, partition, device=None) -> bool:
    """Would a stage-sparse derivative plan be used on ``device``? (The JAX
    package's gate in front of stage-structure certification; pure logic
    here.) True only when the sparse pipeline could be routed: ``jacobian``
    not "dense", no plan attached yet, a partition exists, and — unless
    "sparse" is forced — the fused line search is off, the size clears
    ``jacobian_min_size`` and ``kkt_method`` resolves to the stage sweep
    (on "auto": not the dense kernels, and at least ``stage_min_size``)."""
    if options is None:
        return False
    if options.jacobian == "dense" or options.stage_jacobian_plan is not None:
        return False
    if partition is None:
        return False
    if options.jacobian == "sparse":
        return True
    if options.fused_ls_jacobian == "on":
        return False
    size = partition.n_total
    if size < options.jacobian_min_size:
        return False
    if options.kkt_method == "stage":
        return True
    if options.kkt_method != "auto" or size < options.stage_min_size:
        return False
    dev = resolve_device(device)
    return (kkt_ops.resolve_kkt_method("auto", size, dev, partition,
                                       options.stage_min_size) == "stage"
            and stage_ops.stage_method_available(partition, dev))


def _resolve_precision(opts: SolverOptions) -> str:
    precision = opts.precision
    if precision not in ("auto", "f64", "mixed", "require"):
        raise ValueError(
            f"precision must be 'auto', 'f64', 'mixed' or 'require', got "
            f"{precision!r}")
    if precision in ("mixed", "require"):
        raise NotImplementedError(
            f"precision={precision!r} needs the precision certifier, which "
            f"the port has not ported yet (ROADMAP Queue 1: certifiers)")
    return "full"


def _resolve_jacobian(opts: SolverOptions, size: int, device,
                      dtype: torch.dtype = torch.float32) -> str:
    """Static routing of the derivative pipeline ("dense"/"sparse").

    A ``stage_jacobian_plan`` exists only where the stage-structure
    certificate proved the band, so "auto" routes sparse exactly where (a)
    the proof exists, (b) the stage sweep is the resolved KKT path (the
    banded assembly feeds it) and (c) the size clears
    ``jacobian_min_size``. Forcing "sparse" skips the crossovers but still
    demands the proof."""
    jac = opts.jacobian
    if jac not in ("auto", "dense", "sparse"):
        raise ValueError(
            f"jacobian must be 'auto', 'dense' or 'sparse', got {jac!r}")
    plan = opts.stage_jacobian_plan
    if (plan is not None and opts.stage_partition is not None
            and plan.partition != opts.stage_partition):
        raise ValueError(
            "stage_jacobian_plan and stage_partition describe different "
            "partitions — attach both from the same TranscribedOCP")
    if jac == "dense":
        return "dense"
    if jac == "sparse":
        if plan is None:
            raise ValueError(
                "jacobian='sparse' requires a stage_jacobian_plan — it is "
                "attached from a PROVED stage-structure certificate "
                "(stagejac.plan_from_certificate); refuted/unknown "
                "structure must stay on the dense pipeline")
        if plan.partition.n_total != size:
            raise ValueError(
                f"stage_jacobian_plan covers a {plan.partition.n_total}-"
                f"dim KKT system; this problem is {size}")
        if opts.kkt_method not in ("auto", "stage"):
            raise ValueError(
                f"jacobian='sparse' assembles the banded stage KKT; "
                f"kkt_method={opts.kkt_method!r} contradicts it")
        if opts.fused_ls_jacobian == "on":
            raise ValueError(
                "fused_ls_jacobian='on' is incompatible with "
                "jacobian='sparse' (the fused line search carries dense "
                "trial Jacobians)")
        return "sparse"
    if (plan is None or plan.partition.n_total != size
            or opts.fused_ls_jacobian == "on"):
        return "dense"
    resolved = kkt_ops.resolve_kkt_method(opts.kkt_method, size, device,
                                          plan.partition,
                                          opts.stage_min_size, dtype)
    if resolved != "stage" or size < opts.jacobian_min_size:
        return "dense"
    return "sparse"


def _resolve_paths(opts: SolverOptions, size: int, device,
                   dtype: torch.dtype = torch.float32):
    """(jac_path, kkt_path, plan) for a ``size``-dim KKT system of
    ``dtype``: the sparse pipeline assembles the banded stage system
    directly, so it IS the stage factor path (a forced "sparse" skips the
    size floor)."""
    jac_path = _resolve_jacobian(opts, size, device, dtype)
    if jac_path == "sparse":
        return jac_path, "stage", opts.stage_jacobian_plan
    return jac_path, kkt_ops.resolve_kkt_method(
        opts.kkt_method, size, device, opts.stage_partition,
        opts.stage_min_size, dtype), None


# ---- KKT factor / resolve -----------------------------------------------------

def _factor_kkt_lu(K):
    """Equilibrate + LU-factor once (pivoted)."""
    Ks, scale = kkt_ops.equilibrate(K)
    lu, piv, _ = torch.linalg.lu_factor_ex(Ks)
    return (lu, piv, Ks, scale)


def _resolve_kkt_lu(factor, rhs):
    """Solve with a stored LU factor + two refinement steps."""
    lu, piv, Ks, scale = factor
    rs = rhs * scale
    x = torch.linalg.lu_solve(lu, piv, rs[..., None])[..., 0]
    for _ in range(2):
        r = rs - torch.matmul(Ks, x[..., None])[..., 0]
        x = x + torch.linalg.lu_solve(lu, piv, r[..., None])[..., 0]
    return x * scale


def _factor_kkt(K, method: str, partition=None):
    """Factor once; the factor carries its method tag so the resolve path
    cannot diverge from the factor path."""
    if method == "stage":
        return ("stage", (stage_ops.factor_kkt_stage(K, partition),
                          partition))
    if method == "ldl":
        return ("ldl", kkt_ops.factor_kkt_ldl(K))
    return ("lu", _factor_kkt_lu(K))


def _resolve_kkt(factor, rhs):
    kind, f = factor
    if kind == "stage":
        stage_factor, partition = f
        return stage_ops.resolve_kkt_stage(stage_factor, rhs, partition)
    if kind == "stage_banded":
        # the stage-sparse assembly: the factor was built from (D, E)
        # blocks; refinement runs on the banded product (exact: the
        # certificate proved out-of-band entries structurally zero)
        banded_factor, partition = f
        return stage_ops.resolve_kkt_stage_banded(banded_factor, rhs,
                                                  partition)
    if kind == "ldl":
        return kkt_ops.resolve_kkt_ldl(f, rhs)
    return _resolve_kkt_lu(f, rhs)


# ---- small batched helpers ------------------------------------------------------

def _safe_max(x):
    """max over the last axis including 0 (``jnp.max(x, initial=0.0)``);
    zeros where the axis is empty."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return torch.clamp_min(x.amax(dim=-1), 0.0)


def _max_step(v, dv, tau):
    """Largest alpha in (0,1] with v + alpha*dv >= (1-tau)*v (for v > 0),
    per lane; ``tau`` is (B,)."""
    if v.shape[-1] == 0:
        return v.new_ones(v.shape[:-1])
    neg = dv < 0
    ratio = torch.where(neg, -tau[..., None] * v
                        / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.ones_like(v))
    return torch.clamp_max(ratio.amin(dim=-1), 1.0)


def _clip(x, lo, hi):
    """``jnp.clip``: minimum(maximum(x, lo), hi), elementwise tensors."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _mv(A, v):
    """Batched matrix-vector product (B, m, n) @ (B, n) → (B, m)."""
    return torch.matmul(A, v[..., None])[..., 0]


def _rmv(A, v):
    """Batched transposed product Aᵀ v: (B, m, n), (B, m) → (B, n)."""
    return torch.matmul(A.transpose(-1, -2), v[..., None])[..., 0]


#: held by every solve (both solvers enter through :func:`_true_f32_matmul`):
#: the TF32 switch and the forward-mode AD levels of ``torch.func``'s
#: ``jvp`` are process state, so two threads (the real-time ADMM module's
#: workers) must not interleave solves; interleaved, the derivatives fail
#: ("forward AD level with an invalid index") or a solve runs with TF32 on
SOLVE_LOCK = threading.RLock()


@contextlib.contextmanager
def _true_f32_matmul():
    """KKT math needs true-f32 products: run with TF32 off and restore the
    caller's setting afterwards, holding :data:`SOLVE_LOCK`."""
    with SOLVE_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _theta_dims(theta):
    """vmap in_dims for a theta pytree: tensors batched on axis 0."""
    return tree_map(lambda t: 0 if isinstance(t, torch.Tensor) else None,
                    theta)


def _row_scaling(nlp, w0, theta, th_dims, d_w, gmax, m_e, m_h, plan=None):
    """Gradient-based row scaling of (f, g, h) at ``w0`` (IPOPT
    ``nlp_scaling``), per lane: ``(s_f (B,), s_g (B, m_e), s_h (B, m_h))``.
    Shared by the NLP and QP solvers: row maxes from ONE banded eval on the
    sparse pipeline, from per-row ``jacrev`` on the dense one."""
    in_dims = (0, th_dims)
    if plan is not None:
        ix = plan.tensors(w0.device)

        def raw_fgh(w, th):
            return torch.cat([nlp.f(w, th).reshape(1), nlp.g(w, th),
                              nlp.h(w, th)])

        _, gf0, Jg0, Jh0 = sjac.banded_fgh_jac(plan, raw_fgh, w0, theta,
                                                in_dims=(th_dims,))
        s_f = torch.clamp_max(
            gmax / torch.clamp_min(_safe_max((gf0 * d_w).abs()), 1e-8), 1.0)
        s_g = torch.clamp_max(gmax / torch.clamp_min(
            sjac.band_row_absmax(Jg0, ix["g_cols"], d_w), 1e-8), 1.0)
        s_h = torch.clamp_max(gmax / torch.clamp_min(
            sjac.band_row_absmax(Jh0, ix["h_cols"], d_w), 1e-8), 1.0)
        return s_f, s_g, s_h
    gf0 = vmap(jacrev(nlp.f), in_dims=in_dims)(w0, theta) * d_w
    s_f = torch.clamp_max(gmax / torch.clamp_min(_safe_max(gf0.abs()), 1e-8),
                          1.0)

    def row_scale(fn, m):
        if not m:
            return w0.new_zeros(w0.shape[:-1] + (0,))
        J = vmap(jacrev(fn), in_dims=in_dims)(w0, theta) * d_w[:, None, :]
        return torch.clamp_max(
            gmax / torch.clamp_min(J.abs().amax(dim=-1), 1e-8), 1.0)

    return s_f, row_scale(nlp.g, m_e), row_scale(nlp.h, m_h)


# ---- entry points ------------------------------------------------------------------

def solve_nlp(nlp: NLPFunctions, w0, theta, w_lb, w_ub,
              options: SolverOptions = SolverOptions(), y0=None, z0=None,
              mu0=None, max_iter=None) -> SolverResult:
    """Solve ONE NLP (a batch of one through :func:`solve_nlp_batched`).
    ``theta`` may be any pytree (or None); ``mu0`` overrides
    ``options.mu_init`` and ``max_iter`` overrides ``options.max_iter``."""
    add = lambda t: t.unsqueeze(0) if isinstance(t, torch.Tensor) else t
    res = solve_nlp_batched(
        nlp, add(w0), tree_map(add, theta), add(w_lb), add(w_ub), options,
        y0=add(y0), z0=add(z0), mu0=mu0, max_iter=max_iter)
    drop = lambda t: t[0] if isinstance(t, torch.Tensor) else t
    return SolverResult(w=res.w[0], y=res.y[0], z=res.z[0], s=res.s[0],
                        stats=SolverStats(*(drop(v) for v in res.stats)))


def solve_nlp_batched(nlp: NLPFunctions, w0, theta, w_lb, w_ub,
                      options: SolverOptions = SolverOptions(), y0=None,
                      z0=None, mu0=None, max_iter=None) -> SolverResult:
    """Solve a batch of structure-identical NLPs (the JAX package vmaps
    ``solve_nlp``). ``w0``, ``w_lb``, ``w_ub`` are (B, n); every tensor
    leaf of ``theta`` is batched on axis 0; ``y0`` (B, m_e) and ``z0``
    (B, m_h) warm-start the duals; ``mu0`` (a number or a (B,) tensor) and
    ``max_iter`` (one budget for all lanes) are optional overrides.
    Runs on the device of ``w0`` with TF32 off."""
    with _true_f32_matmul():
        return _solve_batched(nlp, w0, theta, w_lb, w_ub, options, y0, z0,
                              mu0, max_iter)


def _solve_batched(nlp, w0, theta, w_lb, w_ub, opts, y0, z0, mu0_arg,
                   max_iter_arg) -> SolverResult:
    if opts.fused_ls_jacobian not in ("auto", "on", "off"):
        raise ValueError(
            f"fused_ls_jacobian must be 'auto', 'on' or 'off', got "
            f"{opts.fused_ls_jacobian!r}")
    if opts.fusion not in ("auto", "off", "require"):
        raise ValueError(
            f"fusion must be 'auto', 'off' or 'require', got {opts.fusion!r}")
    if opts.fusion == "require":
        raise NotImplementedError(
            "fusion='require' needs the dispatch/fusion certifiers, which the "
            "port has not ported yet (ROADMAP Queue 1: certifiers)")
    dtype, device = w0.dtype, w0.device
    eps = torch.finfo(dtype).eps
    B, n = w0.shape
    th_dims = _theta_dims(theta)
    lane0 = tree_map(lambda t: t[0] if isinstance(t, torch.Tensor) else t,
                     theta)
    m_e = int(nlp.g(w0[0], lane0).shape[0])
    m_h = int(nlp.h(w0[0], lane0).shape[0])

    kkt_size = n + m_e if m_e else n
    jac_path, kkt_path, plan = _resolve_paths(opts, kkt_size, device,
                                              w0.dtype)
    precision_path = _resolve_precision(opts)
    # the fused line search carries per-candidate DENSE Jacobians
    fused_ls = jac_path == "dense" and opts.fused_ls_jacobian == "on"

    # ---- automatic scaling ---------------------------------------------------
    if opts.scale_variables:
        d_w = torch.clamp_min(w0.abs(), 1.0)
    else:
        d_w = torch.ones_like(w0)
    s_f, s_g, s_h = _row_scaling(nlp, w0, theta, th_dims, d_w,
                                 opts.scaling_grad_max, m_e, m_h, plan)
    lb = w_lb / d_w
    ub = w_ub / d_w
    # per-lane scaling data passed alongside theta through vmap
    sc = (d_w, s_f, s_g, s_h, theta)
    sc_dims = (0, 0, 0, 0, th_dims)

    def fgh_lane(w, d_w_, s_f_, s_g_, s_h_, th):
        """Stacked scaled values [f, g..., h...] of ONE problem."""
        ww = w * d_w_
        return torch.cat([(s_f_ * nlp.f(ww, th)).reshape(1),
                          s_g_ * nlp.g(ww, th), s_h_ * nlp.h(ww, th)])

    def fgh_jac_lane(w, *sc_):
        """Values and Jacobian of the stacked residual in one pass."""
        jac, vals = jacrev(lambda ww: (fgh_lane(ww, *sc_),) * 2,
                           has_aux=True)(w)
        return vals, jac

    def lagrangian_lane(w, y, z_h, d_w_, s_f_, s_g_, s_h_, th):
        ww = w * d_w_
        val = s_f_ * nlp.f(ww, th)
        if m_e:
            val = val + y @ (s_g_ * nlp.g(ww, th))
        if m_h:
            val = val - z_h @ (s_h_ * nlp.h(ww, th))
        return val

    if plan is not None:
        # carried Jacobians are banded row windows (B, m_e, 3 v_s) /
        # (B, m_h, 2 v_s) instead of the dense (B, m, n)
        ix = plan.tensors(device)

        def fgh_and_jac(w, *sc_):
            vals, gf, Jg_rows, Jh_rows = sjac.banded_fgh_jac(
                plan, fgh_lane, w, *sc_, in_dims=sc_dims)
            return vals, (gf, Jg_rows, Jh_rows)

        def split(vals, jac):
            gf, Jg, Jh = jac
            return (vals[:, 0], gf, vals[:, 1:1 + m_e], Jg,
                    vals[:, 1 + m_e:], Jh)

        jg_t_mv = lambda Jg, v: sjac.band_rmatvec(Jg, ix["g_cols"], v, n)
        jh_t_mv = lambda Jh, v: sjac.band_rmatvec(Jh, ix["h_cols"], v, n)
        jh_mv = lambda Jh, x: sjac.band_matvec(Jh, ix["h_cols"], x)
    else:
        fgh_and_jac = vmap(fgh_jac_lane, in_dims=(0, *sc_dims))

        def split(vals, jac):
            return (vals[:, 0], jac[:, 0], vals[:, 1:1 + m_e],
                    jac[:, 1:1 + m_e], vals[:, 1 + m_e:], jac[:, 1 + m_e:])

        jg_t_mv, jh_t_mv, jh_mv = _rmv, _rmv, _mv
    fgh_trials = vmap(vmap(fgh_lane, in_dims=(0, None, None, None, None,
                                               None)),
                      in_dims=(0, *sc_dims))
    fgh_jac_trials = vmap(vmap(fgh_jac_lane, in_dims=(0, None, None, None,
                                                       None, None)),
                          in_dims=(0, *sc_dims))
    hess_l = vmap(hessian(lagrangian_lane, argnums=0),
                  in_dims=(0, 0, 0, *sc_dims))
    grad_l = grad(lagrangian_lane, argnums=0)

    # dtype-aware barrier floor and feasibility target (see the JAX
    # package: the f32 noise floor of the scaled constraints)
    mu_floor = max(opts.tol / 10.0, 100.0 * eps)
    viol_tol = max(opts.constr_viol_tol, 1e3 * eps)

    # ---- initial point -------------------------------------------------------
    span = torch.clamp_min(ub - lb, 1e-8)
    push = opts.bound_push * torch.clamp_max(span, 1.0)
    w_init = _clip(w0 / d_w, lb + push, ub - push)
    mu0 = torch.as_tensor(opts.mu_init if mu0_arg is None else mu0_arg,
                          dtype=dtype, device=device).expand(B).clone()
    vals0, jac0 = fgh_and_jac(w_init, *sc)
    fv0, gf_i, gv_i, Jg_i, hv_i, Jh_i = split(vals0, jac0)
    empty = w0.new_zeros((B, 0))
    if m_h:
        s_init = torch.clamp_min(hv_i, 1e-2)
        z_init = torch.clamp(mu0[:, None] / s_init, 1e-8, 1e8)
        if z0 is not None:
            z_init = torch.clamp_min(
                s_f[:, None] * z0 / torch.clamp_min(s_h, 1e-12), 1e-8)
    else:
        s_init = z_init = empty
    if y0 is not None and m_e:
        y_init = s_f[:, None] * y0 / torch.clamp_min(s_g, 1e-12)
    else:
        y_init = w0.new_zeros((B, m_e))
    zL_init = torch.clamp(mu0[:, None] / (w_init - lb), 1e-12, 1e8)
    zU_init = torch.clamp(mu0[:, None] / (ub - w_init), 1e-12, 1e8)

    def kkt_error(gf, Jg, Jh, gv, hv, s, y, z, zL, zU, w, mu):
        """Scaled optimality error E_mu (IPOPT eq. 5) per lane; ``mu`` is
        (B,) or a number."""
        mu_c = mu[:, None] if isinstance(mu, torch.Tensor) else mu
        r_w = gf - zL + zU
        if m_e:
            r_w = r_w + jg_t_mv(Jg, y)
        if m_h:
            r_w = r_w - jh_t_mv(Jh, z)
        r_h = hv - s
        comp = torch.cat([s * z - mu_c, (w - lb) * zL - mu_c,
                          (ub - w) * zU - mu_c], dim=-1)
        s_max = 100.0
        dual_sum = (y.abs().sum(-1) + z.abs().sum(-1) + zL.abs().sum(-1)
                    + zU.abs().sum(-1))
        s_d = torch.clamp_min(dual_sum / (m_e + m_h + 2 * n), s_max) / s_max
        dual_inf = _safe_max(r_w.abs()) / s_d
        viol = torch.maximum(_safe_max(gv.abs()), _safe_max(r_h.abs()))
        compl_inf = _safe_max(comp.abs()) / s_d
        err = torch.maximum(torch.maximum(dual_inf, viol), compl_inf)
        return err, viol, dual_inf, compl_inf

    def body(st: _IPState) -> _IPState:
        w, s, y, z, zL, zU = st.w, st.s, st.y, st.z, st.zL, st.zU
        mu, delta = st.mu, st.delta
        mu_c = mu[:, None]
        gf, Jg, Jh = st.gf, st.Jg, st.Jh
        gv, hv = st.gv, st.hv

        r_h = hv - s
        dL = torch.clamp_min(w - lb, 1e-12)
        dU = torch.clamp_min(ub - w, 1e-12)
        sigma_s = z / torch.clamp_min(s, 1e-12) if m_h else s
        sigma_L = zL / dL
        sigma_U = zU / dU
        r_w = gf - zL + zU
        if m_e:
            r_w = r_w + jg_t_mv(Jg, y)
        if m_h:
            r_w = r_w - jh_t_mv(Jh, z)

        # ---- assemble + factor the reduced KKT system ---------------------
        if plan is not None:
            # compressed Hessian columns (3·v_s forward passes instead of
            # n) assembled straight into the banded stage layout
            with record_function("ipm.eval_jac"):
                CH = sjac.banded_lagrangian_hessian(
                    plan, grad_l, w, y, z, *sc, in_dims=(0, 0, *sc_dims))
            with record_function("ipm.assemble"):
                D, E = sjac.assemble_kkt_banded(
                    plan, CH, Jg, Jh, sigma_s if m_h else w.new_zeros((B, 0)),
                    delta[:, None] + sigma_L + sigma_U, opts.delta_c)
            with record_function("ipm.factor"):
                factor = ("stage_banded",
                          (stage_ops.factor_kkt_stage_banded(D, E),
                           plan.partition))
        else:
            with record_function("ipm.eval_jac"):
                H = hess_l(w, y, z, *sc)
            with record_function("ipm.assemble"):
                W = H + torch.diag_embed(delta[:, None] + sigma_L + sigma_U)
                if m_h:
                    W = W + torch.matmul(Jh.transpose(-1, -2),
                                         sigma_s[..., None] * Jh)
                if m_e:
                    reg = -opts.delta_c * torch.eye(m_e, dtype=dtype,
                                                    device=device)
                    K = torch.cat([torch.cat([W, Jg.transpose(-1, -2)],
                                             dim=-1),
                                   torch.cat([Jg, reg.expand(B, m_e, m_e)],
                                             dim=-1)], dim=-2)
                else:
                    K = W
            with record_function("ipm.factor"):
                factor = _factor_kkt(K, kkt_path, opts.stage_partition)

        def newton_dir(rhs_w_k, mu_s, mu_L, mu_U):
            """Direction from the stored factor for (possibly per-entry)
            complementarity targets."""
            if m_e:
                sol = _resolve_kkt(factor, torch.cat([rhs_w_k, -gv], dim=-1))
                dw_k, dy_k = sol[:, :n], sol[:, n:]
            else:
                dw_k = _resolve_kkt(factor, rhs_w_k)
                dy_k = empty
            ds_k = (jh_mv(Jh, dw_k) + r_h) if m_h else s
            dz_k = (mu_s / torch.clamp_min(s, 1e-12) - z
                    - sigma_s * ds_k) if m_h else z
            dzL_k = mu_L / dL - zL - sigma_L * dw_k
            dzU_k = mu_U / dU - zU + sigma_U * dw_k
            return dw_k, dy_k, ds_k, dz_k, dzL_k, dzU_k

        def rhs_for(mu_s, mu_L, mu_U):
            """rhs with eliminated bound duals and slacks."""
            out = -r_w + (mu_L / dL - zL) - (mu_U / dU - zU)
            if m_h:
                corr = mu_s / torch.clamp_min(s, 1e-12) - z - sigma_s * r_h
                out = out + jh_t_mv(Jh, corr)
            return out

        with record_function("ipm.resolve"):
            # predictor: plain barrier target mu
            dw, dy, ds, dz, dzL, dzU = newton_dir(
                rhs_for(mu_c, mu_c, mu_c), mu_c, mu_c, mu_c)
            if opts.corrector:
                # Mehrotra second-order correction, targets clipped to
                # [0, 10 mu] (Gondzio safeguard)
                top = 10.0 * mu_c
                mu_L = torch.minimum(torch.clamp_min(mu_c - dw * dzL, 0.0),
                                     top)
                mu_U = torch.minimum(torch.clamp_min(mu_c + dw * dzU, 0.0),
                                     top)
                mu_s = torch.minimum(torch.clamp_min(mu_c - ds * dz, 0.0),
                                     top) if m_h else mu_c
                dw, dy, ds, dz, dzL, dzU = newton_dir(
                    rhs_for(mu_s, mu_L, mu_U), mu_s, mu_L, mu_U)

        # ---- fraction to boundary -----------------------------------------
        tau = torch.clamp_min(1.0 - mu, opts.tau_min)
        alpha_p = torch.minimum(_max_step(dL, dw, tau),
                                _max_step(dU, -dw, tau))
        if m_h:
            alpha_p = torch.minimum(alpha_p, _max_step(s, ds, tau))
        alpha_d = torch.minimum(_max_step(zL, dzL, tau),
                                _max_step(zU, dzU, tau))
        if m_h:
            alpha_d = torch.minimum(alpha_d, _max_step(z, dz, tau))

        # ---- l1 merit, parallel backtracking ------------------------------
        nu = 2.0 * torch.clamp_min(
            torch.maximum(_safe_max((y + dy).abs()),
                          _safe_max((z + dz).abs())), 1.0)

        def merit_terms(ww, ss, fvv, gvv, hvv, lb_, ub_, mu_, nu_):
            barrier = (torch.log(torch.clamp_min(ww - lb_, 1e-30)).sum(-1)
                       + torch.log(torch.clamp_min(ub_ - ww, 1e-30)).sum(-1))
            infeas = gvv.abs().sum(-1) if m_e else 0.0
            if m_h:
                barrier = barrier + torch.log(torch.clamp_min(ss, 1e-30)).sum(-1)
                infeas = infeas + (hvv - ss).abs().sum(-1)
            return fvv - mu_ * barrier + nu_ * infeas

        phi0 = merit_terms(w, s, st.fv, gv, hv, lb, ub, mu, nu)
        infeas0 = (gv.abs().sum(-1) if m_e else 0.0) + r_h.abs().sum(-1)
        dphi = ((gf * dw).sum(-1)
                - mu * ((dw / dL).sum(-1) - (dw / dU).sum(-1))
                - ((mu * (ds / torch.clamp_min(s, 1e-12)).sum(-1))
                   if m_h else 0.0)
                - nu * infeas0)
        noise = 10.0 * eps * (1.0 + phi0.abs())

        # all candidate steps alpha_max * 0.5^k in ONE batched evaluation;
        # the largest accepted candidate wins
        halves = 0.5 ** torch.arange(opts.ls_samples, dtype=dtype,
                                     device=device)
        alphas = alpha_p[:, None] * halves                     # (B, L)
        trial_w = w[:, None, :] + alphas[..., None] * dw[:, None, :]
        trial_s = s[:, None, :] + alphas[..., None] * ds[:, None, :] \
            if m_h else w0.new_zeros((B, opts.ls_samples, 0))
        with record_function("ipm.line_search"):
            if fused_ls:
                trial_vals, trial_jacs = fgh_jac_trials(trial_w, *sc)
            else:
                trial_vals = fgh_trials(trial_w, *sc)
        phis = merit_terms(trial_w, trial_s, trial_vals[..., 0],
                           trial_vals[..., 1:1 + m_e],
                           trial_vals[..., 1 + m_e:], lb[:, None], ub[:, None],
                           mu[:, None], nu[:, None])
        # finite-merit requirement: a singular/indefinite KKT solve yields
        # non-finite steps — those must reject so delta bumps
        armijo = phi0[:, None] + opts.armijo_eta * alphas \
            * torch.clamp_max(dphi, 0.0)[:, None]
        ok = (phis <= armijo + noise[:, None]) & torch.isfinite(phis)
        accepted = ok.any(dim=-1)
        first_ok = ok.to(torch.int8).argmax(dim=-1)  # alphas descend
        lanes = torch.arange(B, device=device)
        alpha = torch.where(accepted, alphas[lanes, first_ok],
                            torch.zeros_like(alpha_p))
        # a step whose merit neither made the Armijo decrease nor fell by
        # more than the noise allowance made no progress: it counts toward
        # the wedged-search escape below like a rejected search
        progressed = accepted & (phis[lanes, first_ok] <= torch.minimum(
            armijo[lanes, first_ok], phi0 - noise))
        acc = accepted[:, None]

        # select (not multiply): 0 * nan would poison the rejected branch
        def take(v, dv, a):
            return torch.where(acc, v + a[:, None] * dv, v)

        w_n = take(w, dw, alpha)
        s_n = take(s, ds, alpha)
        y_n = take(y, dy, alpha)
        z_n = take(z, dz, alpha_d)
        zL_n = take(zL, dzL, alpha_d)
        zU_n = take(zU, dzU, alpha_d)
        # sigma-bound reset keeps duals near the central path (IPOPT eq. 16)
        kap = opts.kappa_sigma
        if m_h:
            z_ctr = mu_c / torch.clamp_min(s_n, 1e-12)
            z_n = _clip(z_n, z_ctr / kap, torch.clamp_min(z_ctr * kap, 1e-30))
        zL_ctr = mu_c / torch.clamp_min(w_n - lb, 1e-12)
        zL_n = _clip(zL_n, zL_ctr / kap, torch.clamp_min(zL_ctr * kap, 1e-30))
        zU_ctr = mu_c / torch.clamp_min(ub - w_n, 1e-12)
        zU_n = _clip(zU_n, zU_ctr / kap, torch.clamp_min(zU_ctr * kap, 1e-30))
        delta_n = torch.where(
            accepted, torch.clamp_min(delta / 3.0, opts.delta_init),
            torch.clamp_max(delta * 10.0 + 1e-6, opts.delta_max))

        # ---- refresh carried derivatives at the accepted point ------------
        if fused_ls:
            vals_prev = torch.cat([st.fv[:, None], gv, hv], dim=-1)
            jac_prev = torch.cat([gf[:, None, :], Jg, Jh], dim=-2)
            vals_n = torch.where(acc, trial_vals[lanes, first_ok], vals_prev)
            jac_n = torch.where(acc[..., None], trial_jacs[lanes, first_ok],
                                jac_prev)
        else:
            with record_function("ipm.eval_jac"):
                vals_n, jac_n = fgh_and_jac(w_n, *sc)
        fv_n, gf_n, gv_n, Jg_n, hv_n, Jh_n = split(vals_n, jac_n)

        # ---- barrier update -----------------------------------------------
        err_mu, viol_mu, dual_mu, compl_mu = kkt_error(
            gf_n, Jg_n, Jh_n, gv_n, hv_n, s_n, y_n, z_n, zL_n, zU_n, w_n, mu)
        err_0, viol_0, dual_0, compl_0 = kkt_error(
            gf_n, Jg_n, Jh_n, gv_n, hv_n, s_n, y_n, z_n, zL_n, zU_n, w_n, 0.0)
        frozen_n = torch.where(progressed, torch.zeros_like(st.frozen),
                               st.frozen + 1)
        # Fiacco–McCormick test plus the stall and wedged-search escapes
        # (see the JAX package for the history of both). The JAX package
        # counts only rejected searches as wedged; in float32 the port's
        # searches at the precision floor keep accepting merit rises
        # within the noise allowance, which never shrank mu and burnt the
        # budget (scripts/module_f32_witness.py, ``trace`` lines)
        kap_eps = opts.barrier_tol_factor
        shrink = (err_mu <= kap_eps * mu) | (
            (st.stall >= 2) & (viol_0 <= viol_tol)
            & (compl_mu <= kap_eps * mu)) | (
            (frozen_n >= 4) & (viol_0 <= viol_tol))
        mu_n = torch.where(
            shrink,
            torch.clamp_min(torch.minimum(opts.mu_linear_decrease * mu,
                                          mu ** opts.mu_superlinear_power),
                            mu_floor),
            mu)
        improved = err_0 < 0.95 * st.best_err
        stall_n = torch.where(improved, torch.zeros_like(st.stall),
                              st.stall + 1)
        best_n = torch.minimum(st.best_err, err_0)
        mu_small = mu_n <= 2.0 * mu_floor
        acceptable = ((stall_n >= 4) & mu_small
                      & (dual_0 <= opts.dual_inf_tol)
                      & (viol_0 <= viol_tol)
                      & (compl_0 <= opts.compl_inf_tol))
        done = (err_0 <= opts.tol) | acceptable
        if ITERATION_TRACE is not None:
            ITERATION_TRACE(dict(
                it=st.it, mu=mu, alpha=alpha, phi0=phi0, phis=phis,
                first_ok=first_ok, noise=noise, accepted=accepted,
                progressed=progressed, frozen=frozen_n, stall=stall_n,
                err_0=err_0))
        return _IPState(w=w_n, s=s_n, y=y_n, z=z_n, zL=zL_n, zU=zU_n,
                        mu=mu_n, delta=delta_n, it=st.it + 1, done=done,
                        kkt0=err_0, best_err=best_n, stall=stall_n,
                        frozen=frozen_n, fv=fv_n, gf=gf_n, gv=gv_n, Jg=Jg_n,
                        hv=hv_n, Jh=Jh_n)

    budget = int(opts.max_iter if max_iter_arg is None else max_iter_arg)
    err0, _, _, _ = kkt_error(gf_i, Jg_i, Jh_i, gv_i, hv_i, s_init, y_init,
                              z_init, zL_init, zU_init, w_init, 0.0)
    zeros_i = torch.zeros((B,), dtype=torch.int64, device=device)
    st = _IPState(w=w_init, s=s_init, y=y_init, z=z_init, zL=zL_init,
                  zU=zU_init, mu=mu0,
                  delta=torch.full((B,), opts.delta_init, dtype=dtype,
                                   device=device),
                  it=zeros_i, done=err0 <= opts.tol, kkt0=err0,
                  best_err=err0, stall=zeros_i, frozen=zeros_i,
                  fv=fv0, gf=gf_i, gv=gv_i, Jg=Jg_i, hv=hv_i, Jh=Jh_i)
    # the batched while loop: the body runs on every lane, a lane keeps the
    # new state only where its own condition held on the OLD state
    while True:
        active = ~st.done & (st.it < budget)
        if not bool(active.any()):
            break
        new = body(st)
        st = _IPState(*(
            torch.where(active.reshape((B,) + (1,) * (old.ndim - 1)), nw, old)
            for nw, old in zip(new, st)))

    # budget exhausted at an acceptable point still counts as success
    err_f, viol_f, dual_f, compl_f = kkt_error(
        st.gf, st.Jg, st.Jh, st.gv, st.hv, st.s, st.y, st.z, st.zL, st.zU,
        st.w, 0.0)
    final_acceptable = ((st.mu <= 2.0 * mu_floor)
                        & (dual_f <= opts.dual_inf_tol)
                        & (viol_f <= viol_tol)
                        & (compl_f <= opts.compl_inf_tol))
    done = st.done | final_acceptable

    # ---- unscale back to the original problem space -------------------------
    sf_c = s_f[:, None]
    w_out = st.w * d_w
    y_out = (s_g * st.y / sf_c) if m_e else st.y
    z_out = (s_h * st.z / sf_c) if m_h else st.z
    g_raw_v = st.gv / torch.clamp_min(s_g, 1e-12) if m_e else st.gv
    h_raw_v = st.hv / torch.clamp_min(s_h, 1e-12) if m_h else st.hv
    viol_raw = torch.maximum(_safe_max(g_raw_v.abs()),
                             _safe_max(torch.clamp_min(-h_raw_v, 0.0)))
    stats = SolverStats(
        iterations=st.it,
        kkt_error=st.kkt0,
        success=done,
        objective=st.fv / s_f,
        mu=st.mu,
        constraint_violation=viol_raw,
        kkt_path=KKT_PATHS.index(kkt_path),
        jac_path=JAC_PATHS.index(jac_path),
        precision_path=PRECISION_PATHS.index(precision_path),
    )
    return SolverResult(
        w=w_out, y=y_out, z=z_out,
        s=st.s / torch.clamp_min(s_h, 1e-12) if m_h else st.s,
        stats=stats)
