"""The consensus-ADMM control step of the 256-zone benchmark.

Port of ``build_step``/``warm_step`` (``bench.py:210-359``). Two fleets
(``model``): "zone", the bilinear supply-air zone, and "linear", the
power-actuated 1R1C zone (``LinearRCZone``) — the standard linear-MPC
case the reference serves with qpoases/osqp. Two inner solvers
(``inner``): "nlp", the interior-point solver (``solve_nlp_batched``), and
"qp", the Mehrotra QP fast path (``ops/qp.py:solve_qp``), correct only on
the linear fleet. One control step is ``ADMM_ITERS`` consensus iterations;
each solves every zone's collocation problem as one batch, then takes the
consensus mean of the controls and the scaled dual update. The first (cold) iteration gets the full inner
budget, the warm ones a short budget warm-started in primal, duals and
barrier. The JAX package runs the iterations in one ``lax.scan``; here it
is a Python loop over the same per-iteration (budget, mu0) schedule.

``horizon`` and ``dt`` set the zone OCP's horizon (default: the
benchmark's N=10, dt=300 s). The OCP's stage partition is attached to the
solver options as the JAX package's production form attaches it, so
"auto" takes the stage sweep where the dense KKT no longer fits the LDLᵀ
kernels: a day ahead at 15 min (N=96, dt=900 s) gives an 866×866 KKT of
97 stages of 10, factored stage by stage on the kernels. Where the
stage-sparse derivative pipeline could be routed, the augmented problem's
stage structure is certified and the resulting plan attached
(``stagejac.attach_plan_if_worthwhile``, the JAX package's production
seam): "auto" then evaluates derivatives stage-sparse at N=96 and stays
dense at N=10 (KKT 92 < ``jacobian_min_size`` 384).

The workload constants are copies of ``bench.py``'s (the port imports
nothing of the JAX package or of ``bench.py``); a test holds them equal.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from agentlib_mpc_torch.models.zoo import LinearRCZone, ZoneWithSupply
from agentlib_mpc_torch.ops.admm import _masked_mean
from agentlib_mpc_torch.ops.qp import solve_qp
from agentlib_mpc_torch.ops.solver import (
    NLPFunctions,
    SolverOptions,
    attach_stage_partition,
    solve_nlp_batched,
)
from agentlib_mpc_torch.ops.stagejac import attach_plan_if_worthwhile
from agentlib_mpc_torch.ops.transcription import transcribe
from agentlib_mpc_torch.utils.device import resolve_device

# ---- workload constants (bench.py:174-198, 210-227) ---------------------------
N_AGENTS = 256
HORIZON = 10
ADMM_ITERS = 10
DT = 300.0
SOLVER_BASE = {"tol": 1e-4, "max_iter": 10, "corrector": True}
COLD_BUDGET, WARM_BUDGET = 10, 1
COLD_MU, WARM_MU = 0.1, 1e-2
ZONE_X0_RANGE = (294.0, 300.0)
ZONE_LOAD_RANGE = (80.0, 250.0)
#: exogenous inputs after the load (T_in, T_upper), initial consensus value
#: and penalty of the zone model (bench.py ``_MODELS["zone"]``)
ZONE_D_ROW_TAIL = (290.15, 294.15)
ZONE_ZBAR0 = 0.02
ZONE_RHO0 = 20.0
#: the same for the linear model (bench.py ``_MODELS["linear"]``): T_amb,
#: T_upper; z̄₀ and ρ on the heat power's scale (W)
LINEAR_D_ROW_TAIL = (303.15, 295.15)
LINEAR_ZBAR0 = 100.0
LINEAR_RHO0 = 5e-3


def fleet_inputs(n_agents: int):
    """Per-zone initial temperatures and loads (the heterogeneity axis)."""
    return (np.linspace(*ZONE_X0_RANGE, n_agents),
            np.linspace(*ZONE_LOAD_RANGE, n_agents))


def zone_ocp(horizon: int = HORIZON, dt: float = DT):
    """The per-zone OCP (degree-2 collocation; 61 variables at the default
    N=10)."""
    return transcribe(ZoneWithSupply(), ["mDot"], N=horizon, dt=dt,
                      method="collocation", collocation_degree=2)


def linear_zone_ocp(horizon: int = HORIZON, dt: float = DT):
    """The per-zone LQ OCP (``LinearRCZone``, power-actuated 1R1C; degree-2
    collocation, 61 variables at the default N=10) — the workload the QP
    fast path serves."""
    return transcribe(LinearRCZone(), ["Q"], N=horizon, dt=dt,
                      method="collocation", collocation_degree=2)


#: per-model fleet knobs: (ocp factory, exogenous row tail after the load,
#: initial consensus value, penalty on the coupling's physical scale)
MODELS = {
    "zone": (zone_ocp, ZONE_D_ROW_TAIL, ZONE_ZBAR0, ZONE_RHO0),
    "linear": (linear_zone_ocp, LINEAR_D_ROW_TAIL, LINEAR_ZBAR0,
               LINEAR_RHO0),
}
INNER_SOLVERS = {"nlp": solve_nlp_batched, "qp": solve_qp}


def augmented_nlp(ocp) -> NLPFunctions:
    """One zone's consensus-ADMM subproblem: the OCP's objective plus the
    penalty ½ρ‖u − z̄ + λ‖², constraints unchanged. Its theta is
    ``(ocp_params, zbar (N, 1), lam (N, 1), rho ())``."""

    def f_aug(w, theta):
        ocp_theta, zbar, lam, rho = theta
        u = ocp.unflatten(w)["u"]
        return ocp.nlp.f(w, ocp_theta) + \
            0.5 * rho * ((u - zbar + lam) ** 2).sum()

    return NLPFunctions(f=f_aug, g=lambda w, th: ocp.nlp.g(w, th[0]),
                        h=lambda w, th: ocp.nlp.h(w, th[0]))


def augmented_theta(ocp, model: str, device=None,
                    dtype: torch.dtype = torch.float32):
    """ONE zone's augmented theta at the fleet's initial consensus state
    (default parameters, z̄₀, λ = 0, ρ₀): the point the certifiers trace
    at (their verdicts hold for all theta)."""
    dev = resolve_device(device)
    _, _, zbar0, rho0 = MODELS[model]
    return (ocp.default_params(device=dev, dtype=dtype),
            torch.full((ocp.N, 1), zbar0, dtype=dtype, device=dev),
            torch.zeros((ocp.N, 1), dtype=dtype, device=dev),
            torch.tensor(rho0, dtype=dtype, device=dev))


def build_step(n_agents: int = N_AGENTS, solver_overrides: dict | None = None,
               warm_budget: int = WARM_BUDGET,
               cold_budget: int = COLD_BUDGET, record_stats: bool = False,
               device=None, dtype: torch.dtype = torch.float32,
               horizon: int = HORIZON, dt: float = DT, model: str = "zone",
               inner: str = "nlp"):
    """Return ``(step, args)``: ``step(*args)`` runs one control step.

    ``args = (x0s (n, 1), loads (n,), w (n, n_w), y (n, n_g), z (n, n_h),
    zbar (N, 1), lams (n, N, 1), rho ())``, the positional layout of the
    JAX package. ``step`` returns the carry ``(w, y, z, zbar, lams)``, or
    ``(carry, stats)`` with ``record_stats``: ``stats = (primal (I,),
    dual (I,), iterations (I, n), success (I, n), kkt_error (I, n),
    kkt_path (I, n), jac_path (I, n))``, the last two indexing
    ``solver.KKT_PATHS`` and ``solver.JAC_PATHS``. ``model`` picks the
    fleet ("zone" or "linear"), ``inner`` the inner solver ("nlp" or
    "qp"); ``step.solver_options`` holds the options every solve uses,
    ``step.ocp`` the zone's transcription and ``step.zone_params(x0s,
    loads)`` builds the batched per-zone parameters.
    """
    dev = resolve_device(device)
    if model not in MODELS:
        raise ValueError(f"model must be one of {sorted(MODELS)}, got "
                         f"{model!r}")
    if inner not in INNER_SOLVERS:
        raise ValueError(f"inner must be one of {sorted(INNER_SOLVERS)}, "
                         f"got {inner!r}")
    ocp_fn, d_row_tail, zbar0, rho0 = MODELS[model]
    inner_solve = INNER_SOLVERS[inner]
    ocp = ocp_fn(horizon, dt)
    base_opts = dict(SOLVER_BASE)
    base_opts.update(solver_overrides or {})
    opts = attach_stage_partition(SolverOptions(**base_opts),
                                  ocp.stage_partition)
    budgets = [cold_budget] + [warm_budget] * (ADMM_ITERS - 1)
    mu0s = [COLD_MU] + [WARM_MU] * (ADMM_ITERS - 1)

    nlp = augmented_nlp(ocp)
    theta0 = ocp.default_params(device=dev, dtype=dtype)
    # the stage-sparse plan of the augmented problem (the JAX package's
    # production seam), where "auto" could route sparse
    opts = attach_plan_if_worthwhile(
        opts, ocp.stage_partition, nlp,
        augmented_theta(ocp, model, dev, dtype), ocp.n_w,
        label=f"the {model} zone (augmented)", device=dev)

    def zone_params(x0s, loads):
        """Batched OCPParams: defaults with per-zone x0 and load row."""
        n = x0s.shape[0]
        tail = torch.tensor(d_row_tail, dtype=dtype, device=dev)
        d_row = torch.cat([loads[:, None], tail.expand(n, 2)], dim=-1)
        batched = theta0._replace(
            x0=x0s, d_traj=d_row[:, None, :].expand(n, horizon, 3))
        return batched._replace(**{
            k: v.expand((n,) + v.shape) for k, v in batched._asdict().items()
            if k not in ("x0", "d_traj")})

    def control_step(x0s, loads, w_gs, y_gs, z_gs, zbar, lams, rho):
        n = x0s.shape[0]
        theta = zone_params(x0s, loads)
        lb, ub = vmap(ocp.bounds)(theta)
        rho_b = rho.expand(n)
        stats = []
        for budget, mu0 in zip(budgets, mu0s):
            res = inner_solve(
                nlp, w_gs, (theta, zbar.expand((n,) + zbar.shape), lams,
                            rho_b),
                lb, ub, opts, y0=y_gs, z0=z_gs, mu0=mu0, max_iter=budget)
            w_gs, y_gs, z_gs = res.w, res.y, res.z
            u = ocp.unflatten(w_gs)["u"]                      # (n, N, 1)
            zbar_new = _masked_mean(u)
            lams = lams + (u - zbar_new)
            if record_stats:
                # Boyd residuals of this iteration
                stats.append((
                    torch.linalg.vector_norm(u - zbar_new),
                    torch.linalg.vector_norm(rho * (zbar_new - zbar)),
                    res.stats.iterations, res.stats.success,
                    res.stats.kkt_error,
                    torch.full((n,), res.stats.kkt_path, device=dev),
                    torch.full((n,), res.stats.jac_path, device=dev)))
            zbar = zbar_new
        carry = (w_gs, y_gs, z_gs, zbar, lams)
        if not record_stats:
            return carry
        return carry, tuple(torch.stack(col) for col in zip(*stats))

    control_step.solver_options = opts
    control_step.ocp = ocp
    control_step.zone_params = zone_params

    x0s_np, loads_np = fleet_inputs(n_agents)
    x0s = torch.as_tensor(x0s_np, dtype=dtype, device=dev).reshape(n_agents, 1)
    loads = torch.as_tensor(loads_np, dtype=dtype, device=dev)
    w_gs = ocp.initial_guess(theta0).expand(n_agents, ocp.n_w).clone()
    y_gs = torch.zeros((n_agents, ocp.n_g), dtype=dtype, device=dev)
    z_gs = torch.full((n_agents, ocp.n_h), 0.1, dtype=dtype, device=dev)
    zbar = torch.full((horizon, 1), zbar0, dtype=dtype, device=dev)
    lams = torch.zeros((n_agents, horizon, 1), dtype=dtype, device=dev)
    rho = torch.tensor(rho0, dtype=dtype, device=dev)
    args = (x0s, loads, w_gs, y_gs, z_gs, zbar, lams, rho)
    return control_step, args


def warm_step(step, args, out):
    """Re-invoke the control step warm-started from its own outputs (carry:
    w, y, z, zbar, lams) with the original problem data (x0s, loads, rho)
    — the closed-loop steady-state regime."""
    return step(args[0], args[1], out[0], out[1], out[2], out[3],
                out[4], args[7])
