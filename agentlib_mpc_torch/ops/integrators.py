"""Fixed-step and adaptive ODE integrators, batch-first.

Port of ``agentlib_mpc_tpu/ops/integrators.py``. Explicit Euler and RK4
serve multiple shooting and the plant simulation; implicit midpoint and
TR-BDF2 (with a fixed number of Newton steps) serve stiff plants;
:func:`integrate_adaptive` is the embedded-error TR-BDF2 plant integrator.

Batch-first. The state ``x`` is (..., n): any leading axes are independent
lanes, the state is the last axis. The right-hand side ``f(x, t)`` takes
such a state and a time that is a number or a tensor of the leading shape,
and returns dx/dt of the state's shape. Step sizes ``h`` may be numbers or
tensors of the leading shape (the adaptive integrator's steps differ per
lane). Where the JAX package uses ``lax.scan``/``fori_loop`` the port runs
a Python loop; its ``while_loop`` (under ``vmap``) becomes a loop that
runs while any lane is active and keeps a lane's new values only where
that lane was active (``torch.where``, as the solver does).

Newton solves take the per-lane Jacobian with ``torch.func.jacfwd``:
lanes are independent, so perturbing every lane's state by one shared
vector ``v`` and differentiating with respect to ``v`` gives each lane's
n×n Jacobian in n forward passes over the whole batch. The solves are
``torch.linalg.solve`` on (..., n, n).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd

#: f(x (..., n), t) -> dx/dt (..., n)
ODE = Callable[[torch.Tensor, object], torch.Tensor]


def _vec(h):
    """A step size against a state (..., n): a number as it is, a tensor
    of the leading shape with a trailing axis."""
    return h[..., None] if isinstance(h, torch.Tensor) else h


def _mat(h):
    """A step size against a Jacobian (..., n, n)."""
    return h[..., None, None] if isinstance(h, torch.Tensor) else h


def _lane_jacobian(fn, x: torch.Tensor) -> torch.Tensor:
    """(..., n, n) Jacobian of a lane-independent ``fn`` (..., n) →
    (..., n) at ``x``: forward mode with respect to one shift shared by
    all lanes."""
    return jacfwd(lambda v: fn(x + v))(x.new_zeros(x.shape[-1]))


def euler_step(f: ODE, x, t, h):
    return x + _vec(h) * f(x, t)


def rk4_step(f: ODE, x, t, h):
    hv = _vec(h)
    k1 = f(x, t)
    k2 = f(x + 0.5 * hv * k1, t + 0.5 * h)
    k3 = f(x + 0.5 * hv * k2, t + 0.5 * h)
    k4 = f(x + hv * k3, t + h)
    return x + (hv / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def implicit_midpoint_step(f: ODE, x, t, h, newton_iters: int = 5):
    """Implicit midpoint rule, solved with a fixed number of Newton steps
    (A-stable: for stiff building-physics plants)."""
    hv = _vec(h)

    def residual(x_next):
        xm = 0.5 * (x + x_next)
        return x_next - x - hv * f(xm, t + 0.5 * h)

    return _newton_solve(residual, x + hv * f(x, t), newton_iters, reg=1e-10)


def _newton_solve(residual, x_guess, iters: int = 6, reg: float = 1e-12):
    """Fixed-iteration Newton on small dense per-lane systems."""
    n = x_guess.shape[-1]
    eye = torch.eye(n, dtype=x_guess.dtype, device=x_guess.device)
    xk = x_guess
    for _ in range(iters):
        r = residual(xk)
        J = _lane_jacobian(residual, xk)
        xk = xk + torch.linalg.solve(J + reg * eye, -r)
    return xk


# TR-BDF2 constants (Bank et al.; error pair per Hosea & Shampine 1996).
_TRBDF2_GAMMA = 2.0 - 2.0 ** 0.5          # γ = 2 - √2
_TRBDF2_W = 2.0 ** 0.5 / 4.0              # w = √2 / 4
_TRBDF2_D = _TRBDF2_GAMMA / 2.0           # diagonal DIRK coefficient γ/2
#: 2nd-order weights b and embedded 3rd-order weights b̂ of the DIRK tableau
_TRBDF2_B = (_TRBDF2_W, _TRBDF2_W, _TRBDF2_D)
_TRBDF2_BHAT = ((1.0 - _TRBDF2_W) / 3.0, (3.0 * _TRBDF2_W + 1.0) / 3.0,
                _TRBDF2_D / 3.0)


def trbdf2_step(f: ODE, x, t, h, newton_iters: int = 6):
    """One TR-BDF2 step; returns (x_next, embedded error estimate).

    A trapezoidal half-stage to t+γh and a BDF2 closure to t+h (L-stable);
    the embedded 3rd-order weights give a local error estimate, stiffly
    filtered through (I - γ/2 h J)⁻¹ (Hosea & Shampine 1996)."""
    g, d = _TRBDF2_GAMMA, _TRBDF2_D
    hv = _vec(h)
    k1 = f(x, t)

    # stage 2: trapezoidal to t + γh
    def res_tr(xg):
        return xg - x - d * hv * (k1 + f(xg, t + g * h))

    xg = _newton_solve(res_tr, x + g * hv * k1, newton_iters)
    k2 = f(xg, t + g * h)

    # stage 3: BDF2 closure to t + h
    w = _TRBDF2_W

    def res_bdf(xn):
        return xn - x - hv * (w * k1 + w * k2 + d * f(xn, t + h))

    xn = _newton_solve(res_bdf, xg + (1.0 - g) * hv * k2, newton_iters)
    k3 = f(xn, t + h)

    b, bh = _TRBDF2_B, _TRBDF2_BHAT
    est = hv * ((b[0] - bh[0]) * k1 + (b[1] - bh[1]) * k2
                + (b[2] - bh[2]) * k3)
    # stiff filter: est ← (I - d h J)⁻¹ est
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    J = _lane_jacobian(lambda xx: f(xx, t + h), xn)
    est = torch.linalg.solve(eye - d * _mat(h) * J, est)
    return xn, est


def integrate_adaptive(f: ODE, x0, t0, dt, rtol: float = 1e-6,
                       atol: float = 1e-8, h0: float | None = None,
                       max_steps: int = 10_000, newton_iters: int = 6):
    """Adaptive TR-BDF2 integration of x' = f(x, t) over [t0, t0+dt], per
    lane.

    A step is accepted when the weighted RMS of the local error estimate is
    ≤ 1; the next step size follows ``h ← h · clip(0.9 · err^(-1/3), 0.2,
    5)``. Every lane steps on its own clock; the loop runs while any lane
    has not reached ``t0+dt`` within ``max_steps``. Returns ``(x_final,
    (n_accepted, n_rejected))`` with counts of the leading shape. A lane
    whose step budget ran out before ``t0+dt`` returns NaN — a wrong plant
    state must never look like a successful integration."""
    dtype, device = x0.dtype, x0.device
    lead = x0.shape[:-1]

    def full(v):
        return torch.as_tensor(v, dtype=dtype, device=device).expand(
            lead).clone()

    t = full(t0)
    t_end = t + dt
    h = full(dt / 16.0 if h0 is None else h0)
    x = x0
    zeros = torch.zeros(lead, dtype=torch.int64, device=device)
    acc, rej, k = zeros, zeros, zeros
    t_stop = t_end - 1e-12 * t_end.abs()

    def err_norm(est, x_new, x_old):
        scale = atol + rtol * torch.maximum(x_new.abs(), x_old.abs())
        return torch.sqrt(((est / scale) ** 2).mean(dim=-1))

    while True:
        active = (t < t_stop) & (k < max_steps)
        if not bool(active.any()):
            break
        h_eff = torch.minimum(h, t_end - t)
        x_new, est = trbdf2_step(f, x, t, h_eff, newton_iters)
        err = err_norm(est, x_new, x)
        ok = (err <= 1.0) & torch.isfinite(x_new).all(dim=-1)
        # 3rd-order embedded → exponent -1/3; safety 0.9; bounded factor.
        # A non-finite estimate (Newton blow-up) must SHRINK the step.
        fac = torch.where(
            torch.isfinite(err),
            torch.clamp(0.9 * torch.clamp_min(err, 1e-10) ** (-1.0 / 3.0),
                        0.2, 5.0),
            torch.full_like(err, 0.2))
        t_n = torch.where(ok, t + h_eff, t)
        x_n = torch.where(ok[..., None], x_new, x)
        h_n = h_eff * fac
        # a lane keeps its new values only where it was active
        t = torch.where(active, t_n, t)
        x = torch.where(active[..., None], x_n, x)
        h = torch.where(active, h_n, h)
        acc = torch.where(active, acc + ok.to(acc.dtype), acc)
        rej = torch.where(active, rej + (~ok).to(rej.dtype), rej)
        k = torch.where(active, k + 1, k)
    reached = t >= t_stop
    x = torch.where(reached[..., None], x, torch.full_like(x, float("nan")))
    return x, (acc, rej)


_STEPPERS = {
    "euler": euler_step,
    "rk4": rk4_step,
    "implicit_midpoint": implicit_midpoint_step,
    "trbdf2": lambda f, x, t, h: trbdf2_step(f, x, t, h)[0],
}


def integrate(f: ODE, x0, t0, dt, substeps: int = 1, method: str = "rk4"):
    """Integrate x' = f(x, t) from t0 over dt with ``substeps`` fixed steps.

    ``method="adaptive"`` dispatches to :func:`integrate_adaptive`
    (embedded-error TR-BDF2) and ignores ``substeps``."""
    if method == "adaptive":
        return integrate_adaptive(f, x0, t0, dt)[0]
    if method not in _STEPPERS:
        raise ValueError(f"unknown integrator {method!r}; one of "
                         f"{sorted(_STEPPERS) + ['adaptive']}")
    stepper = _STEPPERS[method]
    h = dt / substeps
    x = x0
    for i in range(substeps):
        x = stepper(f, x, t0 + i * h, h)
    return x
