"""ADMM consensus and exchange math as plain tensor functions.

Port of ``agentlib_mpc_tpu/ops/admm.py``: the masked mean, the consensus
and exchange updates with Boyd-style residuals, their combination over
several couplings, the relative-tolerance convergence check, the
residual-balancing penalty, the shift-by-one warm start, the
augmented-Lagrangian penalties each local problem adds, and the host-side
residual recorders (:func:`record_residuals`, :func:`trim_residuals`) the
ADMM coordinator writes its rounds with. Coupling trajectories are stacked with the agent axis first.
The mesh form (``axis_name``, a ``psum`` over a sharded agent axis) waits
for the multi-GPU slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _active_mask(locals_, active):
    if active is None:
        return torch.ones(locals_.shape[0], dtype=locals_.dtype,
                          device=locals_.device)
    return active.to(locals_.dtype)


def _masked_mean(locals_, active=None):
    """Mean over the agent axis counting only active agents."""
    m = _active_mask(locals_, active)
    w = m.reshape((-1,) + (1,) * (locals_.ndim - 1))
    count = torch.clamp_min(m.sum(), 1.0)
    return (locals_ * w).sum(dim=0) / count


class ConsensusState(NamedTuple):
    """Global consensus-ADMM state for one (stacked) coupling quantity."""

    zbar: torch.Tensor     # (T,) or (K, T) global mean trajectory
    lam: torch.Tensor      # (n_agents, T) / (n_agents, K, T) multipliers
    rho: torch.Tensor      # () penalty parameter


class ExchangeState(NamedTuple):
    """Global exchange-ADMM state (shared multiplier, per-agent diffs)."""

    mean: torch.Tensor     # (T,) mean trajectory
    diff: torch.Tensor     # (n_agents, T) x_i - mean (per-agent targets)
    lam: torch.Tensor      # (T,) shared multiplier
    rho: torch.Tensor      # ()


class AdmmResiduals(NamedTuple):
    primal: torch.Tensor   # () l2 norm
    dual: torch.Tensor     # () l2 norm
    #: scaling terms for the relative criterion
    scale_primal: torch.Tensor
    scale_dual: torch.Tensor
    #: problem sizes entering the sqrt(p)/sqrt(n) tolerance terms
    n_primal: torch.Tensor
    n_dual: torch.Tensor


def consensus_update(locals_, state: ConsensusState, active=None
                     ) -> tuple[ConsensusState, AdmmResiduals]:
    """One consensus-ADMM global step from the stacked local solutions.

    z̄⁺ = mean_i x_i;  λ_i⁺ = λ_i − ρ (z̄⁺ − x_i)
    primal residual = ‖stack_i (z̄⁺ − x_i)‖;  dual = ‖ρ (z̄⁺ − z̄)‖
    """
    zbar_new = _masked_mean(locals_, active)
    m = _active_mask(locals_, active)
    w = m.reshape((-1,) + (1,) * (locals_.ndim - 1))
    prim_per_agent = (zbar_new[None, ...] - locals_) * w
    lam_new = state.lam - state.rho * prim_per_agent
    # masked-out agents keep their multiplier
    lam_new = torch.where(w > 0, lam_new, state.lam)
    n_active = m.sum()
    res = AdmmResiduals(
        primal=torch.linalg.vector_norm(prim_per_agent),
        dual=torch.linalg.vector_norm(state.rho * (zbar_new - state.zbar)),
        scale_primal=torch.maximum(torch.linalg.vector_norm(locals_ * w),
                                   torch.linalg.vector_norm(zbar_new)),
        scale_dual=torch.linalg.vector_norm(lam_new * w),
        n_primal=n_active * zbar_new.numel(),
        n_dual=n_active * zbar_new.numel(),
    )
    return ConsensusState(zbar=zbar_new, lam=lam_new, rho=state.rho), res


def exchange_update(locals_, state: ExchangeState, active=None
                    ) -> tuple[ExchangeState, AdmmResiduals]:
    """One exchange-ADMM global step.

    mean⁺ = mean_i x_i;  diff_i⁺ = x_i − mean⁺;  λ⁺ = λ + ρ mean⁺
    primal residual = ‖mean⁺‖ (resource balance);  dual = ‖ρ Δmean‖
    """
    mean_new = _masked_mean(locals_, active)
    m = _active_mask(locals_, active)
    w = m.reshape((-1,) + (1,) * (locals_.ndim - 1))
    # masked-out agents keep their diff
    diff_new = torch.where(w > 0, locals_ - mean_new[None, ...], state.diff)
    lam_new = state.lam + state.rho * mean_new
    res = AdmmResiduals(
        primal=torch.linalg.vector_norm(mean_new),
        dual=torch.linalg.vector_norm(state.rho * (mean_new - state.mean)),
        scale_primal=torch.maximum(torch.linalg.vector_norm(locals_ * w),
                                   torch.linalg.vector_norm(mean_new)),
        scale_dual=torch.linalg.vector_norm(lam_new),
        n_primal=locals_.new_tensor(float(mean_new.numel())),
        n_dual=m.sum() * mean_new.numel(),
    )
    return ExchangeState(mean=mean_new, diff=diff_new, lam=lam_new,
                         rho=state.rho), res


def combine_residuals(*results: AdmmResiduals) -> AdmmResiduals:
    """Aggregate the residuals of several coupling quantities into one
    check: root sum of squares of the norms, sums of the sizes."""
    def rss(vals):
        return torch.sqrt(sum(v ** 2 for v in vals))

    return AdmmResiduals(
        primal=rss([r.primal for r in results]),
        dual=rss([r.dual for r in results]),
        scale_primal=rss([r.scale_primal for r in results]),
        scale_dual=rss([r.scale_dual for r in results]),
        n_primal=sum(r.n_primal for r in results),
        n_dual=sum(r.n_dual for r in results),
    )


def converged(res: AdmmResiduals, abs_tol: float = 1e-3,
              rel_tol: float = 1e-2, use_relative: bool = True,
              primal_tol: float = 1e-3, dual_tol: float = 1e-3):
    """Boyd-style convergence check with relative tolerances:

    eps_pri  = sqrt(p)·abs_tol + rel_tol·max(‖x‖, ‖z‖)
    eps_dual = sqrt(n)·abs_tol + rel_tol·‖λ‖
    """
    if use_relative:
        eps_pri = torch.sqrt(res.n_dual) * abs_tol + rel_tol * res.scale_primal
        eps_dual = torch.sqrt(res.n_primal) * abs_tol + rel_tol * res.scale_dual
        return (res.primal < eps_pri) & (res.dual < eps_dual)
    return (res.primal < primal_tol) & (res.dual < dual_tol)


def record_residuals(primal, dual, *, iteration=None, registry=None,
                     **labels) -> None:
    """Write one ADMM iteration's primal and dual residuals into the
    telemetry registry: the gauges ``admm_primal_residual`` and
    ``admm_dual_residual`` (labeled by ``iteration`` and any extra labels,
    such as ``agent=...``) and the counter ``admm_iterations_total`` (the
    extra labels only). Call with host numbers; a no-op when telemetry is
    disabled."""
    from agentlib_mpc_torch import telemetry

    reg = registry or telemetry.metrics()
    if not reg.enabled:
        return
    lbl = dict(labels)
    if iteration is not None:
        lbl["iteration"] = str(int(iteration))
    reg.gauge("admm_primal_residual",
              "ADMM primal residual of the labeled iteration"
              ).set(float(primal), **lbl)
    reg.gauge("admm_dual_residual",
              "ADMM dual residual of the labeled iteration"
              ).set(float(dual), **lbl)
    reg.counter("admm_iterations_total",
                "global ADMM iterations recorded").inc(**labels)


def trim_residuals(start_iteration: int, end_iteration: int, *,
                   registry=None, **labels) -> None:
    """Remove the per-iteration residual gauges of the iterations in
    ``[start_iteration, end_iteration)`` for one label set: a round shorter
    than the one before overwrites only its own iterations, and the
    longer round's tail would otherwise stay beside them."""
    from agentlib_mpc_torch import telemetry

    reg = registry or telemetry.metrics()
    prim = reg.gauge("admm_primal_residual",
                     "ADMM primal residual of the labeled iteration")
    dual = reg.gauge("admm_dual_residual",
                     "ADMM dual residual of the labeled iteration")
    for k in range(start_iteration, end_iteration):
        prim.remove(iteration=str(k), **labels)
        dual.remove(iteration=str(k), **labels)


def vary_penalty(rho, res: AdmmResiduals, threshold: float = 10.0,
                 factor: float = 2.0):
    """Residual-balancing adaptive penalty: grow ρ when primal ≫ dual,
    shrink it when dual ≫ primal; ``threshold <= 1`` disables adaptation."""
    if threshold <= 1:
        return rho
    grow = res.primal > threshold * res.dual
    shrink = res.dual > threshold * res.primal
    return torch.where(grow, rho * factor,
                       torch.where(shrink, rho / factor, rho))


def shift_one(traj, horizon: int):
    """Shift a trajectory one control interval forward, repeating the tail
    (the warm start between control steps). The LAST axis is the time grid
    of length ``k·horizon``."""
    shift_by = traj.shape[-1] // horizon
    return torch.cat([traj[..., shift_by:], traj[..., -shift_by:]], dim=-1)


def consensus_penalty(x_local, zbar, lam, rho):
    """Augmented-Lagrangian terms one agent adds to its OCP objective for a
    consensus coupling: ``λᵀ x + ρ/2 ‖z̄ − x‖²`` over the whole trajectory."""
    return (lam * x_local).sum() + 0.5 * rho * ((zbar - x_local) ** 2).sum()


def exchange_penalty(x_local, diff, lam, rho):
    """Exchange coupling terms: ``λᵀ x + ρ/2 ‖diff − x‖²``, where ``diff``
    is the agent's previous deviation from the mean."""
    return (lam * x_local).sum() + 0.5 * rho * ((diff - x_local) ** 2).sum()
