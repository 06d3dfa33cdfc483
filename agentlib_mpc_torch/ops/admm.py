"""ADMM consensus math as plain tensor functions.

Port of ``agentlib_mpc_tpu/ops/admm.py:67-215, 298-305``: the masked
consensus mean, the consensus update with Boyd-style residuals, the
relative-tolerance convergence check and the augmented-Lagrangian penalty
each local problem adds. Coupling trajectories are stacked with the agent
axis first. The mesh form (``axis_name``, a ``psum`` over a sharded agent
axis) waits for the multi-GPU slice.
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


def consensus_penalty(x_local, zbar, lam, rho):
    """Augmented-Lagrangian terms one agent adds to its OCP objective for a
    consensus coupling: ``λᵀ x + ρ/2 ‖z̄ − x‖²`` over the whole trajectory."""
    return (lam * x_local).sum() + 0.5 * rho * ((zbar - x_local) ** 2).sum()
