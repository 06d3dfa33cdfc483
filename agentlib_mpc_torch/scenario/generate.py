"""Scenario generation: disturbance draws into scenario-stacked OCP data.

Port of ``agentlib_mpc_tpu/scenario/generate.py``. Scenarios are data,
never structure: every branch of a scenario tree evaluates the same
transcribed OCP with another exogenous-input trajectory
(``OCPParams.d_traj``), so generating scenarios stacks perturbed parameter
pytrees along a new leading axis, the axis
:class:`~agentlib_mpc_torch.scenario.fleet.ScenarioFleet` batches. The
draws come from the chaos harness's seeded sampler
(:func:`agentlib_mpc_torch.resilience.chaos.disturbance_model`) or the
forecast-ensemble hooks (``InputPredictor.get_prediction_ensemble_at_time``,
``utils.try_format.try_forecast_ensemble``). The perturbation is computed
in float64 numpy, as in the JAX package, and the batch keeps the dtype
and device of the nominal ``theta``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_torch.parallel.fused_admm import stack_params

__all__ = [
    "ensemble_thetas",
    "scenario_thetas",
    "stack_scenario_params",
]


def stack_scenario_params(thetas):
    """Stack per-scenario OCPParams into one batched pytree (scenario
    axis 0), the scenario-axis sibling of
    :func:`~agentlib_mpc_torch.parallel.fused_admm.stack_params`."""
    return stack_params(thetas)


def scenario_thetas(theta, tree, draws, channels=None):
    """Stack one agent's ``theta`` into an (S, ...) scenario batch with
    ``d_traj`` perturbed per branch.

    ``draws``: additive disturbances, shape ``(S, N, len(channels))`` (or
    ``(S, N)`` for one channel); ``channels`` indexes the exogenous
    columns of ``d_traj`` they perturb (default: the leading columns).
    Other columns replicate the nominal data, so a single-scenario tree
    gives an exact 1-stack of ``theta``."""
    S = tree.n_scenarios
    draws = np.asarray(draws, dtype=float)
    if draws.ndim == 2:
        draws = draws[:, :, None]
    if draws.shape[0] != S:
        raise ValueError(
            f"draws carry {draws.shape[0]} scenarios, tree has {S}")
    d_nominal = theta.d_traj
    d = np.asarray(d_nominal.detach().cpu().numpy(), dtype=float)
    if d.ndim != 2:
        raise ValueError(f"theta.d_traj must be (N, n_d), got {d.shape}")
    N, n_d = d.shape
    if draws.shape[1] != N:
        raise ValueError(
            f"draws cover {draws.shape[1]} intervals, horizon has {N}")
    channels = tuple(range(draws.shape[2])) if channels is None \
        else tuple(int(c) for c in channels)
    if len(channels) != draws.shape[2]:
        raise ValueError(
            f"{len(channels)} channel indices for "
            f"{draws.shape[2]}-channel draws")
    bad = [c for c in channels if not 0 <= c < n_d]
    if bad:
        raise ValueError(f"channel index(es) {bad} outside d_traj's "
                         f"{n_d} columns")
    d_batch = np.broadcast_to(d, (S, N, n_d)).copy()
    for k, c in enumerate(channels):
        d_batch[:, :, c] += draws[:, :, k]
    batched = tree_map(
        lambda leaf: leaf.expand((S,) + tuple(leaf.shape)).contiguous()
        if isinstance(leaf, torch.Tensor) else leaf, theta)
    return batched._replace(d_traj=torch.as_tensor(
        d_batch, dtype=d_nominal.dtype, device=d_nominal.device))


def ensemble_thetas(theta, tree, seed: int = 0, scale: float = 1.0,
                    channels=(0,), kind: str = "walk"):
    """Scenario batch straight from the chaos sampler: seeded
    ``disturbance_model`` draws (scenario 0 nominal) added onto the
    selected ``d_traj`` channels. Deterministic in ``seed``; a model
    without exogenous inputs stacks its nominal data S times."""
    from agentlib_mpc_torch.resilience.chaos import disturbance_model

    N, n_d = (int(v) for v in theta.d_traj.shape)
    channels = tuple(c for c in channels if c < n_d)
    draws = disturbance_model(seed=seed, horizon=N,
                              n_scenarios=tree.n_scenarios,
                              n_channels=len(channels),
                              scale=scale, kind=kind)
    return scenario_thetas(theta, tree, draws, channels=channels)
