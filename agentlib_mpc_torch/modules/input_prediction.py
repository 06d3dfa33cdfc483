"""Input prediction: weather/disturbance forecasts for MPC inputs.

Port of ``agentlib_mpc_tpu/modules/input_prediction.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's ``TRYPredictor``
(``modules/InputPrediction/try_predictor.py:7-90``, subclassing agentlib's
TRYSensor): reads a weather table (German TRY datasets there; any CSV /
DataFrame here), publishes the *current* value of each quantity and a
*prediction series* over the MPC horizon — the trajectory-valued
AgentVariables the MPC backends sample onto their grids
(``utils/sampling.sample`` handles (times, values) pairs).
"""

from __future__ import annotations

import logging

import numpy as np

from agentlib_mpc_torch.modules.data_source import DataSource
from agentlib_mpc_torch.runtime.module import register_module
from agentlib_mpc_torch.runtime.variables import AgentVariable
from agentlib_mpc_torch.utils.sampling import interpolate_to_previous

logger = logging.getLogger(__name__)


@register_module("try_predictor", "input_predictor")
class InputPredictor(DataSource):
    """DataSource that additionally broadcasts forecasts.

    Extra config: ``prediction_horizon`` (seconds of lookahead),
    ``prediction_sample`` (forecast grid step, default ``t_sample``),
    ``prediction_suffix`` (default "prediction": column ``T_amb`` is
    forecast under alias ``T_amb_prediction``, matching the reference's
    two-channel layout — measurement + prediction)."""

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.prediction_horizon = float(
            config.get("prediction_horizon", 3600.0))
        self.prediction_sample = float(
            config.get("prediction_sample", self.t_sample))
        self.prediction_suffix = config.get("prediction_suffix",
                                            "prediction")

    def get_prediction_at_time(self, t: float) -> dict[str, tuple]:
        """column → (absolute times, values) forecast window starting at t."""
        n = int(np.floor(self.prediction_horizon
                         / self.prediction_sample)) + 1
        grid = t + np.arange(n) * self.prediction_sample
        out = {}
        for c in self.columns:
            times, vals = self.data[c]
            lookup = grid + self.data_offset
            if self.method == "previous":
                v = interpolate_to_previous(lookup, times, vals)
            else:
                v = np.interp(lookup, times, vals)
            out[c] = (grid.tolist(), v.tolist())
        return out

    def get_prediction_ensemble_at_time(
            self, t: float, n_scenarios: int, seed: int = 0,
            spread: "float | dict | None" = None) -> dict[str, tuple]:
        """column → (absolute times, (S, n) values): the batched
        forecast-ensemble hook of the scenario generator.

        Row 0 is the NOMINAL forecast (exactly
        :meth:`get_prediction_at_time`); rows 1.. add seeded random-walk
        perturbations from
        :func:`agentlib_mpc_torch.resilience.chaos.disturbance_model`, the
        JAX package's draws bit for bit. Equal ``(t, n_scenarios, seed,
        spread)`` reproduce the same ensemble.

        ``spread`` scales the per-step walk increment: a float applies one
        absolute sigma to every column; a dict maps column name → sigma;
        None defaults each column to 5% of its nominal window's
        peak-to-peak range (a flat column gets 0)."""
        from agentlib_mpc_torch.resilience.chaos import disturbance_model

        nominal = self.get_prediction_at_time(t)
        out = {}
        for ci, (c, (grid, vals)) in enumerate(sorted(nominal.items())):
            base = np.asarray(vals, dtype=float)
            if isinstance(spread, dict):
                sigma = float(spread.get(c, 0.0))
            elif spread is not None:
                sigma = float(spread)
            else:
                sigma = 0.05 * float(np.ptp(base)) if base.size else 0.0
            draws = disturbance_model(
                # one independent stream per column and forecast time
                seed=seed + 1009 * ci + int(t), horizon=base.shape[0],
                n_scenarios=int(n_scenarios), scale=sigma, kind="walk")
            ens = base[None, :] + draws[:, :, 0]
            out[c] = (list(grid), ens.tolist())
        return out

    def process(self):
        while True:
            now = float(self.env.now)
            for name, value in self.get_data_at_time(now).items():
                self.set(name, value)
            for name, series in self.get_prediction_at_time(now).items():
                self.send(AgentVariable(
                    name=f"{name}_{self.prediction_suffix}",
                    value=series, shared=True))
            yield self.t_sample
