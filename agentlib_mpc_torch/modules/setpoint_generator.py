"""Set-point generator: randomized comfort-band schedules.

Port of ``agentlib_mpc_tpu/modules/setpoint_generator.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's ``SetPointGenerator``
(``modules/ml_model_training/setpoint_generator.py:28-94``): publishes a
target variable that jumps to a fresh random value inside a day or night
band on a fixed interval — the excitation signal used to generate training
data for the ML pipeline.
"""

from __future__ import annotations

import logging

import numpy as np

from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.variables import AgentVariable

logger = logging.getLogger(__name__)

DAY = 86400.0
WEEK = 7 * DAY


@register_module("set_point_generator")
class SetPointGenerator(BaseModule):
    """Config: ``target_variable`` (default "target"), ``interval``
    (seconds between new set points), ``day_start`` / ``day_end`` (hours),
    ``day_lb``/``day_ub`` and ``night_lb``/``night_ub`` bands, and
    ``weekend_uses_night`` (reference day/night/weekend schedule,
    ``setpoint_generator.py:55-94``)."""

    variable_groups = ("outputs",)
    shared_groups = ("outputs",)

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.target_variable = config.get("target_variable", "target")
        self.interval = float(config.get("interval", 60 * 60 * 4))
        self.day_start = float(config.get("day_start", 8))
        self.day_end = float(config.get("day_end", 16))
        self.day_lb = float(config.get("day_lb", 292.15))
        self.day_ub = float(config.get("day_ub", 297.15))
        self.night_lb = float(config.get("night_lb", 289.15))
        self.night_ub = float(config.get("night_ub", 299.15))
        self.weekend_uses_night = bool(config.get("weekend_uses_night",
                                                  True))
        self._rng = np.random.default_rng(int(config.get("seed", 0)))
        if self.target_variable not in self.vars:
            self._declare(AgentVariable(name=self.target_variable,
                                        shared=True), "outputs")
            self._groups["outputs"].append(self.target_variable)

    def band_at(self, t: float) -> tuple[float, float]:
        hour = (t % DAY) / 3600.0
        weekday = int(t % WEEK // DAY)  # 0 = sim start
        weekend = weekday >= 5
        if (self.day_start <= hour < self.day_end) and not (
                weekend and self.weekend_uses_night):
            return self.day_lb, self.day_ub
        return self.night_lb, self.night_ub

    def process(self):
        while True:
            lb, ub = self.band_at(float(self.env.now))
            self.set(self.target_variable, float(self._rng.uniform(lb, ub)))
            yield self.interval
