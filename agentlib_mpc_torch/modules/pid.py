"""PID controller and the MPC-fallback variant.

Port of ``agentlib_mpc_tpu/modules/pid.py``; the port keeps its own copy
and imports nothing of the JAX package.

The reference leans on agentlib's PID module and subclasses it
(``modules/deactivate_mpc/fallback_pid.py:40-97``); since the runtime here
replaces agentlib (SURVEY.md §1 L0), the PID itself is part of the
framework. Event-driven SISO loop: every arriving measurement triggers one
controller step

    u = Kp · (e + 1/Ti ∫e dt + Td de/dt),  clamped to [lb, ub]

with conditional anti-windup (the integrator freezes while the output
saturates). ``FallbackPID`` runs only while the MPC flag is False and
resets its integrator and timing on every hand-over, so control resumes
bumplessly after MPC outages.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from agentlib_mpc_torch.modules.deactivate_mpc import MPC_FLAG_ACTIVE
from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.variables import AgentVariable

logger = logging.getLogger(__name__)


@register_module("pid")
class PID(BaseModule):
    """Config: ``input`` (measured variable, usually with alias/source),
    ``output`` (actuation variable, shared), ``setpoint`` (value or
    variable entry), ``Kp``, ``Ti`` (s, 0 = no integral action), ``Td``
    (s), ``ub``/``lb`` saturation, ``reverse_acting``."""

    variable_groups = ("inputs", "outputs")
    shared_groups = ("outputs",)

    def __init__(self, config: dict, agent):
        # copy the variable-group lists too: appending into a caller-owned
        # list would leak the singular entries into reused config templates
        config = dict(config)
        if "input" in config:
            config["inputs"] = [*config.get("inputs", []),
                                config.pop("input")]
        if "output" in config:
            config["outputs"] = [*config.get("outputs", []),
                                 config.pop("output")]
        super().__init__(config, agent)
        if not self._groups["inputs"] or not self._groups["outputs"]:
            raise ValueError("PID needs an input and an output variable")
        self.input_name = self._groups["inputs"][0]
        self.output_name = self._groups["outputs"][0]
        sp = config.get("setpoint", 0.0)
        if isinstance(sp, dict):
            var = AgentVariable.from_config(sp)
            self._declare(var, "inputs")
            self._groups["inputs"].append(var.name)
            self.setpoint_name = var.name
        else:
            self.setpoint_name = None
            self.setpoint_value = float(sp)
        self.Kp = float(config.get("Kp", 1.0))
        self.Ti = float(config.get("Ti", 0.0))
        self.Td = float(config.get("Td", 0.0))
        self.ub = float(config.get("ub", math.inf))
        self.lb = float(config.get("lb", -math.inf))
        self.reverse_acting = bool(config.get("reverse_acting", False))
        self.integral = 0.0
        self.e_last = 0.0
        self.last_time: float | None = None

    @property
    def setpoint(self) -> float:
        if self.setpoint_name is not None:
            return float(self.vars[self.setpoint_name].value)
        return self.setpoint_value

    def register_callbacks(self) -> None:
        super().register_callbacks()
        var = self.vars[self.input_name]
        self.agent.data_broker.register_callback(
            var.alias, var.source, self._siso_callback)

    def reset(self, at_time: float | None = None) -> None:
        self.integral = 0.0
        self.e_last = 0.0
        self.last_time = at_time

    def _siso_callback(self, incoming: AgentVariable) -> None:
        self.vars[self.input_name].value = incoming.value
        self.vars[self.input_name].timestamp = incoming.timestamp
        out = self.do_step(float(incoming.value),
                           float(incoming.timestamp))
        if out is not None:
            self.set(self.output_name, out)

    def do_step(self, measurement: float, t: float) -> float | None:
        e = self.setpoint - measurement
        if self.reverse_acting:
            e = -e
        if self.last_time is None:
            self.last_time = t
            self.e_last = e
            return None
        dt = t - self.last_time
        if dt <= 0:
            return None
        d_term = self.Td * (e - self.e_last) / dt
        i_term = (self.integral + e * dt) / self.Ti if self.Ti > 0 else 0.0
        u = self.Kp * (e + i_term + d_term)
        u_sat = float(np.clip(u, self.lb, self.ub))
        # conditional anti-windup: integrate only when not pushing further
        # into saturation
        if self.Ti > 0 and (u == u_sat or (u > u_sat) == (e < 0)):
            self.integral += e * dt
        self.e_last = e
        self.last_time = t
        return u_sat


@register_module("fallback_pid")
class FallbackPID(PID):
    """PID active only while the MPC flag is False (reference
    ``FallbackPID._siso_callback``, ``fallback_pid.py:40-97``)."""

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        if MPC_FLAG_ACTIVE not in self.vars:
            self._declare(AgentVariable(name=MPC_FLAG_ACTIVE, value=True,
                                        shared=False), "inputs")
            self._groups["inputs"].append(MPC_FLAG_ACTIVE)
        self._mpc_was_active: bool | None = None

    def _siso_callback(self, incoming: AgentVariable) -> None:
        mpc_active = bool(self.vars[MPC_FLAG_ACTIVE].value)
        if self._mpc_was_active is None:
            self._mpc_was_active = mpc_active
            if not mpc_active:
                self.reset(at_time=float(incoming.timestamp))
        elif mpc_active != self._mpc_was_active:
            # hand-over in either direction resets integrator and timing
            self.logger.info(
                "MPC flag became %s; %s FallbackPID", mpc_active,
                "deactivating" if mpc_active else "activating")
            self.reset(at_time=None if mpc_active
                       else float(incoming.timestamp))
            self._mpc_was_active = mpc_active
        if not mpc_active:
            super()._siso_callback(incoming)
