"""MPC deactivation: external on/off gating with fallback control values.

Port of ``agentlib_mpc_tpu/modules/deactivate_mpc.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterparts of the reference's deactivation suite:
- ``SkippableMixin`` (``modules/mpc/skippable_mixin.py:44-57``): MPC-side —
  an AgentVariable ``mpc_active`` that other modules may set to False gates
  ``do_step``.
- ``MPCOnOff`` (``modules/deactivate_mpc/deactivate_mpc.py:45-88``):
  sender side — periodically broadcasts the flag, fallback control values
  while inactive, and optional public (in)active messages.
- ``SkipMPCInIntervals`` (``deactivate_mpc.py:106-123``): deactivates
  inside configured time intervals (unit-convertible).
"""

from __future__ import annotations

import logging

from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source
from agentlib_mpc_torch.utils.time_utils import (
    TIME_CONVERSION,
    is_time_in_intervals,
)

logger = logging.getLogger(__name__)

#: reserved flag name (reference ``mpc_datamodels.MPC_FLAG_ACTIVE``)
MPC_FLAG_ACTIVE = "mpc_active"


class SkippableMixin:
    """Mix into an MPC-like module: call ``init_skippable`` from
    ``__init__`` and ``check_if_should_be_skipped`` at the top of each
    step (reference ``skippable_mixin.py:44-57``)."""

    def init_skippable(self) -> None:
        config = self.config
        self.enable_deactivation = bool(
            config.get("enable_deactivation", False))
        if not self.enable_deactivation:
            return
        if MPC_FLAG_ACTIVE not in self.vars:
            var = AgentVariable(
                name=MPC_FLAG_ACTIVE, value=True, shared=False,
                description="MPC is active")
            src = config.get("deactivation_source")
            if src:
                var.source = Source.coerce(src)
            self.vars[MPC_FLAG_ACTIVE] = var
        # subscription happens in BaseModule.register_callbacks — the flag
        # is shared=False, so the default rule covers it; registering here
        # too would run duplicate callbacks per broadcast

    def check_if_should_be_skipped(self) -> bool:
        if not getattr(self, "enable_deactivation", False):
            return False
        flag = self.vars[MPC_FLAG_ACTIVE]
        if bool(flag.value):
            return False
        self.logger.info("MPC deactivated by %s at t=%s",
                         flag.source, self.env.now)
        return True


@register_module("mpc_on_off")
class MPCOnOff(BaseModule):
    """Broadcasts the active flag every ``t_sample``; while inactive, also
    re-sends the configured fallback control values. Subclasses override
    ``check_mpc_deactivation``."""

    variable_groups = ("inputs", "controls_when_deactivated")
    shared_groups = ("controls_when_deactivated",)

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.t_sample = float(config.get("t_sample", 60.0))
        if MPC_FLAG_ACTIVE not in self.vars:
            self._declare(AgentVariable(name=MPC_FLAG_ACTIVE, value=True,
                                        shared=True), "outputs")
        self.public_active_message = config.get("public_active_message")
        self.public_inactive_message = config.get("public_inactive_message")

    def check_mpc_deactivation(self) -> bool:
        """Override: True → MPC should be deactivated now."""
        return False

    def process(self):
        while True:
            if self.check_mpc_deactivation():
                self.deactivate_mpc()
            else:
                self.activate_mpc()
            yield self.t_sample

    def deactivate_mpc(self) -> None:
        self.set(MPC_FLAG_ACTIVE, False)
        for var in self.variables_in_group("controls_when_deactivated"):
            self.set(var.name, var.value)
        if self.public_inactive_message:
            self.send(AgentVariable.from_config(
                self.public_inactive_message))

    def activate_mpc(self) -> None:
        self.set(MPC_FLAG_ACTIVE, True)
        if self.public_active_message:
            self.send(AgentVariable.from_config(self.public_active_message))


@register_module("skip_mpc_intervals")
class SkipMPCInIntervals(MPCOnOff):
    """Deactivates the MPC inside configured [start, end] intervals
    (reference ``SkipMPCInIntervals``, ``deactivate_mpc.py:106-123``)."""

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.intervals = [tuple(map(float, iv))
                          for iv in config.get("intervals", [])]
        self.time_unit = config.get("time_unit", "seconds")
        if self.time_unit not in TIME_CONVERSION:
            raise ValueError(f"unknown time_unit {self.time_unit!r}")

    def check_mpc_deactivation(self) -> bool:
        t = float(self.env.now) / TIME_CONVERSION[self.time_unit]
        return is_time_in_intervals(t, self.intervals)
