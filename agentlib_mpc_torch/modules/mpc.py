"""Central MPC module.

Port of ``agentlib_mpc_tpu/modules/mpc.py``; the port keeps its own copy
and imports nothing of the JAX package.

Re-design of the reference's BaseMPC/MPC
(``modules/mpc/mpc.py``: config :31-107, backend creation :110-143,
do_step :322-340, set_actuation :342-357, process :273-276,
re_init_optimization :297-302; lag handling in ``mpc_full.py``): the module
owns an optimization backend, wakes every ``time_step``, collects live
variable values from its store, calls ``backend.solve``, actuates the first
control (clipped to bounds) and optionally publishes the full predicted
trajectories.

Results are recorded per step as (time, horizon-grid) rows, matching the
reference's MultiIndex CSV layout (``discretization.py:398-484``), with a
separate per-solve stats table (``casadi_backend.py:295-307``); both
frames need pandas, imported where they are built. The backend runs on the
agent's device in its dtype; checkpoints use the port's own format
(``utils/checkpoint.py``). :class:`MINLPMPC` (``minlp_mpc``) adds the
binary controls of the mixed-integer backends.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from agentlib_mpc_torch.backends.backend import VariableReference, create_backend
from agentlib_mpc_torch.modules.deactivate_mpc import MPC_FLAG_ACTIVE, SkippableMixin
from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.variables import AgentVariable

logger = logging.getLogger(__name__)


@register_module("mpc", "mpc_basic")
class BaseMPC(SkippableMixin, BaseModule):
    """Periodic control loop: collect vars → solve OCP → actuate u[0]."""

    variable_groups = ("inputs", "outputs", "states", "parameters",
                      "controls", "binary_controls")
    #: controls (incl. binary schedules) are actuation commands other
    #: agents (the plant) consume
    shared_groups = ("outputs", "controls", "binary_controls")

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.time_step = float(config.get("time_step", 60.0))
        self.prediction_horizon = int(config.get("prediction_horizon", 10))
        self.backend = create_backend(config["optimization_backend"],
                                      device=self.device, dtype=self.dtype)
        self.backend.register_logger(self.logger)
        self._history_rows: list[dict] = []
        self._setup_backend()
        self.init_skippable()
        self._init_resilience()

    def _init_resilience(self) -> None:
        """Guarded actuation (config key ``resilience``) + periodic
        warm-start auto-checkpointing (``checkpoint_path`` /
        ``checkpoint_every``, with restore-on-construct) — see
        docs/robustness.md."""
        from agentlib_mpc_torch.resilience.guard import (
            ActuationGuard,
            DegradationPolicy,
        )

        cfg = dict(self.config.get("resilience") or {})
        self.guard_enabled = bool(cfg.pop("enabled", True))
        plan_columns = None
        try:
            plan_columns = list(
                self.backend.trajectory_layout().get("u") or []) or None
        except Exception:  # noqa: BLE001 - a layout-less custom backend
            pass           # falls back to u0-order mapping in the guard
        #: broadcast guard flag flips beyond this agent. Off by default:
        #: the FallbackPID normally lives in the SAME agent, and a
        #: fleet-wide shared ``mpc_active`` broadcast would deactivate
        #: every OTHER healthy MPC agent on the bus. Enable only for a
        #: fallback controller deployed in a different agent.
        self._share_fallback_flag = bool(
            cfg.pop("share_fallback_flag", False))
        self.guard = ActuationGuard(
            DegradationPolicy.from_config(cfg), logger_=self.logger,
            agent=self.agent.id, module=self.id)
        self.guard.plan_columns = plan_columns
        self.guard.binary_plan_columns = \
            list(self.var_ref.binary_controls) or None
        #: last flag value set by someone OTHER than this module's guard
        #: (an operator's MPCOnOff / SkipMPCInIntervals window). Guard
        #: recovery must not override an operator-mandated off interval.
        self._external_flag = True
        #: effective flag value as last written by ANY writer (the guard
        #: included) — True mid-fallback means the FallbackPID is
        #: disengaged and the guard must serve a degraded hold
        self._flag_value = True
        self.checkpoint_path = self.config.get("checkpoint_path")
        self.checkpoint_every = int(self.config.get("checkpoint_every", 0))
        self._steps_since_checkpoint = 0
        if self.checkpoint_path:
            from agentlib_mpc_torch.utils.checkpoint import has_checkpoint

            if has_checkpoint(self.checkpoint_path):
                try:
                    self.restore_checkpoint(self.checkpoint_path)
                    self.logger.info(
                        "restored warm-start state from checkpoint %s",
                        self.checkpoint_path)
                except Exception as exc:  # noqa: BLE001 - an
                    # incompatible/corrupt checkpoint (e.g. after a
                    # horizon change) must degrade to a cold start, not
                    # crash-loop the controller it exists to protect
                    self.logger.warning(
                        "could not restore checkpoint %s (%s); starting "
                        "cold — delete it or fix the config to silence "
                        "this", self.checkpoint_path, exc)

    def _setup_backend(self) -> None:
        self.var_ref = VariableReference(
            states=self._groups.get("states", []),
            controls=self._groups.get("controls", []),
            inputs=self._groups.get("inputs", []),
            parameters=self._groups.get("parameters", []),
            outputs=self._groups.get("outputs", []),
            binary_controls=self._groups.get("binary_controls", []),
        )
        # load the model once, validate, and hand the instance to the
        # backend (the loaders pass instances through); ML configs need the
        # ML-aware loader so ml_model_sources register before the stomp
        from agentlib_mpc_torch.backends.backend import load_model_for_backend

        model = load_model_for_backend(self.backend.config["model"],
                                       dt=self.time_step)
        self._assert_config_matches_model(model)
        self.backend.config["model"] = model
        self.backend.setup_optimization(
            self.var_ref, self.time_step, self.prediction_horizon)

    def _assert_config_matches_model(self, model) -> None:
        """Validate module variables against the model, like the reference's
        config validation (``mpc.py:200-271``)."""
        errors = []
        for name in (*self.var_ref.controls, *self.var_ref.inputs):
            if name not in model.input_names:
                errors.append(f"{name!r} is not a model input")
        for name in self.var_ref.states:
            if name not in model.state_names:
                errors.append(f"{name!r} is not a model state")
        for name in self.var_ref.parameters:
            if name not in model.parameter_names:
                errors.append(f"{name!r} is not a model parameter")
        for name in self.var_ref.outputs:
            if name not in model.output_names:
                errors.append(f"{name!r} is not a model output")
        if errors:
            raise ValueError(
                f"MPC config does not match model: {'; '.join(errors)}")

    # -- control loop ---------------------------------------------------------

    def register_callbacks(self) -> None:
        super().register_callbacks()
        if self.guard_enabled:
            self.agent.data_broker.register_callback(
                MPC_FLAG_ACTIVE, None, self._external_flag_callback)

    def _external_flag_callback(self, incoming) -> None:
        """Track flag writes from OTHER modules (operator deactivation
        windows), so guard recovery cannot re-activate an MPC an operator
        turned off."""
        src = incoming.source
        if src.agent_id == self.agent.id and src.module_id == self.id:
            return                      # our own guard broadcast
        self._external_flag = bool(incoming.value)
        self._flag_value = bool(incoming.value)

    def process(self):
        while True:
            self.do_step()
            yield self.time_step

    def do_step(self) -> None:
        if self.check_if_should_be_skipped():
            if not (self.guard_enabled and self.guard.in_fallback):
                return
            # the guard itself flipped the flag: keep solving in probe
            # mode (nothing actuated) so recovery hysteresis can observe
            # healthy solves and re-engage
        variables = self.collect_variables_for_optimization()
        result = self.backend.solve(self.env.now, variables)
        decision = self.guarded_actuation(result)
        # results record only what actually drove the plant: probe
        # solves during a fallback outage (healthy, never actuated)
        # must not masquerade as MPC trajectories
        if decision.action == "actuate":
            self._record(result)

    def guarded_actuation(self, result: dict):
        """The ONE guarded actuation seam: assess the solve result and
        actuate it (or a degraded substitute) accordingly. ``do_step``
        routes through here, and so do the decentralized/coordinated
        ADMM modes that own their step loop — any actuation path that
        called ``set_actuation`` directly would re-open the 'failed or
        NaN solve still actuates u[0]' hole this subsystem closes.
        Returns the :class:`GuardDecision` (``decision.healthy`` gates
        results recording and checkpointing)."""
        from agentlib_mpc_torch.resilience.guard import GuardDecision

        if not self.guard_enabled:
            self.set_actuation(result)
            self._maybe_checkpoint()
            return GuardDecision("actuate", None, True, ())
        decision = self.guard.assess(
            result, self._control_bounds(),
            precheck=self.backend.health_check(result))
        if decision.healthy:
            # checkpointing lives on this seam so the ADMM modes (which
            # own their step loops) auto-checkpoint too; it needs only a
            # HEALTHY warm state — probe solves qualify, but a poisoned
            # iterate must never be persisted and auto-restored
            self._maybe_checkpoint()
        if decision.entered_fallback:
            self._set_mpc_flag(False)
        elif decision.reengaged:
            if self._external_flag:
                self._set_mpc_flag(True)
            else:
                # an operator (MPCOnOff / skip interval) holds the MPC
                # off: the guard has recovered, but the flag and the
                # plant stay with the operator's choice
                self.logger.info(
                    "guard recovered but an external deactivation is in "
                    "force; leaving mpc_active False")
                # nothing was actuated: report it like a probe so the
                # caller does not record the plan as a driven trajectory
                return decision._replace(action="fallback")
        if decision.action == "actuate":
            self.set_actuation(result)
        elif decision.controls is not None:     # replay / hold
            self.logger.warning(
                "solve at t=%s rejected (%s); %s", self.env.now,
                ", ".join(decision.reasons),
                "replaying the last accepted plan"
                if decision.action == "replay"
                else "holding the last actuated control")
            self._actuate_degraded(decision.controls)
        elif not decision.entered_fallback and self._flag_value:
            # mid-outage, an external writer re-asserted the flag True
            # (MPCOnOff's periodic activate heartbeat) — the FallbackPID
            # is disengaged, so the plant would be uncommanded: serve a
            # degraded hold instead of fighting over the flag
            held = self.guard.external_override_hold()
            if held is not None:
                self._actuate_degraded(held)
        # fallback otherwise: nothing actuated — FallbackPID owns the plant
        return decision

    def _control_bounds(self) -> dict:
        """Live (lb, ub) per actuated control — the guard's bound check."""
        out = {}
        for name in (*self.var_ref.controls, *self.var_ref.binary_controls):
            var = self.vars[name]
            out[name] = (var.lb, var.ub)
        return out

    def _actuate_degraded(self, controls: dict) -> None:
        """Actuate replay/hold controls, clipped like set_actuation."""
        for name, value in controls.items():
            var = self.vars[name]
            self.set(name, float(np.clip(value, var.lb, var.ub)))

    def _set_mpc_flag(self, active: bool) -> None:
        """Flip the ``mpc_active`` flag so the FallbackPID hands over,
        and mirror it into the local store when deactivation is enabled.
        Agent-local by default — a fleet-shared broadcast would switch
        every OTHER MPC agent to its fallback too; set
        ``resilience.share_fallback_flag`` when the fallback controller
        lives in a different agent."""
        self._flag_value = bool(active)
        if MPC_FLAG_ACTIVE in self.vars:
            self.vars[MPC_FLAG_ACTIVE].value = bool(active)
        self.send(AgentVariable(name=MPC_FLAG_ACTIVE, alias=MPC_FLAG_ACTIVE,
                                value=bool(active),
                                shared=self._share_fallback_flag))

    def _maybe_checkpoint(self) -> None:
        if not (self.checkpoint_path and self.checkpoint_every > 0):
            return
        self._steps_since_checkpoint += 1
        if self._steps_since_checkpoint < self.checkpoint_every:
            return
        self._steps_since_checkpoint = 0
        try:
            self.save_checkpoint(self.checkpoint_path)
        except Exception as exc:  # noqa: BLE001 - checkpointing must
            #              never take down the control loop it protects
            self.logger.warning("auto-checkpoint to %s failed: %s",
                                self.checkpoint_path, exc)

    def collect_variables_for_optimization(self) -> dict:
        """Current value of every referenced variable, plus per-variable
        bound channels (``name__lb``/``name__ub``) from the declarations."""
        out = {}
        for name in self.var_ref.all_names():
            var = self.vars[name]
            out[name] = var.value
            out[f"{name}__lb"] = var.lb
            out[f"{name}__ub"] = var.ub
        return out

    def set_actuation(self, result: dict) -> None:
        """Publish the first control of the optimal sequence (clipped —
        reference ``set_actuation``, ``mpc.py:342-357``)."""
        for name, value in result["u0"].items():
            var = self.vars[name]
            self.set(name, float(np.clip(value, var.lb, var.ub)))

    def _record(self, result: dict) -> None:
        traj = result["traj"]
        self._history_rows.append({
            "time": float(self.env.now),
            "traj": {k: np.asarray(v) for k, v in traj.items()},
        })

    # -- results --------------------------------------------------------------

    def results(self):
        """MultiIndex (time, grid-offset) DataFrame with ('variable', name)
        columns — the reference's results layout
        (``discretization.py:398-484``, loaded by ``utils/analysis.py``)."""
        from agentlib_mpc_torch.utils.results import mpc_trajectory_frame

        return mpc_trajectory_frame(self._history_rows,
                                    self.backend.trajectory_layout())

    def solver_stats(self):
        import pandas as pd

        if not self.backend.stats_history:
            return None
        return pd.DataFrame(self.backend.stats_history).set_index("time")

    def cleanup_results(self) -> None:
        self._history_rows.clear()
        self.backend.stats_history.clear()

    def save_checkpoint(self, path: str) -> str:
        """Persist the backend's warm-start memory (beyond reference:
        SURVEY §5 — its warm starts die with the process). A restarted
        controller built from the same config restores via
        :meth:`restore_checkpoint` and its first solve runs warm."""
        from agentlib_mpc_torch.utils.checkpoint import save_pytree

        return save_pytree(path, self.backend.warm_state())

    def restore_checkpoint(self, path: str) -> None:
        from agentlib_mpc_torch.utils.checkpoint import load_pytree

        self.backend.set_warm_state(
            load_pytree(path, self.backend.warm_state()))

    def re_init_optimization(self) -> None:
        """Rebuild the backend (reference ``re_init_optimization``,
        ``mpc.py:297-302``) — e.g. after a runtime horizon change."""
        self._setup_backend()


@register_module("mpc_full")
class MPC(BaseMPC):
    """Alias of the full MPC (the reference's ``mpc`` type adds NARX lag
    history on top of BaseMPC; here, as in the JAX package, lag collection
    lives in the ML backend, ``backends/ml_backend.py``)."""


@register_module("minlp_mpc")
class MINLPMPC(BaseMPC):
    """Mixed-integer MPC: adds the ``binary_controls`` variable group and
    actuates the scheduled binaries alongside the continuous controls
    (reference ``modules/mpc/minlp_mpc.py:17-86``). Requires a MINLP-family
    backend (``jax_minlp`` / ``jax_cia`` / ``jax_minlp_bb``)."""

    def _assert_config_matches_model(self, model) -> None:
        super()._assert_config_matches_model(model)
        errors = []
        for name in self.var_ref.binary_controls:
            if name not in model.input_names:
                errors.append(f"binary control {name!r} is not a model input")
            else:
                var = model.get_var(name)
                if not (var.lb >= 0.0 and var.ub <= 1.0):
                    errors.append(
                        f"binary control {name!r} must be bounded in [0, 1]")
        if not self.var_ref.binary_controls:
            errors.append("minlp_mpc requires a non-empty binary_controls "
                          "group")
        if errors:
            raise ValueError(
                f"MINLP MPC config does not match model: {'; '.join(errors)}")

    def set_actuation(self, result: dict) -> None:
        """Continuous controls clip to bounds; binaries actuate exactly
        (reference ``MINLPMPC.set_actuation``, ``minlp_mpc.py:79-86``)."""
        binaries = set(self.var_ref.binary_controls)
        for name, value in result["u0"].items():
            if name in binaries:
                self.set(name, float(round(value)))
            else:
                var = self.vars[name]
                self.set(name, float(np.clip(value, var.lb, var.ub)))
