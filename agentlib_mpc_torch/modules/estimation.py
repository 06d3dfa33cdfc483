"""Moving horizon estimation module.

Port of ``agentlib_mpc_tpu/modules/estimation.py`` (the reference's MHE
module, ``modules/estimation/mhe.py``): auto-generates ``measured_<state>``
/ ``weight_<state>`` variables from the ``state_weights`` config
(``_create_auxiliary_variables``, ``mhe.py:277-300``), records
timestamped measurement/input history from broker callbacks
(``register_callbacks`` + ``_callback_hist_vars``, ``mhe.py:213-237,274``),
estimates states / parameters / unknown inputs each ``time_step`` over a
backwards horizon and publishes the most recent values
(``do_step``/``_set_estimation``, ``mhe.py:181-211``), pruning history older
than the horizon (``_remove_old_values_from_history``, ``mhe.py:191-197``).
The backend runs on the agent's device in its dtype.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np

from agentlib_mpc_torch.backends.backend import (
    create_backend,
    load_model_for_backend,
)
from agentlib_mpc_torch.backends.mhe_backend import (
    MEASURED_PREFIX,
    WEIGHT_PREFIX,
    MHEVariableReference,
)
from agentlib_mpc_torch.modules.deactivate_mpc import SkippableMixin
from agentlib_mpc_torch.runtime.module import BaseModule, register_module

MAX_HISTORY = 10_000


@register_module("mhe")
class MHE(SkippableMixin, BaseModule):
    """Moving horizon estimator."""

    variable_groups = ("states", "known_inputs", "estimated_inputs",
                       "known_parameters", "estimated_parameters", "outputs")
    #: estimates are published
    shared_groups = ("estimated_parameters", "estimated_inputs")

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.time_step = float(config.get("time_step", 60.0))
        self.horizon = int(config.get("horizon", 5))
        self.state_weights: Dict[str, float] = dict(
            config.get("state_weights", {}))
        unknown = set(self.state_weights) - set(self._groups["states"])
        if unknown:
            raise ValueError(
                f"state_weights refer to unknown states: {sorted(unknown)}")
        self._history: Dict[str, deque] = {}
        self._history_rows: list = []
        self.backend = create_backend(config["optimization_backend"],
                                      device=self.device, dtype=self.dtype)
        self.backend.register_logger(self.logger)
        self._setup_backend()
        self.init_skippable()

    def _setup_backend(self) -> None:
        states = self._groups.get("states", [])
        self.var_ref = MHEVariableReference(
            states=states,
            measured_states=[MEASURED_PREFIX + s for s in states],
            weights_states=[WEIGHT_PREFIX + s for s in states],
            estimated_inputs=self._groups.get("estimated_inputs", []),
            known_inputs=self._groups.get("known_inputs", []),
            estimated_parameters=self._groups.get(
                "estimated_parameters", []),
            known_parameters=self._groups.get("known_parameters", []),
            outputs=self._groups.get("outputs", []),
        )
        model = load_model_for_backend(self.backend.config["model"],
                                       dt=self.time_step)
        self.backend.config["model"] = model
        self.backend.setup_optimization(
            self.var_ref, self.time_step, self.horizon)
        # history streams: known inputs + state measurements
        for name in (*self.var_ref.known_inputs, *self.var_ref.states):
            self._history.setdefault(name, deque(maxlen=MAX_HISTORY))

    # -- measurement collection -----------------------------------------------

    def register_callbacks(self) -> None:
        """Listen on the alias/source of every known input and state; the
        received series become the backwards trajectories."""
        for name in (*self.var_ref.known_inputs, *self.var_ref.states):
            var = self.vars[name]
            self.agent.data_broker.register_callback(
                var.alias, var.source, self._make_hist_callback(name))

    def _make_hist_callback(self, name: str):
        def _cb(incoming):
            # never record our own published estimates as measurements
            # (self.set() broadcasts loop back through the local broker) —
            # but sibling modules in the same agent are legitimate sources:
            # the reference runs MHE and MPC side by side in one agent and
            # the MHE must see the MPC's actuation (mhe_example.py)
            if (incoming.source.agent_id == self.agent.id
                    and incoming.source.module_id == self.id):
                return
            local = self.vars[name]
            local.value = incoming.value
            local.timestamp = incoming.timestamp
            self._history[name].append(
                (float(incoming.timestamp), float(incoming.value)))
        return _cb

    def _prune_history(self) -> None:
        oldest = self.env.now - self.horizon * self.time_step
        for dq in self._history.values():
            while dq and dq[0][0] < oldest:
                dq.popleft()

    # -- estimation loop -------------------------------------------------------

    def process(self):
        while True:
            self.do_step()
            yield self.time_step

    def do_step(self) -> None:
        if self.check_if_should_be_skipped():
            return
        variables = self.collect_variables_for_optimization()
        result = self.backend.solve(self.env.now, variables)
        self._set_estimation(result)
        self._history_rows.append({
            "time": float(self.env.now),
            "traj": {k: np.asarray(v) for k, v in result["traj"].items()},
        })
        self._prune_history()

    def collect_variables_for_optimization(self) -> dict:
        out = {}
        for name in self.var_ref.all_names():
            var = self.vars[name]
            out[name] = var.value
            out[f"{name}__lb"] = var.lb
            out[f"{name}__ub"] = var.ub
        for name in (*self.var_ref.known_inputs, *self.var_ref.states):
            hist = self._history[name]
            if hist:
                times = np.array([t for t, _ in hist])
                vals = np.array([v for _, v in hist])
                series = (times, vals)
            else:
                series = self.vars[name].value
            if name in self.var_ref.states:
                out[MEASURED_PREFIX + name] = series
            else:
                out[name] = series
        for name in self.var_ref.states:
            out[WEIGHT_PREFIX + name] = float(
                self.state_weights.get(name, 0.0))
        return out

    def _set_estimation(self, result: dict) -> None:
        """Publish estimated parameters (constant) and the most recent
        state/input estimates (reference ``_set_estimation``,
        ``mhe.py:199-211``)."""
        for name, val in result["estimates"].items():
            if name in self.vars:
                self.set(name, float(val))
        for name, traj in result["estimated_inputs"].items():
            self.set(name, float(np.asarray(traj)[-1]))
        self._last_result = result

    # -- results ---------------------------------------------------------------

    def results(self):
        import pandas as pd

        if not self.backend.stats_history:
            return None
        return pd.DataFrame(self.backend.stats_history).set_index("time")

    # naming parity with the MPC module (results() keeps its historical
    # stats meaning; the frame APIs below feed the dashboard's MHE view)
    solver_stats = results

    def estimation_frame(self):
        """(time, grid-offset) MultiIndex frame of the backward estimate
        trajectories — the MPC results layout with NEGATIVE offsets
        ([−N·dt … 0]; the estimate "at now" sits at offset 0)."""
        from agentlib_mpc_torch.utils.results import mpc_trajectory_frame

        return mpc_trajectory_frame(self._history_rows,
                                    self.backend.trajectory_layout())

    def measurements_frame(self):
        """Tidy (time-indexed) frame of every raw measurement series the
        estimator has received, one column per measured state/known
        input."""
        import pandas as pd

        series = {}
        for name, dq in self._history.items():
            if dq:
                t = [pt[0] for pt in dq]
                v = [pt[1] for pt in dq]
                series[name] = pd.Series(v, index=pd.Index(t, name="time"))
        if not series:
            return None
        return pd.DataFrame(series)

    def cleanup_results(self) -> None:
        self._history_rows.clear()
        self.backend.stats_history.clear()
