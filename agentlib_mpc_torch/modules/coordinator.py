"""Coordinated ADMM: central coordinator + employee participants.

Re-design of the reference's star-topology distributed MPC
(``modules/dmpc/coordinator.py``, ``modules/dmpc/employee.py``,
``modules/dmpc/admm/admm_coordinator.py``, ``admm_coordinated.py``): the
coordinator owns the global ADMM state — per-coupling local trajectories
keyed by source, means, multipliers — and drives rounds over a three-phase
wire protocol (registration handshake → start-iteration sync → per-iteration
optimization triggers), with Boyd-style residual convergence, adaptive
penalty, shift-by-one warm starts, and slow-agent de-registration.
Participants (`CoordinatedADMM`) are ADMM modules that only solve on
callback and reply with their coupling trajectories.

Wire protocol names and message shapes follow the reference
(``data_structures/coordinator_datatypes.py:13-89``,
``admm_datatypes.py:334-363``) so deployments can interop; payloads are
plain dicts in-process and JSON at external boundaries.

The per-iteration global update is numerically identical to the fused
engine's (``ops/admm.py`` — same mean / scaled-dual update / residual
definitions); this module is the asynchronous-tolerant broker path for
heterogeneous agents, while ``parallel/fused_admm.py`` is the
single-program fast path. The coordinator's bookkeeping is host numpy
(message state); each participant's local solve runs on its agent's device
in its dtype (``backends/admm_backend.py``).

Port of ``agentlib_mpc_tpu/modules/coordinator.py``; the port keeps its own
copy and imports nothing of the JAX package. The wire messages serialize
key for key as the JAX package's do. Beyond the JAX package, the real-time
coordinator counts the rounds its thread finished (``rounds_run``) and the
rounds that raised (``failed_rounds``), so a caller can tell a round that
failed from one that ran.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time as _time
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.modules.admm import ADMMModule, CouplingEntry
from agentlib_mpc_torch.ops.admm import record_residuals, trim_residuals
from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.utils.sampling import shift_time_series
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source

# wire aliases (reference coordinator_datatypes.py:14-23)
REGISTRATION_C2A = "registration_coordinator_to_agent"
REGISTRATION_A2C = "registration_agent_to_coordinator"
START_ITERATION_C2A = "startIteration_coordinator_to_agent"
START_ITERATION_A2C = "startIteration_agent_to_coordinator"
OPTIMIZATION_C2A = "optimization_coordinator_to_agent"
OPTIMIZATION_A2C = "optimization_agent_to_coordinator"


class CoordinatorStatus(str, Enum):
    sleeping = "sleeping"
    init_iterations = "init_iterations"
    optimization = "optimization"
    updating = "updating"


class AgentStatus(str, Enum):
    pending = "pending"
    standby = "standby"
    ready = "ready"
    busy = "busy"


# -- wire messages (dict in-process, JSON at external boundaries) -------------

@dataclasses.dataclass
class AgentToCoordinator:
    """Local coupling trajectories, keyed by coupling alias
    (reference ``admm_datatypes.py:360-363``)."""

    local_trajectory: Dict[str, list] = dataclasses.field(default_factory=dict)
    local_exchange_trajectory: Dict[str, list] = dataclasses.field(
        default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    to_payload = to_dict

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_payload(cls, value) -> "AgentToCoordinator":
        if isinstance(value, str):
            value = json.loads(value)
        return cls(**value)


@dataclasses.dataclass
class CoordinatorToAgent:
    """Global parameters one agent needs for its next local solve
    (reference ``admm_datatypes.py:350-357``)."""

    target: str = ""
    mean_trajectory: Dict[str, list] = dataclasses.field(default_factory=dict)
    multiplier: Dict[str, list] = dataclasses.field(default_factory=dict)
    mean_diff_trajectory: Dict[str, list] = dataclasses.field(
        default_factory=dict)
    exchange_multiplier: Dict[str, list] = dataclasses.field(
        default_factory=dict)
    penalty_parameter: float = 10.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    to_payload = to_dict

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_payload(cls, value) -> "CoordinatorToAgent":
        if isinstance(value, str):
            value = json.loads(value)
        return cls(**value)


# -- coordinator-side per-coupling state --------------------------------------

class ConsensusVariable:
    """Coordinator state of one consensus coupling: trajectories and
    multipliers keyed by participant source (reference
    ``admm_datatypes.py:221-282``). The math mirrors
    ``ops/admm.consensus_update`` on a dynamic participant set."""

    def __init__(self):
        self.local_trajectories: Dict[Source, np.ndarray] = {}
        self.multipliers: Dict[Source, np.ndarray] = {}
        self.mean_trajectory: Optional[np.ndarray] = None
        self._last_mean: Optional[np.ndarray] = None

    def add_participant(self, source: Source, traj) -> None:
        traj = np.asarray(traj, dtype=float)
        self.local_trajectories[source] = traj
        self.multipliers[source] = np.zeros_like(traj)

    def update_mean(self, sources: List[Source]) -> None:
        vals = [self.local_trajectories[s] for s in sources
                if s in self.local_trajectories]
        if not vals:
            return
        self._last_mean = self.mean_trajectory
        self.mean_trajectory = np.mean(np.stack(vals), axis=0)

    def update_multipliers(self, rho: float, sources: List[Source]) -> None:
        for s in sources:
            if s not in self.multipliers:
                continue
            x = self.local_trajectories[s]
            self.multipliers[s] = self.multipliers[s] - rho * (
                self.mean_trajectory - x)

    def residuals(self, rho: float, sources: List[Source]):
        """Per-element primal stack (z̄ − x_i) and dual ρ·Δz̄
        (reference ``admm_datatypes.py:202-214``). A coupling registered
        mid-round has no mean yet → contributes nothing."""
        if self.mean_trajectory is None:
            return [], []
        prim: list = []
        for s in sources:
            if s in self.local_trajectories:
                prim.extend(self.mean_trajectory - self.local_trajectories[s])
        if self._last_mean is None:
            dual = np.zeros_like(self.mean_trajectory)
        else:
            dual = rho * (self.mean_trajectory - self._last_mean)
        return prim, list(dual)

    def shift(self, horizon: int) -> None:
        for s, traj in self.local_trajectories.items():
            self.local_trajectories[s] = shift_time_series(traj, horizon)
        for s, lam in self.multipliers.items():
            self.multipliers[s] = shift_time_series(lam, horizon)
        if self.mean_trajectory is not None:
            self.mean_trajectory = shift_time_series(
                self.mean_trajectory, horizon)

    def flat_locals(self, sources: List[Source]) -> list:
        out: list = []
        for s in sources:
            if s in self.local_trajectories:
                out.extend(self.local_trajectories[s])
        return out

    def flat_multipliers(self, sources: List[Source]) -> list:
        out: list = []
        for s in sources:
            if s in self.multipliers:
                out.extend(self.multipliers[s])
        return out


class ExchangeVariable:
    """Coordinator state of one exchange coupling: shared multiplier,
    per-agent deviations (reference ``admm_datatypes.py:285-331``)."""

    def __init__(self):
        self.local_trajectories: Dict[Source, np.ndarray] = {}
        self.diff_trajectories: Dict[Source, np.ndarray] = {}
        self.multiplier: Optional[np.ndarray] = None
        self.mean_trajectory: Optional[np.ndarray] = None
        self._last_mean: Optional[np.ndarray] = None

    def add_participant(self, source: Source, traj) -> None:
        traj = np.asarray(traj, dtype=float)
        self.local_trajectories[source] = traj
        if self.multiplier is None:
            self.multiplier = np.zeros_like(traj)

    def update_diffs(self, sources: List[Source]) -> None:
        vals = [self.local_trajectories[s] for s in sources
                if s in self.local_trajectories]
        if not vals:
            return
        self._last_mean = self.mean_trajectory
        self.mean_trajectory = np.mean(np.stack(vals), axis=0)
        for s in sources:
            if s in self.local_trajectories:
                self.diff_trajectories[s] = (
                    self.local_trajectories[s] - self.mean_trajectory)

    def update_multiplier(self, rho: float) -> None:
        if self.multiplier is None or self.mean_trajectory is None:
            return
        self.multiplier = self.multiplier + rho * self.mean_trajectory

    def residuals(self, rho: float, sources: List[Source]):
        prim = list(self.mean_trajectory) \
            if self.mean_trajectory is not None else []
        if self._last_mean is None or self.mean_trajectory is None:
            dual = []
        else:
            dual = list(rho * (self.mean_trajectory - self._last_mean))
        return prim, dual

    def shift(self, horizon: int) -> None:
        for s, traj in self.local_trajectories.items():
            self.local_trajectories[s] = shift_time_series(traj, horizon)
        for s, traj in self.diff_trajectories.items():
            self.diff_trajectories[s] = shift_time_series(traj, horizon)
        if self.multiplier is not None:
            self.multiplier = shift_time_series(self.multiplier, horizon)
        if self.mean_trajectory is not None:
            self.mean_trajectory = shift_time_series(
                self.mean_trajectory, horizon)

    def flat_locals(self, sources: List[Source]) -> list:
        out: list = []
        for s in sources:
            if s in self.local_trajectories:
                out.extend(self.local_trajectories[s])
        return out


@dataclasses.dataclass
class AgentEntry:
    source: Source
    status: AgentStatus = AgentStatus.pending
    coup_vars: List[str] = dataclasses.field(default_factory=list)
    exchange_vars: List[str] = dataclasses.field(default_factory=list)
    #: consecutive rounds this participant was de-registered from for
    #: not responding in time (reset on the next successful reply)
    missed_rounds: int = 0


@register_module("admm_coordinator")
class ADMMCoordinator(BaseModule):
    """Central coordinator driving consensus/exchange ADMM rounds."""

    variable_groups = ()

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.penalty_factor = float(config.get("penalty_factor", 10.0))
        self.admm_iter_max = int(config.get("admm_iter_max",
                                            config.get("maxIter", 20)))
        self.time_step = float(config.get("time_step", 600.0))
        self.sampling_time = float(
            config.get("sampling_time", self.time_step))
        self.prediction_horizon = int(config.get("prediction_horizon", 10))
        self.registration_period = float(
            config.get("registration_period", 5.0))
        self.wait_time_on_start_iters = float(
            config.get("wait_time_on_start_iters", 0.1))
        self.abs_tol = float(config.get("abs_tol", 1e-3))
        self.rel_tol = float(config.get("rel_tol", 1e-3))
        self.primal_tol = float(config.get("primal_tol", 1e-3))
        self.dual_tol = float(config.get("dual_tol", 1e-3))
        self.use_relative_tolerances = bool(
            config.get("use_relative_tolerances", True))
        self.penalty_change_threshold = float(
            config.get("penalty_change_threshold", -1.0))
        self.penalty_change_factor = float(
            config.get("penalty_change_factor", 2.0))
        self.time_out_non_responders = float(
            config.get("time_out_non_responders", 1.0))

        self.status = CoordinatorStatus.sleeping
        # the three registration containers: key insert/remove must hold
        # _registration_lock (per-entry field transitions are the status
        # machine's business, synchronized by the round protocol itself —
        # locking the callbacks would starve received_variable while the
        # round thread holds the lock across a whole round)
        self.agent_dict: Dict[Source, AgentEntry] = {}  # guarded-by: self._registration_lock
        self._coupling_variables: Dict[str, ConsensusVariable] = {}  # guarded-by: self._registration_lock
        self._exchange_variables: Dict[str, ExchangeVariable] = {}  # guarded-by: self._registration_lock
        self.penalty_parameter = self.penalty_factor
        self.received_variable = threading.Event()
        self._thread: "threading.Thread | None" = None
        # RLock: in fast simulation broker delivery is synchronous, so the
        # registration handshake re-enters this module's callback stack
        # (request → params → confirm) within one acquire
        self._registration_lock = threading.RLock()
        self._stats_rows: List[dict] = []
        self._round_start: float = 0.0
        self._perf_counter: float = 0.0
        #: sources already warned about as slow (one WARNING per agent)
        self._dereg_warned: set = set()
        #: real-time rounds the thread finished, and rounds that raised
        self.rounds_run = 0
        self.failed_rounds = 0

    # -- messaging -------------------------------------------------------------

    def _broadcast(self, alias: str, value) -> None:
        self.send(AgentVariable(name=alias, alias=alias, value=value,
                                shared=True))

    def register_callbacks(self) -> None:
        broker = self.agent.data_broker
        broker.register_callback(REGISTRATION_A2C, None,
                                 self.registration_callback)
        broker.register_callback(START_ITERATION_A2C, None,
                                 self.init_iteration_callback)
        broker.register_callback(OPTIMIZATION_A2C, None,
                                 self.optim_results_callback)

    # -- registration handshake ------------------------------------------------

    def registration_callback(self, variable: AgentVariable) -> None:
        """Two-phase handshake: unknown source → send global parameters;
        pending source replying with initial guesses → register
        (reference ``admm_coordinator.py:596-654``)."""
        if variable.source.agent_id == self.agent.id:
            return
        with self._registration_lock:
            if variable.source not in self.agent_dict:
                self.agent_dict[variable.source] = AgentEntry(
                    source=variable.source)
                self._broadcast(REGISTRATION_C2A, {
                    "agent_id": variable.source.agent_id,
                    "opts": {
                        "prediction_horizon": self.prediction_horizon,
                        "time_step": self.time_step,
                        "penalty_factor": self.penalty_factor,
                    },
                })
                self.logger.info("agent %s pending registration",
                                 variable.source)
            elif self.agent_dict[variable.source].status \
                    is AgentStatus.pending:
                self._register_agent(variable)

    def _register_agent(self, variable: AgentVariable) -> None:
        # lint: holds[self._registration_lock] — only called from
        # registration_callback inside its with-block
        value = AgentToCoordinator.from_payload(variable.value)
        entry = self.agent_dict[variable.source]
        for alias, traj in value.local_trajectory.items():
            var = self._coupling_variables.setdefault(
                alias, ConsensusVariable())
            var.add_participant(variable.source, traj)
            entry.coup_vars.append(alias)
        for alias, traj in value.local_exchange_trajectory.items():
            var = self._exchange_variables.setdefault(
                alias, ExchangeVariable())
            var.add_participant(variable.source, traj)
            entry.exchange_vars.append(alias)
        entry.status = AgentStatus.standby
        self.logger.info("registered agent %s", variable.source)

    # -- iteration-sync + results callbacks ------------------------------------

    def init_iteration_callback(self, variable: AgentVariable) -> None:
        if self.status != CoordinatorStatus.init_iterations:
            return
        if variable.value is not True:
            return
        entry = self.agent_dict.get(variable.source)
        if entry is None or entry.status != AgentStatus.standby:
            return
        entry.status = AgentStatus.ready
        self.received_variable.set()

    def optim_results_callback(self, variable: AgentVariable) -> None:
        entry = self.agent_dict.get(variable.source)
        if entry is None:
            return
        result = AgentToCoordinator.from_payload(variable.value)
        for alias, traj in result.local_trajectory.items():
            self._coupling_variables[alias].local_trajectories[
                variable.source] = np.asarray(traj, dtype=float)
        for alias, traj in result.local_exchange_trajectory.items():
            self._exchange_variables[alias].local_trajectories[
                variable.source] = np.asarray(traj, dtype=float)
        entry.status = AgentStatus.ready
        entry.missed_rounds = 0
        self.received_variable.set()

    # -- the round -------------------------------------------------------------

    def _agents_with_status(self, status: AgentStatus) -> List[Source]:
        return [s for s, a in self.agent_dict.items() if a.status == status]

    @property
    def all_finished(self) -> bool:
        return not any(a.status is AgentStatus.busy
                       for a in self.agent_dict.values())

    def trigger_optimizations(self) -> None:
        """Send each ready agent its means/multipliers/ρ and mark it busy
        (reference ``admm_coordinator.py:481-526``)."""
        for source, entry in self.agent_dict.items():
            if entry.status != AgentStatus.ready:
                continue
            means, muls = {}, {}
            for alias in entry.coup_vars:
                var = self._coupling_variables[alias]
                means[alias] = list(var.mean_trajectory)
                muls[alias] = list(var.multipliers[source])
            diffs, ex_muls = {}, {}
            for alias in entry.exchange_vars:
                var = self._exchange_variables[alias]
                diffs[alias] = list(var.diff_trajectories.get(
                    source, np.zeros_like(var.multiplier)))
                ex_muls[alias] = list(var.multiplier)
            entry.status = AgentStatus.busy
            msg = CoordinatorToAgent(
                target=source.agent_id, mean_trajectory=means,
                multiplier=muls, mean_diff_trajectory=diffs,
                exchange_multiplier=ex_muls,
                penalty_parameter=self.penalty_parameter)
            self._broadcast(OPTIMIZATION_C2A, msg.to_payload())

    def _update_mean_coupling_variables(self) -> None:
        active = self._agents_with_status(AgentStatus.ready)
        for var in self._coupling_variables.values():
            var.update_mean(active)
        for var in self._exchange_variables.values():
            var.update_diffs(active)

    def _shift_coupling_variables(self) -> None:
        for var in self._coupling_variables.values():
            var.shift(self.prediction_horizon)
        for var in self._exchange_variables.values():
            var.shift(self.prediction_horizon)

    def _update_multipliers(self) -> None:
        active = self._agents_with_status(AgentStatus.ready)
        for var in self._coupling_variables.values():
            var.update_multipliers(self.penalty_parameter, active)
        for var in self._exchange_variables.values():
            var.update_multiplier(self.penalty_parameter)

    def _check_convergence(self, iteration: int) -> bool:
        """Boyd relative-tolerance convergence + adaptive penalty + stats
        tracking (reference ``admm_coordinator.py:354-435``; jit twin:
        ``ops/admm.converged``)."""
        active = self._agents_with_status(AgentStatus.ready)
        prim, dual = [], []
        flat_locals, flat_means, flat_muls = [], [], []
        for var in self._coupling_variables.values():
            if var.mean_trajectory is None:
                continue  # registered mid-round, not yet in the consensus
            p, d = var.residuals(self.penalty_parameter, active)
            prim.extend(p)
            dual.extend(d)
            flat_locals.extend(var.flat_locals(active))
            flat_muls.extend(var.flat_multipliers(active))
            flat_means.extend(var.mean_trajectory)
        for var in self._exchange_variables.values():
            p, d = var.residuals(self.penalty_parameter, active)
            prim.extend(p)
            dual.extend(d)
            flat_locals.extend(var.flat_locals(active))
            if var.multiplier is not None:
                flat_muls.extend(var.multiplier)
            if var.mean_trajectory is not None:
                flat_means.extend(var.mean_trajectory)

        prim_norm = float(np.linalg.norm(prim))
        dual_norm = float(np.linalg.norm(dual))
        self._vary_penalty(prim_norm, dual_norm)
        record_residuals(prim_norm, dual_norm, iteration=iteration,
                         agent=self.agent.id)
        # new round: drop the stale tail of the previous (longer) round so
        # the per-iteration gauges always describe ONE round
        prev = getattr(self, "_recorded_admm_iters", 0)
        if iteration == 0 and prev > 1:
            trim_residuals(1, prev, agent=self.agent.id)
            prev = 1
        self._recorded_admm_iters = max(prev, iteration + 1)
        self._stats_rows.append({
            "time": self._round_start,
            "iteration": iteration,
            "primal_residual": prim_norm,
            "dual_residual": dual_norm,
            "penalty_parameter": self.penalty_parameter,
            "wall_time": _time.perf_counter() - self._perf_counter,
        })

        if self.use_relative_tolerances:
            primal_scaling = max(np.linalg.norm(flat_locals),
                                 np.linalg.norm(flat_means))
            dual_scaling = np.linalg.norm(flat_muls)
            sqrt_p = math.sqrt(max(len(flat_muls), 1))
            sqrt_n = math.sqrt(max(len(flat_locals), 1))
            eps_pri = sqrt_p * self.abs_tol + self.rel_tol * primal_scaling
            eps_dual = sqrt_n * self.abs_tol + self.rel_tol * dual_scaling
            return prim_norm < eps_pri and dual_norm < eps_dual
        return prim_norm < self.primal_tol and dual_norm < self.dual_tol

    def _vary_penalty(self, prim: float, dual: float) -> None:
        """Residual balancing (reference ``admm_coordinator.py:467-479``;
        jit twin ``ops/admm.vary_penalty``)."""
        mu = self.penalty_change_threshold
        if mu <= 1:
            return
        if prim > mu * dual:
            self.penalty_parameter *= self.penalty_change_factor
        elif dual > mu * prim:
            self.penalty_parameter /= self.penalty_change_factor

    def _wrap_up_algorithm(self) -> None:
        for source in self._agents_with_status(AgentStatus.ready):
            self.agent_dict[source].status = AgentStatus.standby
        self.penalty_parameter = self.penalty_factor

    # -- processes -------------------------------------------------------------

    def process(self):
        if self.env.rt:
            yield from self._realtime_process()
        else:
            yield from self._fast_process()

    def _fast_process(self):
        """Fast-simulation driver: broker delivery is synchronous, so every
        send below has already triggered all participant callbacks when it
        returns (reference ``_fast_process``,
        ``admm_coordinator.py:259-321``)."""
        yield 1e-3
        while True:
            self.status = CoordinatorStatus.init_iterations
            self._round_start = self.env.now
            self._perf_counter = _time.perf_counter()
            self._broadcast(START_ITERATION_C2A, True)
            yield 1e-3
            if not self._agents_with_status(AgentStatus.ready):
                self.logger.info("no agents available at %s", self.env.now)
                spent = self.env.now - self._round_start
                yield self.sampling_time - spent
                continue
            self._update_mean_coupling_variables()
            self._shift_coupling_variables()
            converged = False
            for admm_iter in range(1, self.admm_iter_max + 1):
                self.status = CoordinatorStatus.optimization
                self.trigger_optimizations()
                yield 1e-3
                self._wait_for_ready(block=False)
                self.status = CoordinatorStatus.updating
                self._update_mean_coupling_variables()
                self._update_multipliers()
                if self._check_convergence(admm_iter):
                    self.logger.info("converged in %s iterations", admm_iter)
                    converged = True
                    break
            if not converged:
                self.logger.warning("no convergence within %s iterations",
                                    self.admm_iter_max)
            self._wrap_up_algorithm()
            self._broadcast(START_ITERATION_C2A, False)
            self.status = CoordinatorStatus.sleeping
            spent = self.env.now - self._round_start
            yield max(self.sampling_time - spent, 1e-3)

    def _realtime_process(self):
        """Wall-clock driver: the round runs in a daemon thread so the env
        loop stays responsive (reference ``_realtime_process``,
        ``admm_coordinator.py:161-251``)."""
        self._start_algorithm = threading.Event()
        self._thread = threading.Thread(
            target=self._realtime_thread, daemon=True,
            name=f"admm_coordinator_{self.agent.id}")
        self._thread.start()
        while True:
            self._start_algorithm.set()
            yield self.sampling_time

    def _realtime_thread(self) -> None:
        while not self._stop.is_set():
            if not self._start_algorithm.wait(timeout=0.2):
                continue
            self._start_algorithm.clear()
            if self._stop.is_set():
                break
            with self._registration_lock:
                try:
                    self._realtime_step()
                    self.rounds_run += 1
                except Exception:  # noqa: BLE001 - counted and logged
                    if not self._stop.is_set():
                        self.failed_rounds += 1
                        self.logger.exception("coordinator round failed")

    def terminate(self) -> None:
        """Join the realtime worker thread for a clean interpreter exit."""
        wake = [self.received_variable]    # unblock a wait on agents
        if getattr(self, "_start_algorithm", None) is not None:
            wake.append(self._start_algorithm)
        self._thread = self._join_worker(
            self._thread, wake_events=tuple(wake), timeout=10.0)

    def _realtime_step(self) -> None:
        self.status = CoordinatorStatus.init_iterations
        self._round_start = self.env.now
        self._perf_counter = _time.perf_counter()
        self._broadcast(START_ITERATION_C2A, True)
        _time.sleep(self.wait_time_on_start_iters)
        if not self._agents_with_status(AgentStatus.ready):
            self.logger.info("no agents available at %s", self.env.now)
            return
        self._update_mean_coupling_variables()
        self._shift_coupling_variables()
        converged = False
        for admm_iter in range(1, self.admm_iter_max + 1):
            if self._stop.is_set():
                return     # MAS shutdown mid-round
            self.status = CoordinatorStatus.optimization
            self.trigger_optimizations()
            self._wait_for_ready(block=True)
            self.status = CoordinatorStatus.updating
            self._update_mean_coupling_variables()
            self._update_multipliers()
            if self._check_convergence(admm_iter):
                self.logger.info("converged in %s iterations", admm_iter)
                converged = True
                break
        if not converged:
            self.logger.warning("no convergence within %s iterations",
                                self.admm_iter_max)
        self._wrap_up_algorithm()
        self._broadcast(START_ITERATION_C2A, False)
        self.status = CoordinatorStatus.sleeping

    def _wait_for_ready(self, block: bool) -> None:
        """Wait for all busy agents; de-register non-responders
        (reference ``coordinator.py:232-265``)."""
        self.received_variable.clear()
        while not self.all_finished:
            if self._stop.is_set():
                return     # MAS shutdown: abandon the wait
            if not block:
                # synchronous delivery: busy agents at this point failed
                self._deregister_slow()
                break
            if self.received_variable.wait(
                    timeout=self.time_out_non_responders):
                self.received_variable.clear()
            else:
                self._deregister_slow()
                break

    def _deregister_slow(self) -> None:
        """Drop non-responders from THIS round only: the participant goes
        back to standby, so the next round's start-iteration sync
        re-admits it (a transient stall — GC pause, one slow solve, a
        dropped message — must not exile an agent forever). Every drop
        counts into ``coordinator_deregistrations_total{agent=...}``; the
        WARNING is rate-limited to one per agent (the counter carries the
        rate, the log carries the news)."""
        for entry in self.agent_dict.values():
            if entry.status is AgentStatus.busy:
                entry.status = AgentStatus.standby
                entry.missed_rounds += 1
                agent_id = entry.source.agent_id or str(entry.source)
                if telemetry.enabled():
                    telemetry.counter(
                        "coordinator_deregistrations_total",
                        "participants de-registered from an ADMM round "
                        "for not responding in time").inc(agent=agent_id)
                if entry.source not in self._dereg_warned:
                    self._dereg_warned.add(entry.source)
                    self.logger.warning(
                        "de-registered slow agent %s from this round "
                        "(re-admitted next round; warned once per agent — "
                        "rate lives in coordinator_deregistrations_total)",
                        entry.source)
                else:
                    self.logger.debug(
                        "de-registered slow agent %s (%d rounds missed)",
                        entry.source, entry.missed_rounds)

    # -- results ---------------------------------------------------------------

    def results(self):
        """(time, iteration)-indexed residual/penalty/wall-time stats —
        the reference's ``admm_stats.csv`` layout
        (``admm_coordinator.py:437-465``)."""
        import pandas as pd

        if not self._stats_rows:
            return None
        df = pd.DataFrame(self._stats_rows)
        return df.set_index(["time", "iteration"])

    def cleanup_results(self) -> None:
        self._stats_rows.clear()


@register_module("admm_coordinated")
class CoordinatedADMM(ADMMModule):
    """ADMM participant guided by a coordinator: registers, receives global
    parameters, solves on callback, replies trajectories
    (reference ``admm_coordinated.py`` + ``employee.py``)."""

    def __init__(self, config: dict, agent):
        self.coordinator = config.get("coordinator")
        self.registration_interval = float(
            config.get("registration_interval", 10.0))
        self._registered_coordinator: Optional[Source] = None
        self._result: Optional[dict] = None
        self._result_obtained = False
        self._opt_inputs: dict = {}
        self._start_optimization_at = 0.0
        super().__init__(config, agent)

    # employees do not need peer registration windows
    def register_callbacks(self) -> None:
        super().register_callbacks()
        src = Source.coerce(self.coordinator) if self.coordinator else None
        broker = self.agent.data_broker
        broker.register_callback(REGISTRATION_C2A, src,
                                 self.registration_callback)
        broker.register_callback(START_ITERATION_C2A, src,
                                 self.init_iteration_callback)
        broker.register_callback(OPTIMIZATION_C2A, src, self.optimize)

    def _broadcast(self, alias: str, value) -> None:
        self.send(AgentVariable(name=alias, alias=alias, value=value,
                                shared=True))

    def process(self):
        while True:
            if self._registered_coordinator is None:
                self._broadcast(REGISTRATION_A2C,
                                self._initial_guesses().to_payload())
            yield self.registration_interval

    # -- registration ----------------------------------------------------------

    def _initial_guesses(self) -> AgentToCoordinator:
        n = len(self.backend.coupling_grid)
        guesses, ex_guesses = {}, {}
        for entry in self.couplings:
            var = self.vars[entry.name]
            init = float(var.value if var.value is not None else 0.0)
            guesses[var.alias] = [init] * n
        for entry in self.exchange:
            var = self.vars[entry.name]
            init = float(var.value if var.value is not None else 0.0)
            ex_guesses[var.alias] = [init] * n
        return AgentToCoordinator(local_trajectory=guesses,
                                  local_exchange_trajectory=ex_guesses)

    def registration_callback(self, variable: AgentVariable) -> None:
        """Receive global ADMM parameters; re-init the backend if they
        differ; reply with initial coupling guesses
        (reference ``admm_coordinated.py:67-103,205-223``)."""
        if self._registered_coordinator is not None:
            return
        value = variable.value or {}
        if value.get("agent_id") != self.agent.id:
            return
        opts = value.get("opts", {})
        new_ts = float(opts.get("time_step", self.time_step))
        new_n = int(opts.get("prediction_horizon", self.prediction_horizon))
        self.penalty_factor = float(
            opts.get("penalty_factor", self.penalty_factor))
        if (new_ts, new_n) != (self.time_step, self.prediction_horizon):
            self.time_step, self.prediction_horizon = new_ts, new_n
            self._setup_backend()
        self._registered_coordinator = variable.source
        self._broadcast(REGISTRATION_A2C, self._initial_guesses().to_payload())

    # -- iteration protocol ----------------------------------------------------

    def init_iteration_callback(self, variable: AgentVariable) -> None:
        """Start-of-round sync: collect a fresh measurement and confirm;
        False signals the round finished → actuate
        (reference ``employee.py:93-124``)."""
        if variable.value:
            self._start_optimization_at = self.env.now
            self._opt_inputs = self.collect_variables_for_optimization()
            self._iter_in_step = 0
            self._broadcast(START_ITERATION_A2C, True)
        else:
            if self._result_obtained and self._result is not None:
                decision = self.guarded_actuation(self._result)
                if decision.action == "actuate":
                    self._record(self._result)
            self._result = None
            self._result_obtained = False

    def optimize(self, variable: AgentVariable) -> None:
        """One local solve from a coordinator trigger; reply trajectories
        (reference ``admm_coordinated.py:133-193``)."""
        msg = CoordinatorToAgent.from_payload(variable.value)
        if msg.target != self.agent.id:
            return
        opt_inputs = dict(self._opt_inputs)
        for entry in self.couplings:
            alias = self.vars[entry.name].alias
            if alias in msg.multiplier:
                opt_inputs[entry.multiplier] = np.asarray(
                    msg.multiplier[alias], dtype=float)
                opt_inputs[entry.mean] = np.asarray(
                    msg.mean_trajectory[alias], dtype=float)
        for entry in self.exchange:
            alias = self.vars[entry.name].alias
            if alias in msg.exchange_multiplier:
                opt_inputs[entry.multiplier] = np.asarray(
                    msg.exchange_multiplier[alias], dtype=float)
                opt_inputs[entry.mean_diff] = np.asarray(
                    msg.mean_diff_trajectory[alias], dtype=float)
        opt_inputs["penalty_factor"] = float(msg.penalty_parameter)
        opt_inputs["admm_iteration"] = getattr(self, "_iter_in_step", 0)
        self._result = self.backend.solve(
            self._start_optimization_at, opt_inputs)
        self._iter_in_step = getattr(self, "_iter_in_step", 0) + 1
        self._result_obtained = True
        self._record_iteration(self._result, len(self._iter_rows))

        reply = AgentToCoordinator()
        for entry in self.couplings:
            alias = self.vars[entry.name].alias
            reply.local_trajectory[alias] = [
                float(v) for v in self._result["couplings"][entry.name]]
        for entry in self.exchange:
            alias = self.vars[entry.name].alias
            reply.local_exchange_trajectory[alias] = [
                float(v) for v in self._result["couplings"][entry.name]]
        self._broadcast(OPTIMIZATION_A2C, reply.to_payload())
