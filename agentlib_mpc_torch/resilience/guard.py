"""Guarded actuation: solve health checks and the degradation cascade.

Port of ``agentlib_mpc_tpu/resilience/guard.py``; the port keeps its own copy
and imports nothing of the JAX package.

The reference's failure handling stops at a log line
(``modules/mpc/mpc.py:389-404``): a failed IPOPT solve still actuates
``u[0]`` of whatever trajectory came back. Here every solve result
passes :func:`check_result` (solver success, finite trajectories,
control bounds) and an unhealthy result walks a configurable ladder
instead of reaching the plant:

1. **replay** — re-actuate the next step of the last *accepted* plan
   (the MPC already optimized those moves; shifting through them is the
   best available open-loop action),
2. **hold** — hold the last actuated control once the stored plan is
   exhausted,
3. **fallback** — flip the ``mpc_active`` flag so
   :class:`~agentlib_mpc_torch.modules.pid.FallbackPID` takes over, while
   the MPC keeps solving in *probe* mode (nothing actuated) so recovery
   can be observed.

Re-engagement is hysteretic: ``recovery_steps`` consecutive healthy
probe solves are required before the flag flips back — one lucky solve
mid-outage must not bounce the plant between controllers.

The cascade state is exported to telemetry: a
``mpc_degradation_level{agent,module}`` gauge (0 = MPC, 1 = replay,
2 = hold, 3 = fallback) plus ``mpc_unhealthy_solves_total{reason=...}``,
``mpc_degraded_actuations_total{action=...}``,
``mpc_fallback_engagements_total`` and ``mpc_recoveries_total``
counters. See ``docs/robustness.md``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, NamedTuple, Optional

import numpy as np

from agentlib_mpc_torch import telemetry

logger = logging.getLogger(__name__)

#: degradation-ladder levels, exported as the gauge value
LEVEL_MPC = 0
LEVEL_REPLAY = 1
LEVEL_HOLD = 2
LEVEL_FALLBACK = 3

_LEVEL_NAMES = {LEVEL_MPC: "mpc", LEVEL_REPLAY: "replay",
                LEVEL_HOLD: "hold", LEVEL_FALLBACK: "fallback"}


def _finite(value) -> bool:
    try:
        return bool(np.all(np.isfinite(np.asarray(value, dtype=float))))
    except (TypeError, ValueError):
        return False


def check_result(result: dict, bounds: "dict | None" = None,
                 tol: float = 1e-6) -> tuple[bool, tuple[str, ...]]:
    """Health-check one backend solve result.

    Checks, in order of cheapness: the solver's own success flag
    (``result["stats"]["success"]``), finiteness of the first controls
    ``u0``, per-control bounds (``bounds``: name → (lb, ub), checked
    within ``tol``), and finiteness of every returned trajectory.
    Returns ``(healthy, reasons)`` where ``reasons`` names every failed
    check — the label set of ``mpc_unhealthy_solves_total``.
    """
    reasons: list[str] = []
    stats = result.get("stats") or {}
    success = stats.get("success", True) if isinstance(stats, dict) \
        else getattr(stats, "success", True)
    if not bool(success):
        reasons.append("solver_failure")
    u0 = result.get("u0") or {}
    for name, value in u0.items():
        if not _finite(value):
            reasons.append("nonfinite_control")
            break
    if bounds:
        for name, (lb, ub) in bounds.items():
            value = u0.get(name)
            if value is None or not _finite(value):
                continue  # finiteness already reported above
            lb = -math.inf if lb is None else float(lb)
            ub = math.inf if ub is None else float(ub)
            if not (lb - tol <= float(value) <= ub + tol):
                reasons.append("control_out_of_bounds")
                break
    for traj in (result.get("traj") or {}).values():
        if not _finite(traj):
            reasons.append("nonfinite_trajectory")
            break
    return (not reasons), tuple(reasons)


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Knobs of the cascade (module config key ``resilience``)."""

    #: consecutive unhealthy solves served from the stored plan before
    #: the ladder moves on (bounded by the plan's remaining horizon)
    replay_steps: int = 3
    #: held actuations after the replay budget, before fallback
    hold_steps: int = 2
    #: hard cap on consecutive unhealthy solves before the flag flips —
    #: the total degradation budget; None → replay_steps + hold_steps
    fallback_after: Optional[int] = None
    #: consecutive healthy probe solves before MPC re-engages (hysteresis)
    recovery_steps: int = 2
    #: bound-check slack for actuated controls
    bounds_tol: float = 1e-6

    @classmethod
    def from_config(cls, cfg: dict) -> "DegradationPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(
                f"unknown resilience option(s) {sorted(unknown)}; "
                f"known: {sorted(known)}")
        return cls(**cfg)

    @property
    def budget(self) -> int:
        """Consecutive unhealthy solves tolerated before fallback."""
        if self.fallback_after is not None:
            return int(self.fallback_after)
        return int(self.replay_steps) + int(self.hold_steps)


class GuardDecision(NamedTuple):
    """What the module should do with one assessed solve result."""

    action: str                        # actuate | replay | hold | fallback
    controls: "dict[str, float] | None"  # what to actuate (None: nothing)
    healthy: bool
    reasons: tuple[str, ...]
    #: this assessment crossed INTO fallback — flip the MPC flag off
    entered_fallback: bool = False
    #: recovery hysteresis satisfied — flip the MPC flag back on
    reengaged: bool = False


class ActuationGuard:
    """Per-module degradation state machine (one per BaseMPC instance)."""

    def __init__(self, policy: DegradationPolicy = DegradationPolicy(),
                 logger_: "logging.Logger | None" = None, **labels: str):
        self.policy = policy
        self.logger = logger_ or logger
        self.labels = {k: str(v) for k, v in labels.items()}
        self.level = LEVEL_MPC
        #: name hints for the stored-plan columns: the column names of
        #: ``result["traj"]["u"]`` and of ``result["binary_schedule"]``.
        #: The owning module sets them from the backend's
        #: ``trajectory_layout()`` / binary controls; when None, the u0
        #: key order is assumed (true for the non-MINLP backends).
        self.plan_columns: "list[str] | None" = None
        self.binary_plan_columns: "list[str] | None" = None
        self._plan: "dict[str, np.ndarray] | None" = None
        self._last_controls: "dict[str, float] | None" = None
        self._unhealthy_streak = 0
        self._healthy_streak = 0
        self._export_level()

    # -- telemetry ------------------------------------------------------------

    def _export_level(self) -> None:
        if telemetry.enabled():
            telemetry.gauge(
                "mpc_degradation_level",
                "guarded-actuation ladder position (0=mpc, 1=replay, "
                "2=hold, 3=fallback)").set(float(self.level), **self.labels)

    def _count(self, name: str, help_: str, **extra) -> None:
        if telemetry.enabled():
            telemetry.counter(name, help_).inc(**self.labels, **extra)

    # -- state queries --------------------------------------------------------

    @property
    def in_fallback(self) -> bool:
        return self.level == LEVEL_FALLBACK

    @property
    def degraded(self) -> bool:
        return self.level != LEVEL_MPC

    # -- the cascade ----------------------------------------------------------

    def assess(self, result: dict, bounds: "dict | None" = None,
               precheck: "tuple[bool, tuple] | None" = None
               ) -> GuardDecision:
        """Walk the ladder for one solve result. The caller actuates
        ``decision.controls`` (clipped to bounds), flips the MPC flag on
        ``entered_fallback`` / ``reengaged``, and records the result
        only when ``decision.healthy``. ``precheck`` merges a
        backend-level verdict (``OptimizationBackend.health_check`` —
        the hook subclasses override with backend-specific validity
        checks) into the assessment."""
        healthy, reasons = check_result(result, bounds,
                                        tol=self.policy.bounds_tol)
        if precheck is not None:
            pre_ok, pre_reasons = precheck
            healthy = healthy and bool(pre_ok)
            reasons = tuple(dict.fromkeys((*reasons, *pre_reasons)))
        level_before = self.level
        decision = self._healthy(result) if healthy \
            else self._unhealthy(reasons)
        self._export_level()
        if self.level != level_before:
            # ladder MOVES are journaled (not every assessment — the
            # steady state must not flood the flight recorder). Labels
            # are free-form caller data: merged with setdefault so a
            # label named "level"/"reasons" can neither collide (a
            # TypeError inside assess would crash the actuation path)
            # nor overwrite the transition fields.
            ev = {"level": _LEVEL_NAMES[self.level],
                  "level_from": _LEVEL_NAMES[level_before],
                  "reasons": list(decision.reasons)}
            for k, v in self.labels.items():
                if k not in ("etype", "seq", "t", "round"):
                    ev.setdefault(k, v)
            telemetry.journal_event("guard.transition", **ev)
        return decision

    def _healthy(self, result: dict) -> GuardDecision:
        self._unhealthy_streak = 0
        if self.level == LEVEL_FALLBACK:
            self._healthy_streak += 1
            if self._healthy_streak < self.policy.recovery_steps:
                # probing: healthy again, but hysteresis not yet met
                return GuardDecision("fallback", None, True, ())
            self.logger.info(
                "MPC re-engaging after %d consecutive healthy solves",
                self._healthy_streak)
            self._count("mpc_recoveries_total",
                        "MPC re-engagements after a fallback outage")
            self.level = LEVEL_MPC
            self._healthy_streak = 0
            self._store_plan(result)
            return GuardDecision("actuate", None, True, (), reengaged=True)
        if self.level != LEVEL_MPC:
            # replay/hold recover immediately: the plant never left MPC
            self.logger.info("solve healthy again; leaving %s degradation",
                             _LEVEL_NAMES[self.level])
        self.level = LEVEL_MPC
        self._healthy_streak = 0
        self._store_plan(result)
        return GuardDecision("actuate", None, True, ())

    def _unhealthy(self, reasons: tuple[str, ...]) -> GuardDecision:
        self._healthy_streak = 0
        self._unhealthy_streak += 1
        k = self._unhealthy_streak
        for reason in reasons:
            self._count("mpc_unhealthy_solves_total",
                        "solve results rejected by the actuation guard",
                        reason=reason)
        if self.level != LEVEL_FALLBACK and k <= self.policy.budget:
            if k <= self.policy.replay_steps:
                controls = self._replay_controls(k)
                if controls is not None:
                    self.level = LEVEL_REPLAY
                    self._count("mpc_degraded_actuations_total",
                                "degraded actuations served instead of a "
                                "rejected solve", action="replay")
                    self._last_controls = dict(controls)
                    return GuardDecision("replay", controls, False, reasons)
            if self._last_controls is not None:
                self.level = LEVEL_HOLD
                self._count("mpc_degraded_actuations_total",
                            "degraded actuations served instead of a "
                            "rejected solve", action="hold")
                return GuardDecision("hold", dict(self._last_controls),
                                     False, reasons)
        entered = self.level != LEVEL_FALLBACK
        if entered:
            self.logger.warning(
                "degradation budget exhausted after %d consecutive "
                "unhealthy solves (%s); handing over to the fallback "
                "controller", k, ", ".join(reasons))
            self._count("mpc_fallback_engagements_total",
                        "hand-overs to the fallback controller")
        self.level = LEVEL_FALLBACK
        return GuardDecision("fallback", None, False, reasons,
                             entered_fallback=entered)

    def external_override_hold(self) -> "dict[str, float] | None":
        """Mid-fallback, an external writer (e.g. MPCOnOff's periodic
        ``activate_mpc`` heartbeat) re-asserted the MPC flag True — which
        disengages the FallbackPID while this guard still refuses to
        actuate a rejected solve. Rather than fighting over the flag (it
        would flap at heartbeat cadence) or leaving the plant
        uncommanded, serve the last actuated control as a degraded hold.
        Returns None when nothing was ever actuated."""
        if self._last_controls is None:
            return None
        self._count("mpc_degraded_actuations_total",
                    "degraded actuations served instead of a rejected "
                    "solve", action="hold")
        return dict(self._last_controls)

    # -- checkpoint seam ------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able ladder state for durable checkpoints (the serving
        plane persists each tenant's guard so a crash/restart does not
        reset degradation budgets or the recovery hysteresis)."""
        return {
            "level": int(self.level),
            "unhealthy_streak": int(self._unhealthy_streak),
            "healthy_streak": int(self._healthy_streak),
            "last_controls": (None if self._last_controls is None
                              else dict(self._last_controls)),
            "plan": (None if self._plan is None
                     else {n: [float(x) for x in v]
                           for n, v in self._plan.items()}),
            "plan_columns": self.plan_columns,
            "binary_plan_columns": self.binary_plan_columns,
        }

    def restore(self, snap: dict) -> None:
        """Inverse of :meth:`snapshot` (tolerates missing keys so older
        checkpoints restore with defaults)."""
        snap = snap or {}
        self.level = int(snap.get("level", LEVEL_MPC))
        self._unhealthy_streak = int(snap.get("unhealthy_streak", 0))
        self._healthy_streak = int(snap.get("healthy_streak", 0))
        last = snap.get("last_controls")
        self._last_controls = None if last is None else \
            {n: float(v) for n, v in last.items()}
        plan = snap.get("plan")
        self._plan = None if not plan else \
            {n: np.asarray(v, dtype=float) for n, v in plan.items()}
        self.plan_columns = snap.get("plan_columns")
        self.binary_plan_columns = snap.get("binary_plan_columns")
        self._export_level()

    # -- plan memory ----------------------------------------------------------

    def _store_plan(self, result: dict) -> None:
        """Keep the accepted control plan for shift-and-replay, and the
        accepted first controls for hold-last. Columns map by NAME via
        ``plan_columns`` / ``binary_plan_columns``; a control with no
        trajectory column (e.g. a coupling-only alias) simply has no
        replay data — replay then serves the names it has, and the plant
        holds the rest implicitly."""
        u0 = result.get("u0") or {}
        self._last_controls = {n: float(v) for n, v in u0.items()}
        plan: dict[str, np.ndarray] = {}
        traj = (result.get("traj") or {}).get("u")
        if traj is not None:
            traj = np.asarray(traj, dtype=float)
            names = self.plan_columns if self.plan_columns is not None \
                else list(u0)
            if traj.ndim == 2:
                for i, n in enumerate(names):
                    if n in u0 and i < traj.shape[1]:
                        plan[n] = traj[:, i]
        # MINLP: binaries ride in the top-level binary_schedule, not in
        # traj["u"] — without this the replay rung could never engage
        # for the backend family whose scheduled moves matter most
        sched = result.get("binary_schedule")
        if sched is not None and self.binary_plan_columns:
            sched = np.asarray(sched, dtype=float)
            if sched.ndim == 2:
                for i, n in enumerate(self.binary_plan_columns):
                    if n in u0 and i < sched.shape[1]:
                        plan[n] = sched[:, i]
        self._plan = plan or None

    def _replay_controls(self, k: int) -> "dict[str, float] | None":
        """Step ``k`` of the stored plan (failure #1 replays plan row 1 —
        row 0 was already actuated when the plan was accepted)."""
        if not self._plan:
            return None
        depth = min(len(v) for v in self._plan.values())
        if k >= depth:
            return None          # plan exhausted → ladder moves to hold
        return {n: float(v[k]) for n, v in self._plan.items()}
