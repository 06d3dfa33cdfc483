"""Per-tenant SLO and error-budget accounting for the serving plane.

Port of ``agentlib_mpc_tpu/telemetry/slo.py``. Each tenant carries two
objectives, availability (actuated over delivered results) and deadline
adherence, tracked cumulatively and over sliding round windows, with
multi-window error-budget burn rates (burn 1.0 consumes exactly the
budget the target allows; above 1 the objective is violated if it
lasts).

The tracker is fed only by the per-round results the serving plane
produces (its guard verdicts and shed decisions), so the whole report can
be recomputed offline from the journal's ``serve.round`` events
(:func:`slo_from_events`): the live report and the offline one agree.

A delivered result is available only when the guard actuated the fresh
solve (``action == "actuate"``); replay, hold and fallback rounds and
every shed (overload, deadline, eviction, poisoned theta) are delivered
but unavailable.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable



@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Objectives and windows (plane config key ``slo_policy``)."""

    #: target fraction of delivered results that actuate a fresh solve
    availability_target: float = 0.99
    #: target fraction of submissions that meet their deadline
    deadline_target: float = 0.99
    #: sliding windows, in served rounds (fast, slow) — burn rates are
    #: reported per window
    windows: tuple = (8, 32)

    def __post_init__(self):
        for t in (self.availability_target, self.deadline_target):
            if not (0.0 < t < 1.0):
                raise ValueError(f"SLO targets must sit in (0, 1), "
                                 f"got {t}")
        if not self.windows or any(int(w) < 1 for w in self.windows):
            raise ValueError(f"windows must be >= 1 round each, "
                             f"got {self.windows}")

    @classmethod
    def from_config(cls, cfg: dict) -> "SLOPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(f"unknown slo option(s) {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        if "windows" in cfg:
            cfg = dict(cfg, windows=tuple(int(w)
                                          for w in cfg["windows"]))
        return cls(**cfg)


class _TenantLedger:
    """One tenant's tallies: cumulative + a per-round ring of
    (delivered, actuated, deadline_missed) triples."""

    __slots__ = ("delivered", "actuated", "deadline_missed",
                 "cur", "recent")

    def __init__(self, max_window: int):
        self.delivered = 0
        self.actuated = 0
        self.deadline_missed = 0
        self.cur = [0, 0, 0]
        self.recent = deque(maxlen=max_window)


class SLOTracker:
    """Accumulates per-tenant verdicts and renders the SLO report.

    Wire-up (the plane does all of this): ``record_result`` per
    delivered result or shed decision, ``tick_round`` once per served
    round (returns that round's tally — what the plane journals as the
    ``serve.round`` event, making the report offline-recomputable).
    """

    def __init__(self, policy: SLOPolicy = SLOPolicy()):
        self.policy = policy
        self._max_window = max(int(w) for w in policy.windows)
        self._rows: dict = {}
        #: tenants that left: tenant_id -> rounds of tombstone left.
        #: ``forget`` no longer drops the ledger — a tenant that
        #: leaves and rejoins inside ``max_window`` rounds resumes its
        #: burn windows where it left them (a flapping tenant cannot
        #: launder its burn by churning membership); after
        #: ``max_window`` tombstoned rounds the windows have fully
        #: aged out and the row really goes
        self._tombstones: dict = {}
        self.rounds = 0
        #: the caller's round clock at the last tick (drift check
        #: against the journal's serve.round stamps)
        self.last_round_index: "int | None" = None

    def _row(self, tenant_id: str) -> _TenantLedger:
        # any access revives a tombstoned row: the rejoining tenant
        # resumes its windows (the whole point of the tombstone)
        self._tombstones.pop(tenant_id, None)
        row = self._rows.get(tenant_id)
        if row is None:
            row = self._rows[tenant_id] = _TenantLedger(self._max_window)
        return row

    # -- feed -----------------------------------------------------------------

    def record_result(self, tenant_id: str, action: str,
                      deadline_missed: bool = False) -> None:
        """One delivered verdict: a guard action (actuate / replay /
        hold / fallback) from a served result OR a shed decision."""
        row = self._row(tenant_id)
        ok = action == "actuate"
        row.delivered += 1
        row.actuated += int(ok)
        row.deadline_missed += int(bool(deadline_missed))
        row.cur[0] += 1
        row.cur[1] += int(ok)
        row.cur[2] += int(bool(deadline_missed))

    def forget(self, tenant_id: str) -> None:
        """Tombstone a departed tenant's ledger for ``max_window``
        rounds instead of dropping it: the row keeps aging through
        the sliding windows (and keeps counting in the fleet roll-up —
        budgets are an accounting record) but leaves the per-tenant
        report; a rejoin inside the window resumes the burn exactly
        where it stood. Dropping immediately let a flapping tenant
        restart its windows from zero each rejoin — burn laundering."""
        if tenant_id in self._rows:
            self._tombstones[tenant_id] = self._max_window

    def tick_round(self, round_index: "int | None" = None) -> dict:
        """Close the current round: push each tenant's tally into the
        sliding windows and return ``{tenant: [delivered, actuated,
        deadline_missed]}`` — the journal payload. ``round_index`` is
        the caller's round clock, kept on ``last_round_index`` so a
        drift between the tracker and the journal's ``serve.round``
        stamps is observable. Exports the ``serving_slo_*`` gauges for
        the tenants with traffic this round (the others' numbers did
        not move — at 10k tenants a full re-export per round would be
        the serving loop's dominant host cost)."""
        self.rounds += 1
        if round_index is not None:
            self.last_round_index = int(round_index)
        tally = {}
        for tid, row in self._rows.items():
            if row.cur != [0, 0, 0]:
                tally[tid] = list(row.cur)
            row.recent.append(tuple(row.cur))
            row.cur = [0, 0, 0]
        # tombstoned rows age like every other idle tenant above; once
        # the windows have fully cycled the ledger really goes
        for tid in list(self._tombstones):
            self._tombstones[tid] -= 1
            if self._tombstones[tid] <= 0:
                del self._tombstones[tid]
                self._rows.pop(tid, None)
        self._export_gauges(tally.keys())
        return tally

    # -- report ---------------------------------------------------------------

    @staticmethod
    def _rate(num: int, den: int) -> "float | None":
        return None if den <= 0 else num / den

    def _window_stats(self, row: _TenantLedger, window: int) -> dict:
        recent = list(row.recent)[-int(window):]
        delivered = sum(r[0] for r in recent)
        actuated = sum(r[1] for r in recent)
        avail = self._rate(actuated, delivered)
        # burn rate: observed miss fraction over the window, in units of
        # the budgeted miss fraction (1 - target); 1.0 = burning exactly
        # the allowed budget, >1 = violating if sustained
        budget = 1.0 - self.policy.availability_target
        burn = None if avail is None else (1.0 - avail) / budget
        return {
            "delivered": delivered,
            "availability_pct": (None if avail is None
                                 else round(100.0 * avail, 3)),
            "burn_rate": None if burn is None else round(burn, 3),
        }

    def burn_rates(self) -> dict:
        """Per-tenant windowed burn rates, ``{tenant: {window: burn}}``
        (``None`` for windows with no delivered traffic), public so
        policy code never reaches into the ledger rows."""
        return {
            tid: {int(w): self._window_stats(row, w)["burn_rate"]
                  for w in self.policy.windows}
            for tid, row in self._rows.items()}

    def _tenant_report(self, row: _TenantLedger) -> dict:
        avail = self._rate(row.actuated, row.delivered)
        deadline_hit = self._rate(row.delivered - row.deadline_missed,
                                  row.delivered)
        # error budget: the miss allowance the availability target
        # grants over everything delivered so far; remaining < 0 means
        # the objective is already violated for this horizon
        allowed = (1.0 - self.policy.availability_target) * row.delivered
        consumed = row.delivered - row.actuated
        remaining = None if row.delivered == 0 else \
            1.0 - (consumed / allowed if allowed > 0 else float(consumed))
        return {
            "delivered": row.delivered,
            "actuated": row.actuated,
            "availability_pct": (None if avail is None
                                 else round(100.0 * avail, 3)),
            "deadline_hit_pct": (None if deadline_hit is None
                                 else round(100.0 * deadline_hit, 3)),
            "error_budget_remaining": (None if remaining is None
                                       else round(remaining, 4)),
            "slo_met": (None if avail is None else
                        avail >= self.policy.availability_target),
            "windows": {str(w): self._window_stats(row, w)
                        for w in self.policy.windows},
        }

    def report(self) -> dict:
        """The full SLO report: per-tenant objectives + a fleet roll-up
        (what ``ServingPlane.slo_report()`` returns)."""
        # tombstoned (departed) tenants leave the per-tenant section
        # but keep counting in the fleet sums: the roll-up is an
        # accounting record, not a membership list
        tenants = {tid: self._tenant_report(row)
                   for tid, row in sorted(self._rows.items())
                   if tid not in self._tombstones}
        delivered = sum(r.delivered for r in self._rows.values())
        actuated = sum(r.actuated for r in self._rows.values())
        missed = sum(r.deadline_missed for r in self._rows.values())
        avail = self._rate(actuated, delivered)
        return {
            "policy": {
                "availability_target": self.policy.availability_target,
                "deadline_target": self.policy.deadline_target,
                "windows": list(self.policy.windows),
            },
            "rounds": self.rounds,
            "fleet": {
                "delivered": delivered,
                "actuated": actuated,
                "availability_pct": (None if avail is None
                                     else round(100.0 * avail, 3)),
                "deadline_missed": missed,
                "tenants_in_violation": sum(
                    1 for t in tenants.values()
                    if t["slo_met"] is False),
            },
            "tenants": tenants,
        }

    def _export_gauges(self, tenant_ids=None) -> None:
        from agentlib_mpc_torch import telemetry

        if not telemetry.enabled():
            return
        reg = telemetry.metrics()
        avail_g = reg.gauge(
            "serving_slo_availability_pct",
            "per-tenant cumulative availability (actuated / delivered)")
        budget_g = reg.gauge(
            "serving_slo_error_budget_remaining",
            "fraction of the tenant's availability error budget left "
            "(1 = untouched, <= 0 = objective violated)")
        burn_g = reg.gauge(
            "serving_slo_burn_rate",
            "windowed error-budget burn rate (1 = exactly the budgeted "
            "miss rate)")
        ids = (self._rows.keys() if tenant_ids is None
               else tenant_ids)
        for tid in ids:
            row = self._rows.get(tid)
            if row is None:
                continue
            rep = self._tenant_report(row)
            if rep["availability_pct"] is not None:
                avail_g.set(rep["availability_pct"], tenant=tid)
            if rep["error_budget_remaining"] is not None:
                budget_g.set(rep["error_budget_remaining"], tenant=tid)
            for w, ws in rep["windows"].items():
                if ws["burn_rate"] is not None:
                    burn_g.set(ws["burn_rate"], tenant=tid, window=w)

    # -- checkpoint seam ------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able state for the plane checkpoint (crash/restart must
        not reset error budgets — a restore that forgot the burn would
        report a fresh 100% budget mid-incident)."""
        return {
            "rounds": int(self.rounds),
            "tenants": {
                tid: {"delivered": row.delivered,
                      "actuated": row.actuated,
                      "deadline_missed": row.deadline_missed,
                      "recent": [list(r) for r in row.recent]}
                for tid, row in self._rows.items()},
            "tombstones": {tid: int(n)
                           for tid, n in self._tombstones.items()},
        }

    def restore(self, snap: "dict | None") -> None:
        if not snap:
            return
        self.rounds = int(snap.get("rounds") or 0)
        for tid, s in (snap.get("tenants") or {}).items():
            row = self._row(tid)
            row.delivered = int(s.get("delivered") or 0)
            row.actuated = int(s.get("actuated") or 0)
            row.deadline_missed = int(s.get("deadline_missed") or 0)
            row.recent.clear()
            for r in s.get("recent") or []:
                row.recent.append(tuple(int(x) for x in r))
        for tid, n in (snap.get("tombstones") or {}).items():
            if tid in self._rows:
                self._tombstones[tid] = int(n)


def slo_from_events(events: Iterable,
                    policy: "SLOPolicy | None" = None) -> dict:
    """Recompute the SLO report offline from journal ``serve.round``
    events (each carries the round's ``{tenant: [delivered, actuated,
    deadline_missed]}`` tally) — byte-for-byte the same report shape as
    :meth:`SLOTracker.report`, from the flight recorder alone.

    ``policy=None`` reads the plane's OWN policy from the journal's
    ``slo.policy`` event (the plane journals it once per process, so an
    auditor with only the tape recomputes against the same targets and
    windows the live report used); an explicit policy overrides, and
    the default applies only to a tape that predates policy stamping."""
    events = list(events)
    if policy is None:
        stamped = [e for e in events if e.get("etype") == "slo.policy"]
        if stamped:
            last = stamped[-1]
            policy = SLOPolicy(
                availability_target=float(
                    last.get("availability_target", 0.99)),
                deadline_target=float(
                    last.get("deadline_target", 0.99)),
                windows=tuple(int(w)
                              for w in last.get("windows") or (8, 32)))
        else:
            policy = SLOPolicy()
    tracker = SLOTracker(policy)
    for ev in events:
        if ev.get("etype") != "serve.round":
            continue
        tally = ev.get("tally") or {}
        for tid, counts in tally.items():
            d, a, m = (int(x) for x in counts)
            row = tracker._row(tid)
            row.delivered += d
            row.actuated += a
            row.deadline_missed += m
            row.recent.append((d, a, m))
        # idle-but-known tenants age through the sliding windows
        # exactly like the online tracker's tick_round
        for tid, row in tracker._rows.items():
            if tid not in tally:
                row.recent.append((0, 0, 0))
        tracker.rounds += 1
    return tracker.report()
