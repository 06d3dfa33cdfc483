"""Per-tenant health ledger: the quarantine → probation → evict ladder.

Port of ``agentlib_mpc_tpu/serving/health.py``.

The fused engine's quarantine keeps a NaN-ing lane from poisoning its bucket's consensus math — but it keeps
the lane *occupied*: the substituted iterate comes back finite, the guard
sees a healthy solve, and a persistently sick tenant occupies its slot
(and degrades its bucket's batch) forever. The ledger closes that gap.

Inputs, per served round and tenant (fed by
``ServingPlane._assess_bucket``):

* the guard verdict (``healthy`` + reasons) — catches NaN/failed/
  out-of-bounds results that reach the decode,
* ``stats.quarantined_iters`` — the per-lane
  :class:`~agentlib_mpc_torch.parallel.fused_admm.IterationStats`
  attribution; a lane quarantined through the WHOLE round is sick even
  though its decoded trajectory is finite (the substitution did the
  work). This is the signal the guard alone cannot see.

The ladder (all thresholds on :class:`HealthPolicy`):

1. **healthy** — the steady state; any healthy round resets the strike
   count.
2. **quarantined** — ``quarantine_after`` consecutive sick rounds. An
   observability state: the tenant still serves (the engine-level
   quarantine is already containing it), but it is flagged
   (``serving_health_state`` gauge) and one more ladder rung from
   eviction.
3. **evicted** — ``evict_after`` consecutive sick rounds. The plane
   masks the tenant's lane out (slot freed, spec and guard retained);
   its submissions shed straight into its ``ActuationGuard``
   ladder (replay → hold → fallback), so the tenant's plant is
   commanded by its degradation policy while the bucket's batch is
   clean again.
4. **probation** — after ``readmit_after`` evicted rounds the plane
   re-admits the tenant (fresh warm start into a free slot: a splice,
   no engine built). ``probation_rounds`` consecutive
   healthy rounds promote it back to healthy; ONE sick round during
   probation re-evicts immediately (hysteresis: a tenant must prove
   itself, one lucky round must not bounce it back into the batch).

Everything is counted: ``serving_health_state{tenant=}`` gauge
(0=healthy, 1=quarantined, 2=probation, 3=evicted),
``serving_evictions_total{bucket=}``,
``serving_readmissions_total{bucket=}``.
"""

from __future__ import annotations

import dataclasses
import logging

from agentlib_mpc_torch import telemetry

logger = logging.getLogger(__name__)

#: ledger states, exported as the gauge value
HEALTHY = "healthy"
QUARANTINED = "quarantined"
PROBATION = "probation"
EVICTED = "evicted"

_STATE_LEVEL = {HEALTHY: 0, QUARANTINED: 1, PROBATION: 2, EVICTED: 3}


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Knobs of the tenant-health ladder (plane config key
    ``health_policy``)."""

    #: consecutive sick rounds before a tenant is flagged quarantined
    quarantine_after: int = 2
    #: consecutive sick rounds before the tenant's lane is masked out
    evict_after: int = 4
    #: evicted rounds before the plane attempts a probation re-admission
    readmit_after: int = 6
    #: consecutive healthy rounds in probation before full promotion
    probation_rounds: int = 3
    #: a round whose lane spent >= this fraction of its iterations in
    #: the engine quarantine counts as sick even when the decoded
    #: trajectory is finite (the substitution made it so)
    quarantine_sick_fraction: float = 1.0

    def __post_init__(self):
        if not (0 < self.quarantine_after <= self.evict_after):
            raise ValueError(
                "need 0 < quarantine_after <= evict_after, got "
                f"{self.quarantine_after} / {self.evict_after}")
        if self.readmit_after < 1 or self.probation_rounds < 1:
            raise ValueError("readmit_after and probation_rounds must "
                             "be >= 1")

    @classmethod
    def from_config(cls, cfg: dict) -> "HealthPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(
                f"unknown health option(s) {sorted(unknown)}; "
                f"known: {sorted(known)}")
        return cls(**cfg)


@dataclasses.dataclass
class TenantHealth:
    """One tenant's ledger row."""

    state: str = HEALTHY
    sick_streak: int = 0
    healthy_streak: int = 0
    #: rounds spent evicted since the (latest) eviction
    evicted_rounds: int = 0
    evictions: int = 0


class HealthLedger:
    """The per-tenant state machine; owns no plane mechanics — it only
    decides transitions, the plane executes them."""

    def __init__(self, policy: HealthPolicy = HealthPolicy()):
        self.policy = policy
        self._rows: "dict[str, TenantHealth]" = {}

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._rows

    def row(self, tenant_id: str) -> TenantHealth:
        return self._rows.setdefault(tenant_id, TenantHealth())

    def state(self, tenant_id: str) -> str:
        return self.row(tenant_id).state

    def forget(self, tenant_id: str) -> None:
        self._rows.pop(tenant_id, None)
        if telemetry.enabled():
            # leave the gauge at its last value? No: a departed tenant
            # must not read as eternally sick on the dashboard
            telemetry.gauge(
                "serving_health_state",
                "tenant-health ladder position (0=healthy, "
                "1=quarantined, 2=probation, 3=evicted)").set(
                0.0, tenant=tenant_id)

    def _export(self, tenant_id: str, row: TenantHealth) -> None:
        if telemetry.enabled():
            telemetry.gauge(
                "serving_health_state",
                "tenant-health ladder position (0=healthy, "
                "1=quarantined, 2=probation, 3=evicted)").set(
                float(_STATE_LEVEL[row.state]), tenant=tenant_id)

    def _journal_move(self, tenant_id: str, row: TenantHealth,
                      state_from: str) -> None:
        if row.state != state_from:
            telemetry.journal_event(
                "health.transition", tenant=tenant_id,
                state=row.state, state_from=state_from,
                sick_streak=row.sick_streak,
                healthy_streak=row.healthy_streak,
                evictions=row.evictions)

    def is_sick_result(self, healthy: bool, stats: "dict | None") -> bool:
        """Merge the guard verdict with the per-lane quarantine
        attribution into one sick/healthy bit for the ledger."""
        if not healthy:
            return True
        stats = stats or {}
        iters = int(stats.get("iterations") or 0)
        q = int(stats.get("quarantined_iters") or 0)
        if iters <= 0 or q <= 0:
            return False
        return q >= self.policy.quarantine_sick_fraction * iters

    def observe(self, tenant_id: str, sick: bool) -> "str | None":
        """Record one served round's verdict. Returns the transition the
        plane must execute: ``"evict"`` (mask the lane out), ``"clear"``
        (probation completed), or None."""
        row = self.row(tenant_id)
        if row.state == EVICTED:
            # an evicted tenant has no served rounds; ignore strays
            # (e.g. a pipelined round launched before the eviction)
            return None
        state_before = row.state
        transition = None
        if sick:
            row.healthy_streak = 0
            row.sick_streak += 1
            if row.state == PROBATION:
                # hysteresis: one sick probation round re-evicts
                transition = "evict"
            elif row.sick_streak >= self.policy.evict_after:
                transition = "evict"
            elif row.sick_streak >= self.policy.quarantine_after \
                    and row.state == HEALTHY:
                row.state = QUARANTINED
                logger.warning(
                    "tenant %s quarantined after %d consecutive sick "
                    "rounds (evict at %d)", tenant_id, row.sick_streak,
                    self.policy.evict_after)
        else:
            row.sick_streak = 0
            row.healthy_streak += 1
            if row.state == PROBATION:
                if row.healthy_streak >= self.policy.probation_rounds:
                    row.state = HEALTHY
                    transition = "clear"
                    logger.info(
                        "tenant %s promoted from probation after %d "
                        "healthy rounds", tenant_id, row.healthy_streak)
            elif row.state == QUARANTINED:
                row.state = HEALTHY
                logger.info("tenant %s left quarantine", tenant_id)
        if transition == "evict":
            row.state = EVICTED
            row.sick_streak = 0
            row.healthy_streak = 0
            row.evicted_rounds = 0
            row.evictions += 1
        self._export(tenant_id, row)
        self._journal_move(tenant_id, row, state_before)
        return transition

    def force_evict(self, tenant_id: str) -> None:
        """Record an eviction decided OUTSIDE observe(): the plane's
        public ``evict_tenant`` (operator action, chaos drills).
        Idempotent."""
        row = self.row(tenant_id)
        if row.state == EVICTED:
            return
        state_before = row.state
        row.state = EVICTED
        row.sick_streak = 0
        row.healthy_streak = 0
        row.evicted_rounds = 0
        row.evictions += 1
        self._export(tenant_id, row)
        self._journal_move(tenant_id, row, state_before)

    def tick_evicted(self) -> "list[str]":
        """Advance every evicted tenant's clock by one served round;
        returns the tenants whose re-admission window opened."""
        due = []
        for tenant_id, row in self._rows.items():
            if row.state == EVICTED:
                row.evicted_rounds += 1
                if row.evicted_rounds >= self.policy.readmit_after:
                    due.append(tenant_id)
        return due

    def readmitted(self, tenant_id: str) -> None:
        """The plane re-admitted a tenant: start probation."""
        row = self.row(tenant_id)
        state_before = row.state
        row.state = PROBATION
        row.sick_streak = 0
        row.healthy_streak = 0
        row.evicted_rounds = 0
        self._export(tenant_id, row)
        self._journal_move(tenant_id, row, state_before)

    # -- checkpoint seam ------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able ledger state for the plane checkpoint."""
        return {tid: dataclasses.asdict(row)
                for tid, row in self._rows.items()}

    def restore(self, snap: dict) -> None:
        for tid, row in (snap or {}).items():
            self._rows[tid] = TenantHealth(**row)
            self._export(tid, self._rows[tid])
