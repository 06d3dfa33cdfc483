"""Admission control: bounded queue, per-tenant deadlines, shed-to-fallback.

Port of ``agentlib_mpc_tpu/serving/admission.py``.

The serving plane must degrade PREDICTABLY under overload. Three rules,
in the order they bite:

1. **Coalescing** — one outstanding request per tenant: a newer
   submission replaces the older one (MPC semantics: the next
   measurement supersedes a stale solve request; the reference's QoS-0
   broadcasts make the same call).
2. **Bounded queue** — at most ``limit`` distinct tenants pending. A
   submission beyond the bound is SHED immediately
   (``serving_shed_total{reason="overload"}``) instead of growing an
   unbounded backlog whose tail latency nobody can meet.
3. **Deadlines** — a request not served within its ``deadline_s`` is
   dropped at drain time (``reason="deadline"``).

A shed request is not silently lost: the plane assesses it as an
unhealthy solve against the tenant's
:class:`~agentlib_mpc_torch.resilience.guard.ActuationGuard`, so the
tenant walks the replay → hold → fallback ladder exactly as it would
for a diverged solver — overload and solver failure degrade through ONE
code path, and ``FallbackPID`` hand-over / hysteretic recovery come for
free.
"""

from __future__ import annotations

import dataclasses

from agentlib_mpc_torch import telemetry


@dataclasses.dataclass
class SolveRequest:
    tenant_id: str
    #: fresh parameter row for this solve (None: reuse the lane's)
    theta: object = None
    submitted_at: float = 0.0
    deadline_s: "float | None" = None

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None
                and now - self.submitted_at > self.deadline_s)


class AdmissionQueue:
    """FIFO of pending solve requests, coalesced per tenant, bounded."""

    def __init__(self, limit: int = 1024,
                 default_deadline_s: "float | None" = None):
        self.limit = int(limit)
        self.default_deadline_s = default_deadline_s
        self._pending: "dict[str, SolveRequest]" = {}   # insertion-ordered
        self.submitted = 0
        self.shed_overload = 0
        self.shed_deadline = 0

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, request: SolveRequest) -> bool:
        """Enqueue (or coalesce). Returns False when shed on overload."""
        self.submitted += 1
        if request.deadline_s is None:
            request.deadline_s = self.default_deadline_s
        if request.tenant_id in self._pending:
            self._pending[request.tenant_id] = request   # coalesce
            return True
        if len(self._pending) >= self.limit:
            self.shed_overload += 1
            if telemetry.enabled():
                telemetry.counter(
                    "serving_shed_total",
                    "solve requests shed to the degradation ladder"
                    ).inc(reason="overload")
            return False
        self._pending[request.tenant_id] = request
        return True

    def snapshot(self, now: float) -> list:
        """JSON-able view of the pending queue — the plane checkpoint's
        queue carryover. Parameter payloads are NOT persisted (the
        coalescing contract: the next submission supersedes; a restored
        request re-solves on its lane's last spliced parameters), only
        identity, deadline and the age already accrued."""
        return [{"tenant_id": r.tenant_id,
                 "deadline_s": r.deadline_s,
                 "elapsed_s": max(0.0, now - r.submitted_at)}
                for r in self._pending.values()]

    def drain(self, now: float) -> "tuple[list, list]":
        """Empty the queue: ``(ready, expired)``. Expired requests are
        counted and handed back so the plane can walk the tenant's
        guard ladder for them."""
        ready, expired = [], []
        for req in self._pending.values():
            (expired if req.expired(now) else ready).append(req)
        self._pending.clear()
        if expired:
            self.shed_deadline += len(expired)
            if telemetry.enabled():
                telemetry.counter(
                    "serving_shed_total",
                    "solve requests shed to the degradation ladder"
                    ).inc(len(expired), reason="deadline")
        return ready, expired
