"""The serving front door: join / leave / submit / serve_round.

Port of ``agentlib_mpc_tpu/serving/plane.py`` on one device. One
:class:`ServingPlane` hosts many structure buckets, each a
:class:`~agentlib_mpc_torch.serving.slots.SlotPlane` over a fused engine
acquired through the fingerprint-keyed
:class:`~agentlib_mpc_torch.serving.cache.CompileCache`. The request
path:

1. ``join(spec)``: fingerprint the tenant's problem, find (cache hit) or
   build (miss: certify, route, warm one round) the bucket engine, splice
   the tenant into a padded slot. A structurally identical rejoin is a
   measured cache hit: its latency is the splice, not the build.
2. ``submit(tenant_id, theta)``: enqueue one solve request (bounded
   queue, per-tenant deadline, coalescing). The parameters are checked
   for NaN on the host at the door. A shed request walks the tenant's
   :class:`~agentlib_mpc_torch.resilience.guard.ActuationGuard` ladder at
   once and returns the resulting decision.
3. ``serve_round()``: drain the queue, splice each touched bucket's fresh
   parameter rows with one host-to-device copy, run one fused round per
   touched bucket through the (pipelined) dispatcher, assess every
   delivered result against the tenant's guard, return per-tenant
   :class:`RoundResult` s.

Capacity: a full bucket grows to the next slot multiple: a new engine
(cached by capacity), the sitting tenants migrated with their warm
starts reset (the documented cost of growth; size ``initial_capacity``).

Survivability:

* ``health_policy=`` arms the per-tenant
  :class:`~agentlib_mpc_torch.serving.health.HealthLedger`: a
  persistently sick tenant walks quarantine → eviction (lane masked out;
  its submissions shed into its guard ladder) → probation re-admission.
* ``watchdog_timeout_s=`` arms the dispatch watchdog over the round's
  launch and decode: a round that never returns times out, its tenants
  shed into their ladders, and the dispatcher falls back to synchronous
  dispatch; no exception escapes ``serve_round``.
* ``save_checkpoint``/``restore_checkpoint`` persist the whole plane;
  the restore rebuilds buckets through the compile cache.

The plane runs on ``device`` (None: the card; without one it raises
unless ``device="cpu"`` is passed) in ``dtype``; every tenant's
parameters are moved to them at the door.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP Queue 1 item: ``mesh=`` (item 5), ``engine_store=`` (item 5),
``autopilot=`` (item 5), ``warmstart=True`` and ``warmstart_tape=True``
(item 5), ``profile_every=`` (item 6) and ``memory_certify="require"``
(item 7). In the JAX package ``memory_certify="auto"`` escalates to a
certificate check once the device's memory size is known; here
``"auto"`` certifies nothing until item 7 brings the memory certificate,
and the bucket engines are built with the port's ``FusedADMM`` and
``ScenarioFleet`` defaults. The capacity-shed join path (a join whose
engine the memory budget refuses) stays: it runs on
:class:`MemoryBudgetExceeded`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.parallel.fused_admm import (
    AgentGroup,
    FusedADMM,
    FusedADMMOptions,
)
from agentlib_mpc_torch.resilience.guard import (
    ActuationGuard,
    DegradationPolicy,
)
from agentlib_mpc_torch.serving.admission import AdmissionQueue, SolveRequest
from agentlib_mpc_torch.serving.cache import CompileCache
from agentlib_mpc_torch.serving.dispatch import (
    PipelinedDispatcher,
    RoundTimeout,
)
from agentlib_mpc_torch.serving.fingerprint import TenantSpec, bucket_key
from agentlib_mpc_torch.serving.health import HealthLedger, HealthPolicy
from agentlib_mpc_torch.serving.slots import (
    ScenarioSlotPlane,
    SlotPlane,
    stack_rows,
    tree_repeat,
    tree_row,
)
from agentlib_mpc_torch.telemetry.slo import SLOPolicy, SLOTracker
from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class MemoryBudgetExceeded(RuntimeError):
    """A bucket engine (or its growth) refused for the device's memory
    budget: the join is shed into the tenant's guard ladder."""


class JoinReceipt(NamedTuple):
    tenant_id: str
    bucket: str              # bucket digest (artifact/log key)
    #: slot index, or -1 for a CAPACITY-SHED join: the bucket growth (or
    #: initial build) that would have admitted this tenant was refused
    #: for memory; the tenant is registered and its submissions shed into
    #: its guard ladder until capacity frees (``readmit_tenant``)
    slot: int
    capacity: int
    #: the engine came out of the compile cache; False = it was built
    engine_cached: bool
    #: wall seconds of the whole join (engine acquisition + splice)
    latency_s: float


class RoundResult(NamedTuple):
    """What the plane tells a tenant's actuator after a round."""

    #: actuate | replay | hold | fallback (guard ladder vocabulary)
    action: str
    #: controls to apply (the solve's u0 for ``actuate``, the guard's
    #: degraded controls otherwise; None = nothing to actuate)
    controls: "dict | None"
    healthy: bool
    reasons: tuple = ()
    #: raw per-tenant solve stats (None for shed requests)
    stats: "dict | None" = None


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class ServingPlane:
    def __init__(self,
                 admm_options: FusedADMMOptions = FusedADMMOptions(),
                 slot_multiple: "int | None" = None,
                 initial_capacity: "int | None" = None,
                 pipelined: "bool | str" = "auto",
                 donate: "bool | str" = "auto",
                 queue_limit: int = 1024,
                 default_deadline_s: "float | None" = None,
                 guard_policy: DegradationPolicy = DegradationPolicy(),
                 warm_on_build: bool = True,
                 health_policy: "HealthPolicy | None" = None,
                 watchdog_timeout_s: "float | None" = None,
                 max_engines: "int | None" = None,
                 cache: "CompileCache | None" = None,
                 mesh=None,
                 engine_store=None,
                 memory_certify: str = "auto",
                 hbm_bytes: "int | str | None" = "auto",
                 slo_policy: "SLOPolicy | None" = None,
                 profile_every: "int | None" = None,
                 autopilot=None,
                 warmstart: "bool | str" = "auto",
                 warmstart_tape: bool = False,
                 device=None,
                 dtype: torch.dtype = torch.float32):
        _refuse_unported(mesh, engine_store, memory_certify, profile_every,
                         autopilot, warmstart, warmstart_tape)
        self.device = resolve_device(device)
        self.dtype = dtype
        if slot_multiple is None:
            from agentlib_mpc_torch.parallel.multihost import (
                serving_slot_multiple,
            )

            slot_multiple = serving_slot_multiple()
        # "auto" resolves by device: pipelined on the card, synchronous
        # on the CPU (the JAX package's defaults per backend)
        on_card = self.device.type == "cuda"
        if pipelined == "auto":
            pipelined = on_card
        if donate == "auto":
            donate = on_card
        self.admm_options = admm_options
        self.slot_multiple = max(1, int(slot_multiple))
        # every capacity is a slot multiple; a user initial_capacity is
        # rounded UP
        want = (self.slot_multiple if initial_capacity is None
                else int(initial_capacity))
        self.initial_capacity = self.slot_multiple * math.ceil(
            max(want, 1) / self.slot_multiple)
        #: passed to ``FusedADMM(donate_state=)``, which validates it (the
        #: port's eager round allocates new state tensors either way)
        self.donate = bool(donate)
        self.warm_on_build = bool(warm_on_build)
        self.guard_policy = guard_policy
        #: pass a shared cache to model a supervisor restart
        self.cache = cache if cache is not None \
            else CompileCache(max_engines=max_engines)
        self.memory_certify = memory_certify
        #: the device memory budget a join's engine is held to; "auto"
        #: reads nothing until the memory certificate is ported (item 7)
        self.hbm_bytes = (int(hbm_bytes) if hbm_bytes not in
                          (None, "auto") else None)
        self.dispatcher = PipelinedDispatcher(
            pipelined, timeout_s=watchdog_timeout_s, device=self.device)
        self.queue = AdmissionQueue(queue_limit, default_deadline_s)
        self._health = None if health_policy is None \
            else HealthLedger(health_policy)
        self._buckets: dict = {}          # BucketKey -> SlotPlane
        self._tenant_bucket: dict = {}    # tenant_id -> BucketKey
        self._specs: dict = {}            # tenant_id -> TenantSpec
        self._guards: dict = {}           # tenant_id -> ActuationGuard
        #: health-evicted (or capacity-shed) tenants: registered but
        #: occupying no slot; tenant_id -> BucketKey
        self._evicted: dict = {}
        #: results decoded outside serve_round (growth/leave flushes),
        #: merged into the next serve_round return
        self._carryover: dict = {}
        #: tenants whose submission was rejected at the door this round
        #: (NaN theta), scored as sick at the next assessment
        self._sick_marks: set = set()
        #: fused dispatches (one per touched bucket per round)
        self.rounds = 0
        #: serve_round() calls: the journal's round stamp and the SLO
        #: windows' clock
        self.served_rounds = 0
        self.slo = SLOTracker(slo_policy if slo_policy is not None
                              else SLOPolicy())
        self._slo_policy_journaled = False
        # events between rounds belong to the UPCOMING round
        telemetry.journal_set_round(self.served_rounds)

    # -- parameters at the door -------------------------------------------------

    def _host_theta(self, theta):
        """A tenant's parameter tree as CPU tensors in the plane's dtype
        (the queue's form: checked and batched on the host), copied so the
        caller cannot change a request after the door checked it."""
        return tree_map(
            lambda t: torch.as_tensor(t).detach().to(
                device="cpu", dtype=self.dtype, copy=True), theta)

    def _device_theta(self, theta):
        return tree_map(lambda t: t.to(device=self.device),
                        self._host_theta(theta))

    # -- membership -----------------------------------------------------------

    def _register_tenant(self, tenant_id: str, key, spec: TenantSpec
                         ) -> None:
        self._tenant_bucket[tenant_id] = key
        self._specs[tenant_id] = spec
        self._guards[tenant_id] = ActuationGuard(
            self.guard_policy, logger_=logger,
            tenant=tenant_id, bucket=key.digest)

    def join(self, spec: TenantSpec) -> JoinReceipt:
        if spec.tenant_id in self._tenant_bucket:
            raise ValueError(f"tenant {spec.tenant_id!r} already joined")
        t0 = time.perf_counter()
        spec = self._door_spec(spec)
        key = bucket_key(spec)
        bucket = self._buckets.get(key)
        cached = True
        try:
            if bucket is None:
                bucket, cached = self._acquire_bucket(key, spec,
                                                      n_needed=1)
            elif bucket.free_slots == 0:
                bucket, cached = self._acquire_bucket(
                    key, spec, n_needed=bucket.n_active + 1,
                    migrate_from=bucket)
            else:
                # joining a LIVE bucket: the engine is reused without
                # even a cache lookup, still a hit in the metric
                self.cache.note_hit(label=key.digest)
        except MemoryBudgetExceeded as exc:
            return self._capacity_shed_join(spec, key, t0, exc)
        slot = bucket.admit(spec.tenant_id, spec.theta)
        self._register_tenant(spec.tenant_id, key, spec)
        if telemetry.enabled():
            telemetry.serving_metrics()["active"].set(
                float(bucket.n_active), bucket=key.digest)
        latency = time.perf_counter() - t0
        logger.info(
            "tenant %s joined bucket %s slot %d (%s, %.1f ms)",
            spec.tenant_id, key.digest, slot,
            "cached engine" if cached else "cold build", 1e3 * latency)
        return JoinReceipt(spec.tenant_id, key.digest, slot,
                           bucket.capacity, cached, latency)

    def _door_spec(self, spec: TenantSpec) -> TenantSpec:
        """The spec as the plane keeps it: robust specs normalized, the
        parameters on the plane's device in its dtype."""
        spec = self._normalize_robust_spec(spec)
        return dataclasses.replace(spec,
                                   theta=self._device_theta(spec.theta))

    @staticmethod
    def _normalize_robust_spec(spec: TenantSpec) -> TenantSpec:
        """Validate a robust tenant's spec at the door.

        The single-scenario tree normalizes into a FLAT tenant (theta's
        branch axis squeezed); a real tree requires an (S, ...)-leading
        theta stack and no exchange couplings (``ScenarioFleet`` lifts
        consensus couplings only)."""
        tree = spec.scenario_tree
        if tree is None:
            return spec
        if tree.n_scenarios == 1:
            return dataclasses.replace(
                spec, theta=tree_row(spec.theta, 0), scenario_tree=None,
                scenario_options=None)
        if spec.exchanges:
            raise ValueError(
                f"robust tenant {spec.tenant_id!r} declares exchange "
                f"couplings {sorted(spec.exchanges)} — scenario "
                f"buckets lift consensus couplings only")
        leaves = tree_flatten(spec.theta)[0]
        lead = int(np.shape(leaves[0])[0]) if leaves else 0
        if lead != tree.n_scenarios:
            raise ValueError(
                f"robust tenant {spec.tenant_id!r} carries a "
                f"{lead}-branch theta stack for a "
                f"{tree.n_scenarios}-scenario tree — build it with "
                f"scenario.generate (scenario_thetas/ensemble_thetas)")
        return spec

    def _capacity_shed_join(self, spec: TenantSpec, key, t0: float,
                            exc) -> JoinReceipt:
        """A join the memory budget refused: register the tenant (spec,
        guard, ladder) WITHOUT a slot; its submissions shed into its
        guard ladder and :meth:`readmit_tenant` splices it in when
        capacity frees. The sitting tenants' rounds are never touched."""
        self._register_tenant(spec.tenant_id, key, spec)
        self._evicted[spec.tenant_id] = key
        telemetry.journal_event(
            "certifier.refused", kind="memory", tenant=spec.tenant_id,
            bucket=key.digest, hbm_bytes=self.hbm_bytes,
            detail=str(exc)[:300])
        if telemetry.enabled():
            telemetry.counter(
                "serving_capacity_shed_joins_total",
                "joins refused by the bucket memory budget and shed into "
                "the guard ladder").inc(bucket=key.digest)
        logger.warning(
            "tenant %s join shed into its guard ladder — bucket %s "
            "cannot grow within the device memory budget: %s",
            spec.tenant_id, key.digest, exc)
        return JoinReceipt(spec.tenant_id, key.digest, -1, 0, False,
                           time.perf_counter() - t0)

    def leave(self, tenant_id: str) -> None:
        key = self._tenant_bucket.pop(tenant_id)
        # an evicted tenant holds no slot, and (after a checkpoint
        # restore) possibly no live bucket either
        bucket = self._buckets.get(key)
        if tenant_id not in self._evicted and bucket is not None:
            bucket.evict(tenant_id)
        self._evicted.pop(tenant_id, None)
        self._specs.pop(tenant_id, None)
        self._guards.pop(tenant_id, None)
        # the SLO ledger KEEPS the departed tenant's rows (an accounting
        # record; the offline recompute over the journal keeps them too)
        if self._health is not None:
            self._health.forget(tenant_id)
        if bucket is None:
            return
        if telemetry.enabled():
            telemetry.serving_metrics()["active"].set(
                float(bucket.n_active), bucket=key.digest)
        if bucket.n_active == 0 and key not in self._evicted.values():
            # drain the pipeline, then retire the slot plane; the ENGINE
            # stays in the compile cache, so a rejoin is a hit
            self._stash_flush(key)
            del self._buckets[key]

    def _engine_key(self, key, capacity: int):
        return (key, capacity, self._options_key(), self.donate,
                str(self.device), str(self.dtype))

    def _acquire_bucket(self, key, spec: TenantSpec, n_needed: int,
                        migrate_from: "SlotPlane | None" = None,
                        capacity: "int | None" = None):
        """Find or build an engine with capacity for ``n_needed`` active
        tenants (rounded up to the slot multiple; an explicit
        ``capacity``, the checkpoint-restore path, is taken verbatim);
        optionally migrate a full bucket's tenants into it."""
        if capacity is None:
            capacity = max(self.initial_capacity,
                           self.slot_multiple
                           * math.ceil(n_needed / self.slot_multiple))
        scen_tree = key.scenario_tree

        def make_engine():
            group = AgentGroup(
                name=f"bucket-{key.digest}",
                ocp=spec.ocp, n_agents=capacity,
                couplings=dict(key.couplings),
                exchanges=dict(key.exchanges),
                solver_options=key.solver_options,
                warm_solver_options=key.warm_solver_options,
                qp_fast_path=key.qp_fast_path)
            off = torch.zeros((capacity,), dtype=torch.bool,
                              device=self.device)
            if scen_tree is not None:
                from agentlib_mpc_torch.scenario.fleet import (
                    ScenarioFleet,
                    ScenarioFleetOptions,
                )

                return ScenarioFleet(
                    group, scen_tree,
                    (key.scenario_options
                     if key.scenario_options is not None
                     else ScenarioFleetOptions()),
                    active=off, device=self.device)
            return FusedADMM([group], self.admm_options, active=[off],
                             donate_state=self.donate, device=self.device)

        def build():
            engine = make_engine()
            if self.warm_on_build:
                # pay the first round NOW (lazy per-dtype constants, the
                # kernels' first launches) so the cold/cached join split
                # is honest and the first served round is warm; every
                # lane masked off, a throwaway state
                theta_b = tree_repeat(spec.theta, capacity)
                off = torch.zeros((capacity,), dtype=torch.bool,
                                  device=self.device)
                if scen_tree is not None:
                    engine.step(engine.init_state(theta_b), theta_b,
                                active=off)
                else:
                    engine.step(engine.init_state([theta_b]), [theta_b],
                                active=[off])
            return engine

        engine, hit, _latency = self.cache.get_or_build(
            self._engine_key(key, capacity), build, label=key.digest)
        if scen_tree is not None:
            bucket = ScenarioSlotPlane(engine, spec.ocp, spec.theta)
        else:
            bucket = SlotPlane(engine, spec.ocp, spec.theta)
        if migrate_from is not None:
            self._stash_flush(key)       # deliver the old plane's round
            for tenant_id in migrate_from.tenants:
                slot = migrate_from.slot_of(tenant_id)
                row = tree_row(migrate_from.theta_batch, slot)
                bucket.admit(tenant_id, row)
            logger.info(
                "bucket %s grew %d -> %d slots (%d tenants migrated, "
                "warm starts reset)", key.digest, migrate_from.capacity,
                capacity, len(migrate_from.tenants))
        self._buckets[key] = bucket
        return bucket, hit

    def _options_key(self):
        """Hashable identity of the engine-level options (rho may be a
        dict)."""
        opts = self.admm_options
        rho = opts.rho
        rho_key = tuple(sorted(rho.items())) if isinstance(rho, dict) \
            else float(rho)
        return opts._replace(rho=rho_key)

    def install_warmstart(self, model) -> int:
        """Learned warm starts need ``ml/warmstart.py``: not ported."""
        raise NotImplementedError(
            "install_warmstart (learned warm starts, ml/warmstart.py) is "
            "not ported yet (ROADMAP Queue 1 item 5)")

    # -- tenant health: evict / readmit ---------------------------------------

    def evict_tenant(self, tenant_id: str, reason: str = "manual") -> None:
        """Mask a tenant's lane out of its bucket WITHOUT deregistering
        it: the spec, guard ladder and health row stay, its submissions
        shed into the ladder, and :meth:`readmit_tenant` (or the health
        ledger's re-admission window) splices it back fresh."""
        if tenant_id not in self._tenant_bucket:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        if tenant_id in self._evicted:
            return
        key = self._tenant_bucket[tenant_id]
        bucket = self._buckets[key]
        bucket.evict(tenant_id)
        self._evicted[tenant_id] = key
        if self._health is not None:
            self._health.force_evict(tenant_id)
        if telemetry.enabled():
            telemetry.counter(
                "serving_evictions_total",
                "tenants masked out of their bucket by the health "
                "ladder (or operator)").inc(bucket=key.digest,
                                            reason=reason)
            telemetry.serving_metrics()["active"].set(
                float(bucket.n_active), bucket=key.digest)
        telemetry.journal_event("serve.eviction", tenant=tenant_id,
                                bucket=key.digest, reason=reason)
        logger.warning("tenant %s evicted from bucket %s (%s); "
                       "submissions now shed into its guard ladder",
                       tenant_id, key.digest, reason)

    def readmit_tenant(self, tenant_id: str) -> bool:
        """Splice an evicted tenant back into its bucket with a FRESH
        warm start. Returns False when its bucket is full (retry later);
        the engine comes from the live bucket or the compile cache."""
        key = self._evicted.get(tenant_id)
        if key is None:
            raise KeyError(f"tenant {tenant_id!r} is not evicted")
        spec = self._specs[tenant_id]
        bucket = self._buckets.get(key)
        if bucket is None:
            # the slot plane retired but the ENGINE is cached: this
            # acquisition is the measured cache-hit rejoin
            bucket, _hit = self._acquire_bucket(key, spec, n_needed=1)
        if bucket.free_slots == 0:
            return False
        slot = bucket.admit(tenant_id, spec.theta)
        del self._evicted[tenant_id]
        if self._health is not None:
            self._health.readmitted(tenant_id)
        if telemetry.enabled():
            telemetry.counter(
                "serving_readmissions_total",
                "evicted tenants spliced back on probation").inc(
                bucket=key.digest)
            telemetry.serving_metrics()["active"].set(
                float(bucket.n_active), bucket=key.digest)
        telemetry.journal_event("serve.readmission", tenant=tenant_id,
                                bucket=key.digest, slot=slot)
        logger.info("tenant %s readmitted to bucket %s slot %d "
                    "(probation)", tenant_id, key.digest, slot)
        return True

    def _readmit_due(self) -> None:
        if self._health is None:
            return
        for tenant_id in self._health.tick_evicted():
            if tenant_id in self._evicted:
                self.readmit_tenant(tenant_id)

    # -- request path ---------------------------------------------------------

    @staticmethod
    def _theta_valid(theta) -> bool:
        """NaN-free (not finite: parameter trees legitimately carry ±inf
        bounds), checked on the host copy."""
        try:
            return not any(bool(torch.isnan(leaf).any())
                           for leaf in tree_flatten(theta)[0]
                           if _is_float(leaf))
        except (TypeError, RuntimeError):
            return False

    def submit(self, tenant_id: str, theta=None,
               deadline_s: "float | None" = None,
               now: "float | None" = None):
        """Enqueue one solve request. Returns None when queued; when it
        is shed (overload, NaN parameters, or the tenant is
        health-evicted), the tenant's guard ladder is walked at once and
        the resulting degraded
        :class:`~agentlib_mpc_torch.resilience.guard.GuardDecision` is
        returned."""
        if tenant_id not in self._tenant_bucket:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        if deadline_s is None:
            deadline_s = self._specs[tenant_id].deadline_s
        if telemetry.enabled():
            telemetry.serving_metrics()["requests"].inc()
        if tenant_id in self._evicted:
            if telemetry.enabled():
                telemetry.counter(
                    "serving_shed_total",
                    "solve requests shed to the degradation ladder"
                    ).inc(reason="evicted")
            return self._shed(tenant_id, "shed_evicted")
        if theta is not None:
            try:
                theta = self._host_theta(theta)
            except (TypeError, ValueError, RuntimeError):
                theta = None
                valid = False
            else:
                valid = self._theta_valid(theta)
            if not valid:
                # validated at the door: a NaN parameter tree never
                # reaches a lane splice; it counts as a sick round on
                # the health ladder
                if telemetry.enabled():
                    telemetry.counter(
                        "serving_shed_total",
                        "solve requests shed to the degradation ladder"
                        ).inc(reason="nonfinite_theta")
                if self._health is not None:
                    self._sick_marks.add(tenant_id)
                return self._shed(tenant_id, "nonfinite_theta")
        ok = self.queue.submit(SolveRequest(
            tenant_id=tenant_id, theta=theta,
            submitted_at=time.monotonic() if now is None else now,
            deadline_s=deadline_s))
        if ok:
            return None
        return self._shed(tenant_id, "shed_overload")

    def _shed(self, tenant_id: str, reason: str):
        """Walk a shed request through the tenant's degradation ladder
        (overload and solver failure degrade through one path)."""
        guard = self._guards.get(tenant_id)
        if guard is None:
            return None
        decision = guard.assess({"stats": {"success": True}},
                                precheck=(False, (reason,)))
        key = self._tenant_bucket.get(tenant_id)
        telemetry.journal_event(
            "admission.shed", tenant=tenant_id, reason=reason,
            action=decision.action,
            bucket=key.digest if key is not None else None)
        self.slo.record_result(
            tenant_id, decision.action,
            deadline_missed=(reason == "shed_deadline"))
        return decision

    def _shed_result(self, tenant_id: str, reason: str, results: dict
                     ) -> None:
        decision = self._shed(tenant_id, reason)
        if decision is not None:
            results[tenant_id] = RoundResult(
                action=decision.action, controls=decision.controls,
                healthy=False, reasons=decision.reasons)

    def serve_round(self, now: "float | None" = None) -> dict:
        """Drain the queue and run one fused round per touched bucket.
        Returns ``{tenant_id: RoundResult}``; in pipelined mode these are
        the results of each bucket's PREVIOUS round (plus any deadline
        sheds of this one); :meth:`flush` drains the pipeline. Never
        raises for a watchdogged round: its tenants shed into their
        ladders and the dispatcher falls back to synchronous dispatch."""
        t0 = time.perf_counter()
        now = time.monotonic() if now is None else now
        telemetry.journal_set_round(self.served_rounds)
        if not self._slo_policy_journaled \
                and telemetry.journal_active() is not None:
            # stamp the SLO policy onto the tape once, so the offline
            # recompute audits against the live report's targets
            telemetry.journal_event(
                "slo.policy",
                availability_target=self.slo.policy.availability_target,
                deadline_target=self.slo.policy.deadline_target,
                windows=list(self.slo.policy.windows))
            self._slo_policy_journaled = True
        self._readmit_due()
        ready, expired = self.queue.drain(now)
        results: dict = {}
        for res in self._carryover.values():
            results.update(self._assess_bucket(res))
        self._carryover.clear()
        for req in expired:
            self._shed_result(req.tenant_id, "shed_deadline", results)
        touched: dict = {}                # key -> [(slot, host row)]
        for req in ready:
            if req.tenant_id in self._evicted:
                # evicted after submitting (or a restored carryover)
                self._shed_result(req.tenant_id, "shed_evicted", results)
                continue
            key = self._tenant_bucket.get(req.tenant_id)
            if key is None:
                continue                  # left after submitting
            rows = touched.setdefault(key, [])
            if req.theta is not None:
                rows.append((self._buckets[key].slot_of(req.tenant_id),
                             req.theta))
        m = telemetry.serving_metrics() if telemetry.enabled() else None
        for key, rows in touched.items():
            bucket = self._buckets[key]
            if rows:
                # one host-to-device copy per bucket and round
                bucket.update_thetas([s for s, _ in rows],
                                     stack_rows([r for _, r in rows]))
            res = self.dispatcher.dispatch(key, bucket)
            self.rounds += 1
            if m is not None:
                m["rounds"].inc(bucket=key.digest)
            if res is not None:
                results.update(self._assess_bucket(res))
        # rounds condemned by a stall in another bucket: assess as
        # failures now (their tenants shed into their ladders)
        for res in self.dispatcher.drain_failed().values():
            results.update(self._assess_bucket(res))
        if self._health is not None and self._sick_marks:
            # tenants whose only traffic was a rejected (NaN) submission:
            # score the strike though no lane result carried it
            for tenant_id in tuple(self._sick_marks):
                self._sick_marks.discard(tenant_id)
                if tenant_id not in self._tenant_bucket \
                        or tenant_id in self._evicted:
                    continue
                if self._health.observe(tenant_id, True) == "evict":
                    self.evict_tenant(tenant_id, reason="health")
        if m is not None:
            m["queue_depth"].set(float(len(self.queue)))
            m["round_seconds"].observe(time.perf_counter() - t0)
        # close the SLO round and journal its tally: the serve.round
        # event makes slo_report() recomputable offline
        tally = self.slo.tick_round(self.served_rounds)
        telemetry.journal_event(
            "serve.round", round=self.served_rounds, tally=tally,
            buckets_touched=len(touched),
            actions={tid: r.action for tid, r in results.items()})
        self.served_rounds += 1
        telemetry.journal_set_round(self.served_rounds)
        return results

    def flush(self) -> dict:
        """Drain the dispatch pipeline: assess and return every in-flight
        round's results (empty dict when none)."""
        results: dict = {}
        for res in self.dispatcher.flush().values():
            results.update(self._assess_bucket(res))
        for res in self._carryover.values():
            results.update(self._assess_bucket(res))
        self._carryover.clear()
        return results

    def _stash_flush(self, key) -> None:
        flushed = self.dispatcher.flush(key)
        if key in flushed:
            self._carryover[key] = flushed[key]

    def _assess_bucket(self, decoded) -> dict:
        """Run each delivered result through its tenant's guard and shape
        the per-tenant verdicts. A :class:`RoundTimeout` (the watchdog
        declared the round dead) becomes a failed solve for every tenant
        the round served."""
        if isinstance(decoded, RoundTimeout):
            decoded = {
                tenant_id: {
                    "u0": {}, "traj": {},
                    "stats": {"success": False,
                              "watchdog_timeout": True},
                } for tenant_id, _slot in decoded.served}
        out = {}
        evictions = []
        m = telemetry.serving_metrics() if telemetry.enabled() else None
        for tenant_id, result in decoded.items():
            guard = self._guards.get(tenant_id)
            if guard is None:
                continue                  # tenant left while in flight
            spec = self._specs.get(tenant_id)
            bounds = None
            if spec is not None:
                bounds = getattr(spec.ocp, "control_bounds", None)
            stats = result.get("stats") or {}
            precheck = ((False, ("watchdog_timeout",))
                        if stats.get("watchdog_timeout") else None)
            decision = guard.assess(result, bounds, precheck=precheck)
            controls = result["u0"] if decision.action == "actuate" \
                else decision.controls
            out[tenant_id] = RoundResult(
                action=decision.action, controls=controls,
                healthy=decision.healthy, reasons=decision.reasons,
                stats=result.get("stats"))
            if m is not None:
                # labelled by guard action: availability (actuated /
                # delivered) is computable from telemetry alone
                m["solves"].inc(action=decision.action)
            self.slo.record_result(tenant_id, decision.action)
            if self._health is not None:
                sick = self._health.is_sick_result(decision.healthy,
                                                   stats)
                if tenant_id in self._sick_marks:
                    # a rejected (NaN) submission this round: the lane's
                    # healthy stale-theta result must not mask it
                    sick = True
                    self._sick_marks.discard(tenant_id)
                if self._health.observe(tenant_id, sick) == "evict":
                    evictions.append(tenant_id)
        for tenant_id in evictions:
            if tenant_id in self._tenant_bucket \
                    and tenant_id not in self._evicted:
                self.evict_tenant(tenant_id, reason="health")
        return out

    # -- durability -----------------------------------------------------------

    def save_checkpoint(self, path: str) -> str:
        """Durable snapshot of the whole plane (crash-safe swap); see
        :func:`agentlib_mpc_torch.serving.checkpoint.save_plane`."""
        from agentlib_mpc_torch.serving.checkpoint import save_plane

        return save_plane(self, path)

    def restore_checkpoint(self, path: str, specs):
        """Rebuild a checkpointed plane into this (empty) one through the
        compile-cache path; returns a :class:`~agentlib_mpc_torch.serving.
        checkpoint.RestoreReport` whose ``total_s`` is the measured
        recovery time."""
        from agentlib_mpc_torch.serving.checkpoint import restore_plane

        return restore_plane(self, path, specs)

    def _export_active(self) -> None:
        if telemetry.enabled():
            gauge = telemetry.serving_metrics()["active"]
            for key, bucket in self._buckets.items():
                gauge.set(float(bucket.n_active), bucket=key.digest)

    # -- introspection --------------------------------------------------------

    @property
    def tenants(self) -> tuple:
        """Registered tenant ids (health-evicted ones included: they are
        still the plane's responsibility)."""
        return tuple(self._tenant_bucket)

    @property
    def evicted_tenants(self) -> tuple:
        return tuple(self._evicted)

    def health_state(self, tenant_id: str) -> "str | None":
        """The tenant's health-ladder state, or None when the ledger is
        disabled."""
        if self._health is None:
            return None
        return self._health.state(tenant_id)

    def slo_report(self) -> dict:
        """Per-tenant SLO / error-budget report
        (:meth:`~agentlib_mpc_torch.telemetry.slo.SLOTracker.report`),
        recomputable offline from the journal
        (:func:`~agentlib_mpc_torch.telemetry.slo.slo_from_events`)."""
        return self.slo.report()

    def stats(self) -> dict:
        return {
            "tenants": len(self._tenant_bucket),
            "evicted": len(self._evicted),
            "buckets": {
                key.digest: {"capacity": b.capacity,
                             "active": b.n_active,
                             "rounds": b.rounds_served}
                for key, b in self._buckets.items()},
            "cache": {"engines": len(self.cache),
                      "hits": self.cache.hits,
                      "misses": self.cache.misses,
                      "evictions": self.cache.evictions},
            "queue": {"pending": len(self.queue),
                      "submitted": self.queue.submitted,
                      "shed_overload": self.queue.shed_overload,
                      "shed_deadline": self.queue.shed_deadline},
            "watchdog": {"stalls": self.dispatcher.stalls,
                         "sync_fallback": self.dispatcher.sync_fallback},
            "warmstart": {"installed": [], "buckets": {}},
            "memory": {"hbm_bytes": self.hbm_bytes,
                       "certified_peak_bytes": {
                           key.digest: None for key in self._buckets}},
            "rounds": self.rounds,
        }


def _refuse_unported(mesh, engine_store, memory_certify, profile_every,
                     autopilot, warmstart, warmstart_tape) -> None:
    """``NotImplementedError`` naming the ROADMAP Queue 1 item of each
    option the port does not have yet."""
    if mesh is not None:
        raise NotImplementedError(
            "ServingPlane(mesh=) (buckets on a device mesh) is not ported "
            "yet (ROADMAP Queue 1 item 5: multi-GPU)")
    if engine_store not in (None, False):
        raise NotImplementedError(
            "ServingPlane(engine_store=) (the cross-process engine store, "
            "serving/store.py over parallel/export.py) is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if autopilot is not None:
        raise NotImplementedError(
            "ServingPlane(autopilot=) (the SLO autopilot, "
            "serving/autopilot.py) is not ported yet (ROADMAP Queue 1 "
            "item 5)")
    if warmstart not in (True, False, "auto"):
        raise ValueError(f"warmstart must be True, False or 'auto', "
                         f"got {warmstart!r}")
    if warmstart is True or warmstart_tape:
        raise NotImplementedError(
            "learned warm starts (warmstart=True, warmstart_tape=True, "
            "install_warmstart; ml/warmstart.py) are not ported yet "
            "(ROADMAP Queue 1 item 5)")
    if profile_every is not None:
        raise NotImplementedError(
            "ServingPlane(profile_every=) (telemetry/profiler."
            "PeriodicCapture) is not ported yet (ROADMAP Queue 1 item 6)")
    if memory_certify not in ("auto", "require", "off"):
        raise ValueError(
            f"memory_certify must be 'auto', 'require' or 'off', "
            f"got {memory_certify!r}")
    if memory_certify == "require":
        raise NotImplementedError(
            "ServingPlane(memory_certify='require') needs the memory "
            "certificate, which is not ported yet (ROADMAP Queue 1 "
            "item 7)")
