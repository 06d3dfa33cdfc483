"""Serving survivability in the port: durable plane state, fault
isolation, the watchdog, robust buckets and a JAX plane carried across.

The contracts of ``tests/test_serving_survivability.py`` on the port's
plane (CPU, float64, the tracker OCP), and against the JAX package where
both can run the same thing:

* the health ledger's transitions equal the JAX ledger's for the same
  verdict sequences;
* crash and restart: a two-bucket plane checkpoints and restores into a
  fresh plane sharing its cache with every tenant a cache hit and the
  state bitwise, then serves the next round bitwise; every refusal of
  ``tests/test_serving_survivability.py:93-190`` (non-empty plane, spec
  drift, missing spec, damaged arrays, dropped manifest, absent path) and
  the topology drift;
* fault isolation: a NaN-storm tenant is evicted within the window and
  re-admitted on probation while its bucket peers stay bitwise
  unaffected; a result-mode storm walks the guard verdicts;
* the watchdog: a stalled round launch sheds its tenants and the
  dispatcher falls back to synchronous dispatch; a stall condemns other
  buckets' in-flight rounds; a flush pays one timeout;
* a capacity-shed join (an explicit memory refusal) sheds into the guard
  ladder until re-admitted;
* one robust tenant bucket on a fan of 2: the actuated u0 identical
  across the group's branches; a single-scenario tree lands in the flat
  bucket;
* a JAX plane carried across (``utils.convert.serving_state_from_jax`` /
  ``load_serving_state``: slots, engine state, thetas, guard and health
  ladders, SLO ledger, queue carryover, round counters) serves its next
  round in the port as in JAX, controls within 1e-8 (the file's one JAX
  reference run).
"""

import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from agentlib_mpc_tpu.lint.retrace_budget import tracker_ocp as jtracker_ocp
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.parallel.fused_admm import FusedADMMOptions as JFO
from agentlib_mpc_tpu.serving import HealthPolicy as JHealthPolicy
from agentlib_mpc_tpu.serving import ServingPlane as JPlane
from agentlib_mpc_tpu.serving import TenantSpec as JSpec
from agentlib_mpc_tpu.serving.health import HealthLedger as JLedger
from agentlib_mpc_torch.ops.solver import SolverOptions
from agentlib_mpc_torch.parallel.fused_admm import (
    FusedADMMOptions,
    stack_params,
)
from agentlib_mpc_torch.reference_configs import tracker_ocp
from agentlib_mpc_torch.resilience.chaos import (
    ChaosBuildError,
    ServeChaosConfig,
    ServeNaNStormRule,
    ServeStallRule,
    corrupt_checkpoint,
    install_serving_chaos,
)
from agentlib_mpc_torch.serving import (
    CompileCache,
    HealthPolicy,
    MemoryBudgetExceeded,
    ServingPlane,
    TenantSpec,
    bucket_key,
    has_plane_checkpoint,
)
from agentlib_mpc_torch.serving.health import (
    EVICTED,
    HEALTHY,
    PROBATION,
    QUARANTINED,
    HealthLedger,
)
from agentlib_mpc_torch.utils.convert import (
    load_serving_state,
    serving_state_from_jax,
)

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: controls of a carried-across JAX plane against the JAX plane's own
U_TOL = 1e-8
ADMM = dict(max_iterations=6, rho=2.0)


@pytest.fixture(scope="module")
def ocp():
    return tracker_ocp()


@pytest.fixture(scope="module")
def cache():
    """One engine cache per file: each bucket structure builds once (a
    shared cache is the supervisor-restart model the crash tests use)."""
    return CompileCache()


def theta(ocp, a):
    return ocp.default_params(device="cpu", dtype=F64,
                              p=torch.tensor([float(a)], dtype=F64))


def make_spec(ocp, tid, a, max_iter=30, couplings=None, **kw):
    return TenantSpec(
        tenant_id=tid, ocp=ocp, theta=theta(ocp, a),
        couplings={"shared_u": "u"} if couplings is None else couplings,
        solver_options=SolverOptions(max_iter=max_iter), **kw)


def make_plane(cache, **kw):
    kw.setdefault("cache", cache)
    kw.setdefault("slot_multiple", 1)
    kw.setdefault("initial_capacity", 4)
    kw.setdefault("pipelined", False)
    kw.setdefault("donate", False)
    return ServingPlane(FusedADMMOptions(**ADMM), device="cpu", dtype=F64,
                        **kw)


def host_state(plane):
    return {key.digest: [t.clone() for t in tree_flatten(b.state)[0]]
            for key, b in plane._buckets.items()}


# -- the health ledger against the JAX package's ------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_transitions_equal_the_jax_ledger(seed):
    rng = np.random.default_rng(seed)
    kw = dict(quarantine_after=2, evict_after=3, readmit_after=2,
              probation_rounds=2)
    t, j = HealthLedger(HealthPolicy(**kw)), JLedger(JHealthPolicy(**kw))
    tenants = ("a", "b", "c")
    for _ in range(60):
        for tid in tenants:
            sick = bool(rng.random() < 0.45)
            assert t.observe(tid, sick) == j.observe(tid, sick)
        due_t, due_j = t.tick_evicted(), j.tick_evicted()
        assert due_t == due_j
        for tid in due_t:
            t.readmitted(tid)
            j.readmitted(tid)
        if rng.random() < 0.05:
            t.force_evict("b")
            j.force_evict("b")
        assert t.snapshot() == j.snapshot()
    for stats in ({"iterations": 6, "quarantined_iters": 6},
                  {"iterations": 6, "quarantined_iters": 2}, None):
        for healthy in (True, False):
            assert t.is_sick_result(healthy, stats) == \
                j.is_sick_result(healthy, stats)
    clone = HealthLedger(t.policy)
    clone.restore(t.snapshot())
    assert clone.snapshot() == t.snapshot()


def test_health_ladder_states():
    ledger = HealthLedger(HealthPolicy(quarantine_after=2, evict_after=3,
                                       readmit_after=2, probation_rounds=2))
    assert ledger.observe("t", True) is None and ledger.state("t") == HEALTHY
    ledger.observe("t", True)
    assert ledger.state("t") == QUARANTINED
    assert ledger.observe("t", True) == "evict"
    assert ledger.state("t") == EVICTED
    assert ledger.tick_evicted() == [] and ledger.tick_evicted() == ["t"]
    ledger.readmitted("t")
    assert ledger.state("t") == PROBATION
    assert ledger.observe("t", True) == "evict"     # one sick round


# -- crash and restart ---------------------------------------------------------


@pytest.fixture(scope="module")
def saved(ocp, cache, tmp_path_factory):
    plane = make_plane(cache)
    # two structure buckets: max_iter 30 and 31 are two engines
    specs = {tid: make_spec(ocp, tid, a, max_iter=mi)
             for tid, a, mi in [("a", 1.0, 30), ("b", 3.0, 30),
                                ("c", 2.0, 31), ("d", -1.0, 31)]}
    for spec in specs.values():
        plane.join(spec)
    for _ in range(2):
        for tid in plane.tenants:
            plane.submit(tid)
        plane.serve_round()
    plane.submit("a")             # queue carryover
    path = str(tmp_path_factory.mktemp("ckpt") / "plane")
    plane.save_checkpoint(path)
    state = host_state(plane)
    slots = {k.digest: list(b.slots) for k, b in plane._buckets.items()}
    # the uninterrupted plane's next round
    nxt = plane.serve_round()
    return {"plane": plane, "specs": specs, "path": path, "state": state,
            "slots": slots, "next": nxt}


def test_restore_is_all_cache_hits_and_bitwise(saved, cache):
    assert has_plane_checkpoint(saved["path"])
    fresh = make_plane(cache)
    report = fresh.restore_checkpoint(saved["path"], saved["specs"])
    assert sorted(report.tenants) == ["a", "b", "c", "d"]
    assert report.buckets == 2 and report.cold_builds == 0
    assert report.cache_hits == 4 and report.requeued == 1
    assert set(report.per_tenant_s) == {"a", "b", "c", "d"}
    for key, bucket in fresh._buckets.items():
        assert list(bucket.slots) == saved["slots"][key.digest]
        for x, y in zip(saved["state"][key.digest],
                        tree_flatten(bucket.state)[0]):
            assert torch.equal(x, y)
    # the carried request serves a's bucket (its members all deliver),
    # as the uninterrupted plane's next round did, bitwise
    res = fresh.serve_round()
    assert set(res) == set(saved["next"]) == {"a", "b"}
    for tid, r in res.items():
        assert r.action == saved["next"][tid].action == "actuate"
        assert r.controls == saved["next"][tid].controls


def test_restore_refusals(saved, cache, ocp, tmp_path):
    fresh = make_plane(cache)
    fresh.join(make_spec(ocp, "squatter", 0.5))
    with pytest.raises(ValueError, match="EMPTY"):
        fresh.restore_checkpoint(saved["path"], saved["specs"])
    drifted = dict(saved["specs"])
    drifted["a"] = make_spec(ocp, "a", 1.0, max_iter=77)
    with pytest.raises(ValueError, match="fingerprints into"):
        make_plane(cache).restore_checkpoint(saved["path"], drifted)
    partial = {t: s for t, s in saved["specs"].items() if t != "c"}
    with pytest.raises(KeyError, match="'c'"):
        make_plane(cache).restore_checkpoint(saved["path"], partial)
    with pytest.raises(ValueError, match="topology"):
        make_plane(cache, slot_multiple=2).restore_checkpoint(
            saved["path"], saved["specs"])
    with pytest.raises(FileNotFoundError):
        make_plane(cache).restore_checkpoint(str(tmp_path / "nope"),
                                             saved["specs"])


@pytest.mark.parametrize("mode", ["truncate", "drop-manifest"])
def test_damaged_checkpoint_is_refused(saved, cache, tmp_path, mode):
    copy = str(tmp_path / "plane")
    shutil.copytree(saved["path"], copy)
    corrupt_checkpoint(copy, mode=mode)
    if mode == "drop-manifest":
        assert not has_plane_checkpoint(copy)
    with pytest.raises((ValueError, RuntimeError),
                       match="manifest" if mode == "drop-manifest"
                       else "arrays"):
        make_plane(cache).restore_checkpoint(copy, saved["specs"])


def test_leave_of_restored_evicted_tenant_without_bucket(ocp, cache):
    plane = make_plane(cache, health_policy=HealthPolicy())
    spec = plane._door_spec(make_spec(ocp, "ghost", 1.0))
    key = bucket_key(spec)
    plane._register_tenant("ghost", key, spec)
    plane._evicted["ghost"] = key
    plane.leave("ghost")
    assert plane.tenants == () and plane.evicted_tenants == ()
    assert plane._guards == {} and plane._specs == {}


# -- fault isolation -------------------------------------------------------------


@pytest.mark.chaos
def test_nan_tenant_evicted_peers_bitwise_unaffected(ocp, cache):
    policy = HealthPolicy(quarantine_after=1, evict_after=2,
                          readmit_after=2, probation_rounds=1)
    tenants = [("sick", 0.0), ("h1", 1.0), ("h2", -2.0)]

    def run(with_chaos):
        plane = make_plane(cache, health_policy=policy)
        for tid, a in tenants:
            plane.join(make_spec(ocp, tid, a, couplings={}))
        ctl = None
        if with_chaos:
            ctl = install_serving_chaos(plane, ServeChaosConfig(
                nan_storm=(ServeNaNStormRule(
                    tenant="sick", start_round=0, n_rounds=4),)))
        history, evicted_at = [], None
        for r in range(10):
            for tid, a in tenants:
                if tid not in plane.evicted_tenants:
                    plane.submit(tid, theta=theta(ocp, a + 0.01 * r))
            res = plane.serve_round()
            history.append({t: v.controls["u"] if v.action == "actuate"
                            else None for t, v in res.items()})
            if evicted_at is None and "sick" in plane.evicted_tenants:
                evicted_at = r
        if ctl is not None:
            ctl.uninstall()
            assert ctl.count("serve_nan_theta") >= 1
        return plane, history, evicted_at

    _, clean, _ = run(False)
    plane, chaos, evicted_at = run(True)
    assert evicted_at is not None and evicted_at <= 2
    assert "sick" not in plane.evicted_tenants
    assert plane.health_state("sick") in (HEALTHY, PROBATION)
    assert chaos[-1]["sick"] is not None
    for r, (a, b) in enumerate(zip(clean, chaos)):
        for tid in ("h1", "h2"):
            assert a[tid] is not None and a[tid] == b[tid], (r, tid)


@pytest.mark.chaos
def test_result_mode_storm_walks_guard_verdicts(ocp, cache):
    plane = make_plane(cache, health_policy=HealthPolicy(
        quarantine_after=1, evict_after=2, readmit_after=8,
        probation_rounds=1))
    plane.join(make_spec(ocp, "v", 1.0, couplings={}))
    plane.join(make_spec(ocp, "w", 2.0, couplings={}))
    ctl = install_serving_chaos(plane, ServeChaosConfig(
        nan_storm=(ServeNaNStormRule(tenant="v", mode="result",
                                     start_round=0, n_rounds=6),)))
    actions = []
    for _ in range(4):
        for tid in ("v", "w"):
            if tid not in plane.evicted_tenants:
                plane.submit(tid)
        actions.append({t: r.action for t, r in
                        plane.serve_round().items()})
    ctl.uninstall()
    assert plane.health_state("v") == EVICTED
    assert any(a.get("v") in ("replay", "hold", "fallback")
               for a in actions)
    assert all(a["w"] == "actuate" for a in actions if "w" in a)


# -- the watchdog ------------------------------------------------------------------


@pytest.mark.chaos
def test_stalled_round_sheds_and_falls_back_to_sync(ocp, cache):
    plane = make_plane(cache, pipelined=True, donate=True,
                       watchdog_timeout_s=0.5)
    plane.join(make_spec(ocp, "a", 1.0))
    plane.join(make_spec(ocp, "b", 3.0))
    # launch call 2 is round 2's: it hangs past the watchdog
    ctl = install_serving_chaos(plane, ServeChaosConfig(
        stall=(ServeStallRule(call=2, duration_s=3.0),)))
    for _ in range(2):
        for t in ("a", "b"):
            plane.submit(t)
        res = plane.serve_round()
    assert all(r.action == "actuate" for r in res.values())
    rounds_before = plane._buckets[bucket_key(
        plane._specs["a"])].rounds_served
    for t in ("a", "b"):
        plane.submit(t)
    res = plane.serve_round()                  # the watchdog fires
    assert set(res) == {"a", "b"}
    assert all(not r.healthy and r.action in ("replay", "hold",
                                              "fallback")
               for r in res.values())
    d = plane.dispatcher
    assert d.stalls == 1 and d.sync_fallback and not d.pipelined
    assert d.last_probe == "cpu"
    for t in ("a", "b"):
        plane.submit(t)
    res = plane.serve_round()                  # sync, recovered
    assert all(r.action == "actuate" for r in res.values())
    ctl.uninstall()
    assert ctl.count("serve_stall") == 1
    # the abandoned launch never runs late: after its stall ends, the
    # bucket has served only the rounds the plane ran
    time.sleep(3.2)
    bucket = plane._buckets[bucket_key(plane._specs["a"])]
    assert bucket.rounds_served == rounds_before + 1


class _FakeHandle:
    def __init__(self, served):
        self.served = served


class _FakePlane:
    def __init__(self, name, hang=False):
        self.name, self.hang, self.launched = name, hang, 0

    def served_now(self):
        return ((f"{self.name}{self.launched + 1}", 0),)

    def launch_round(self):
        self.launched += 1
        return _FakeHandle(((f"{self.name}{self.launched}", 0),))

    def materialize(self, handle):
        if self.hang:
            time.sleep(5.0)
        return {t: {"u0": {}} for t, _ in handle.served}


def test_stall_condemns_other_buckets_inflight_rounds():
    from agentlib_mpc_torch.serving.dispatch import (
        PipelinedDispatcher,
        RoundTimeout,
    )

    d = PipelinedDispatcher(pipelined=True, timeout_s=0.2, device="cpu")
    a, b = _FakePlane("a", hang=True), _FakePlane("b")
    assert d.dispatch("A", a) is None
    assert d.dispatch("B", b) is None
    res = d.dispatch("A", a)                   # A's decode stalls
    assert isinstance(res, RoundTimeout)
    assert {t for t, _ in res.served} == {"a1", "a2"}
    failed = d.drain_failed()
    assert set(failed) == {"B"}
    assert {t for t, _ in failed["B"].served} == {"b1"}
    assert d.flush() == {} and not d.pipelined and d.sync_fallback


def test_flush_condemns_rest_after_first_stall():
    from agentlib_mpc_torch.serving.dispatch import (
        PipelinedDispatcher,
        RoundTimeout,
    )

    d = PipelinedDispatcher(pipelined=True, timeout_s=0.2, device="cpu")
    for k in ("A", "B", "C"):
        d.dispatch(k, _FakePlane(k, hang=True))
    t0 = time.perf_counter()
    out = d.flush()
    assert set(out) == {"A", "B", "C"}
    assert all(isinstance(v, RoundTimeout) for v in out.values())
    assert time.perf_counter() - t0 < 2.0 and d.stalls == 1


def test_probe_device_bounded_answers_on_the_cpu():
    from agentlib_mpc_torch.serving.dispatch import probe_device_bounded

    assert probe_device_bounded(5.0, "cpu") == "cpu"


# -- chaos config and the build seam -------------------------------------------


def test_serve_chaos_config():
    with pytest.raises(ValueError, match="unknown serve-chaos"):
        ServeChaosConfig.from_dict({"nope": 1})
    cfg = ServeChaosConfig.from_dict({
        "seed": 3, "nan_storm": [{"tenant": "x", "n_rounds": 2}],
        "stall": [{"call": 1, "duration_s": 0.1}],
        "build_fail": [{"build": 0}],
        "overload": [{"deadline_s": 0.01}]})
    assert cfg.seed == 3 and cfg.nan_storm[0].tenant == "x"
    assert cfg.stall[0].call == 1 and cfg.build_fail[0].triggered(0)
    assert cfg.overload[0].triggered(5)


def test_build_fail_propagates_from_join(ocp):
    plane = make_plane(CompileCache())
    ctl = install_serving_chaos(plane, ServeChaosConfig(
        build_fail=(ServeChaosConfig.from_dict(
            {"build_fail": [{"build": 0}]}).build_fail[0],)))
    with pytest.raises(ChaosBuildError):
        plane.join(make_spec(ocp, "x", 1.0))
    assert plane.tenants == () and len(plane.cache) == 0
    ctl.uninstall()


def test_capacity_shed_join_walks_the_ladder(ocp, cache, monkeypatch):
    """A join the memory budget refuses (here an explicit refusal: the
    memory certificate comes with ROADMAP Queue 1 item 7) registers the
    tenant without a slot; its submissions shed into its guard ladder
    until it is re-admitted."""
    plane = make_plane(cache)
    acquire = plane._acquire_bucket

    def refuse(*a, **kw):
        raise MemoryBudgetExceeded("over the budget")

    monkeypatch.setattr(plane, "_acquire_bucket", refuse)
    rec = plane.join(make_spec(ocp, "x", 1.0))
    assert rec.slot == -1 and not rec.engine_cached
    assert plane.evicted_tenants == ("x",)
    decision = plane.submit("x")
    assert decision is not None and decision.action == "fallback"
    monkeypatch.setattr(plane, "_acquire_bucket", acquire)
    assert plane.readmit_tenant("x")
    # healthy rounds walk the guard back up its recovery hysteresis
    actions = []
    for _ in range(plane.guard_policy.recovery_steps + 1):
        plane.submit("x")
        res = plane.serve_round()["x"]
        assert res.healthy
        actions.append(res.action)
    assert actions[-1] == "actuate"


# -- robust buckets --------------------------------------------------------------


def test_robust_bucket_on_a_fan_of_two(ocp, cache):
    from agentlib_mpc_torch.scenario import (
        ScenarioFleetOptions,
        fan_tree,
        single_scenario,
    )

    plane = make_plane(cache)
    tree = fan_tree(2, robust_horizon=1)
    opts = ScenarioFleetOptions(max_iterations=6, rho=2.0, rho_na=4.0)
    for tid, a in (("r1", 1.0), ("r2", 2.0)):
        plane.join(TenantSpec(
            tenant_id=tid, ocp=ocp,
            theta=stack_params([theta(ocp, a), theta(ocp, a + 0.5)]),
            couplings={"shared_u": "u"},
            solver_options=SolverOptions(max_iter=30),
            scenario_tree=tree, scenario_options=opts))
    flat = plane.join(make_spec(ocp, "f", 1.5))
    s1 = plane.join(TenantSpec(
        tenant_id="s1", ocp=ocp, theta=stack_params([theta(ocp, 1.5)]),
        couplings={"shared_u": "u"},
        solver_options=SolverOptions(max_iter=30),
        scenario_tree=single_scenario()))
    assert s1.bucket == flat.bucket           # S=1 is the flat bucket
    robust = [b for b in plane._buckets.values()
              if getattr(b, "n_scenarios", 1) == 2]
    assert len(robust) == 1 and robust[0].n_active == 2
    for _ in range(2):
        for tid in plane.tenants:
            plane.submit(tid)
        res = plane.serve_round()
        u0 = robust[0].engine.actuated_u0(robust[0].state)
        for tid in ("r1", "r2"):
            slot = robust[0].slot_of(tid)
            assert res[tid].action == "actuate"
            assert torch.equal(u0[slot, 0], u0[slot, 1])
            assert res[tid].controls["u"] == float(u0[slot, 0, 0])
            assert len(res[tid].stats["branch_quarantined"]) == 2
    plane.submit("r1", theta=stack_params([theta(ocp, 1.0)] * 3))
    with pytest.raises(ValueError, match="branch"):
        plane.serve_round()


# -- a JAX plane carried across --------------------------------------------------


def test_jax_plane_carried_across_serves_its_next_round(ocp, cache):
    jocp = jtracker_ocp()
    targets = {"a": 1.0, "b": 3.0, "c": -1.0}
    jplane = JPlane(JFO(**ADMM), slot_multiple=1, initial_capacity=4,
                    pipelined=False, donate=False,
                    health_policy=JHealthPolicy())
    for tid, a in targets.items():
        jplane.join(JSpec(tenant_id=tid, ocp=jocp,
                          theta=jocp.default_params(p=jnp.array([a])),
                          couplings={"shared_u": "u"},
                          solver_options=JSO(max_iter=30)))
    for r in range(3):
        for tid, a in targets.items():
            jplane.submit(tid, theta=jocp.default_params(
                p=jnp.array([a + 0.1 * r])))
        jplane.serve_round()
    jplane.submit("a")                         # carried in the queue
    state = serving_state_from_jax(jplane)

    plane = make_plane(cache, health_policy=HealthPolicy())
    specs = {tid: make_spec(ocp, tid, a) for tid, a in targets.items()}
    buckets, _per_tenant, requeued = load_serving_state(plane, state,
                                                        specs)
    assert buckets == 1 and requeued == 1
    assert plane.served_rounds == jplane.served_rounds == 3
    assert plane.rounds == jplane.rounds
    assert plane.slo.snapshot() == jplane.slo.snapshot()
    for tid in targets:
        assert plane._guards[tid].snapshot() == \
            jplane._guards[tid].snapshot()
    for tid in ("b", "c"):
        jplane.submit(tid, theta=jocp.default_params(
            p=jnp.array([targets[tid] + 0.5])))
        plane.submit(tid, theta=theta(ocp, targets[tid] + 0.5))
    j_res, t_res = jplane.serve_round(), plane.serve_round()
    assert set(t_res) == set(j_res) == set(targets)
    for tid, r in t_res.items():
        assert r.action == j_res[tid].action == "actuate"
        assert abs(r.controls["u"] - float(j_res[tid].controls["u"])) \
            <= U_TOL
    with pytest.raises(ValueError, match="EMPTY"):
        load_serving_state(plane, state, specs)
