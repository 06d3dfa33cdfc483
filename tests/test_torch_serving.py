"""The port's serving plane against the JAX package's, on the CPU.

``agentlib_mpc_torch/serving/`` and ``agentlib_mpc_tpu/serving/`` on the
tracker OCP of the JAX package's serving tests
(``agentlib_mpc_torch.reference_configs.tracker_ocp``, its copy of
``agentlib_mpc_tpu/lint/retrace_budget.py:104-124``; the fingerprints are
in ``tests/test_torch_serving_fingerprint.py``):

* ``churn_schedule`` equals the JAX package's event for event (seeds 0-3);
* one shared f64 churn run (5 tenants, 6 rounds, sync, 2 initial slots
  so the bucket grows and migrates, a queue of 2 so overload sheds walk
  the guard ladder) through both planes: equal
  actions per tenant and round, controls within 1e-8, equal ``stats()``
  counters (cache hits and misses, sheds, rounds);
* port-only contracts of ``tests/test_serving.py``: padded plus mask
  equals the unpadded fleet (1e-5, that file's tolerance), admission
  sheds walk the guard ladder, a tenant that leaves while its round is in
  flight is dropped, the cache's LRU bound, the backend's
  ``problem_fingerprint``, and every deferred option names its ROADMAP
  item;
* the SLO tracker's tallies and ``slo_from_events`` equal the JAX
  package's on the same verdicts and the same journal, and the journal's
  tape is read by both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.lint.retrace_budget import tracker_ocp as jtracker_ocp
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.parallel.fused_admm import FusedADMMOptions as JFO
from agentlib_mpc_tpu.resilience import chaos as jchaos
from agentlib_mpc_tpu.resilience.guard import DegradationPolicy as JDP
from agentlib_mpc_tpu.serving import ServingPlane as JPlane
from agentlib_mpc_tpu.serving import TenantSpec as JSpec
from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.ops.solver import SolverOptions
from agentlib_mpc_torch.parallel.fused_admm import (
    AgentGroup,
    FusedADMM,
    FusedADMMOptions,
    stack_params,
)
from agentlib_mpc_torch.reference_configs import tracker_ocp
from agentlib_mpc_torch.resilience.chaos import churn_schedule
from agentlib_mpc_torch.resilience.guard import DegradationPolicy
from agentlib_mpc_torch.serving import CompileCache, ServingPlane, TenantSpec

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: controls of the two planes (f64; bitwise equal in practice)
U_TOL = 1e-8
#: tests/test_serving.py's padded-lane tolerance
PAD_ATOL = 1e-5
ADMM = dict(max_iterations=6, rho=2.0)
CHURN = (1, 5, 6)            # seed, tenants, rounds
TARGETS = {f"t{i:03d}": -2.0 + 1.3 * i for i in range(5)}


@pytest.fixture(scope="module")
def ocp():
    return tracker_ocp()


@pytest.fixture(scope="module")
def jocp():
    return jtracker_ocp()


def theta(ocp, a):
    return ocp.default_params(device="cpu", dtype=F64,
                              p=torch.tensor([float(a)], dtype=F64))


def make_spec(ocp, tid, a, **kw):
    kw.setdefault("couplings", {"shared_u": "u"})
    kw.setdefault("solver_options", SolverOptions(max_iter=30))
    return TenantSpec(tenant_id=tid, ocp=ocp, theta=theta(ocp, a), **kw)


def cpu_plane(**kw):
    kw.setdefault("slot_multiple", 1)
    kw.setdefault("initial_capacity", 4)
    kw.setdefault("pipelined", False)
    kw.setdefault("donate", False)
    return ServingPlane(FusedADMMOptions(**ADMM), device="cpu", dtype=F64,
                        **kw)


def test_backend_exposes_problem_fingerprint():
    """tests/test_serving.py's TestBackendSeam in the port."""
    from agentlib_mpc_torch.backends.backend import (
        VariableReference,
        create_backend,
    )

    backend = create_backend({
        "type": "jax", "model": {"class": "LinearRCZone"},
        "discretization_options": {"collocation_order": 2},
    }, device="cpu")
    with pytest.raises(RuntimeError):
        backend.problem_fingerprint()    # no OCP yet
    backend.setup_optimization(
        VariableReference(
            states=["T", "T_slack"], controls=["Q"],
            inputs=["load", "T_amb", "T_upper"],
            parameters=["C", "R", "s_T", "r_Q"]),
        time_step=300.0, prediction_horizon=4)
    fp = backend.problem_fingerprint()
    assert fp.digest
    assert backend.problem_fingerprint() is fp


# -- churn: the schedule and one shared run of both planes ----------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_churn_schedule_equals_the_jax_package(seed):
    for n, rounds in ((6, 30), (256, 16)):
        assert churn_schedule(seed, n, rounds) == \
            jchaos.churn_schedule(seed, n, rounds)


def _churn(plane, mk_spec, mk_theta):
    """CHURN's schedule; every member submits its drifted target. Per
    round the submit decisions (sheds) and the served results."""
    out = []
    for r, events in enumerate(churn_schedule(*CHURN)):
        for kind, tid in events:
            if kind == "join":
                plane.join(mk_spec(tid, TARGETS[tid]))
            else:
                plane.leave(tid)
        shed = {}
        for tid in plane.tenants:
            d = plane.submit(tid, theta=mk_theta(TARGETS[tid] + 0.1 * r))
            if d is not None:
                shed[tid] = d.action
        res = plane.serve_round()
        out.append((shed, {t: (v.action, None if v.controls is None
                               else float(v.controls["u"]))
                           for t, v in res.items()}))
    return out


def _counters(stats):
    return {"cache": {k: stats["cache"][k] for k in ("hits", "misses")},
            "queue": {k: stats["queue"][k] for k in
                      ("submitted", "shed_overload", "shed_deadline")},
            "rounds": stats["rounds"],
            "buckets": sorted((b["capacity"], b["active"], b["rounds"])
                              for b in stats["buckets"].values())}


@pytest.fixture(scope="module")
def churn_runs(ocp, jocp):
    """The one JAX reference run of this file and the port's."""
    jplane = JPlane(JFO(**ADMM), slot_multiple=1, initial_capacity=2,
                    pipelined=False, donate=False, queue_limit=2,
                    guard_policy=JDP(replay_steps=1, hold_steps=1))
    j = _churn(jplane,
               lambda tid, a: JSpec(
                   tenant_id=tid, ocp=jocp,
                   theta=jocp.default_params(p=jnp.array([a])),
                   couplings={"shared_u": "u"},
                   solver_options=JSO(max_iter=30)),
               lambda a: jocp.default_params(p=jnp.array([a])))
    tplane = cpu_plane(initial_capacity=2, queue_limit=2,
                       guard_policy=DegradationPolicy(replay_steps=1,
                                                      hold_steps=1))
    t = _churn(tplane, lambda tid, a: make_spec(ocp, tid, a),
               lambda a: theta(ocp, a))
    return {"jax": (j, jplane.stats()), "port": (t, tplane.stats())}


def test_churn_actions_and_controls_equal(churn_runs):
    (j, _), (t, _) = churn_runs["jax"], churn_runs["port"]
    assert len(j) == len(t) == CHURN[2]
    sheds = 0
    for r, ((j_shed, j_res), (t_shed, t_res)) in enumerate(zip(j, t)):
        assert t_shed == j_shed, r
        sheds += len(t_shed)
        assert set(t_res) == set(j_res), r
        for tid, (action, u) in t_res.items():
            assert action == j_res[tid][0], (r, tid)
            if u is None:
                assert j_res[tid][1] is None
            else:
                assert abs(u - j_res[tid][1]) <= U_TOL, (r, tid)
    assert sheds > 0           # the queue of 2 shed, in both packages


def test_churn_stats_counters_equal(churn_runs):
    assert _counters(churn_runs["port"][1]) == \
        _counters(churn_runs["jax"][1])
    # the bucket grew past its initial 2 slots: a second engine, the
    # sitting tenants migrated
    port = churn_runs["port"][1]
    assert port["cache"]["misses"] == 2 and port["cache"]["hits"] >= 1
    assert [b["capacity"] for b in port["buckets"].values()] == [3]


# -- port-only contracts of tests/test_serving.py --------------------------------


def test_lifecycle_cache_and_recycled_slot(ocp):
    plane = cpu_plane(pipelined=True)
    r1 = plane.join(make_spec(ocp, "a1", 1.0))
    r2 = plane.join(make_spec(ocp, "a2", 3.0))
    assert not r1.engine_cached and r2.engine_cached
    for t in ("a1", "a2"):
        plane.submit(t)
    assert plane.serve_round() == {}          # pipelined: round 0 in flight
    res = plane.flush()
    assert set(res) == {"a1", "a2"}
    assert all(r.action == "actuate" for r in res.values())
    assert all(1.0 < r.controls["u"] < 3.0 for r in res.values())
    plane.leave("a1")
    plane.leave("a2")
    assert plane.tenants == () and plane.stats()["buckets"] == {}
    # a rejoin after the bucket retired is a cache hit, and the recycled
    # slot 0 starts fresh: it tracks ITS target, not the old tenant's
    rec = plane.join(make_spec(ocp, "new", 4.0, couplings={}))
    assert rec.slot == 0
    plane.submit("new")
    plane.serve_round()
    assert abs(plane.flush()["new"].controls["u"] - 4.0) < 0.1


def test_padded_plus_mask_equals_unpadded_fleet(ocp):
    opts = FusedADMMOptions(**ADMM)
    so = SolverOptions(max_iter=30)
    th2 = stack_params([theta(ocp, 1.0), theta(ocp, 3.0)])
    ref = FusedADMM([AgentGroup(name="ref", ocp=ocp, n_agents=2,
                                couplings={"shared_u": "u"},
                                solver_options=so)], opts, device="cpu")
    sref, tref, _ = ref.step(ref.init_state([th2]), [th2])
    th4 = stack_params([theta(ocp, a) for a in (1.0, 3.0, 7.0, -7.0)])
    pad = FusedADMM([AgentGroup(name="padded", ocp=ocp, n_agents=4,
                                couplings={"shared_u": "u"},
                                solver_options=so)], opts, device="cpu")
    mask = torch.tensor([True, True, False, False])
    sp, tpad, _ = pad.step(pad.init_state([th4]), [th4], active=[mask])
    np.testing.assert_allclose(tpad[0]["u"][:2].numpy(),
                               tref[0]["u"].numpy(), atol=PAD_ATOL)
    np.testing.assert_allclose(sp.zbar["shared_u"].numpy(),
                               sref.zbar["shared_u"].numpy(),
                               atol=PAD_ATOL)


def test_overload_and_deadline_sheds_walk_the_guard_ladder(ocp):
    plane = cpu_plane(initial_capacity=2, queue_limit=1,
                      guard_policy=DegradationPolicy(replay_steps=1,
                                                     hold_steps=1))
    plane.join(make_spec(ocp, "t1", 1.0))
    plane.join(make_spec(ocp, "t2", 2.0))
    plane.submit("t1")
    first = plane.submit("t2")                 # queue full: shed
    assert first is not None and first.action == "fallback"
    assert plane.serve_round()["t1"].action == "actuate"
    plane.submit("t1", deadline_s=0.1, now=0.0)
    res = plane.serve_round(now=5.0)           # expired: replay
    assert res["t1"].action == "replay" and not res["t1"].healthy
    assert plane.queue.shed_deadline == 1
    plane.submit("t1")
    res = plane.serve_round()
    assert res["t1"].action == "actuate" and res["t1"].healthy
    # NaN parameters are refused at the door, into the ladder
    bad = theta(ocp, 1.0)._replace(p=torch.tensor([float("nan")],
                                                  dtype=F64))
    assert plane.submit("t1", theta=bad).action != "actuate"


def test_tenant_left_while_in_flight_is_dropped(ocp):
    plane = cpu_plane(pipelined=True)
    plane.join(make_spec(ocp, "stay", 1.0))
    plane.join(make_spec(ocp, "goer", 3.0))
    plane.submit("stay")
    plane.submit("goer")
    plane.serve_round()                        # round in flight
    plane.leave("goer")
    res = plane.flush()
    assert "goer" not in res and res["stay"].action == "actuate"


def test_dispatcher_flush_with_dead_bucket_key():
    from agentlib_mpc_torch.serving.dispatch import PipelinedDispatcher

    d = PipelinedDispatcher(pipelined=True, device="cpu")
    assert d.flush("no-such-bucket") == {} and d.flush() == {}


def test_cache_lru_bound_and_metric():
    built = []

    def builder(tag):
        def build():
            built.append(tag)
            return f"engine-{tag}"
        return build

    evictions = telemetry.metrics().counter("serving_cache_evictions_total")
    before = {k: evictions.value(bucket=k) or 0.0 for k in "AB"}
    cache = CompileCache(max_engines=2)
    cache.get_or_build("A", builder("A"), label="A")
    cache.get_or_build("B", builder("B"), label="B")
    assert cache.get_or_build("A", builder("A"), label="A")[1]
    cache.get_or_build("C", builder("C"), label="C")       # evicts B
    assert cache.evictions == 1 and "B" not in cache
    assert not cache.get_or_build("B", builder("B"), label="B")[1]
    assert built == ["A", "B", "C", "B"] and len(cache) == 2
    # B evicted by C, then A by B's return: one count per bucket label
    assert all(evictions.value(bucket=k) - before[k] == 1 for k in "AB")
    unbounded = CompileCache()
    for i in range(64):
        unbounded.get_or_build(i, lambda i=i: i)
    assert len(unbounded) == 64 and unbounded.evictions == 0
    with pytest.raises(ValueError, match="max_engines"):
        CompileCache(max_engines=0)


def test_auto_dispatch_resolves_by_device():
    plane = ServingPlane(device="cpu")
    assert plane.dispatcher.pipelined is False and plane.donate is False


def test_plane_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingPlane()


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "item 5"),
    (dict(engine_store=True), "item 5"),
    (dict(autopilot=object()), "item 5"),
    (dict(warmstart=True), "item 5"),
    (dict(warmstart_tape=True), "item 5"),
    (dict(profile_every=4), "item 6"),
    (dict(memory_certify="require"), "item 7"),
])
def test_deferred_options_name_their_item(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        ServingPlane(device="cpu", **kwargs)


def test_deferred_calls_name_their_item():
    from agentlib_mpc_torch.parallel.multihost import serving_slot_multiple
    from agentlib_mpc_torch.resilience.chaos import ServeChaosConfig

    assert serving_slot_multiple() == 1
    with pytest.raises(NotImplementedError, match="item 5"):
        serving_slot_multiple(object())
    with pytest.raises(NotImplementedError, match="item 5"):
        ServingPlane(device="cpu").install_warmstart(object())
    with pytest.raises(NotImplementedError, match="item 5"):
        ServeChaosConfig.from_dict({"warmstart_poison": [{}]})


# -- SLO and journal against the JAX package -----------------------------------


def test_slo_tracker_equals_the_jax_package():
    from agentlib_mpc_torch.telemetry.slo import SLOPolicy, SLOTracker
    from agentlib_mpc_tpu.telemetry.slo import SLOPolicy as JPolicy
    from agentlib_mpc_tpu.telemetry.slo import SLOTracker as JTracker

    rng = np.random.default_rng(5)
    t = SLOTracker(SLOPolicy(windows=(2, 5)))
    j = JTracker(JPolicy(windows=(2, 5)))
    actions = ("actuate", "actuate", "actuate", "replay", "hold",
               "fallback")
    for r in range(12):
        for tid in ("a", "b", "c"):
            if rng.random() < 0.8:
                act = actions[rng.integers(len(actions))]
                miss = bool(rng.random() < 0.1)
                t.record_result(tid, act, deadline_missed=miss)
                j.record_result(tid, act, deadline_missed=miss)
        if r == 7:
            t.forget("c")
            j.forget("c")
        assert t.tick_round(r) == j.tick_round(r)
    assert t.report() == j.report()
    assert t.burn_rates() == j.burn_rates()
    clone = SLOTracker(SLOPolicy(windows=(2, 5)))
    clone.restore(t.snapshot())
    assert clone.report() == t.report()


def test_journal_and_offline_slo_across_packages(ocp, tmp_path):
    """The port's plane journals its rounds; both packages read the tape,
    and both ``slo_from_events`` rebuild the live report from it."""
    from agentlib_mpc_torch.telemetry import journal as tjournal
    from agentlib_mpc_torch.telemetry.slo import slo_from_events
    from agentlib_mpc_tpu.telemetry import journal as jjournal
    from agentlib_mpc_tpu.telemetry.slo import slo_from_events as jslo

    path = str(tmp_path / "journal.jsonl")
    telemetry.enable_journal(path)
    try:
        plane = cpu_plane(queue_limit=1)
        plane.join(make_spec(ocp, "a", 1.0))
        plane.join(make_spec(ocp, "b", 2.0))
        for _ in range(3):
            plane.submit("a")
            plane.submit("b")                  # shed: queue of 1
            plane.serve_round()
        live = plane.slo_report()
    finally:
        telemetry.disable_journal()
    events = tjournal.read_events(path)
    assert events == jjournal.read_events(path)
    assert [e["seq"] for e in events] == list(range(1, len(events) + 1))
    kinds = {e["etype"] for e in events}
    assert {"serve.round", "slo.policy", "admission.shed",
            "cache.engine"} <= kinds
    assert slo_from_events(events) == live == jslo(events)
    # a torn tail line is skipped, and a reopened journal resumes seq
    with open(path, "a") as fh:
        fh.write('{"seq": 999, "etype": "torn"')
    assert tjournal.read_events(path) == events
    j = tjournal.Journal(path)
    assert j.record("x.y") == len(events) + 1
    j.close()
