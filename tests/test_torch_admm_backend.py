"""The ADMM backend's option sets and exchange terms, the real-time ADMM
module's protocol, and the ADMM registrations, on the CPU in float64.

* (d) the warm option set of ``ADMMBackend`` against the JAX package's,
  field by field, for the example's solver config and for configs that
  leave ``max_iter``, ``compl_inf_tol`` or ``dual_inf_tol`` unset or set
  them in ``warm_solver``;
* (e) the exchange terms: a cooler whose air flow is an *exchange*
  coupling, solved cold and warm in both packages from the same seeded
  deviations and multipliers (iterations equal, trajectories within
  1e-8); the exchange branch of ``_set_mean_coupling_values`` and
  ``update_lambda`` (and the consensus one) on the same numbers in both
  packages, exactly;
* (g) ``RealtimeADMM`` (``tests/test_admm_realtime.py``'s pair, from
  ``reference_configs.admm_realtime_pair_configs``) without a wall-clock
  run of the MAS: registration on the wire alias, the bounded inbox, the
  skipped trigger and its count, one round of both agents driven by hand
  in two threads, a failing round counted by the worker, the termination
  checks, and ``terminate`` joining the worker (idempotent); the two
  backends solving at once in two threads equal their solves alone;
* (h) the reserved ``admm`` prefix, a module without couplings and a
  coupling that is neither a model input nor output are refused;
* (i) ``jax_admm``/``casadi_admm``, ``admm_local``/``local_admm``,
  ``admm``, ``admm_coordinator`` and ``admm_coordinated`` resolve to the
  port's classes.
"""

import copy
import logging
import threading
import time
import types

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.backends.admm_backend import (
    ADMMBackend,
    ADMMVariableReference,
)
from agentlib_mpc_torch.backends.backend import create_backend
from agentlib_mpc_torch.modules import admm as padmm
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.runtime.module import (
    DEFERRED_MODULE_TYPES,
    MODULE_TYPES,
    create_module,
)
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source
from agentlib_mpc_tpu.backends.admm_backend import (
    ADMMVariableReference as JADMMVariableReference,
)
from agentlib_mpc_tpu.backends.backend import (
    create_backend as jcreate_backend,
)
from agentlib_mpc_tpu.modules import admm as jadmm

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: one augmented solve from the same state, absolute
SOLVE_TOL = 1e-8
N, DT = 8, 300.0


def _cooler_backend_config(solver=None, **extra):
    return {"type": "jax_admm", "model": {"class": "Cooler"},
            "discretization_options": {"collocation_order": 2,
                                       "collocation_method": "legendre"},
            "solver": dict(solver or {}), **extra}


def _both_backends(cfg, jax_cfg=None, **roles):
    """The same backend config set up in both packages (the port on the
    CPU in f64; ``jax_cfg`` replaces the JAX package's)."""
    port = create_backend(copy.deepcopy(cfg), device="cpu", dtype=F64)
    port.setup_optimization(ADMMVariableReference(**roles), DT, N)
    ref = jcreate_backend(copy.deepcopy(jax_cfg or cfg))
    ref.setup_optimization(JADMMVariableReference(**roles), DT, N)
    return port, ref


def _same_options(port, ref):
    for field in ref._fields:
        p, r = getattr(port, field), getattr(ref, field)
        if field == "stage_partition":
            for key in ("n_stages", "block", "n_w", "n_total", "perm"):
                assert tuple(np.ravel(getattr(p, key))) == \
                    tuple(np.ravel(getattr(r, key))), key
        else:
            assert p == r, (field, p, r)


@pytest.mark.parametrize("solver, warm", [
    ({"max_iter": 40}, None),                      # the example's
    ({}, None),                                    # cap 8 applies
    ({"max_iter": 5}, None),                       # below the cap
    ({"max_iter": 40, "compl_inf_tol": 1e-4, "dual_inf_tol": 0.5}, None),
    ({"max_iter": 40}, {"max_iter": 3, "compl_inf_tol": 1e-3}),
    ({}, {"dual_inf_tol": 0.25}),
])
def test_warm_option_set_matches_jax_field_by_field(solver, warm):
    extra = {} if warm is None else {"warm_solver": warm}
    cfg = _cooler_backend_config({**solver, "qp_fast_path": "off"}, **extra)
    port, ref = _both_backends(cfg, controls=["mDot"],
                               couplings=["mDot_out"])
    _same_options(port.solver_options, ref.solver_options)
    _same_options(port.warm_solver_options, ref.warm_solver_options)


def test_exchange_terms_solve_like_jax():
    """The cooler with its air flow as an exchange coupling: f_aug's
    exchange term, cold and warm, from seeded deviations and multipliers;
    the augmented problem stays LQ (the port's "auto" routes it to the
    QP; the JAX package is told so, which spares its sampled probe)."""
    solver = {"max_iter": 40, "kkt_method": "ldl"}
    port, ref = _both_backends(
        _cooler_backend_config({**solver, "qp_fast_path": "auto"}),
        _cooler_backend_config({**solver, "qp_fast_path": "on"}),
        controls=["mDot"], exchange=["mDot_out"])
    assert port.uses_qp_fast_path is True
    assert port._coup_kinds == ref._coup_kinds == {"mDot_out": "output"}
    rng = np.random.default_rng(11)
    variables = {"mDot": 0.02, "mDot__lb": 0.0, "mDot__ub": 0.05,
                 "r_mDot": 1.0, "penalty_factor": 7.5,
                 "admm_exchange_mean_mDot_out":
                     0.01 * rng.standard_normal(N),
                 "admm_exchange_lambda_mDot_out":
                     0.1 * rng.standard_normal(N)}
    for admm_iter in (0, 1):
        variables["admm_iteration"] = admm_iter
        out = port.solve(600.0, copy.deepcopy(variables))
        res = ref.solve(600.0, copy.deepcopy(variables))
        assert out["stats"]["iterations"] == res["stats"]["iterations"]
        assert out["stats"]["success"] and res["stats"]["success"]
        assert abs(out["u0"]["mDot"] - res["u0"]["mDot"]) <= SOLVE_TOL
        np.testing.assert_allclose(out["couplings"]["mDot_out"],
                                   res["couplings"]["mDot_out"], rtol=0,
                                   atol=SOLVE_TOL)
        np.testing.assert_allclose(out["traj"]["u"], res["traj"]["u"],
                                   rtol=0, atol=SOLVE_TOL)


def _protocol_stub(pkg, rng):
    """A stand-in module for the host-side update functions: one
    consensus and one exchange coupling, two neighbors each."""
    own = {"c": rng.standard_normal(4), "e": rng.standard_normal(4)}
    received = {w: [rng.standard_normal(4) for _ in range(2)]
                for w in ("wc", "we")}
    values = {}
    for entry, key in ((pkg.CouplingEntry("c"), "c"),
                       (pkg.ExchangeEntry("e"), "e")):
        values[entry.local] = own[key]
        values[entry.multiplier] = rng.standard_normal(4)
    values["admm_coupling_mean_c"] = np.zeros(4)
    values["admm_exchange_mean_e"] = np.zeros(4)
    wires = {"c": "wc", "e": "we"}
    return types.SimpleNamespace(
        couplings=[pkg.CouplingEntry("c")],
        exchange=[pkg.ExchangeEntry("e")], penalty_factor=3.5,
        _admm_values=values,
        _wire_alias=lambda entry: wires[entry.name],
        participant_values=lambda wire: [v.copy() for v in received[wire]])


def test_mean_and_multiplier_updates_match_jax_exactly():
    port = _protocol_stub(padmm, np.random.default_rng(5))
    ref = _protocol_stub(jadmm, np.random.default_rng(5))
    for pkg, stub in ((padmm, port), (jadmm, ref)):
        pkg.ADMMModule._set_mean_coupling_values(stub)
        pkg.ADMMModule.update_lambda(stub)
    assert port._admm_values.keys() == ref._admm_values.keys()
    for key, value in ref._admm_values.items():
        np.testing.assert_array_equal(port._admm_values[key], value, key)
    # the exchange mean stores the deviation x − mean, the consensus one
    # the mean itself
    vals = port._admm_values
    assert np.allclose(vals["admm_exchange_mean_e"],
                       vals["admm_exchange_e"] - np.mean(
                           [*port.participant_values("we"),
                            vals["admm_exchange_e"]], axis=0))


# -- the real-time module without a wall-clock run ----------------------------


@pytest.fixture(scope="module")
def rt_pair():
    mas = LocalMAS(rc.admm_realtime_pair_configs(),
                   env={"rt": True, "factor": 1.0}, device="cpu", dtype=F64)
    yield mas
    mas.terminate()


def _rt(mas):
    return (mas.agents["Room"].get_module("admm"),
            mas.agents["Cooler"].get_module("admm"))


def _named(obj):
    """A config with every model class replaced by its name."""
    if isinstance(obj, dict):
        return {k: _named(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_named(v) for v in obj]
    return obj.__name__ if isinstance(obj, type) else obj


def test_realtime_configs_are_the_tests():
    import test_admm_realtime as t

    assert _named(rc.admm_realtime_pair_configs()) == _named(
        [t.ROOM, t.COOLER])


def test_realtime_registration_and_inbox(rt_pair):
    room, _ = _rt(rt_pair)
    wire = "admm_coupling_air"
    src = Source(agent_id="Late", module_id="admm")
    var = AgentVariable(name=wire, alias=wire, value=[0.01] * 4, source=src)
    own = AgentVariable(name=wire, alias=wire, value=[0.5] * 4,
                        source=Source(agent_id="Room", module_id="admm"))
    old = room._status
    try:
        room.participant_callback(own)        # its own broadcast: ignored
        assert Source(agent_id="Room", module_id="admm") not in \
            room._registered_participants[wire]
        room._status = padmm.ModuleStatus.at_registration
        room.participant_callback(var)
        link = room._registered_participants[wire][src]
        assert link.status is padmm.ParticipantStatus.not_available
        assert link.pending == 0
        room._status = padmm.ModuleStatus.optimizing
        room.participant_callback(var)
        assert link.status is padmm.ParticipantStatus.available
        assert link.pending == 1
        for i in range(padmm._INBOX_DEPTH + 1):
            room.participant_callback(AgentVariable(
                name=wire, alias=wire, value=[float(i)] * 4, source=src))
        assert link.pending == padmm._INBOX_DEPTH
        assert link.pop().value == [1.0] * 4   # the stalest were evicted
        assert link.pop(timeout=0.01).value == [2.0] * 4
    finally:
        room._status = old
        del room._registered_participants[wire][src]


def test_realtime_trigger_skip_is_counted(rt_pair, caplog):
    room, _ = _rt(rt_pair)
    before = room.overruns
    try:
        with caplog.at_level(logging.ERROR):
            room._fire_trigger()             # idle: arms the worker
            assert room.start_step.is_set()
            room._fire_trigger()             # still pending: skipped
    finally:
        room.start_step.clear()
    assert room.overruns == before + 1
    assert any("still running" in r.message for r in caplog.records)


def test_realtime_termination_checks(rt_pair, caplog):
    room, _ = _rt(rt_pair)
    now = room.env.now
    assert room._check_termination(room.max_iterations, now, time.time())
    assert not room._check_termination(0, now, time.time())
    with caplog.at_level(logging.WARNING):
        assert room._check_termination(1, now,
                                       time.time() - 2 * room.time_step)
    assert any("budget" in r.message for r in caplog.records)
    room._stop.set()
    try:
        assert room._check_termination(0, now, time.time())
    finally:
        room._stop.clear()


def test_realtime_round_by_hand_in_two_threads(rt_pair):
    """One round of both agents (registration window, three iterations
    with blocking receives) run concurrently, as their workers would."""
    modules = _rt(rt_pair)
    errors = []

    def run(module):
        try:
            module.admm_step()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(m,)) for m in modules]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    room, cooler = modules
    for module, other in ((room, "Cooler"), (cooler, "Room")):
        assert Source(agent_id=other, module_id="admm") in \
            module._registered_participants["admm_coupling_air"]
        rows = module._iter_rows
        assert [r["iteration"] for r in rows] == [0, 1, 2]
        assert all(r["stats"]["success"] for r in rows)
    mean = room._admm_values["admm_coupling_mean_mDot"]
    assert mean.shape == (4,) and np.all(np.isfinite(mean))
    # the last iteration's mean is the two agents' average
    np.testing.assert_allclose(
        mean, 0.5 * (room._admm_values["admm_coupling_mDot"]
                     + cooler._admm_values["admm_coupling_mDot_out"]))


def test_realtime_worker_counts_a_failed_round_and_terminate_joins(
        rt_pair, caplog):
    room, cooler = _rt(rt_pair)
    solve = room.backend.solve

    def failing(now, variables):
        raise RuntimeError("injected solver fault")

    room.backend.solve = failing
    try:
        gen = room.process()
        next(gen)                           # starts the worker thread
        worker = room._thread
        assert worker is not None and worker.is_alive()
        with caplog.at_level(logging.ERROR):
            room._fire_trigger()
            deadline = time.time() + 30.0
            while room.failed_rounds == 0 and time.time() < deadline:
                time.sleep(0.02)
        assert room.failed_rounds == 1
        assert any("ADMM round failed" in r.message
                   for r in caplog.records)
    finally:
        room.backend.solve = solve
        room.terminate()
    assert room._thread is None and not worker.is_alive()
    room.terminate()                        # idempotent
    cooler.terminate()                      # never started: a no-op
    assert cooler._thread is None


def test_solves_in_two_threads_equal_their_sequential_solves(rt_pair):
    """The two workers' backends solving at once give what each gives
    alone: a solve holds the solver lock (``torch.func``'s forward-mode
    AD levels and the TF32 switch are process state)."""
    backends = [m.backend for m in _rt(rt_pair)]
    inputs = [m.collect_variables_for_optimization() for m in _rt(rt_pair)]

    def solve(k, out):
        for _ in range(3):
            backends[k]._reset_warm_start()
            res = backends[k].solve(0.0, copy.deepcopy(inputs[k]))
            out.append((res["stats"]["iterations"], res["couplings"]))

    alone = []
    for k in range(2):
        rows = []
        solve(k, rows)
        alone.append(rows)
    together = [[], []]
    threads = [threading.Thread(target=solve, args=(k, together[k]))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for k in range(2):
        assert len(together[k]) == len(alone[k]) == 3
        for (it, coup), (it0, coup0) in zip(together[k], alone[k]):
            assert it == it0
            for name, value in coup0.items():
                np.testing.assert_array_equal(coup[name], value)


def test_launch_counters_lose_no_count_across_threads(monkeypatch):
    """The kernels' launch counters are read-modify-writes shared by the
    real-time workers: many threads counting at once with a short switch
    interval lose no count."""
    import sys

    from agentlib_mpc_torch.ops import kkt

    monkeypatch.setattr(kkt.ldl_factor, "launches", 0)
    monkeypatch.setattr(kkt.ldl_factor, "shapes", set())
    n_threads, per_thread = 16, 500

    def count():
        for _ in range(per_thread):
            kkt._record(kkt.ldl_factor, torch.float32, (1, 8))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kkt.ldl_factor.launches == n_threads * per_thread
    assert kkt.ldl_factor.shapes == {(1, 8)}


# -- configuration errors and registrations ----------------------------------


def _room_module_config(**changes):
    cfg = copy.deepcopy(rc.admm_cooled_room_configs()[0]["modules"][1])
    cfg.update(changes)
    return cfg


def _agent():
    from agentlib_mpc_torch.runtime.agent import Agent
    from agentlib_mpc_torch.runtime.environment import Environment

    return Agent({"id": "A", "modules": []}, Environment(), device="cpu",
                 dtype=F64)


@pytest.mark.parametrize("changes, match", [
    ({"parameters": [{"name": "admm_s_T", "value": 1.0}]}, "reserved"),
    ({"couplings": []}, "at least one coupling"),
    ({"couplings": [{"name": "T_in", "alias": "x", "value": 290.0}],
      "inputs": [{"name": "load", "value": 150}]}, None),
])
def test_module_config_errors(changes, match):
    cfg = _room_module_config(**changes)
    if match is None:
        # T_in as a coupling is a model input: accepted
        create_module(cfg, _agent())
        return
    with pytest.raises(ValueError, match=match):
        create_module(cfg, _agent())


def test_coupling_neither_input_nor_output_is_refused():
    with pytest.raises(ValueError, match="neither a model input nor"):
        create_backend(_cooler_backend_config(), device="cpu",
                       dtype=F64).setup_optimization(
            ADMMVariableReference(controls=["mDot"], couplings=["r_mDot"]),
            DT, N)


@pytest.mark.parametrize("type_key, cls", [
    ("admm_local", padmm.LocalADMM), ("local_admm", padmm.LocalADMM),
    ("admm", padmm.RealtimeADMM)])
def test_module_types_resolve_to_the_port(type_key, cls):
    assert MODULE_TYPES[type_key] is cls


@pytest.mark.parametrize("type_key, name", [
    ("admm_coordinator", "ADMMCoordinator"),
    ("admm_coordinated", "CoordinatedADMM")])
def test_coordinator_types_resolve_to_the_port(type_key, name):
    from agentlib_mpc_torch.modules import coordinator

    assert MODULE_TYPES[type_key] is getattr(coordinator, name)
    assert type_key not in DEFERRED_MODULE_TYPES


@pytest.mark.parametrize("type_key", ["jax_admm", "casadi_admm"])
def test_backend_types_resolve_to_the_port(type_key):
    backend = create_backend({"type": type_key, "model": {"class": "Cooler"}},
                             device="cpu", dtype=F64)
    assert type(backend) is ADMMBackend


@pytest.mark.parametrize("type_key", ["jax_admm_ml", "casadi_admm_ml"])
def test_ml_admm_backends_still_raise(type_key):
    """The ML ADMM types raised until the ML slice; now they build the
    port's ML ADMM backend, an ADMM participant on a NARX OCP."""
    from agentlib_mpc_torch.backends.ml_backend import MLADMMBackend

    backend = create_backend({"type": type_key}, device="cpu")
    assert type(backend) is MLADMMBackend
