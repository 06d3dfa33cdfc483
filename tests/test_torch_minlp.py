"""Mixed-integer MPC through both packages on the CPU in float64.

* the CIA functions (``ops/cia.py``): ``sum_up_rounding``,
  ``cia_objective`` and ``solve_cia`` on seeded relaxed schedules, the
  port's native library (``csrc/cia.cpp``) and its plain Python version
  against the JAX package's result: the same schedule and objectives
  within 1e-12, with and without SOS1 and per-control switch budgets;
* the library is built from the repository's source into ``_build/`` and
  a failed build raises: nothing falls back to the Python version;
* ``examples/minlp_switched_room.py``'s ``jax_cia`` agent in closed loop
  for 600 s (three controller steps, 11 plant steps) in both packages
  (``agentlib_mpc_torch/reference_configs.py``, the plain LDLᵀ in both):
  per step the binary schedule, u0, the relaxed and fixed iterations and
  objectives, and the plant's rows within 1e-8 relative; then one
  relaxed + CIA + fixed ``CIABackend.solve`` from the same warm state
  (``warm_state_from_jax``) within 1e-6; the fixed-binary program stops
  on a wedged point in both packages at t = 300 s, and from the inputs of
  t = 3 900 s (``tests/data/torch_cia_fixed_3900.json``), where only the
  port's does, both succeed within the spread of the JAX package's own
  optima from starts 1e-10 apart;
* ``BranchAndBoundBackend`` (``jax_minlp_bb``) at the example's width
  (N=8, ``batch_pairs`` 4) with ``max_nodes`` 3 (one sweep): the same
  schedule,
  incumbent (1e-6 relative), node count and proven flag as the JAX
  package, and the port's batched node relaxations equal to the same
  nodes solved one by one.

The JAX side forces ``qp_fast_path`` "on" for the relaxed programs (the
port's certificate routes them there itself, which the tests assert):
"auto" would spend the JAX package's sampled LQ probe on proving it.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import native
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.backends.backend import (
    VariableReference,
    create_backend,
)
from agentlib_mpc_torch.ops import cia, kkt
from agentlib_mpc_torch.ops.solver import solve_nlp
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_torch.utils.convert import warm_state_from_jax
from agentlib_mpc_tpu.ops import cia as jcia
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: the closed loop: length (s), three controller steps at 300 s
UNTIL = 600.0
#: loop parity, relative (both run the same f64 arithmetic but for the
#: order of some sums)
RTOL = 1e-8
#: one backend solve from the same inputs and warm state, absolute on the
#: trajectories (K) and relative on objectives
SOLVE_TOL = 1e-6
#: CIA objectives of the same schedule, absolute (seconds of deviation)
CIA_TOL = 1e-12
SOLVER = {"kkt_method": "ldl"}

#: (N, nb, sos1, max_switches, non-uniform dt, seed)
CIA_CASES = {
    "one_control": (10, 1, False, None, False, 0),
    "two_controls": (10, 2, False, None, False, 1),
    "sos1_three": (8, 3, True, None, False, 2),
    "switch_budgets": (12, 2, False, [2, 3], False, 3),
    "sos1_switch_budgets": (9, 3, True, [2, 2, 4], True, 4),
    "example_budget": (8, 1, False, [6], False, 5),
    "tight_budget": (12, 1, False, [1], True, 6),
}


def _cia_inputs(N, nb, sos1, non_uniform, seed):
    rng = np.random.default_rng(seed)
    b_rel = rng.uniform(size=(N, nb))
    if sos1:
        b_rel = b_rel / b_rel.sum(axis=1, keepdims=True)
    dt = rng.uniform(0.5, 2.0, size=N) if non_uniform else np.ones(N)
    return b_rel, dt


@pytest.mark.parametrize("backend_type", ["jax_cia", "jax_minlp_bb"])
def test_configs_are_the_example(backend_type):
    """reference_configs holds examples/minlp_switched_room.py's agents,
    the model named by its zoo name."""
    from examples.minlp_switched_room import agent_configs

    def named(obj):
        if isinstance(obj, dict):
            return {k: named(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [named(v) for v in obj]
        return obj.__name__ if isinstance(obj, type) else obj

    assert rc.minlp_switched_room_configs(backend_type=backend_type) == \
        named(agent_configs(backend_type=backend_type))


@pytest.mark.parametrize("case", sorted(CIA_CASES))
def test_solve_cia_native_mirror_and_jax_agree(case):
    N, nb, sos1, ms, non_uniform, seed = CIA_CASES[case]
    b_rel, dt = _cia_inputs(N, nb, sos1, non_uniform, seed)
    calls = cia.solve_cia.native_calls
    B, eta = cia.solve_cia(b_rel, dt, max_switches=ms, sos1=sos1)
    assert cia.solve_cia.native_calls == calls + 1
    B_py, eta_py = cia._solve_python(b_rel, dt, ms, sos1,
                                     max_nodes=10_000_000)
    B_jax, eta_jax = jcia.solve_cia(b_rel, dt, max_switches=ms, sos1=sos1)
    np.testing.assert_array_equal(B, B_py)
    np.testing.assert_array_equal(B, B_jax)
    assert abs(eta - eta_py) <= CIA_TOL and abs(eta - eta_jax) <= CIA_TOL
    assert abs(cia.cia_objective(b_rel, B, dt) - eta) <= CIA_TOL
    assert set(np.unique(B)) <= {0.0, 1.0}
    if sos1:
        np.testing.assert_array_equal(B.sum(axis=1), 1.0)
    if ms is not None:
        switches = np.abs(np.diff(B, axis=0)).sum(axis=0)
        assert np.all(switches <= np.asarray(ms))


@pytest.mark.parametrize("sos1", [False, True])
def test_sum_up_rounding_and_objective_match_jax(sos1):
    b_rel, dt = _cia_inputs(20, 3, sos1, True, 7)
    B = cia.sum_up_rounding(b_rel, dt, sos1=sos1)
    np.testing.assert_array_equal(B, jcia.sum_up_rounding(b_rel, dt,
                                                          sos1=sos1))
    assert abs(cia.cia_objective(b_rel, B, dt)
               - jcia.cia_objective(b_rel, B, dt)) <= CIA_TOL


def test_node_budget_before_the_first_leaf_returns_no_schedule():
    b_rel, dt = _cia_inputs(10, 1, False, False, 8)
    B, eta = cia.solve_cia(b_rel, dt, max_nodes=3)
    assert eta == np.inf and not B.any()


def test_cia_arguments_are_checked():
    with pytest.raises(ValueError, match="max_switches"):
        cia.solve_cia(np.full((4, 2), 0.5), dt=1.0, max_switches=[2])
    with pytest.raises(ValueError, match="at most 16"):
        cia.solve_cia(np.full((4, 17), 0.5), dt=1.0)
    with pytest.raises(ValueError, match=r"\(N, nb\)"):
        cia.solve_cia(np.full(4, 0.5), dt=1.0)


def test_native_library_is_built_from_the_source_into_build():
    cia.solve_cia(np.full((3, 1), 0.5), dt=1.0)
    path = native.lib_path("cia")
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert path.parent.name == "_build"
    assert path.name.startswith("libcia-") and path.suffix == ".so"


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load("cia")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        cia.solve_cia(np.full((3, 1), 0.5), dt=1.0)
    monkeypatch.setattr(native.shutil, "which", lambda name: "/bin/false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load("cia")
    assert not list(tmp_path.iterdir())  # no library, no temporary left


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B, M", [(1, 34), (1, 26), (8, 34)])
def test_auto_routes_the_minlp_shapes_to_the_kernels(monkeypatch, dtype, B,
                                                     M):
    """On an H100 (232 448 bytes of opt-in shared memory per block) "auto"
    sends the relaxed (1, 34), fixed (1, 26) and node-batch (8, 34) KKT
    systems to the LDLᵀ kernels in either type; on the CPU to LU."""
    monkeypatch.setattr(kkt, "_smem_optin", lambda device: 232448)
    dt = getattr(torch, dtype)
    assert kkt.ldl_fits(M, "cuda", dt)
    assert kkt.resolve_kkt_method("auto", M, "cuda", dtype=dt) == "ldl"
    assert kkt.resolve_kkt_method("auto", M, "cpu", dtype=dt) == "lu"


# -- the jax_cia agent in closed loop, both packages -----------------------


def cia_configs(jax_side=False):
    cfgs = rc.minlp_switched_room_configs(
        solver={**SOLVER, **({"qp_fast_path": "on"} if jax_side else {})})
    return cfgs


def _trace(mas):
    module = mas.agents["Controller"].get_module("mpc")
    return {"module": module,
            "solves": [dict(r) for r in module.backend.stats_history],
            "history": [(row["time"], {k: np.array(v)
                                       for k, v in row["traj"].items()})
                        for row in module._history_rows],
            "rows": [dict(r) for r in
                     mas.agents["Plant"].get_module("room")._rows]}


@pytest.fixture(scope="module")
def cia_loops():
    port = LocalMAS(cia_configs(), env={"rt": False}, device="cpu",
                    dtype=F64)
    calls = cia.solve_cia.native_calls
    port.run(until=UNTIL)
    native_runs = cia.solve_cia.native_calls - calls
    ref = JLocalMAS(cia_configs(jax_side=True), env={"rt": False})
    ref.run(until=UNTIL)
    return {"port": _trace(port), "jax": _trace(ref),
            "native_runs": native_runs}


def _close(port, ref, what, rtol=RTOL):
    port, ref = np.asarray(port, dtype=float), np.asarray(ref, dtype=float)
    np.testing.assert_allclose(
        port, ref, rtol=rtol,
        atol=rtol * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
        err_msg=what)


def test_cia_loop_matches_jax_step_by_step(cia_loops):
    port, ref = cia_loops["port"], cia_loops["jax"]
    assert port["module"].backend.uses_qp_fast_path is True
    assert len(port["solves"]) == len(ref["solves"]) == 3
    for p, r in zip(port["solves"], ref["solves"]):
        assert p["time"] == r["time"]
        for key in ("iterations", "success", "relaxed_success"):
            assert p[key] == r[key], (r["time"], key)
        for key in ("objective", "relaxed_objective", "cia_objective"):
            _close(p[key], r[key], f"{key} t={r['time']}")
    for (t, p), (_, r) in zip(port["history"], ref["history"]):
        for key in ("x", "y"):
            _close(p[key], r[key], f"traj {key} at t={t}")
    assert len(port["rows"]) == len(ref["rows"]) > 0
    for p, r in zip(port["rows"], ref["rows"]):
        for key in r:
            _close(p[key], r[key], f"plant {key} at t={r['time']}")


def test_cia_loop_actuates_binaries_from_the_native_library(cia_loops):
    rows = cia_loops["port"]["rows"]
    assert {r["on"] for r in rows} <= {0.0, 1.0}
    assert cia_loops["native_runs"] == len(cia_loops["port"]["solves"])
    assert rows[-1]["T_out"] < rows[0]["T_out"]


def test_cia_solve_matches_jax_from_the_same_warm_state(cia_loops):
    """One relaxed + CIA + fixed solve of each package's backend, from the
    JAX package's warm state and the same inputs."""
    pm, jm = cia_loops["port"]["module"], cia_loops["jax"]["module"]
    warm = {k: (v if k == "cold" else np.asarray(v))
            for k, v in jm.backend.warm_state().items()}
    pm.backend.set_warm_state(warm_state_from_jax(warm, "cpu", F64))
    variables = jm.collect_variables_for_optimization()
    variables["T"] = 295.6
    now = float(jm.env.now) + 300.0
    ref = jm.backend.solve(now, variables)
    out = pm.backend.solve(now, variables)
    np.testing.assert_array_equal(out["binary_schedule"],
                                  ref["binary_schedule"])
    assert out["u0"] == ref["u0"]
    assert out["stats"]["iterations"] == ref["stats"]["iterations"]
    for key in ("x", "y"):
        np.testing.assert_allclose(out["traj"][key], ref["traj"][key],
                                   rtol=0, atol=SOLVE_TOL)
        np.testing.assert_allclose(out["traj_relaxed"][key],
                                   ref["traj_relaxed"][key], rtol=0,
                                   atol=SOLVE_TOL)
    for key in ("objective", "relaxed_objective", "cia_objective"):
        assert out["stats"][key] == pytest.approx(ref["stats"][key],
                                                  rel=SOLVE_TOL)


#: the fixed-binary program's inputs at t = 3 900 s of the JAX package's
#: f64 CIA loop (``scripts/module_f32_witness.py --fixture``)
FIXED_3900 = os.path.join(os.path.dirname(__file__), "data",
                          "torch_cia_fixed_3900.json")
#: a wedged exit: accepted by the fixed program's wide stall tolerances
#: (``dual_inf_tol`` 100) with a KKT error far above the solver's tol
WEDGED_KKT = 1e-3
#: relative: the fixed program's optimum is flat. From 80 starts whose x0
#: differ by 1e-10 relative, the JAX package's converged objectives span
#: 1508.345 to 1508.801, 3.0e-4 of their size (the witness's
#: ``fixed_3900`` line)
FIXED_OBJECTIVE_RTOL = 3.5e-4


def test_fixed_program_wedges_as_the_reference_does(cia_loops):
    """The fixed program can stop on a wedged point in both packages. At
    t = 300 s of the loop the JAX package's own solve does, and the port's
    follows it (the loop parity above). From the inputs of t = 3 900 s the
    JAX package converges (KKT 5.1e-7) and the port wedges (0.066): their
    iterates agree to 2.2e-10 until the JAX package's error at iteration 16
    falls below tol and the port's (2.5e-6) does not, after which a step
    pins a variable at its bound (ROADMAP Queue 3). Both still succeed,
    within the objectives the reference reaches from nearby starts."""
    import jax.numpy as jnp

    for name in ("port", "jax"):
        row = cia_loops[name]["solves"][1]
        assert row["time"] == 300.0 and row["success"]
        assert row["kkt_error"] > WEDGED_KKT, name
    with open(FIXED_3900) as fh:
        a = json.load(fh)
    names = ("x0", "u_prev", "d_traj", "p", "x_lb", "x_ub", "u_lb", "u_ub")
    # each package's arguments typed as its backend passes them (the JAX
    # package's compiled program is reused, not traced again)
    stats = {"jax": cia_loops["jax"]["module"].backend._step_fixed(
        *(np.asarray(a[k], dtype=np.float64) for k in names),
        jnp.asarray(a["mu0"], dtype=jnp.float64),
        jnp.asarray(a["t0"]))[-1],
        "port": cia_loops["port"]["module"].backend._step_fixed(
        *(torch.tensor(a[k], dtype=F64) for k in names), a["mu0"],
        torch.tensor(a["t0"], dtype=F64))[-1]}
    for name, st in stats.items():
        assert bool(st.success), name
    assert float(stats["port"].objective) == pytest.approx(
        float(stats["jax"].objective), rel=FIXED_OBJECTIVE_RTOL)


# -- branch-and-bound ----------------------------------------------------------

#: the example's node batch (2·batch_pairs = 8 relaxations per sweep); a
#: node budget of 3 (the root relaxation and the heuristic's exact score
#: count 2) lets the search run exactly one sweep
BB_OPTIONS = {"max_nodes": 3, "batch_pairs": 4}


@pytest.fixture(scope="module")
def bb_solves(cia_loops):
    """One ``jax_minlp_bb`` solve of the example's width (N=8) in each
    package, the room at the comfort bound (a fractional relaxed duty
    cycle); the port's sweep is recorded. The port's backend is built from
    its config; the JAX package's takes the CIA agent's backend (its
    transcriptions and compiled relaxed and fixed steps) and adds what its
    ``BranchAndBoundBackend.setup_optimization`` adds (the options, the
    default rounding heuristic and the node program), to spare a second
    transcription and compile."""
    from agentlib_mpc_torch.backends.minlp_backend import BranchAndBoundBackend
    from agentlib_mpc_tpu.backends.minlp_backend import (
        BranchAndBoundBackend as JBranchAndBound,
    )

    port = create_backend(rc.switched_room_backend_config(
        "jax_minlp_bb", SOLVER, bb_options=dict(BB_OPTIONS)), device="cpu",
        dtype=F64)
    port.setup_optimization(cia_loops["port"]["module"].var_ref, rc.MINLP_DT,
                            8)
    cia_backend = cia_loops["jax"]["module"].backend
    ref = JBranchAndBound.__new__(JBranchAndBound)
    ref.__dict__.update(cia_backend.__dict__)
    ref.config = {k: v for k, v in cia_backend.config.items()
                  if k != "cia_options"}
    ref.config["bb_options"] = dict(BB_OPTIONS)
    ref._method = JBranchAndBound.default_binary_method
    ref._cia_options = {}
    ref._bb = dict(BB_OPTIONS)
    ref._batch_pairs = BB_OPTIONS["batch_pairs"]
    ref._build_node_program()
    ref._reset_warm_start()
    ref._stats_history = []

    sweeps = []
    solve_nodes = port._solve_nodes

    def recorded(node_bounds, ctx):
        u_batch, stats = solve_nodes(node_bounds, ctx)
        sweeps.append((node_bounds, ctx, u_batch, stats))
        return u_batch, stats

    port._solve_nodes = recorded
    out = port.solve(0.0, {"T": 295.15})
    del port._solve_nodes
    assert isinstance(port, BranchAndBoundBackend)
    return {"port": port, "out": out, "sweeps": sweeps,
            "want": ref.solve(0.0, {"T": 295.15})}


def test_bb_solve_matches_jax(bb_solves):
    """The schedule, incumbent, node count and proven flag are the JAX
    package's, after one batched sweep of 8 node relaxations."""
    out, want = bb_solves["out"], bb_solves["want"]
    assert bb_solves["port"].uses_qp_fast_path is True
    assert len(bb_solves["sweeps"]) == out["stats"]["bb_sweeps"] == 1
    np.testing.assert_array_equal(out["binary_schedule"],
                                  want["binary_schedule"])
    s, r = out["stats"], want["stats"]
    assert s["bb_nodes"] == r["bb_nodes"]
    for key in ("bb_proven_optimal", "bb_improved_on_heuristic", "success"):
        assert s[key] == r[key], key
    for key in ("bb_incumbent", "bb_bound", "objective",
                "relaxed_objective"):
        assert s[key] == pytest.approx(r[key], rel=SOLVE_TOL), key
    assert s["bb_incumbent"] <= s["bb_heuristic"]
    np.testing.assert_allclose(out["traj"]["x"], want["traj"]["x"],
                               rtol=0, atol=SOLVE_TOL)


def test_bb_batched_nodes_equal_their_single_solves(bb_solves):
    """The port's node program (one ``solve_nlp_batched`` of the padded
    batch of 8: the root's two children, then copies of the first) against
    the two children solved alone by ``solve_nlp``; the padding lanes
    repeat the first child's result."""
    port = bb_solves["port"]
    node_bounds, ctx, u_batch, stats = bb_solves["sweeps"][0]
    assert u_batch.shape[0] == 2 * BB_OPTIONS["batch_pairs"]
    for i in range(2, u_batch.shape[0]):
        torch.testing.assert_close(u_batch[i], u_batch[0], rtol=0, atol=0)
    ocp = port.ocp
    lanes = port._node_thetas(node_bounds, ctx)
    for i in (0, 1):
        th = lanes[i]
        lb, ub = ocp.bounds(th)
        res = solve_nlp(ocp.nlp, ocp.initial_guess(th), th, lb, ub,
                        port.solver_options,
                        mu0=port.solver_options.mu_init)
        assert int(res.stats.iterations) == int(stats.iterations[i])
        assert bool(res.stats.success) == bool(stats.success[i])
        torch.testing.assert_close(ocp.unflatten(res.w)["u"], u_batch[i],
                                   rtol=0, atol=1e-9)
        torch.testing.assert_close(res.stats.objective,
                                   stats.objective[i], rtol=1e-9, atol=0)


# -- module-level checks, port only -----------------------------------------


def test_minlp_mpc_checks_its_config():
    cfg = copy.deepcopy(rc.minlp_switched_room_configs()[0])
    cfg["modules"][1]["binary_controls"] = []
    with pytest.raises(ValueError, match="non-empty binary_controls"):
        LocalMAS([cfg], env={"rt": False}, device="cpu", dtype=F64)
    cfg = copy.deepcopy(rc.minlp_switched_room_configs()[0])
    cfg["modules"][1]["binary_controls"] = [{"name": "load"}]
    cfg["modules"][1]["inputs"] = [{"name": "T_upper", "value": 295.15}]
    with pytest.raises(ValueError, match="bounded in \\[0, 1\\]"):
        LocalMAS([cfg], env={"rt": False}, device="cpu", dtype=F64)


def test_backends_need_binaries_and_the_jax_backend_refuses_them():
    backend = create_backend(rc.switched_room_backend_config("jax_minlp"),
                             device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="binary_controls"):
        backend.setup_optimization(
            VariableReference(states=["T"], controls=["on"]),
            time_step=300.0, prediction_horizon=4)
    backend = create_backend(rc.switched_room_backend_config("jax"),
                             device="cpu", dtype=F64)
    with pytest.raises(NotImplementedError, match="jax_minlp"):
        backend.setup_optimization(
            VariableReference(states=["T"], binary_controls=["on"]),
            time_step=300.0, prediction_horizon=4)
