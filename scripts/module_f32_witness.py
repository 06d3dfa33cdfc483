#!/usr/bin/env python3
"""Float32 and float64 on the MHE and MINLP examples, both packages, CPU.

    JAX_PLATFORMS=cpu python3 scripts/module_f32_witness.py [--out PATH]
        [--fixture PATH] [--starts N] [--only fixed_3900]

Which type each of ``chip_smoke.py``'s ``module_mhe`` (float32),
``module_minlp_cia`` and ``module_minlp_bb`` (float64) runs in, and how
the port's interior-point solver stalls where it did. Every loop runs on
the CPU with the plain LDLᵀ in both packages (``kkt_method="ldl"``, the
card's factor in the port), from ``agentlib_mpc_torch/reference_configs.py``
(the JAX package with its own model classes). One JSON line each:

- ``loop``: per example (``mhe``: examples/mhe_one_room.py, 3 600 s;
  ``cia``: examples/minlp_switched_room.py with ``jax_cia``, 7 200 s;
  ``bb``: the same with ``jax_minlp_bb``, 7 200 s in the JAX package and
  2 100 s in the port, whose B&B is slow on the CPU), package and type:
  the times of the failed solves (the MHE example: the MPC's and the
  MHE's), of the successful ones that stopped with a KKT error above 1e-3
  (in float64 a wedged point the stall exit accepted; in float32 most
  acceptable exits), iterations per solve, and the example's outcome.
- ``replay``: every MPC solve of one package's float32 MHE-example loop
  replayed in the other package's float32 from the same inputs and warm
  state (``warm_state_from_jax``): the failed replays.
- ``perturbed``: the same solves of the JAX package's loop with the warm
  start's primal scaled by (1 + 1e-6·N(0, 1)), three seeds each, in both
  packages: failed solves out of all.
- ``trace``: both packages' float32 line searches on the JAX loop's state
  where the port takes the most steps inside the noise allowance (merit
  change, noise, progress, the wedge counter, mu and the KKT error per
  iteration; for the JAX package the error and mu after each iteration
  and whether its search rejected every candidate).
- ``fixed_3900``: the CIA loop's fixed-binary program at t = 3 900 s in
  float64 from the JAX package's inputs, in both packages: the whole
  solve (iterations, objective, KKT error), the two iterate sequences
  side by side, and ``--starts`` starts (80 by default) with x0 scaled by
  (1 + 1e-10·N(0, 1)), seed 0: wedged exits (KKT error above 1e-3) and
  the spread of the objectives. With ``--fixture`` the program's inputs
  are written there as JSON.
- ``fixed_3900_counts``: the wedged exits of both packages from those
  starts, with the number of starts and the seed, on a line of its own.

- ``mhe_qp_iterations``: the MHE QP's iterations per solve in the MHE
  example's four loops (both packages, both types; also in each ``loop``
  line as ``mhe_iterations``).

- ``ml_loop`` (``--only ml``): the two data-driven examples, per package
  and type: ``ml_mpc`` (examples/ml_mpc_one_room.py on ``jax_ml``,
  6 000 s) and ``ml_admm`` (examples/three_zone_datadriven_admm.py's seven
  agents for one control step of 300 s, 10 ADMM iterations). Every
  surrogate is trained once, by the port's trainer on the CPU in float64
  at the examples' 300 epochs, and both packages load the same JSON: the
  failed solves, the iterations per solve, and the outcome (the plant
  temperatures; the zones' first moves).

- ``ml_replay`` and ``ml_perturbed`` (``--only ml_replay``): the surrogate
  room's float32 loop in both packages, each package's solves replayed in
  both packages' float32 from the same plant and warm state
  (``warm_state_from_jax``), and the JAX package's states replayed with
  the warm start's primal scaled by (1 + 1e-6·N(0, 1)), five seeds each,
  in both packages: failed solves and iterations. With ``--fixture`` the
  JAX package's state before its solve at t = 300 s is written there
  with the surrogate's document (``tests/data/torch_ml_room_f32_300.json``).
- ``ml_trace`` (``--only ml_replay``): from that stored state, both
  packages' NARX derivatives in float32 against float64, their iterates
  after 1..10 iterations in both types, and which of 17 starts (the
  stored one and 16 with the warm primal scaled by 1 + 1e-6·N(0, 1))
  converge in the port's backend, the JAX package's backend and the JAX
  package's bare ``solve_nlp``.

``--only fixed_3900`` runs that program alone (a few minutes); ``--only
mhe`` the MHE example's four loops and the ``mhe_qp_iterations`` line;
``--only ml`` the ``ml_loop`` lines (about 3 minutes on a 4-core CPU).

With ``--out`` the lines are also written to that file. Takes about 15
minutes on a 4-core CPU; the loops run in parallel subprocesses.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

#: seed of the perturbed starts of the fixed program at t = 3 900 s
FIXED_SEED = 0
UNTIL = {"mhe": 3600.0, "cia": 7200.0, "bb": 7200.0}
#: the port's branch-and-bound loop is cut to the chip phase's depth
PORT_BB_UNTIL = 2100.0
MPC_ROLES = dict(states=["T"], controls=["mDot"], inputs=["T_in", "T_upper"],
                 parameters=["load", "s_T", "r_mDot"])


def setup_jax(x64: bool):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types


def configs(example: str, jax_side: bool):
    from agentlib_mpc_torch import reference_configs as rc

    solver = {"kkt_method": "ldl"}
    if example == "mhe":
        cfgs = rc.mhe_one_room_configs(solver=solver)
        if jax_side:
            from examples.mhe_one_room import RoomLoadParam

            for agent in cfgs:
                for module in agent["modules"]:
                    for holder in (module.get("optimization_backend", {}),
                                   module):
                        model = holder.get("model")
                        if isinstance(model, dict) and \
                                model.get("class") is rc.RoomLoadParam:
                            model["class"] = RoomLoadParam
        return cfgs
    return rc.minlp_switched_room_configs(
        backend_type="jax_cia" if example == "cia" else "jax_minlp_bb",
        solver=solver)


def make_mas(pkg: str, dtype: str, example: str):
    if pkg == "jax":
        setup_jax(dtype == "f64")
        from agentlib_mpc_tpu.runtime.mas import LocalMAS

        return LocalMAS(configs(example, True), env={"rt": False})
    import torch

    from agentlib_mpc_torch.runtime.mas import LocalMAS

    return LocalMAS(configs(example, False), env={"rt": False},
                    device="cpu", dtype=getattr(torch, {
                        "f32": "float32", "f64": "float64"}[dtype]))


def run_loop(pkg: str, dtype: str, example: str, capture: str | None):
    """One closed loop; with ``capture`` (a path) every MPC solve's inputs
    and warm state are pickled there."""
    import numpy as np

    mas = make_mas(pkg, dtype, example)
    mpc = mas.agents["Controller"].get_module("mpc")
    caps = []
    if capture:
        solve = mpc.backend.solve

        def captured(now, variables):
            warm = {k: (v if k == "cold" else np.asarray(v))
                    for k, v in mpc.backend.warm_state().items()}
            caps.append({"now": now, "vars": copy.deepcopy(variables),
                         "warm": warm})
            return solve(now, variables)

        mpc.backend.solve = captured
    until = PORT_BB_UNTIL if (example, pkg) == ("bb", "torch") \
        else UNTIL[example]
    mas.run(until=until)
    stats = mpc.backend.stats_history
    rows = mas.agents["Plant"].get_module("room")._rows
    out = {"line": "loop", "example": example, "package": pkg,
           "dtype": dtype, "until_s": until, "solves": len(stats),
           "failed_at": [r["time"] for r in stats if not r["success"]],
           "kkt_above_1e-3_at": [r["time"] for r in stats if r["success"]
                         and r["kkt_error"] > 1e-3],
           "iterations": [r["iterations"] for r in stats],
           "final_temperature_K": float(rows[-1]["T_out"])}
    if example == "mhe":
        mhe = mas.agents["Controller"].get_module("mhe")
        out["mhe_failed_at"] = [r["time"] for r in mhe.backend.stats_history
                                if not r["success"]]
        out["load_estimate_W"] = float(mhe.get_value("load"))
        out["mhe_qp"] = mhe.backend.uses_qp_fast_path
        out["mhe_iterations"] = [r["iterations"]
                                 for r in mhe.backend.stats_history]
    else:
        out["duty_cycle"] = float(np.mean([r["on"] for r in rows]))
    if capture:
        with open(capture, "wb") as fh:
            pickle.dump(caps, fh)
    return out


def mpc_backend(pkg: str):
    """The MHE example's MPC backend alone, float32, in one package, and
    the converter of a captured warm state into it."""
    cfg = copy.deepcopy(configs("mhe", pkg == "jax")[0]["modules"][2])
    if pkg == "jax":
        setup_jax(False)
        import jax.numpy as jnp

        from agentlib_mpc_tpu.backends.backend import (
            VariableReference,
            create_backend,
        )

        backend = create_backend(cfg["optimization_backend"])
        conv = lambda w: {k: (v if k == "cold" else
                              jnp.asarray(v, dtype=jnp.float32))
                          for k, v in w.items()}
    else:
        import torch

        from agentlib_mpc_torch.backends.backend import (
            VariableReference,
            create_backend,
        )
        from agentlib_mpc_torch.utils.convert import warm_state_from_jax

        backend = create_backend(cfg["optimization_backend"], device="cpu",
                                 dtype=torch.float32)
        conv = lambda w: warm_state_from_jax(w, "cpu", torch.float32)
    backend.setup_optimization(VariableReference(**MPC_ROLES), 120.0, 10)
    return backend, conv


def replay(pkg: str, capture: str, perturb: bool):
    import numpy as np

    with open(capture, "rb") as fh:
        caps = pickle.load(fh)
    backend, conv = mpc_backend(pkg)
    rng = np.random.default_rng(0)
    failed, n = [], 0
    for c in caps:
        for seed in range(3 if perturb else 1):
            warm = dict(c["warm"])
            if perturb:
                w = np.asarray(warm["w"], dtype=np.float64)
                warm["w"] = (w * (1.0 + 1e-6 * rng.standard_normal(
                    w.shape))).astype(np.float32)
            backend.set_warm_state(conv(warm))
            result = backend.solve(c["now"], c["vars"])
            n += 1
            if not result["stats"]["success"]:
                failed.append([c["now"], seed])
    return {"line": "perturbed" if perturb else "replay", "package": pkg,
            "states_from": os.path.basename(capture).split("_")[0],
            "failed": failed, "solves": n}


def trace(capture: str):
    """The line searches of both packages' float32 MPC solves from the
    JAX package's loop state where the port's search takes the most steps
    inside the noise allowance. The port's per iteration from
    ``agentlib_mpc_torch.ops.solver.ITERATION_TRACE``; the JAX package's
    by re-running its ``solve_nlp`` with ``max_iter`` = 1, 2, ... from the
    same inputs (a rejected search leaves the iterate bitwise unchanged)."""
    import numpy as np
    import torch

    from agentlib_mpc_torch.ops import solver

    with open(capture, "rb") as fh:
        caps = pickle.load(fh)
    port, conv = mpc_backend("torch")
    rows = []
    solver.ITERATION_TRACE = lambda d: rows.append(
        {k: (v[0].item() if v.ndim else v.item()) for k, v in d.items()
         if torch.is_tensor(v) and v.ndim <= 1}
        | {"merit_change": (d["phis"][0, d["first_ok"][0]]
                            - d["phi0"][0]).item()})
    per_state = []
    for c in caps:
        rows.clear()
        port.set_warm_state(conv(c["warm"]))
        stats = port.solve(c["now"], c["vars"])["stats"]
        per_state.append((sum(r["accepted"] and not r["progressed"]
                              for r in rows), c, list(rows), stats))
    solver.ITERATION_TRACE = None
    noise_steps, c, rows, stats = max(per_state, key=lambda t: t[0])
    out = {"line": "trace", "time": c["now"],
           "noise_only_steps_per_state": [t[0] for t in per_state],
           "torch": {"iterations": stats["iterations"],
                     "success": stats["success"],
                     "per_iteration": [
                         {k: r[k] for k in ("it", "mu", "alpha", "noise",
                                            "merit_change", "accepted",
                                            "progressed", "frozen", "stall",
                                            "err_0")}
                         for r in rows]}}

    import jax.numpy as jnp

    from agentlib_mpc_tpu.ops.solver import solve_nlp as jsolve

    jax_backend, jconv = mpc_backend("jax")
    args = {}
    step = jax_backend._step

    def captured(*a):
        args["a"] = a
        return step(*a)

    jax_backend._step = captured
    jax_backend.set_warm_state(jconv(c["warm"]))
    jstats = jax_backend.solve(c["now"], c["vars"])["stats"]
    (x0, u_prev, d_traj, p, x_lb, x_ub, u_lb, u_ub, w_guess, y_guess,
     z_guess, mu0, t0) = args["a"]
    ocp, opts = jax_backend.ocp, jax_backend.solver_options
    theta = ocp.default_params(x0=x0, u_prev=u_prev, d_traj=d_traj, p=p,
                               x_lb=x_lb, x_ub=x_ub, u_lb=u_lb, u_ub=u_ub,
                               t0=t0)
    lb, ub = ocp.bounds(theta)
    per_k, w_prev = [], None
    for k in range(1, int(jstats["iterations"]) + 1):
        res = jsolve(ocp.nlp, w_guess, theta, lb, ub, opts, y0=y_guess,
                     z0=z_guess, mu0=mu0, max_iter=jnp.asarray(k))
        w = np.asarray(res.w)
        per_k.append({"it": k - 1, "mu": float(res.stats.mu),
                      "err_0": float(res.stats.kkt_error),
                      "rejected": bool(w_prev is not None
                                       and np.array_equal(w, w_prev))})
        w_prev = w
    out["jax"] = {"iterations": jstats["iterations"],
                  "success": jstats["success"], "per_iteration": per_k}
    return out


def fixed_3900(fixture: str | None, starts: int = 80):
    """The CIA loop's fixed-binary program at t = 3 900 s in f64, from the
    JAX package's inputs, in both packages: the whole solve, the iterates
    after 1, 2, ... iterations, and ``starts`` starts with x0 scaled by
    (1 + 1e-10·N(0, 1)), seed 0. With ``fixture`` the program's inputs are written
    there as JSON (``tests/test_torch_minlp.py`` reads them)."""
    import numpy as np
    import torch

    setup_jax(True)
    import jax.numpy as jnp

    from agentlib_mpc_torch.ops.solver import solve_nlp as psolve
    from agentlib_mpc_tpu.ops.solver import solve_nlp as jsolve

    jmas = make_mas("jax", "f64", "cia")
    jb = jmas.agents["Controller"].get_module("mpc").backend
    cap, step = {}, jb._step_fixed

    def captured(*a):
        if float(a[-1]) == 3900.0:
            cap["args"] = [np.asarray(v, dtype=np.float64) for v in a]
        return step(*a)

    jb._step_fixed = captured
    jmas.run(until=3900.0)
    names = ("x0", "u_prev", "d_traj", "p", "x_lb", "x_ub", "u_lb", "u_ub",
             "mu0", "t0")
    a = dict(zip(names, cap["args"]))
    if fixture:
        with open(fixture, "w") as fh:
            json.dump({k: v.tolist() for k, v in a.items()}, fh)
    pmas = make_mas("torch", "f64", "cia")
    pb = pmas.agents["Controller"].get_module("mpc").backend
    mu0 = float(a["mu0"])
    out = {"line": "fixed_3900"}
    for name, backend, arr in (("jax", jb, jnp.asarray),
                               ("torch", pb, torch.as_tensor)):
        s = backend._step_fixed(*(arr(a[k]) for k in names[:8]), mu0,
                                arr(a["t0"]))[-1]
        out[name] = {"iterations": int(s.iterations),
                     "objective": float(s.objective),
                     "kkt_error": float(s.kkt_error),
                     "success": bool(s.success)}

    jo, jopts = jb.ocp_fixed, jb._fixed_options
    po, popts = pb.ocp_fixed, pb._fixed_options
    theta0 = po.default_params(device="cpu", dtype=torch.float64)

    def programs(x0):
        jth = jo.default_params(**{k: jnp.asarray(a[k]) for k in names
                                   if k not in ("mu0", "x0")},
                                x0=jnp.asarray(x0))
        pth = theta0._replace(**{k: torch.as_tensor(a[k]) for k in names
                                 if k not in ("mu0", "x0")},
                              x0=torch.as_tensor(x0))
        return ((jo, jth, *jo.bounds(jth), jopts, jsolve,
                 lambda k: None if k is None else jnp.asarray(k)),
                (po, pth, *po.bounds(pth), popts, psolve, lambda k: k))

    def run(prog, k=None):
        ocp, th, lb, ub, opts, solve, mk = prog
        res = solve(ocp.nlp, ocp.initial_guess(th), th, lb, ub, opts,
                    mu0=mu0, max_iter=mk(k))
        return (np.asarray(res.w), float(res.stats.kkt_error),
                float(res.stats.objective), int(res.stats.iterations))

    jprog, pprog = programs(a["x0"])
    out["iterates"] = []
    for k in range(1, out["torch"]["iterations"] + 1):
        jw, jerr, jobj, jit = run(jprog, k)
        pw, perr, pobj, pit = run(pprog, k)
        out["iterates"].append({"k": k, "jax_err": jerr, "jax_obj": jobj,
                                "jax_it": jit, "torch_err": perr,
                                "torch_obj": pobj, "torch_it": pit,
                                "w_max_abs_diff": float(np.abs(jw - pw)
                                                        .max())})
    rng = np.random.default_rng(FIXED_SEED)
    ens = {"jax": [], "torch": []}
    for _ in range(starts):
        x0 = a["x0"] * (1.0 + 1e-10 * rng.standard_normal(a["x0"].shape))
        for name, prog in zip(("jax", "torch"), programs(x0)):
            ens[name].append(run(prog)[1:3])
    out["perturbed"] = {"starts": starts, "seed": FIXED_SEED,
                        "x0_rel": 1e-10, **{
        name: {"kkt_above_1e-3": sum(e > 1e-3 for e, _ in v),
               "kkt_above_tol": sum(e > 1e-6 for e, _ in v),
               "kkt_max": max(e for e, _ in v),
               "objective_min": min(o for _, o in v),
               "objective_max": max(o for _, o in v)}
        for name, v in ens.items()}}
    return out


def train_ml_surrogates(directory: str) -> dict:
    """The examples' surrogates, trained once by the port's trainer on the
    CPU in float64 (300 epochs), as JSON files in ``directory``."""
    import torch

    from agentlib_mpc_torch import reference_configs as rc

    docs = {"room": rc.train_room_surrogate(
        rc.ml_room_training_data(), device="cpu", dtype=torch.float64)}
    for i in range(rc.ZONES_N):
        docs[f"zone{i}"] = rc.train_zone_surrogate(
            rc.ZONES_LOADS[i], seed=i, device="cpu", dtype=torch.float64)
    paths = {}
    for key, doc in docs.items():
        paths[key] = os.path.join(directory, f"{key}.json")
        doc.save(paths[key])
    return paths


def _ml_doc(directory: str, key: str) -> str:
    with open(os.path.join(directory, f"{key}.json")) as fh:
        return fh.read()


#: perturbed starts per solve of the surrogate room's replay
ML_PERTURBED_SEEDS = 5
#: the data-driven examples' solver, both packages (the card's factor)
ML_SOLVER = {"max_iter": 60, "kkt_method": "ldl"}


def ml_mpc_backend(pkg: str, dtype: str, directory: str):
    """The surrogate room's ``jax_ml`` backend in one package and type
    (examples/ml_mpc_one_room.py's, horizon 10), with the surrogate of
    :func:`train_ml_surrogates`, and the converter of a JAX warm state
    into it."""
    from agentlib_mpc_torch import reference_configs as rc

    if pkg == "jax":
        setup_jax(dtype == "f64")
        import jax.numpy as jnp

        from agentlib_mpc_tpu.backends.backend import (
            VariableReference,
            create_backend,
        )
        from agentlib_mpc_tpu.ml import load_serialized_model
        from examples import ml_mpc_one_room as ex_mpc

        model = {"class": ex_mpc.SurrogateRoom,
                 "ml_model_sources": [load_serialized_model(
                     _ml_doc(directory, "room"))]}
        kw = {}
        jdt = jnp.float32 if dtype == "f32" else jnp.float64
        conv = lambda w: {k: (v if k == "cold" else jnp.asarray(v, jdt))
                          for k, v in w.items()}
    else:
        import torch

        from agentlib_mpc_torch.backends.backend import (
            VariableReference,
            create_backend,
        )
        from agentlib_mpc_torch.utils.convert import warm_state_from_jax

        model = rc.ml_mpc_backend_config(_ml_doc(directory, "room"))["model"]
        tdt = getattr(torch, {"f32": "float32", "f64": "float64"}[dtype])
        kw = {"device": "cpu", "dtype": tdt}
        conv = lambda w: warm_state_from_jax(w, "cpu", tdt)
    backend = create_backend({"type": "jax_ml", "model": model,
                              "solver": ML_SOLVER}, **kw)
    backend.setup_optimization(
        VariableReference(states=["T"], controls=["Q"], inputs=["T_upper"],
                          parameters=["s_T", "r_Q"]),
        time_step=rc.ML_DT, prediction_horizon=10)
    return backend, conv


def ml_loop(pkg: str, dtype: str, example: str, directory: str,
            capture: str | None = None) -> dict:
    """One data-driven example in one package and type, with the
    surrogates of :func:`train_ml_surrogates`; with ``capture`` (a path)
    every solve of the surrogate room's loop is pickled there with its
    plant state and the backend's warm state before it."""
    import numpy as np

    from agentlib_mpc_torch import reference_configs as rc

    solver = ML_SOLVER
    out = {"line": "ml_loop", "example": example, "package": pkg,
           "dtype": dtype}
    if example == "ml_mpc":
        backend, _conv = ml_mpc_backend(pkg, dtype, directory)
        T, temps, stats, caps = 297.5, [], [], []
        for k in range(20):
            if capture:
                caps.append({"now": k * rc.ML_DT, "T": T, "warm": {
                    key: (v if key == "cold" else np.asarray(v))
                    for key, v in backend.warm_state().items()}})
            res = backend.solve(k * rc.ML_DT, {"T": T})
            T = rc.ml_room_plant_step(T, res["u0"]["Q"])
            temps.append(T)
            stats.append(res["stats"])
        out.update(failed_at=[s["time"] for s in stats if not s["success"]],
                   iterations=[s["iterations"] for s in stats],
                   temperatures_K=temps)
        if capture:
            with open(capture, "wb") as fh:
                pickle.dump(caps, fh)
        return out
    if pkg == "jax":
        setup_jax(dtype == "f64")
        from agentlib_mpc_tpu.ml import load_serialized_model
        from agentlib_mpc_tpu.runtime.mas import LocalMAS
        from examples import three_zone_datadriven_admm as ex_admm

        kw = {}
    else:
        import torch

        from agentlib_mpc_torch.runtime.mas import LocalMAS

        kw = {"device": "cpu", "dtype": getattr(torch, {
            "f32": "float32", "f64": "float64"}[dtype])}
    docs = [_ml_doc(directory, f"zone{i}") for i in range(rc.ZONES_N)]
    if pkg == "jax":
        configs = ex_admm.agent_configs(
            [load_serialized_model(d) for d in docs])
    else:
        configs = rc.three_zone_datadriven_configs(docs)
    for agent in configs:
        for module in agent["modules"]:
            backend = module.get("optimization_backend")
            if backend is not None:
                backend["solver"] = {**backend["solver"], **solver}
                if agent["id"] == "AHU":
                    backend["solver"]["qp_fast_path"] = "on"
    mas = LocalMAS(configs, env={"rt": False}, **kw)
    mas.run(until=rc.ML_DT)
    modules = {aid: mas.agents[aid].get_module("admm")
               for aid in ("Zone_1", "Zone_2", "Zone_3", "AHU")}
    out.update(
        failed={aid: [k for k, s in enumerate(m.backend.stats_history)
                      if not s["success"]] for aid, m in modules.items()},
        iterations={aid: [s["iterations"] for s in m.backend.stats_history]
                    for aid, m in modules.items()},
        admm_iterations={aid: len(m._iter_rows)
                         for aid, m in modules.items()},
        first_moves=[float(np.asarray(
            modules[f"Zone_{i}"]._iter_rows[-1]["couplings"]["mDot"])[0])
            for i in (1, 2, 3)])
    return out


def ml_replay(pkg: str, capture: str, directory: str,
              seeds: int = 0) -> dict:
    """Every float32 surrogate-room solve of one package's loop (pickled
    by :func:`ml_loop`) replayed in ``pkg``'s float32 from the same plant
    state and warm state: failed solves, iterations and first controls.
    With ``seeds`` > 0 each solve instead starts ``seeds`` times from the
    warm state with its primal scaled by (1 + 1e-6·N(0, 1)) (numpy seed
    0): the failed (time, seed) pairs and the iterations per time."""
    import numpy as np

    with open(capture, "rb") as fh:
        caps = pickle.load(fh)
    backend, conv = ml_mpc_backend(pkg, "f32", directory)
    rng = np.random.default_rng(0)
    rows = []
    for c in caps:
        for seed in range(max(seeds, 1)):
            warm = dict(c["warm"])
            if seeds:
                w = np.asarray(warm["w"], dtype=np.float64)
                warm["w"] = (w * (1.0 + 1e-6 * rng.standard_normal(
                    w.shape))).astype(np.float32)
            backend.set_warm_state(conv(warm))
            res = backend.solve(c["now"], {"T": c["T"]})
            rows.append({"now": c["now"], "seed": seed, "success": bool(
                res["stats"]["success"]),
                "iterations": int(res["stats"]["iterations"]),
                "Q0": float(res["u0"]["Q"])})
    out = {"line": "ml_perturbed" if seeds else "ml_replay",
           "package": pkg,
           "states_from": os.path.basename(capture).split("_")[0]}
    if seeds:
        out.update(seeds=seeds, x0_rel=1e-6, solves=len(rows),
                   failed=[[r["now"], r["seed"]] for r in rows
                           if not r["success"]],
                   iterations={str(c["now"]): [r["iterations"] for r in rows
                                               if r["now"] == c["now"]]
                               for c in caps})
        return out
    out.update(failed_at=[r["now"] for r in rows if not r["success"]],
               iterations=[r["iterations"] for r in rows],
               Q0=[r["Q0"] for r in rows])
    return out


#: the surrogate room's solve the ``--fixture`` of ``--only ml_replay``
#: keeps: the JAX package's float32 loop solves it in 53 of 60 iterations
ML_FIXTURE_TIME = 300.0


def write_ml_fixture(path: str, capture: str, doc_path: str) -> None:
    """The surrogate (its JSON document) and the JAX package's float32
    plant and warm state before the solve at :data:`ML_FIXTURE_TIME`, as
    JSON at ``path``."""
    with open(capture, "rb") as fh:
        caps = pickle.load(fh)
    c = next(c for c in caps if c["now"] == ML_FIXTURE_TIME)
    with open(doc_path) as fh:
        doc = json.load(fh)
    warm = {k: (bool(v) if k == "cold" else
                [float(x) for x in v.reshape(-1)])
            for k, v in c["warm"].items()}
    with open(path, "w") as fh:
        json.dump({"now": c["now"], "T": float(c["T"]), "warm": warm,
                   "surrogate": doc}, fh)


#: the surrogate room's stored state (``--only ml_replay --fixture``)
ML_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_ml_room_f32_300.json")
#: interior-point iterations ``ml_trace`` follows both packages' iterates
ML_TRACE_STEPS = 10
#: perturbed starts (1e-6 relative on the warm primal) of ``ml_trace``
ML_TRACE_STARTS = 16


def _ml_step_arguments(backend, state: dict, run_step: bool):
    """What a backend's solve at the fixture's time hands its step (the
    backend's own input assembly); the JAX package's step is not run."""
    class Captured(Exception):
        pass

    step, caught = backend._step, {}

    def capture(*args):
        caught["args"] = args
        if not run_step:
            raise Captured
        return step(*args)

    backend._step = capture
    try:
        backend.solve(state["now"], {"T": state["T"]})
    except Captured:
        pass
    backend._step = step
    return caught["args"]


def ml_trace(path: str) -> dict:
    """From the JAX package's float32 state before the surrogate room's
    solve at t = 300 s (the fixture): both packages' NARX derivatives in
    f32 against f64, their iterates after 1..ML_TRACE_STEPS iterations in
    f32 and f64, and the outcomes of ML_TRACE_STARTS + 1 starts (the
    stored one and ones with the warm primal scaled by 1 + 1e-6·N(0, 1),
    numpy seed 0) in the port's backend, the JAX package's backend and the
    JAX package's bare ``solve_nlp`` (another compiled program)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from torch.func import hessian, jacrev

    from agentlib_mpc_torch.ops.solver import solve_nlp
    from agentlib_mpc_tpu.ops.solver import solve_nlp as jsolve

    with open(path) as fh:
        state = json.load(fh)
    directory = tempfile.mkdtemp(prefix="ml_trace_")
    with open(os.path.join(directory, "room.json"), "w") as fh:
        json.dump(state["surrogate"], fh)
    warm = {k: (v if k == "cold" else np.asarray(v, np.float32)
                .astype(np.float64)) for k, v in state["warm"].items()}
    rng = np.random.default_rng(0)
    starts = [warm["w"]] + [warm["w"] * (1.0 + 1e-6 * rng.standard_normal(
        warm["w"].shape)) for _ in range(ML_TRACE_STARTS)]

    def outcomes(backend, conv):
        ok = []
        for w0 in starts:
            backend.set_warm_state(conv({**warm, "w": w0}))
            ok.append(bool(backend.solve(state["now"], {"T": state["T"]})
                           ["stats"]["success"]))
        return ok

    out = {"line": "ml_trace", "time": state["now"], "starts": len(starts),
           "outcomes": {}}
    port, jx = {}, {}
    for dt in ("f32", "f64"):
        backend, conv = ml_mpc_backend("torch", dt, directory)
        backend.set_warm_state(conv(warm))
        (x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub, ml_params, w,
         y, z, mu0, t0) = _ml_step_arguments(backend, state, True)
        th = backend._theta0._replace(
            x0=x0, u_prev=u_prev, past=past, d_traj=d_traj, p=p, x_lb=x_lb,
            x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0, ml_params=ml_params)
        nlp, opts = backend.ocp.nlp, backend.solver_options
        lb, ub = backend.ocp.bounds(th)
        lag = lambda ww: (nlp.f(ww, th) + (y * nlp.g(ww, th)).sum()
                          + (z * nlp.h(ww, th)).sum())
        port[dt] = {k: v.double().numpy() for k, v in {
            "gf": jacrev(lambda ww: nlp.f(ww, th))(w),
            "Jg": jacrev(lambda ww: nlp.g(ww, th))(w),
            "H": hessian(lag)(w)}.items()}
        port[dt]["w"] = [solve_nlp(nlp, w, th, lb, ub, opts, y0=y, z0=z,
                                   mu0=mu0, max_iter=k).w.double().numpy()
                         for k in range(1, ML_TRACE_STEPS + 1)]
        if dt == "f32":
            out["outcomes"]["torch_backend"] = outcomes(backend, conv)
    for dt in ("f32", "f64"):
        backend, conv = ml_mpc_backend("jax", dt, directory)
        backend.set_warm_state(conv(warm))
        (x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub, ml_params, w,
         y, z, mu0, t0) = _ml_step_arguments(backend, state, False)
        ocp = backend.ocp
        nlp, opts = ocp.nlp, backend.solver_options
        th = ocp.default_params(
            x0=x0, u_prev=u_prev, past=past, d_traj=d_traj, p=p, x_lb=x_lb,
            x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0, ml_params=ml_params)
        lb, ub = ocp.bounds(th)
        lag = lambda ww: (nlp.f(ww, th) + jnp.sum(y * nlp.g(ww, th))
                          + jnp.sum(z * nlp.h(ww, th)))
        solve_k = jax.jit(lambda k: jsolve(nlp, w, th, lb, ub, opts, y0=y,
                                           z0=z, mu0=mu0, max_iter=k).w)
        jx[dt] = {
            "gf": np.asarray(jax.jit(jax.grad(lambda ww: nlp.f(ww, th)))(w),
                             np.float64),
            "Jg": np.asarray(jax.jit(jax.jacrev(
                lambda ww: nlp.g(ww, th)))(w), np.float64),
            "H": np.asarray(jax.jit(jax.hessian(lag))(w), np.float64),
            "w": [np.asarray(solve_k(jnp.asarray(k)), np.float64)
                  for k in range(1, ML_TRACE_STEPS + 1)]}
        if dt == "f32":
            bare = jax.jit(lambda w0: jsolve(nlp, w0, th, lb, ub, opts, y0=y,
                                             z0=z, mu0=mu0).stats.success)
            out["outcomes"]["jax_solve_nlp"] = [
                bool(bare(jnp.asarray(w0, jnp.float32))) for w0 in starts]
            out["outcomes"]["jax_backend"] = outcomes(backend, conv)
    rel = lambda a, b: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    out["derivatives"] = {key: {
        "torch_f32_vs_f64": rel(port["f32"][key], port["f64"][key]),
        "jax_f32_vs_f64": rel(jx["f32"][key], jx["f64"][key]),
        "torch_f64_vs_jax_f64": rel(port["f64"][key], jx["f64"][key])}
        for key in ("gf", "Jg", "H")}
    pairs = {"torch_f32_vs_f64": (port["f32"], port["f64"]),
             "jax_f32_vs_f64": (jx["f32"], jx["f64"]),
             "torch_f32_vs_jax_f32": (port["f32"], jx["f32"]),
             "torch_f64_vs_jax_f64": (port["f64"], jx["f64"])}
    out["iterates"] = {name: [rel(a["w"][k], b["w"][k])
                              for k in range(ML_TRACE_STEPS)]
                       for name, (a, b) in pairs.items()}
    out["converged"] = {k: sum(v) for k, v in out["outcomes"].items()}
    os.unlink(os.path.join(directory, "room.json"))
    os.rmdir(directory)
    return out


def ml_iterations(lines) -> dict:
    """Failed solves and iterations per solve of the ``ml_loop`` lines,
    by example, package and type, on a line of their own."""
    out = {"line": "ml_iterations"}
    for line in lines:
        if line.get("line") != "ml_loop":
            continue
        its = line["iterations"]
        its = its if isinstance(its, list) else [
            n for aid in sorted(its) for n in its[aid]]
        failed = line.get("failed_at", line.get("failed"))
        n_failed = len(failed) if isinstance(failed, list) else sum(
            len(v) for v in failed.values())
        out[f"{line['example']}_{line['package']}_{line['dtype']}"] = {
            "solves": len(its), "failed": n_failed,
            "per_solve": sum(its) / len(its)}
    return out


def child(argv):
    kind = argv[0]
    if kind == "ml_loop":
        out = ml_loop(argv[1], argv[2], argv[3], argv[4],
                      argv[5] if len(argv) > 5 else None)
    elif kind == "ml_trace":
        out = ml_trace(argv[1])
    elif kind == "ml_replay":
        out = ml_replay(argv[1], argv[2], argv[3],
                        int(argv[4]) if len(argv) > 4 else 0)
    elif kind == "loop":
        out = run_loop(argv[1], argv[2], argv[3],
                       argv[4] if len(argv) > 4 else None)
    elif kind == "replay":
        out = replay(argv[1], argv[2], argv[3] == "perturbed")
    elif kind == "trace":
        out = trace(argv[1])
    else:
        out = fixed_3900(argv[2] if len(argv) > 2 else None, int(argv[1]))
    print("RESULT " + json.dumps(out), flush=True)


def mhe_iterations(lines) -> dict:
    """The MHE QP's iterations per solve in the MHE example's loops, by
    package and type, on a line of its own."""
    out = {"line": "mhe_qp_iterations"}
    for line in lines:
        if line.get("line") == "loop" and line.get("example") == "mhe":
            its = line["mhe_iterations"]
            out[f"{line['package']}_{line['dtype']}"] = {
                "qp": line["mhe_qp"], "solves": len(its),
                "iterations": sum(its), "per_solve": sum(its) / len(its),
                "failed": len(line["mhe_failed_at"])}
    return out


def wedge_counts(line: dict) -> dict:
    """The ``fixed_3900`` line's wedged exits on a line of their own."""
    pert = line["perturbed"]
    return {"line": "fixed_3900_counts", "starts": pert["starts"],
            "seed": pert["seed"], "x0_rel": pert["x0_rel"],
            **{f"{pkg}_wedged": pert[pkg]["kkt_above_1e-3"]
               for pkg in ("jax", "torch")}}


def spawn(args, env):
    return subprocess.Popen([sys.executable, __file__, "--child", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, env=env)


def collect(procs):
    lines = []
    for proc in procs:
        out, _ = proc.communicate()
        found = [ln[len("RESULT "):] for ln in out.splitlines()
                 if ln.startswith("RESULT ")]
        lines.append(json.loads(found[-1]) if found else
                     {"line": "error", "returncode": proc.returncode})
    return lines


def main() -> int:
    if "--child" in sys.argv:
        child(sys.argv[sys.argv.index("--child") + 1:])
        return 0
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    parser.add_argument("--fixture", help="write the fixed program's "
                        "inputs at t = 3 900 s there (JSON); with --only "
                        "ml_replay the surrogate room's JAX float32 state "
                        "before its solve at t = 300 s")
    parser.add_argument("--starts", type=int, default=80,
                        help="perturbed starts of the fixed program")
    parser.add_argument("--only", choices=("fixed_3900", "mhe", "ml",
                                           "ml_replay"),
                        help="run only that line, or only the MHE "
                        "example's loops")
    args = parser.parse_args()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    tmp = tempfile.mkdtemp(prefix="module_f32_witness_")
    caps = {pkg: os.path.join(tmp, f"{pkg}_mhe_f32.pkl")
            for pkg in ("jax", "torch")}
    jobs = [["loop", pkg, dtype, example]
            + ([caps[pkg]] if (example, dtype) == ("mhe", "f32") else [])
            for example in ("mhe", "cia", "bb")
            for pkg in ("jax", "torch") for dtype in ("f32", "f64")]
    fixed = ["fixed_3900", str(args.starts)] + (
        [args.fixture] if args.fixture else [])
    lines = []
    if args.only is None:
        for start in range(0, len(jobs), 4):
            lines += collect([spawn(job, env)
                              for job in jobs[start:start + 4]])
        lines += collect([
            spawn(["replay", "jax", caps["torch"], "plain"], env),
            spawn(["replay", "torch", caps["jax"], "plain"], env),
            spawn(["replay", "jax", caps["jax"], "perturbed"], env),
            spawn(["replay", "torch", caps["jax"], "perturbed"], env)])
        lines += collect([spawn(["trace", caps["jax"]], env),
                          spawn(fixed, env)])
    elif args.only == "mhe":
        lines += collect([spawn(job, env) for job in jobs
                          if job[3] == "mhe"])
    elif args.only == "ml":
        paths = train_ml_surrogates(tmp)
        ml_jobs = [["ml_loop", pkg, dtype, example, tmp]
                   for example in ("ml_mpc", "ml_admm")
                   for pkg in ("jax", "torch") for dtype in ("f32", "f64")]
        for start in range(0, len(ml_jobs), 4):
            lines += collect([spawn(job, env)
                              for job in ml_jobs[start:start + 4]])
        lines.append(ml_iterations(lines))
        for path in paths.values():
            os.unlink(path)
    elif args.only == "ml_replay":
        paths = train_ml_surrogates(tmp)
        ml_caps = {pkg: os.path.join(tmp, f"{pkg}_ml_f32.pkl")
                   for pkg in ("jax", "torch")}
        lines += collect([spawn(["ml_loop", pkg, "f32", "ml_mpc", tmp,
                                 ml_caps[pkg]], env)
                          for pkg in ("jax", "torch")])
        lines += collect([spawn(["ml_replay", pkg, ml_caps[src], tmp], env)
                          for src in ("jax", "torch")
                          for pkg in ("jax", "torch")])
        lines += collect([spawn(["ml_replay", pkg, ml_caps["jax"], tmp,
                                 str(ML_PERTURBED_SEEDS)], env)
                          for pkg in ("jax", "torch")])
        if args.fixture:
            write_ml_fixture(args.fixture, ml_caps["jax"], paths["room"])
        lines += collect([spawn(["ml_trace", args.fixture or ML_FIXTURE],
                                env)])
        for path in (*paths.values(), *ml_caps.values()):
            os.unlink(path)
    else:
        lines += collect([spawn(fixed, env)])
    lines += [wedge_counts(line) for line in lines
              if line.get("line") == "fixed_3900"]
    if any(line.get("example") == "mhe" for line in lines):
        lines.append(mhe_iterations(lines))
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    for path in caps.values():
        if os.path.exists(path):
            os.unlink(path)
    os.rmdir(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
