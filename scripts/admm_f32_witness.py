#!/usr/bin/env python3
"""Float32 and float64 on the four ADMM configurations, both packages, CPU.

    JAX_PLATFORMS=cpu python3 scripts/admm_f32_witness.py [--out PATH]
        [--rounds R] [--fixture PATH] [--only coord4,exchange4]

Which type each of ``chip_smoke.py``'s ADMM phases runs in:
``module_admm`` (``examples/admm_cooled_room.py``) in float32,
``module_admm_rt`` (the real-time pair of ``tests/test_admm_realtime.py``)
in float64, ``module_admm_coord`` (``examples/admm_4rooms_coordinator.py``)
in float64 and ``module_admm_exchange`` (``examples/exchange_admm_4rooms.py``)
in float32. Every run uses the plain LDLᵀ in both packages
(``kkt_method="ldl"``: in the port the arithmetic of the card's kernels,
in the JAX package that of its TPU kernels), with the configs of
``agentlib_mpc_torch/reference_configs.py`` (the JAX package resolves the
same zoo names) and the JAX package's routing forced to what its
certificate proves (room NLP, cooler QP). One JSON line each:

- ``loop``: the cooled-room example's three agents to 1 800 s, the depth
  of ``module_admm``, per package and type: per agent the solves, the
  failed ones and the summed iterations; the ADMM iterations of each
  control step; the final room temperature; the largest gap between the
  two agents' air-flow trajectories at the last iteration.
- ``rt``: the real-time pair's rounds driven by hand (both agents'
  ``admm_step`` at once in two threads, as their worker threads run them;
  ``--rounds`` rounds, 3 by default), per package and type: per agent the
  solves, the failed ones and the KKT error of each.
- ``coord4`` and ``exchange4``: the two four-room examples to 600 s (two
  control steps, the depth of their chip phases), per package and type:
  per agent the solves, the failed ones and the summed iterations; the
  ADMM iterations of each control step; each room's final temperature and
  mean actuated air flow; the peak total actuated flow (``coord4``) or the
  supplier's last flow against the rooms' total (``exchange4``).
- ``failed``: one line per failed solve of those two loops: loop,
  package, type, agent, time, ADMM iteration, interior-point iterations
  and KKT error.

With ``--fixture`` the JAX package's float64 ``coord4`` loop also writes
the inputs and warm state of its first failed AHU solve there as JSON
(``tests/test_torch_exchange_admm.py`` replays it). ``--only`` runs only
the named kinds. With ``--out`` the lines are also written to that file.
Takes about 10 minutes on 8 cores; the runs go in parallel subprocesses,
four at a time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

UNTIL = 1800.0
#: the four-room loops' depth (two control steps)
FOUR_ROOM_UNTIL = 600.0
KINDS = ("loop", "rt", "coord4", "exchange4")
#: the routing the JAX package's certificate proves for each agent's
#: augmented problem (its "auto" would spend a sampled probe on it)
JAX_ROUTES = {"CooledRoom": "off", "Room": "off", "Cooler": "on",
              "AHU": "on", "Supplier": "on",
              **{f"Room_{i}": "off" for i in range(1, 5)}}


def configs(kind: str, pkg: str):
    from agentlib_mpc_torch import reference_configs as rc

    solver = {"kkt_method": "ldl"}
    cfgs = {"loop": rc.admm_cooled_room_configs,
            "rt": rc.admm_realtime_pair_configs,
            "coord4": rc.admm_4rooms_coordinator_configs,
            "exchange4": rc.exchange_admm_4rooms_configs}[kind](
                solver=solver)
    if pkg == "jax":
        for agent in cfgs:
            for module in agent["modules"]:
                backend = module.get("optimization_backend")
                if backend is not None:
                    backend["solver"]["qp_fast_path"] = \
                        JAX_ROUTES[agent["id"]]
    return cfgs


def make_mas(kind: str, pkg: str, dtype: str):
    env = {"rt": kind == "rt"}
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", dtype == "f64")
        import agentlib_mpc_tpu.modules  # noqa: F401 - registers types
        from agentlib_mpc_tpu.runtime.mas import LocalMAS

        return LocalMAS(configs(kind, pkg), env=env)
    import torch

    from agentlib_mpc_torch.runtime.mas import LocalMAS

    torch.set_num_threads(1)
    return LocalMAS(configs(kind, pkg), env=env, device="cpu",
                    dtype=torch.float32 if dtype == "f32"
                    else torch.float64)


def solves_of(module) -> dict:
    rows = module.backend.stats_history
    return {"solves": len(rows),
            "failed": sum(not r["success"] for r in rows),
            "iterations": sum(int(r["iterations"]) for r in rows),
            "kkt_error": [float(r["kkt_error"]) for r in rows]}


def loop(pkg: str, dtype: str) -> dict:
    import numpy as np

    mas = make_mas("loop", pkg, dtype)
    mas.run(until=UNTIL)
    room = mas.agents["CooledRoom"].get_module("admm")
    cooler = mas.agents["Cooler"].get_module("admm")
    rows = mas.agents["Simulation"].get_module("simulator")._rows
    step = lambda r: int(np.floor(r["time"] / room.time_step + 1e-9))
    per_step = {}
    for r in room._iter_rows:
        per_step[step(r)] = per_step.get(step(r), 0) + 1
    last_room, last_cooler = room._iter_rows[-1], cooler._iter_rows[-1]
    gap = float(np.abs(np.asarray(last_room["couplings"]["mDot"])
                       - np.asarray(last_cooler["couplings"]["mDot_out"]))
                .max())
    out = {"line": "loop", "package": pkg, "dtype": dtype, "until": UNTIL,
           "room": solves_of(room), "cooler": solves_of(cooler),
           "admm_iterations_per_step": [per_step[k]
                                        for k in sorted(per_step)],
           "final_room_temperature_K": float(rows[-1]["T_out"]),
           "last_iteration_gap": gap}
    for agent in ("room", "cooler"):
        out[agent].pop("kkt_error")
    return out


def to_json(tree):
    """Arrays as lists of floats, nested in dicts, lists and tuples (a
    solve's inputs and warm state)."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: to_json(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_json(v) for v in tree]
    if tree is None or isinstance(tree, (str, bool)):
        return tree
    arr = np.asarray(tree)
    return arr.tolist() if arr.dtype == bool else \
        arr.astype(float).tolist()


def four_rooms(kind: str, pkg: str, dtype: str,
               fixture: str | None) -> list:
    """One four-room loop to 600 s: its ``coord4``/``exchange4`` line and
    one ``failed`` line per failed solve."""
    import numpy as np

    mas = make_mas(kind, pkg, dtype)
    aids = [f"Room_{i}" for i in range(1, 5)] + [
        "AHU" if kind == "coord4" else "Supplier"]
    modules = {aid: mas.agents[aid].get_module("admm") for aid in aids}
    capture = fixture is not None and pkg == "jax" and dtype == "f64" \
        and kind == "coord4"
    if capture:
        ahu = modules["AHU"].backend
        solve, starts = ahu.solve, []

        def captured(now, variables):
            starts.append((now, {k: np.asarray(v) if not isinstance(
                v, (int, float)) else v for k, v in variables.items()},
                {k: (v if k == "cold" else np.asarray(v))
                 for k, v in ahu.warm_state().items()}))
            return solve(now, variables)

        ahu.solve = captured
    mas.run(until=FOUR_ROOM_UNTIL)
    step = lambda r: int(np.floor(r["time"] / 300.0 + 1e-9))
    out = {"line": kind, "package": pkg, "dtype": dtype,
           "until": FOUR_ROOM_UNTIL}
    failed = []
    for aid, module in modules.items():
        per_step: dict = {}
        for row, stats in zip(module._iter_rows,
                              module.backend.stats_history):
            k = step(row)
            it = per_step.get(k, 0)
            per_step[k] = it + 1
            if not stats["success"]:
                failed.append({"line": "failed", "loop": kind,
                               "package": pkg, "dtype": dtype,
                               "agent": aid, "time": k * 300.0,
                               "admm_iteration": it,
                               "ip_iterations": int(stats["iterations"]),
                               "kkt_error": float(stats["kkt_error"])})
        out[aid] = {**solves_of(module),
                    "admm_iterations_per_step": [per_step[k]
                                                 for k in sorted(per_step)]}
        out[aid].pop("kkt_error")
    temps, flows = {}, {}
    for i in range(1, 5):
        rows = mas.agents[f"Simulation_{i}"].get_module("simulator")._rows
        temps[i] = [float(r["T_out"]) for r in rows]
        flows[i] = [float(r["mDot"]) for r in rows]
    out["final_room_temperature_K"] = [temps[i][-1] for i in range(1, 5)]
    out["mean_flow"] = [float(np.mean(flows[i])) for i in range(1, 5)]
    out["mean_flow_4_minus_1"] = out["mean_flow"][3] - out["mean_flow"][0]
    out["building_cools"] = bool(np.mean([temps[i][-1] for i in temps])
                                 < np.mean([temps[i][0] for i in temps]))
    if kind == "coord4":
        out["peak_total_flow"] = float(np.max(np.sum(
            [flows[i] for i in range(1, 5)], axis=0)))
        coord = mas.agents["Coordinator"].get_module("coordinator")
        stats = coord.results()
        out["admm_iterations_per_round"] = [
            int(n) for n in stats.groupby(level="time").size()]
    else:
        supply = float(modules["Supplier"].vars["mDot"].value)
        out["supplier_flow"] = supply
        out["total_room_flow_last"] = float(sum(flows[i][-1]
                                                for i in range(1, 5)))
    if capture:
        first = next((k for k, r in enumerate(
            modules["AHU"].backend.stats_history) if not r["success"]),
            None)
        if first is not None:
            now, variables, warm = starts[first]
            with open(fixture, "w") as fh:
                json.dump({"now": now, "variables": to_json(variables),
                           "warm": to_json(warm),
                           "stats": to_json(modules["AHU"].backend
                                            .stats_history[first])}, fh)
    return [out, *failed]


def rt(pkg: str, dtype: str, rounds: int) -> dict:
    mas = make_mas("rt", pkg, dtype)
    modules = {aid: mas.agents[aid].get_module("admm")
               for aid in ("Room", "Cooler")}
    errors = []

    def run(module):
        try:
            module.admm_step()
        except Exception as exc:  # noqa: BLE001 - reported in the line
            errors.append(repr(exc))

    for _ in range(rounds):
        threads = [threading.Thread(target=run, args=(m,))
                   for m in modules.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return {"line": "rt", "package": pkg, "dtype": dtype, "rounds": rounds,
            "errors": errors,
            **{aid: solves_of(m) for aid, m in modules.items()}}


def child(argv):
    kind, pkg, dtype = argv[:3]
    if kind == "loop":
        out = [loop(pkg, dtype)]
    elif kind == "rt":
        out = [rt(pkg, dtype, int(argv[3]))]
    else:
        out = four_rooms(kind, pkg, dtype, argv[3] if len(argv) > 3
                         else None)
    for line in out:
        print("RESULT " + json.dumps(line), flush=True)


def main() -> int:
    if "--child" in sys.argv:
        child(sys.argv[sys.argv.index("--child") + 1:])
        return 0
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--fixture", help="write the JAX package's first "
                        "failed AHU solve of its f64 coord4 loop there")
    parser.add_argument("--only", help="comma-separated kinds to run, of "
                        + ", ".join(KINDS))
    args = parser.parse_args()
    kinds = args.only.split(",") if args.only else KINDS
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    extra = {"rt": [str(args.rounds)],
             "coord4": [os.path.abspath(args.fixture)] if args.fixture
             else []}
    jobs = [[kind, pkg, dtype] + extra.get(kind, [])
            for kind in kinds for pkg in ("jax", "torch")
            for dtype in ("f32", "f64")]
    lines = []
    for start in range(0, len(jobs), 4):
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--child", *job],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env) for job in jobs[start:start + 4]]
        for job, proc in zip(jobs[start:start + 4], procs):
            out, _ = proc.communicate()
            found = [json.loads(ln[len("RESULT "):])
                     for ln in out.splitlines() if ln.startswith("RESULT ")]
            lines += found or [{"line": "error", "job": job,
                                "returncode": proc.returncode}]
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
