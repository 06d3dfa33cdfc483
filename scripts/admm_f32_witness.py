#!/usr/bin/env python3
"""Float32 and float64 on the two ADMM configurations, both packages, CPU.

    JAX_PLATFORMS=cpu python3 scripts/admm_f32_witness.py [--out PATH]
        [--rounds R]

Which type each of ``chip_smoke.py``'s ADMM phases runs in:
``module_admm`` (``examples/admm_cooled_room.py``) in float32,
``module_admm_rt`` (the real-time pair of ``tests/test_admm_realtime.py``)
in float64. Every run uses the plain LDLᵀ in both packages
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

With ``--out`` the lines are also written to that file. Takes a few
minutes; the eight runs go in parallel subprocesses, four at a time.
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
#: the routing the JAX package's certificate proves for each agent's
#: augmented problem (its "auto" would spend a sampled probe on it)
JAX_ROUTES = {"CooledRoom": "off", "Room": "off", "Cooler": "on"}


def configs(kind: str, pkg: str):
    from agentlib_mpc_torch import reference_configs as rc

    solver = {"kkt_method": "ldl"}
    cfgs = (rc.admm_cooled_room_configs(solver=solver) if kind == "loop"
            else rc.admm_realtime_pair_configs(solver=solver))
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
    out = loop(pkg, dtype) if kind == "loop" else rt(pkg, dtype,
                                                     int(argv[3]))
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    if "--child" in sys.argv:
        child(sys.argv[sys.argv.index("--child") + 1:])
        return 0
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    jobs = [[kind, pkg, dtype] + ([str(args.rounds)] if kind == "rt"
                                  else [])
            for kind in ("loop", "rt") for pkg in ("jax", "torch")
            for dtype in ("f32", "f64")]
    lines = []
    for start in range(0, len(jobs), 4):
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--child", *job],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env) for job in jobs[start:start + 4]]
        for job, proc in zip(jobs[start:start + 4], procs):
            out, _ = proc.communicate()
            found = [ln[len("RESULT "):] for ln in out.splitlines()
                     if ln.startswith("RESULT ")]
            lines.append(json.loads(found[-1]) if found else
                         {"line": "error", "job": job,
                          "returncode": proc.returncode})
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
