#!/usr/bin/env python3
"""Solved lanes of the day-ahead shooting fleet in float32 and float64,
both packages, CPU.

    JAX_PLATFORMS=cpu python3 scripts/shooting_f32_share.py [--zones 32]
        [--packages jax,torch]

``chip_smoke.py``'s ``shooting`` phase solves 256 zones a day ahead
(``ZoneWithSupply``, N=96, dt 900 s, multiple shooting with rk4 and 3
sub-steps, tol 1e-4, 50 iterations, the corrector) in f32 and in f64 and
compares which lanes each solves. This script solves the same fleet
(``fleet_inputs``: temperatures and loads spread evenly over their
ranges, ``zones`` lanes) with each package's ``solve_nlp_batched`` on the
CPU ("auto": the stage sweep), one subprocess per package and type, and
prints one JSON line each: the share of lanes solved, the lanes as a
string of 0/1, and the iterations per lane.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, DT, SUBSTEPS, MAX_ITER = 96, 900.0, 3, 50
SOLVER = {"tol": 1e-4, "max_iter": MAX_ITER, "corrector": True}
X0_RANGE, LOAD_RANGE = (294.0, 300.0), (80.0, 250.0)
D_TAIL = (290.15, 294.15)


def solve_torch(dtype_name: str, zones: int):
    import numpy as np
    import torch

    from agentlib_mpc_torch.models.zoo import ZoneWithSupply
    from agentlib_mpc_torch.ops.solver import (
        SolverOptions,
        attach_stage_partition,
        solve_nlp_batched,
    )
    from agentlib_mpc_torch.ops.transcription import transcribe

    dtype = getattr(torch, dtype_name)
    ocp = transcribe(ZoneWithSupply(), ["mDot"], N=N, dt=DT,
                     method="multiple_shooting", integrator="rk4",
                     integrator_substeps=SUBSTEPS)
    theta0 = ocp.default_params(device="cpu", dtype=dtype)
    x0 = torch.as_tensor(np.linspace(*X0_RANGE, zones), dtype=dtype)
    load = torch.as_tensor(np.linspace(*LOAD_RANGE, zones), dtype=dtype)
    d_row = torch.cat([load[:, None],
                       torch.tensor(D_TAIL, dtype=dtype).expand(zones, 2)],
                      -1)
    theta = theta0._replace(
        x0=x0[:, None], d_traj=d_row[:, None, :].expand(zones, N, 3),
        **{k: v.expand((zones,) + v.shape)
           for k, v in theta0._asdict().items()
           if k not in ("x0", "d_traj")})
    lb, ub = torch.func.vmap(ocp.bounds)(theta)
    w0 = torch.func.vmap(ocp.initial_guess)(theta)
    opts = attach_stage_partition(SolverOptions(**SOLVER),
                                  ocp.stage_partition)
    stats = solve_nlp_batched(ocp.nlp, w0, theta, lb, ub, opts).stats
    return stats.success.numpy(), stats.iterations.numpy()


def solve_jax(dtype_name: str, zones: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype_name == "float64")
    import jax.numpy as jnp
    import numpy as np

    from agentlib_mpc_tpu.models.zoo import ZoneWithSupply
    from agentlib_mpc_tpu.ops.solver import (
        SolverOptions,
        attach_stage_partition,
        solve_nlp_batched,
    )
    from agentlib_mpc_tpu.ops.transcription import transcribe

    dtype = getattr(jnp, dtype_name)
    ocp = transcribe(ZoneWithSupply(), ["mDot"], N=N, dt=DT,
                     method="multiple_shooting", integrator="rk4",
                     integrator_substeps=SUBSTEPS)
    theta0 = ocp.default_params()
    x0 = jnp.asarray(np.linspace(*X0_RANGE, zones), dtype)
    load = jnp.asarray(np.linspace(*LOAD_RANGE, zones), dtype)
    d_row = jnp.concatenate(
        [load[:, None], jnp.broadcast_to(jnp.asarray(D_TAIL, dtype),
                                         (zones, 2))], -1)
    theta = theta0._replace(
        x0=x0[:, None],
        d_traj=jnp.broadcast_to(d_row[:, None, :], (zones, N, 3)),
        **{k: jnp.broadcast_to(jnp.asarray(v, dtype),
                               (zones,) + jnp.shape(v))
           for k, v in theta0._asdict().items()
           if k not in ("x0", "d_traj")})
    lb, ub = jax.vmap(ocp.bounds)(theta)
    w0 = jax.vmap(ocp.initial_guess)(theta)
    opts = attach_stage_partition(SolverOptions(**SOLVER),
                                  ocp.stage_partition)
    stats = solve_nlp_batched(ocp.nlp, w0, theta, lb, ub, opts).stats
    return np.asarray(stats.success), np.asarray(stats.iterations)


def child(package: str, dtype_name: str, zones: int) -> None:
    solve = solve_jax if package == "jax" else solve_torch
    success, iterations = solve(dtype_name, zones)
    print("RESULT " + json.dumps({
        "package": package, "dtype": dtype_name, "zones": zones,
        "share": float(success.mean()),
        "solved": "".join(str(int(s)) for s in success),
        "iterations": [int(i) for i in iterations]}), flush=True)


def main() -> int:
    if "--child" in sys.argv:
        package, dtype_name, zones = sys.argv[sys.argv.index("--child")
                                              + 1:][:3]
        child(package, dtype_name, int(zones))
        return 0
    parser = argparse.ArgumentParser()
    parser.add_argument("--zones", type=int, default=32)
    parser.add_argument("--packages", default="jax,torch")
    args = parser.parse_args()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--child", package, dtype_name,
         str(args.zones)], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env)
        for package in args.packages.split(",")
        for dtype_name in ("float32", "float64")]
    for proc in procs:
        out, _ = proc.communicate()
        found = [ln[len("RESULT "):] for ln in out.splitlines()
                 if ln.startswith("RESULT ")]
        print(found[-1] if found else json.dumps(
            {"error": proc.returncode}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
