#!/usr/bin/env python3
"""Float32 against float64 on the scenario-tree workloads, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/scenario_f32_witness.py [--only ab|fleet]
        [--zones N]

Which gates ``chip_smoke.py``'s ``scenario_ab`` and ``scenario_fleet``
phases can hold in float32. Both run with the plain LDLᵀ
(``kkt_method="ldl"``). One JSON line each:

- ``ab``: ``bench.py``'s ``--scenario-ab`` legs at 4 zones × 8 scenarios
  (``chip_smoke.scenario_ab_run``: 8 serial single-scenario rounds and the
  uncoupled batched round with pinned Boyd exits, the robust round, the
  robust controls of zone 0 and their warm re-solve) in the port, float32
  against float64: per leg the largest z̄ and u0 differences and the
  iterations; and the serial legs of the JAX package (its ScenarioFleet on
  the same parameters) float32 against float64.
- ``fleet``: the port's ``scenario_fleet`` rounds (``--zones`` zones,
  default 256, × a fan of 8 scenarios, a cold and a warm round) float32
  against float64: z̄ and u0 differences and the iterations per round.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def port_ab() -> dict:
    import torch

    import chip_smoke as cs

    r32 = cs.scenario_ab_run(torch, "cpu", torch.float32, lambda: None)
    r64 = cs.scenario_ab_run(torch, "cpu", torch.float64, lambda: None)
    return {"line": "ab", "package": "torch",
            "legs": cs.scenario_ab_quality(r32, r64)}


def jax_ab() -> dict:
    """The JAX package's serial legs (its ScenarioFleet, one scenario,
    pinned exits) in float32 and float64 on the same parameters."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import chip_smoke as cs
    from agentlib_mpc_torch.parallel import admm_step as A
    from agentlib_mpc_tpu import scenario as J
    from agentlib_mpc_tpu.models.zoo import ZoneWithSupply
    from agentlib_mpc_tpu.ops.solver import SolverOptions
    from agentlib_mpc_tpu.ops.transcription import transcribe
    from agentlib_mpc_tpu.parallel.fused_admm import AgentGroup

    n, S = cs.SCENARIO_AB_ZONES, cs.SCENARIOS

    def run(x64: bool):
        with jax.enable_x64(x64):
            dt = jnp.float64 if x64 else jnp.float32
            ocp = transcribe(ZoneWithSupply(), ["mDot"], N=A.HORIZON,
                             dt=A.DT, method="collocation",
                             collocation_degree=2)
            x0s, loads = A.fleet_inputs(n)
            rows = []
            for i in range(n):
                d = np.tile([loads[i], *A.ZONE_D_ROW_TAIL], (A.HORIZON, 1))
                th = ocp.default_params(x0=jnp.asarray([x0s[i]], dt),
                                        d_traj=jnp.asarray(d, dt))
                rows.append(J.ensemble_thetas(
                    th, J.fan_tree(S), seed=i,
                    scale=cs.SCENARIO_AB_LOAD_SCALE * loads[i],
                    channels=(0,)))
            thetas = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
            group = AgentGroup(
                name="zones", ocp=ocp, n_agents=n,
                couplings={cs.SCENARIO_ALIAS: "mDot"},
                solver_options=SolverOptions(**A.SOLVER_BASE,
                                             mu_init=A.COLD_MU,
                                             kkt_method="ldl"))
            opts = J.ScenarioFleetOptions(
                **cs.scenario_options(pinned=True)._asdict())
            fleet = J.ScenarioFleet(group, J.single_scenario(), opts)
            out = []
            for s in range(S):
                th = jax.tree.map(lambda leaf, s=s: leaf[:, s:s + 1], thetas)
                st, _, stats = fleet.step(fleet.init_state(th), th)
                u = jax.vmap(jax.vmap(
                    lambda w: ocp.unflatten(w)["u"]))(st.w)[:, :, 0, :]
                out.append((np.asarray(st.zbar[cs.SCENARIO_ALIAS],
                                       np.float64),
                            np.asarray(u, np.float64),
                            int(stats.iterations)))
            return out

    a, b = run(False), run(True)
    return {"line": "ab", "package": "jax", "legs": {"serial": [{
        "iterations": [a[s][2], b[s][2]],
        "zbar_max_abs_diff": float(np.abs(a[s][0] - b[s][0]).max()),
        "u0_max_abs_diff": float(np.abs(a[s][1] - b[s][1]).max())}
        for s in range(S)]}}


def port_fleet(zones: int) -> dict:
    import torch

    import chip_smoke as cs
    from agentlib_mpc_torch.scenario import fan_tree

    tree = fan_tree(cs.SCENARIOS, robust_horizon=1)
    rows = {}
    for dtype in (torch.float32, torch.float64):
        fleet, ocp = cs.scenario_fleet(torch, zones, tree, "cpu",
                                       kkt_method="ldl")
        thetas = cs.scenario_thetas(torch, ocp, zones, "cpu", dtype)
        rows[dtype] = cs.scenario_rounds(torch, fleet, thetas, 2,
                                         lambda: None)
    out = []
    for r32, r64 in zip(rows[torch.float32], rows[torch.float64]):
        z32 = r32["state"].zbar[cs.SCENARIO_ALIAS].double()
        z64 = r64["state"].zbar[cs.SCENARIO_ALIAS]
        out.append({"iterations": [int(r32["stats"].iterations),
                                   int(r64["stats"].iterations)],
                    "zbar_max_abs_diff": float((z32 - z64).abs().max()),
                    "u0_max_abs_diff": float(
                        (r32["u0"].double() - r64["u0"]).abs().max())})
    return {"line": "fleet", "zones": zones, "scenarios": cs.SCENARIOS,
            "rounds": out}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", choices=("ab", "fleet"))
    parser.add_argument("--zones", type=int, default=256)
    args = parser.parse_args()
    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    lines = []
    if args.only in (None, "ab"):
        lines += [port_ab(), jax_ab()]
    if args.only in (None, "fleet"):
        lines.append(port_fleet(args.zones))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
