#!/usr/bin/env python3
"""The fused linear fleet in float32 against float64, through the JAX
package and the port, on the CPU.

    python3 scripts/fused_linear_f32.py [zones] [kkt_method]

Builds ``bench.py``'s linear fleet (``LinearRCZone``, N=10, inner
budgets 10 / 1 with the Mehrotra corrector, ρ 5e-3) as one group of each
package's ``FusedADMM`` with the Boyd exits pinned to zero, runs two
rounds from one state in float64 (plain LDLᵀ) and in float32 (on
``kkt_method``, default ``ldl``) in each package, and prints one JSON
line per round: z̄ and the median |Δu| of each package's float32 rounds
against the JAX package's float64 rounds (the run-off), of the port's
float32 against the JAX package's float32, of the two float64 runs, and
the spreads max|u − z̄|. This is the reference behaviour that
``chip_smoke.py``'s ``fused_linear`` phase reports beside the card's
rounds, and that ``tests/test_torch_fused_f32.py`` holds at 8 zones.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROUNDS = 2


def fleet(pkg: str, n: int, kkt_method: str, dtype):
    """(engine, thetas) of one package; the JAX package's precision is
    the x64 flag in force, the port's ``dtype``."""
    import bench

    if pkg == "jax":
        import jax.numpy as jnp

        from agentlib_mpc_tpu.models.zoo import LinearRCZone
        from agentlib_mpc_tpu.ops.solver import SolverOptions
        from agentlib_mpc_tpu.ops.transcription import transcribe
        from agentlib_mpc_tpu.parallel import fused_admm as fa
        kw = {}
    else:
        import torch

        from agentlib_mpc_torch.models.zoo import LinearRCZone
        from agentlib_mpc_torch.ops.solver import SolverOptions
        from agentlib_mpc_torch.ops.transcription import transcribe
        from agentlib_mpc_torch.parallel import fused_admm as fa
        kw = {"device": "cpu"}
    ocp = transcribe(LinearRCZone(), ["Q"], N=bench.HORIZON, dt=bench.DT,
                     method="collocation", collocation_degree=2)
    cold = SolverOptions(**bench.SOLVER_BASE, mu_init=bench.COLD_MU,
                         kkt_method=kkt_method)
    group = fa.AgentGroup(
        name="zones", ocp=ocp, n_agents=n, couplings={"Q": "Q"},
        solver_options=cold,
        warm_solver_options=cold._replace(max_iter=bench.WARM_BUDGET,
                                          mu_init=bench.WARM_MU))
    engine = fa.FusedADMM([group], fa.FusedADMMOptions(
        max_iterations=bench.ADMM_ITERS, rho=5e-3, abs_tol=0.0, rel_tol=0.0,
        primal_tol=0.0, dual_tol=0.0), **kw)
    x0s, loads = bench.fleet_inputs(n)
    rows = []
    for x0, load in zip(x0s, loads):
        d = np.broadcast_to([load, 303.15, 295.15], (bench.HORIZON, 3))
        if pkg == "jax":
            rows.append(ocp.default_params(x0=jnp.array([x0]),
                                           d_traj=jnp.asarray(d)))
        else:
            rows.append(ocp.default_params(
                device="cpu", dtype=dtype, x0=torch.tensor([x0], dtype=dtype),
                d_traj=torch.tensor(d.copy(), dtype=dtype)))
    return engine, [fa.stack_params(rows)]


def rounds(pkg: str, n: int, kkt_method: str, dtype=None) -> np.ndarray:
    """(ROUNDS, 1 + n, N) float64: per round z̄ and each zone's controls."""
    engine, thetas = fleet(pkg, n, kkt_method, dtype)
    state = engine.init_state(thetas)
    out = []
    for _ in range(ROUNDS):
        state, trajs, _ = engine.step(state, thetas)
        zbar, u = state.zbar["Q"], trajs[0]["u"][..., 0]
        if pkg == "torch":
            zbar, u = zbar.numpy(), u.numpy()
        out.append(np.concatenate([np.asarray(zbar, np.float64)[None],
                                   np.asarray(u, np.float64)]))
    return np.stack(out)


def gaps(a: np.ndarray, b: np.ndarray) -> dict:
    return {"zbar_max_abs_diff_W": float(np.abs(a[0] - b[0]).max()),
            "u_median_abs_diff_W": float(np.median(np.abs(a[1:] - b[1:])))}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    kkt_method = sys.argv[2] if len(sys.argv) > 2 else "ldl"
    with jax.enable_x64(True):
        jax64 = rounds("jax", n, "ldl")
    with jax.enable_x64(False):
        jax32 = rounds("jax", n, kkt_method)
    port64 = rounds("torch", n, "ldl", torch.float64)
    port32 = rounds("torch", n, kkt_method, torch.float32)
    for k in range(ROUNDS):
        print(json.dumps({
            "round": k, "zones": n, "f32_kkt_method": kkt_method,
            "jax_f32_vs_jax_f64": gaps(jax32[k], jax64[k]),
            "port_f32_vs_jax_f64": gaps(port32[k], jax64[k]),
            "port_f32_vs_jax_f32": gaps(port32[k], jax32[k]),
            "port_f64_vs_jax_f64": gaps(port64[k], jax64[k]),
            "spread_W": {name: float(np.abs(r[k][1:] - r[k][0]).max())
                         for name, r in (("jax_f64", jax64),
                                         ("jax_f32", jax32),
                                         ("port_f64", port64),
                                         ("port_f32", port32))}}))


if __name__ == "__main__":
    main()
