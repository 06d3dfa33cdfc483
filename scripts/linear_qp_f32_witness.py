#!/usr/bin/env python3
"""Why the linear-QP agent's closed loop fails solves in float32, on the
card and on the CPU.

    python3 scripts/linear_qp_f32_witness.py [--out PATH]

The agent of ``examples/linear_qp_mpc.py``
(``agentlib_mpc_torch/reference_configs.py``: ``LinearRCZone``, N=8, the
QP fast path, KKT 74) runs its 7 200 s closed loop through the port's
``LocalMAS`` in several ways, and the script prints one JSON line each:

- ``loop``: per route, the solves that failed, the interior-point
  iterations per solve, u0 per solve and the plant's final temperature.
  Routes: float32 on the card through the LDLᵀ kernels ("auto") and
  through pivoted LU ("lu"); float32 on the CPU through the plain LDLᵀ
  and through LU; float64 on the card through the float64 kernels and on
  the CPU through the plain LDLᵀ (the reference). Without a card only the
  CPU routes run.
- ``sensitivity``: how far the float64 loop on the CPU (plain LDLᵀ)
  moves when its start temperature is raised by 1e-12 K and by 1e-9 K:
  the largest |Δu0| over the 25 solves and the solves whose iteration
  count changed. With tol 1e-4, where a solve stops moves u0 by watts,
  and the closed loop carries that on; two loops that differ only in
  rounding are therefore compared solve by solve, not as sequences.
- ``first_solve``: the first solve (same inputs on every route) in float32
  on the card and on the CPU, one row per KKT factorization: the largest
  relative difference between the card's and the CPU's KKT matrix, the
  largest difference between the kernel's factor of the card's matrix and
  the plain version's factor of the same matrix on the CPU, and each
  route's smallest |pivot| over the largest (the pivot-free factor's
  breakdown: it reaches 0 where a soft-constraint barrier weight
  condensed into the primal block cancels every bit of a pivot).

With ``--out`` the lines are also written to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

UNTIL = 7200.0


def run_loop(torch, device, dtype, kkt_method, start_offset_K=0.0):
    """One closed loop: per solve success, iterations, u0; the plant's
    final temperature. ``start_offset_K`` raises the start temperature of
    the plant and of the controller's state."""
    from agentlib_mpc_torch.reference_configs import linear_qp_config
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    solver = {} if kkt_method == "auto" else {"kkt_method": kkt_method}
    config = linear_qp_config(solver)
    if start_offset_K:
        mpc, sim = config["modules"][1], config["modules"][2]
        for var in (mpc["states"][0], sim["model"]["states"][0],
                    sim["outputs"][0]):
            var["value"] += start_offset_K
    mas = LocalMAS([config], env={"rt": False}, device=device, dtype=dtype)
    agent = mas.agents["LinearZone"]
    backend = agent.get_module("mpc").backend
    u0 = []
    solve = backend.solve

    def recorded(now, variables):
        result = solve(now, variables)
        u0.append(float(result["u0"]["Q"]))
        return result

    backend.solve = recorded
    mas.run(until=UNTIL)
    stats = backend.stats_history
    return {"device": str(device), "dtype": str(dtype).replace("torch.", ""),
            "kkt_method": kkt_method,
            "kkt_path": sorted({r["kkt_path"] for r in stats}),
            "failed": [k for k, r in enumerate(stats) if not r["success"]],
            "iterations": [int(r["iterations"]) for r in stats],
            "u0_W": u0,
            "final_plant_K": float(agent.get_module("sim")._rows[-1]["T_out"])}


def first_solve_factors(torch, device):
    """The KKT matrices (as assembled and equilibrated) and LDLᵀ factors
    of the first float32 solve on ``device``, on the host in float64."""
    from agentlib_mpc_torch.ops import qp
    from agentlib_mpc_torch.reference_configs import linear_qp_config
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    mas = LocalMAS([linear_qp_config({"kkt_method": "ldl"})],
                   env={"rt": False}, device=device, dtype=torch.float32)
    module = mas.agents["LinearZone"].get_module("mpc")
    records = []
    factor = qp._factor_kkt

    def recorded(K, method, partition=None):
        out = factor(K, method, partition)
        LD, Ks, _ = out[1]
        records.append((K.detach().double().cpu(), Ks.detach().cpu(),
                        LD.detach().double().cpu()))
        return out

    qp._factor_kkt = recorded
    try:
        module.backend.solve(0.0, module.collect_variables_for_optimization())
    finally:
        qp._factor_kkt = factor
    return records


def pivot_ratio(LD) -> float:
    d = LD.diagonal(dim1=-2, dim2=-1).abs()
    return float(d.min() / d.max())


def main() -> int:
    import torch

    from agentlib_mpc_torch.ops import kkt

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    card = torch.device("cuda", 0) if torch.cuda.is_available() else None
    routes = [("cpu", torch.float32, "ldl"), ("cpu", torch.float32, "lu"),
              ("cpu", torch.float64, "ldl")]
    if card is not None:
        routes = [(card, torch.float32, "auto"), (card, torch.float32, "lu"),
                  (card, torch.float64, "auto")] + routes
    loops = {}
    for device, dtype, method in routes:
        loops[(str(device), dtype, method)] = run_loop(torch, device, dtype,
                                                       method)
        emit({"loop": loops[(str(device), dtype, method)]})

    base = loops[("cpu", torch.float64, "ldl")]
    rows = []
    for offset in (1e-12, 1e-9):
        moved = run_loop(torch, "cpu", torch.float64, "ldl", offset)
        rows.append({"start_offset_K": offset,
                     "u0_max_abs_diff_W": max(
                         abs(a - b) for a, b in zip(moved["u0_W"],
                                                    base["u0_W"])),
                     "iterations_differ": [
                         k for k, (a, b) in enumerate(zip(
                             moved["iterations"], base["iterations"]))
                         if a != b],
                     "final_plant_K": moved["final_plant_K"]})
    emit({"sensitivity": rows})

    if card is not None:
        on_card = first_solve_factors(torch, card)
        on_cpu = first_solve_factors(torch, "cpu")
        rows = []
        for k, ((K_c, Ks_c, LD_c), (K_h, _, LD_h)) in enumerate(
                zip(on_card, on_cpu)):
            scale = float(K_h.abs().max())
            plain = kkt.ldl_factor_plain(Ks_c.float()).double()
            rows.append({"factorization": k,
                         "K_card_vs_cpu_rel": float((K_c - K_h).abs().max())
                         / scale,
                         "kernel_vs_plain_on_card_K": float(
                             (LD_c - plain).abs().max()),
                         "pivot_ratio_card": pivot_ratio(LD_c),
                         "pivot_ratio_cpu": pivot_ratio(LD_h)})
        emit({"first_solve": {"factorizations_card": len(on_card),
                              "factorizations_cpu": len(on_cpu),
                              "rows": rows}})
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(obj) + "\n" for obj in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
