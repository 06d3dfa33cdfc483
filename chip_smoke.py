#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. env      — card, torch and CUDA versions, ``nvidia-smi`` name/power limit.
2. build    — compile ``agentlib_mpc_torch/csrc/*.cu`` with nvcc (one
              process per source, in parallel; ``-Xptxas -v`` report,
              which must show no spills); the kernels' own shared-memory
              sizes and MAX_M must equal those ``ops/kkt.py`` routes by.
3. kernels  — each LDLᵀ kernel against its plain PyTorch version on the
              card (bitwise), on seeded quasi-definite KKT batches at the
              main path's shape (256, 92), ragged shapes, one above 48 KB of
              shared memory and the largest routed size, M = 240. Times at
              (256, 92): device time per launch from torch.profiler's kernel
              events, CUDA events around raw launches (one ctypes call
              each) and around the wrappers, beside the bound, the plain
              version and a library yardstick; then device times at
              M = 32, 64, 92, 128 (B = 256), whose slope in M separates the
              recursion's per-step latency from the load.
4. slice    — the 256-zone consensus-ADMM control step (``build_step``) in
              f32 on the card: one cold step and three warm steps, with the
              kernels' launch counters reset just before and read just after.
   profile  — one more warm step under ``torch.profiler``: device time
              by operator, the card's busy share of the step, host time.
5. quality  — the same steps through the port in f64 with the plain
              versions on the CPU; the card's z̄ and consensus spread must
              agree within the stated tolerance.

Then the ``nvidia-smi`` line, the ``kernels`` JSON line and, last,
``{"ok": true, "device": {...}}``. Needs one card; exits non-zero when
``torch.cuda.is_available()`` is False. Imports nothing of JAX, of the JAX
package or of ``bench.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): device memory rate and fp32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

MAIN_B, MAIN_M, MAIN_N = 256, 92, 61          # zones, KKT dim, primal dim
CHECK_SHAPES = ((256, 92, 61), (3, 7, 5), (130, 13, 9), (64, 128, 86),
                (16, 240, 160))
#: KKT sizes of the timing slope, each at B = MAIN_B
SLOPE_M = (32, 64, 92, 128)
#: kernel vs plain version, same inputs, same device, f32: both perform the
#: same rounded operations (every product and difference rounded
#: separately, IEEE division) in the same per-element order, so they must
#: agree bitwise
KERNEL_ABS_TOL = 0.0
#: relative residual max|Kx − b| / max|b| of the equilibrated, refined
#: solve (solve_kkt_ldl) in f32 on these quasi-definite batches
RESIDUAL_TOL = 1e-3
#: f32 card run vs f64 plain CPU run of the same control steps. The inner
#: solves stop at tol 1e-4 and the warm ones after one interior-point
#: iteration, so the f32 round-off of each solve carries into the next
#: ADMM iteration instead of converging out. This phase's first run on an
#: H100 (700 W, PERF.md) saw gaps of at most 7.2e-5 in z̄ (scale 0.05)
#: and 3.4e-4 in the spread (scale 0.01) over the four steps; the limits
#: allow about 6x the larger, and a fifth of the spread itself.
ZBAR_TOL = 2e-3
SPREAD_TOL = 2e-3
N_WARM = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def quasi_definite_batch(B, n, m, seed):
    """Random interior-point-shaped KKT matrices [[W, Jgᵀ], [Jg, -δI]] and
    right-hand sides (the construction of tests/test_kkt.py)."""
    rng = np.random.default_rng(seed)
    Ks, rhss = [], []
    for _ in range(B):
        A = rng.normal(size=(n, n))
        W = A @ A.T + 3 * np.eye(n)
        Jg = rng.normal(size=(m, n))
        Ks.append(np.block([[W, Jg.T], [Jg, -1e-6 * np.eye(m)]]))
        rhss.append(rng.normal(size=n + m))
    return np.stack(Ks), np.stack(rhss)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_env(torch):
    smi = nvidia_smi()
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})
    return smi


def phase_build():
    import ctypes
    import re

    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.utils import cuda_build

    t0 = time.perf_counter()
    results = cuda_build.build_all()
    # the shared-memory formulas ldl_fits reads must be the kernels' own
    formulas = {"ldl_factor": kkt.factor_smem_bytes,
                "ldl_solve": kkt.solve_smem_bytes}
    smem = {}
    for name, formula in formulas.items():
        lib = cuda_build.load(name)
        smem_fn = getattr(lib, f"{name}_smem_bytes")
        smem_fn.argtypes, smem_fn.restype = [ctypes.c_int], ctypes.c_longlong
        max_m = getattr(lib, f"{name}_max_m")
        max_m.restype = ctypes.c_int
        check(max_m() == kkt.MAX_M,
              f"{name}: kernel MAX_M {max_m()} != kkt.MAX_M {kkt.MAX_M}")
        smem[name] = {}
        for _, M, _ in CHECK_SHAPES:
            check(smem_fn(M) == formula(M),
                  f"{name}: kernel needs {smem_fn(M)} B of shared memory at "
                  f"M={M}, kkt.py's formula says {formula(M)}")
            smem[name][str(M)] = smem_fn(M)
    reports = {name: [ln.strip() for ln in r.ptxas.splitlines() if ln.strip()]
               for name, r in results.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          # dynamic shared memory per block (ptxas sees static only)
          "dynamic_smem_bytes": smem,
          "libraries": {
              name: {"seconds": r.seconds, "cached": r.cached,
                     "ptxas": reports[name]}
              for name, r in results.items()}})
    for name, lines in reports.items():
        # each usage line follows the line naming its kernel
        spills = [(entry, ln) for entry, ln in zip([""] + lines, lines)
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        check(not spills, f"{name}: ptxas reports spills: {spills}")


def device_ms(torch, fn, kernel: str, launches: int = 100) -> float:
    """Mean device time per launch of ``kernel`` over ``launches`` calls of
    ``fn``, from torch.profiler's CUDA kernel events (sum / count)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    # CUPTI may miss a launch at the edge of the window: the mean is over
    # the kernel events it saw, at least 90 % of the launches
    check(len(spans) >= 0.9 * launches,
          f"profiler saw {len(spans)} {kernel} events of {launches} launches")
    return sum(spans) / len(spans) / 1e3


def bounds(B: int, M: int):
    """(bound_ms, bound_by) of the factor and the solve on B systems of size
    M: bytes each function must move (the lower triangle and diagonal it
    reads, each output written once) over the memory rate, against its
    flops over the fp32 rate."""
    tri = B * M * (M + 1) // 2 * 4
    factor_bytes = tri + B * M * M * 4
    factor_flops = B * sum(n + n * (n + 1) for n in range(M))
    solve_bytes = tri + 2 * B * M * 4
    solve_flops = B * (2 * M * (M - 1) + M)

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                else "operations")

    return bound(factor_bytes, factor_flops), bound(solve_bytes, solve_flops)


def kernel_times(torch, kkt, K, b, LD):
    """Device time per launch (profiler) and raw-launch event time of both
    kernels on one batch."""
    raw_f = kkt.raw_launcher("ldl_factor", K, torch.empty_like(K))
    raw_s = kkt.raw_launcher("ldl_solve", LD, b, torch.empty_like(b))
    return {
        "factor_device_ms": device_ms(torch, raw_f, "ldl_factor_kernel"),
        "factor_ms": time_ms(raw_f, 200),
        "solve_device_ms": device_ms(torch, raw_s, "ldl_solve_kernel"),
        "solve_ms": time_ms(raw_s, 200),
    }


def phase_kernels(torch, dev):
    from agentlib_mpc_torch.ops import kkt

    errors = {}
    for seed, (B, M, n) in enumerate(CHECK_SHAPES):
        K_np, b_np = quasi_definite_batch(B, n, M - n, seed)
        K = torch.as_tensor(K_np, dtype=torch.float32, device=dev)
        b = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
        LD_kernel = kkt.ldl_factor(K)
        LD_plain = kkt.ldl_factor_plain(K)
        x_kernel = kkt.ldl_solve(LD_plain, b)
        x_plain = kkt.ldl_solve_plain(LD_plain, b)
        x_full = kkt.solve_kkt_ldl(K, b)
        torch.cuda.synchronize()
        f_err = float((LD_kernel - LD_plain).abs().max())
        s_err = float((x_kernel - x_plain).abs().max())
        resid = float((torch.einsum("bij,bj->bi", K, x_full) - b).abs().max()
                      / b.abs().max())
        errors[f"{B}x{M}"] = {"factor_max_abs_err": f_err,
                              "solve_max_abs_err": s_err,
                              "residual_rel": resid}
        check(f_err <= KERNEL_ABS_TOL,
              f"ldl_factor vs plain at {B}x{M}: {f_err}")
        check(s_err <= KERNEL_ABS_TOL,
              f"ldl_solve vs plain at {B}x{M}: {s_err}")
        check(np.isfinite(resid) and resid <= RESIDUAL_TOL,
              f"solve_kkt_ldl residual at {B}x{M}: {resid}")

    # ---- times at the main path's shape --------------------------------------
    K_np, b_np = quasi_definite_batch(MAIN_B, MAIN_N, MAIN_M - MAIN_N, 0)
    K = torch.as_tensor(K_np, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
    LD = kkt.ldl_factor_plain(K)
    LDlib, piv = torch.linalg.ldl_factor(K)
    lu, lu_piv = torch.linalg.lu_factor(K)
    t = kernel_times(torch, kkt, K, b, LD)
    t.update({
        "factor_wrapper_ms": time_ms(lambda: kkt.ldl_factor(K), 200),
        "solve_wrapper_ms": time_ms(lambda: kkt.ldl_solve(LD, b), 200),
        "factor_plain_ms": time_ms(lambda: kkt.ldl_factor_plain(K), 10),
        "factor_library_ms": time_ms(lambda: torch.linalg.ldl_factor(K), 5, 1),
        "solve_plain_ms": time_ms(lambda: kkt.ldl_solve_plain(LD, b), 10),
        "solve_library_ms": time_ms(
            lambda: torch.linalg.ldl_solve(LDlib, piv, b[..., None]), 5, 1),
        "lu_factor_ms": time_ms(lambda: torch.linalg.lu_factor(K), 20),
        "lu_solve_ms": time_ms(
            lambda: torch.linalg.lu_solve(lu, lu_piv, b[..., None]), 20),
    })
    # device time vs raw-launch event time: more than 20 % apart needs a
    # reason
    disagreements = {}
    for k in ("factor", "solve"):
        dev_ms, ev_ms = t[f"{k}_device_ms"], t[f"{k}_ms"]
        if abs(ev_ms - dev_ms) > 0.2 * dev_ms:
            disagreements[k] = (
                f"raw-launch events {ev_ms:.5f} ms vs device {dev_ms:.5f} ms: "
                + ("the card idles between launches; the host's enqueue "
                   "(one ctypes call) or the launch gap is longer than the "
                   "kernel" if ev_ms > dev_ms else
                   "the profiler's kernel spans include its per-kernel "
                   "instrumentation"))
    # ---- the slope in M at B = 256 ------------------------------------------
    slope = []
    for M in SLOPE_M:
        n = (2 * M) // 3
        Ks_np, bs_np = quasi_definite_batch(MAIN_B, n, M - n, M)
        Ks = torch.as_tensor(Ks_np, dtype=torch.float32, device=dev)
        bs = torch.as_tensor(bs_np, dtype=torch.float32, device=dev)
        ts = kernel_times(torch, kkt, Ks, bs, kkt.ldl_factor_plain(Ks))
        (fb, _), (sb, _) = bounds(MAIN_B, M)
        slope.append({
            "M": M, "factor_device_ms": ts["factor_device_ms"],
            "factor_ms": ts["factor_ms"], "factor_bound_ms": fb,
            "factor_us_per_step": ts["factor_device_ms"] * 1e3 / M,
            "solve_device_ms": ts["solve_device_ms"],
            "solve_ms": ts["solve_ms"], "solve_bound_ms": sb,
            "solve_us_per_step": ts["solve_device_ms"] * 1e3 / (2 * M)})
    fits = {}
    for k in ("factor", "solve"):
        a1, a0 = np.polyfit([r["M"] for r in slope],
                            [r[f"{k}_device_ms"] * 1e3 for r in slope], 1)
        fits[k] = {"us_per_unit_M": float(a1), "us_at_M0": float(a0)}
    (f_bound, f_by), (s_bound, s_by) = bounds(MAIN_B, MAIN_M)
    emit({"phase": "kernels", "errors": errors, "times": t,
          "factor_bound_ms": f_bound, "solve_bound_ms": s_bound,
          "device_vs_events": disagreements or "within 20 %",
          "slope_B256": slope, "slope_fit": fits,
          "shape": [MAIN_B, MAIN_M]})
    for why in disagreements.values():
        print(f"chip_smoke: {why}", flush=True)
    main = errors[f"{MAIN_B}x{MAIN_M}"]
    common = {"route": "cuda"}
    return [
        {"name": "ldl_factor", **common,
         "source": "agentlib_mpc_torch/csrc/ldl_factor.cu",
         "replaces": "agentlib_mpc_tpu/ops/kkt.py:72",
         "max_abs_err": main["factor_max_abs_err"],
         "device_ms": t["factor_device_ms"], "ms": t["factor_ms"],
         "wrapper_ms": t["factor_wrapper_ms"],
         "plain_ms": t["factor_plain_ms"],
         "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": t["factor_library_ms"]},
        {"name": "ldl_solve", **common,
         "source": "agentlib_mpc_torch/csrc/ldl_solve.cu",
         "replaces": "agentlib_mpc_tpu/ops/kkt.py:104",
         "max_abs_err": main["solve_max_abs_err"],
         "device_ms": t["solve_device_ms"], "ms": t["solve_ms"],
         "wrapper_ms": t["solve_wrapper_ms"],
         "plain_ms": t["solve_plain_ms"],
         "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": t["solve_library_ms"]},
    ]


def run_steps(torch, step, args, sync):
    """One cold step and N_WARM warm steps; per-step wall ms, outputs,
    stats and (on the card) per-step kernel launches."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel.admm_step import warm_step

    outs, ms, launches = [], [], []
    out = None
    for k in range(1 + N_WARM):
        before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
        t0 = time.perf_counter()
        out = step(*args) if out is None else warm_step(step, args, out[0])
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append((kkt.ldl_factor.launches - before[0],
                         kkt.ldl_solve.launches - before[1]))
        outs.append(out)
    return outs, ms, launches


def spread(ocp, carry):
    u = ocp.unflatten(carry[0])["u"]
    return float((u - carry[3]).abs().max())


def phase_slice(torch, dev):
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel.admm_step import (
        N_AGENTS, build_step, zone_ocp)

    step, args = build_step(N_AGENTS, device=dev, dtype=torch.float32,
                            record_stats=True)
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    outs, ms, launches = run_steps(torch, step, args, torch.cuda.synchronize)
    totals = {"ldl_factor": kkt.ldl_factor.launches,
              "ldl_solve": kkt.ldl_solve.launches}
    ocp = zone_ocp()
    carry, (prim, dual, iters, ok, _kkt) = outs[-1]
    for k, (nf, ns) in enumerate(launches):
        check(0 < nf <= 19 and 0 < ns <= 114,
              f"step {k}: {nf} factor / {ns} solve launches (limits 19/114)")
    finite = all(bool(torch.isfinite(t).all()) for t in carry)
    check(finite, "non-finite control-step output")
    sp = spread(ocp, carry)
    emit({"phase": "slice", "zones": N_AGENTS, "dtype": "float32",
          "cold_step_ms": ms[0], "warm_step_ms": ms[1:],
          "warm_step_ms_median": float(np.median(ms[1:])),
          "ip_iterations_per_admm_iteration_mean":
              iters.double().mean(dim=1).tolist(),
          "ip_iterations_per_admm_iteration_max":
              iters.max(dim=1).values.tolist(),
          "lane_success_fraction": ok.double().mean(dim=1).tolist(),
          "primal_residual": float(prim[-1]), "dual_residual": float(dual[-1]),
          "spread": sp, "launches_per_step": launches,
          "launches": totals,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)})
    phase_profile(torch, step, args, outs[-1], float(np.median(ms[1:])))
    return outs, totals, ocp


def phase_profile(torch, step, args, out, warm_ms):
    """One warm step under the profiler (not counted as main-path
    launches): device time by operator and the device's busy share of the
    unprofiled median warm step."""
    from torch.profiler import ProfilerActivity, profile

    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel.admm_step import warm_step

    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        warm_step(step, args, out[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before

    # device time from the kernel and copy events themselves (the aten
    # rows above them carry the same time again); the solver's named
    # ranges also appear on the device timeline and are skipped
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ipm.")]
    by_name: dict = {}
    for e in dev_events:
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, us + e.time_range.elapsed_us())
    device_ms = sum(us for _, us in by_name.values()) / 1e3
    top_dev = sorted(by_name.items(), key=lambda kv: kv[1][1],
                     reverse=True)[:10]
    # the solver's named ranges (ops/solver.py): inclusive host time, from
    # the host-side range events themselves
    phases: dict = {}
    for e in prof.events():
        if e.name.startswith("ipm.") and \
                e.device_type == torch.autograd.DeviceType.CPU:
            count, ms = phases.get(e.name, (0, 0.0))
            phases[e.name] = (count + 1, ms + e.time_range.elapsed_us() / 1e3)
    phases = {k: {"count": c, "host_ms": ms} for k, (c, ms) in phases.items()}
    rows = prof.key_averages()
    top_cpu = sorted(rows, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
    emit({"phase": "profile", "profiled_step_ms": wall_ms,
          "device_ms": device_ms if device_ms > 0 else None,
          "device_kernels": len(dev_events),
          "busy_share_of_median_warm_step":
              device_ms / warm_ms if device_ms > 0 else None,
          "solver_phases": phases,
          "top_device_ms": [[name[:100], count, us / 1e3]
                            for name, (count, us) in top_dev],
          "top_host_self_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3]
                               for e in top_cpu]})


def phase_quality(torch, outs32, ocp):
    from agentlib_mpc_torch.parallel.admm_step import N_AGENTS, build_step

    step, args = build_step(N_AGENTS, {"kkt_method": "ldl"}, device="cpu",
                            dtype=torch.float64, record_stats=True)
    t0 = time.perf_counter()
    outs64, _, _ = run_steps(torch, step, args, lambda: None)
    seconds = time.perf_counter() - t0
    rows = []
    for k, (o32, o64) in enumerate(zip(outs32, outs64)):
        c32 = tuple(t.double().cpu() for t in o32[0])
        c64 = o64[0]
        check(all(bool(torch.isfinite(t).all()) for t in c64),
              f"non-finite f64 reference output at step {k}")
        dz = float((c32[3] - c64[3]).abs().max())
        ds = abs(spread(ocp, c32) - spread(ocp, c64))
        rows.append({"step": k, "zbar_max_abs_diff": dz, "spread_diff": ds,
                     "spread_f64": spread(ocp, c64)})
        check(dz <= ZBAR_TOL, f"step {k}: z̄ differs from f64 by {dz}")
        check(ds <= SPREAD_TOL, f"step {k}: spread differs from f64 by {ds}")
    emit({"phase": "quality", "reference": "f64 plain on cpu",
          "seconds": seconds, "zbar_tol": ZBAR_TOL,
          "spread_tol": SPREAD_TOL, "steps": rows})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = phase_env(torch)
    phase_build()
    kernels = phase_kernels(torch, dev)
    outs, totals, ocp = phase_slice(torch, dev)
    phase_quality(torch, outs, ocp)
    for k in kernels:
        k["launches"] = totals[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched on the main "
              f"path")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
