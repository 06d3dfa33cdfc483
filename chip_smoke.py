#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. env      — card, torch and CUDA versions, ``nvidia-smi`` name/power limit.
2. build    — compile ``agentlib_mpc_torch/csrc/*.cu`` with nvcc (one
              process per source, in parallel; ``-Xptxas -v`` report,
              which must show no spills) and ``csrc/cia.cpp`` with g++;
              the kernels' own shared-memory sizes and MAX_M must equal
              those ``ops/kkt.py`` routes by.
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
              f32 on the card: one cold step and two warm steps, with the
              kernels' launch counters reset just before and read just after.
   profile  — one more warm step under ``torch.profiler``: device time
              by operator, the card's busy share of the step, host time.
5. quality  — the same steps through the port in f64 with the plain
              versions on the CPU (computed in a subprocess from the
              script's start); the card's z̄ and consensus spread must
              agree within the stated tolerance.
6. stage_kernels — both kernels against their plain versions (bitwise) at
              the stage sweep's shapes: factor (256, 10) and (256, 5), solve
              (2560, 10), (256, 10), (1280, 5) and (256, 5); device time
              per launch, raw-launch events, bound, plain version and
              library yardstick at each.
7. long_horizon — the 256-zone step a day ahead (N=96, dt=900 s, KKT
              866 of 97 stages of 10), "auto" routed to the stage sweep:
              one cold and one warm step in f32 with the launch counters
              reset just before and read just after (launches must equal
              97 factor and 1 254 solve launches per interior-point
              iteration), then the quality gate: the same steps in f64 on
              the card with kkt_method="lu" (and in f32 with "lu", the
              dense path's own f32 round-off); the seconds of each part.
              (No profiled step: processing its ~115 000 device events
              takes ~28 s of the time limit; PERF.md keeps both day-ahead
              profiles.)
8. shooting — 256 zones at N=96 by multiple shooting (rk4, 3 substeps;
              KKT 386 of 97 stages of 5): one batched cold solve on the
              stage sweep, held against the same solve in f64 with "lu"
              on the card, then one plant step of every zone by
              ``Model.simulate_step`` from the solved first control, held
              against the same step in f64 on the CPU.
9. qp_slice — the linear fleet (256 ``LinearRCZone`` zones, N=10, KKT
              92) on the Mehrotra QP fast path (``build_step(model=
              "linear", inner="qp")``) in f32: the certified routing
              verdicts of both fleets (linear ``lq``, zone ``not_lq``),
              one cold and two warm steps with the launch counters
              reset just before and read just after (exactly 1 factor and
              6 solve launches per QP iteration), a profiled warm step;
              quality: the same steps in f64 with the plain versions on
              the CPU, one cold step of the same fleet with the NLP inner
              solver on the card (the JAX package's ``--qp-ab``), and
              converged QP and NLP solves of the fleet's subproblems at
              the last step's consensus state, held against each other.
10. qp_day_ahead — the linear fleet at N=96, dt=900 s (KKT 866), "auto",
              which takes the stage-sparse derivative pipeline with the
              certified plan: cold and warm steps with launch counts
              (97 factor and 1 254 solve launches per QP iteration), held
              against the same steps in f64 with "lu" and dense
              derivatives on the card.
11. sparse_day_ahead — the zone fleet at N=96 with "auto", now sparse:
              the same cold and warm steps as long_horizon (which forces
              dense derivatives) with launch counts and the seconds of
              each part; held against long_horizon's f64
              LU outputs (reused) with its gate, and within 1e-3 of its
              dense f32 run on z̄.
12. fused_slice — ``bench.py``'s ``--mesh-ab`` workload at one device
              through the port's ``FusedADMM``: 256 ``ZoneWithSupply``
              zones, N=10, inner budgets 10 / 1, 10 ADMM iterations with
              the Boyd exit: a cold and two warm rounds with the launch
              counters reset just before and read just after (exactly 6
              solve launches per factor launch, at most the inner budgets'
              factor launches, every factor at (256, 92)), a profiled warm
              round, the quality gate against the same engine in f64 on
              the CPU with the exits pinned to zero (both run exactly 10
              iterations), and a quarantined NaN lane.
13. fused_linear — the linear fleet the same way, routed to the QP by
              its certificate. Its f32 rounds run off f64 in the JAX
              package too (FUSED_LINEAR_F64_TOL_W); they are reported, and
              the gate holds the card's engine in f64 against the CPU's
              (tests/test_torch_fused_f32.py holds the port's f32 rounds
              against the JAX package's at 8 zones).
14. fused_fleet — ``FusedFleet.from_configs`` over 256 room configs of
              ``examples/fused_fleet_rooms.py`` (N=6, degree-2 Legendre
              collocation, KKT 56): three control intervals in closed
              loop (round, a plant step of every room by
              ``Model.simulate_step``, ``update_agent``, ``advance``), a
              checkpoint after the first, restored into a fresh fleet whose
              next round must equal the uninterrupted one bitwise.
15. scenario_tree_kkt — the coupled tree KKT solve
              (``scenario.tree.solve_kkt_tree``: every branch's stage
              sweep and the non-anticipativity Schur complement, as a
              batch of one, all on the kernels) on the zone OCP's
              partition (N=10, KKT 92, 11 stages of 10) for a fan of 8
              scenarios (7 coupling rows) and a (4, 2) branching tree
              (11 rows), on synthetic systems in f32 and f64:
              ``tree_method_available`` true for each, the coupled
              residual below the probe's 1e-3 in f32 and 1e-8 in f64 (the
              exact system, δ_c = 0), the card's f64 solution within
              1e-10 of the plain versions' on the CPU, one solve's ms.
16. scenario_ab — ``bench.py``'s ``--scenario-ab`` workload at one
              device through ``ScenarioFleet``: 4 zones × 8 scenarios
              (each zone's load perturbed by ``ensemble_thetas``), the
              slice's solver and budgets, ρ = ρ_na = 20, in f32: 8 serial
              single-scenario rounds and the uncoupled batched round
              (robust horizon 0, exits pinned; bench.py's identity gate
              1e-3 on z̄), the robust round (robust horizon 1, live
              exits; u0 identical across branches, ``na_spread``), and
              ``robust_scenario_controls`` for zone 0 with its warm
              re-solve; ms per scenario of each leg. The batched, robust
              and controls legs in f64 on the card are held against the
              same legs in f64 on the CPU with the plain versions (a
              subprocess from the script's start): z̄ and u0 within
              ZBAR_TOL, the same iterations and ``converged``; the f32
              legs' distance from it is reported.
17. scenario_fleet — the main path's fleet (256 zones, N=10) × a fan of 8
              scenarios (u_0 shared) through ``ScenarioFleet``: 2 048
              lanes of one batched solve per ADMM iteration, a cold and a
              warm round in f32 with the launch counters reset just
              before and read just after (every factor at (2048, 92), 6
              solves per factor, at most the inner budgets' factors),
              peak memory, ``local_solves_ok``, ``lane_quarantined`` and
              ``na_spread`` per round, a profiled warm round; the same
              rounds in f64 on the card: z̄ within ZBAR_TOL, u0 within
              ZBAR_TOL in the median and on all but 5 % of the zones,
              u0 identical across each zone's branches in both types.
18. serve — the serving plane (``agentlib_mpc_torch/serving``) under
              ``bench.py --serve``'s workload built from the port: 256
              ``LinearRCZone`` tenants coupled on ``power``, membership
              from ``churn_schedule(0, 256, 16)`` (a round-0 cohort of
              128), the slice's solver options, 5 ADMM iterations at
              ρ 5e-3, deadline 60 s, queue 4n, capacity n, x0 drifting by
              U(-0.5, 0.5) K a round; the launch counters reset just
              before and read just after the whole phase. f32, a sync
              then a pipelined plane (the latter under a 60 s watchdog):
              solves/s, p50/p99 warm round ms, mean round ms of each,
              cold and cached join ms, cache hits and misses, sheds;
              gates: every result an actuated finite solve or shed by
              deadline or queue only, 0 engines built after round 0, no
              round timed out. The sync plane's checkpoint after round 8
              restored into a fresh plane sharing its cache: every join a
              cache hit, the state bitwise, rounds 9-15 the uninterrupted
              plane's u0 bitwise. f64: ``churn_schedule(0, 16, 8)`` on the
              card against the same run in f64 on the CPU (a reference
              subprocess from the script's start): equal actions, u0
              within 1e-6 W. A profiled warm round gives the busy share.
19. module_one_room — the module path: ``LocalMAS`` over the two-agent
              one-room MAS of ``tests/test_mas_one_room.py``
              (``agentlib_mpc_torch/reference_configs.py``; the ``mpc``
              module on the ``jax`` backend, N=15, degree-2 Legendre
              collocation, KKT 137; the ``simulator`` every 10 s) for
              1 800 s in f32 on the card: launch counters reset just before
              and read just after (only at (1, 137), one factor and three
              solves per interior-point iteration), every solve successful
              with the actuation guard at level 0 and no warm-start reset;
              first and median warm solve, the simulator's time, a profiled
              solve; quality: the same MAS in f64 on the CPU with the plain
              LDLᵀ, comfort error (AIE) and cooling energy within 1 %.
20. module_linear_qp — ``examples/linear_qp_mpc.py``'s agent the same way
              (N=8, KKT 74) on the QP fast path, in f64 on the card: the
              float64 kernels, only at (1, 74), one factor and six solves
              per QP iteration; every solve successful with the guard at
              level 0 and no warm-start reset; the plant at or below the
              example's own 295.25 K; every solve replayed on the CPU in
              f64 (plain LDLᵀ) from the same inputs and warm state: the
              same iterations, u0 within 1e-6 W; the same loop in f64 on
              the CPU is reported beside it. (In f32 the pivot-free LDLᵀ
              breaks down on this QP in both packages:
              ``scripts/linear_qp_f32_witness.py``.)
21. module_mhe — ``examples/mhe_one_room.py``'s two agents for 1 800 s
              (cut from the example's 3 600 s for the script's time
              limit) in f32 on the card (the module path's default): the
              ``mhe`` module (``jax_mhe``, horizon 10, its estimation OCP
              certified LQ: the QP fast path at (1, 142), one factor and
              six solves per QP iteration) beside an ``mpc`` that
              consumes its load estimate (NLP at (1, 92), one factor and
              three solves per iteration), the plant with the true 260 W;
              every solve successful, the example's gates (estimate
              within 40 W of 260 W, the room 1 K below its start), the
              final estimate within 1 % of the same loop in f64 on the
              CPU. (Until the
              port's solver counted steps taken only inside the line
              search's noise allowance as no progress, its MPC failed 3
              of 31 solves here in f32: ``scripts/module_f32_witness.py``.)
22. module_minlp_cia — ``examples/minlp_switched_room.py``'s ``jax_cia``
              agent for 1 800 s in f64 (a quarter of the example's run,
              for the script's time limit): the relaxed program on the QP at
              (1, 34), the CIA schedule from the native library
              (``csrc/cia.cpp``, never the Python version), the fixed
              program at (1, 26); launches exact per solve; the example's
              gates (binary commands, the zone below UB + 0.5 K, a duty
              cycle inside (0, 1)); final temperature within 0.05 K and
              duty within 0.02 of the same loop in f64 on the CPU; after
              the next phase, every card solve replayed on the CPU in f64
              from the same inputs and warm state (a subprocess): the same
              command and relaxed-QP iterations, the relaxed trajectory
              within 1e-6 K.
23. module_minlp_bb — the same agent on ``jax_minlp_bb`` (max_nodes 8,
              cut from the example's 48 to 16 when the scenario phases
              came and to 8 when the serve phase came;
              batch_pairs 4) for 2 100 s in f64: node relaxations as one
              batched NLP per sweep at (8, 34), exact launches per fixed
              solve and per sweep, the example's gates, on every step the
              incumbent at most the rounding heuristic's
              (``bb_proven_optimal`` and ``bb_improved_on_heuristic`` per
              step in the line). module_one_room, module_linear_qp,
              module_mhe, module_admm and module_admm_exchange each have a
              ``*_profile`` line.
24. module_admm — ``examples/admm_cooled_room.py``'s three agents for
              600 s in f32 (two control steps, for the script's time
              limit): the room and the cooler as ``admm_local``
              modules over ``jax_admm``, whose augmented problems route by
              their certificates (the room's NLP at (1, 74), one factor
              and three solves per iteration; the cooler, which has no
              states, on the QP at (1, 8), one factor and six solves per
              iteration), both agents' solves and guard levels captured;
              six ADMM iterations on every step, every solve successful at
              guard level 0 with no warm-start reset, the example's gates
              (the room cools below 297.0 K, the actuated air flow at most
              0.05 m³/s, the two agents' trajectories within 5e-3 of each
              other at the last step's last iteration, the gap printed per
              step), the final temperature within 0.02 K of the same loop
              in f64 on the CPU.
25. module_admm_rt — ``tests/test_admm_realtime.py``'s pair of real-time
              ``admm`` modules (N=4, a step every 8 s) on the wall clock
              for 10 s of the MAS's clock in f64 (in f32 the room's solves
              fail on the pivot-free LDLᵀ in both packages:
              ``scripts/admm_f32_witness.py``), the rounds its triggers
              started run to their end in the worker threads, then
              ``terminate()``: each registered the other on the wire alias,
              ran at least one round with successful solves and no failed
              round (a round that raises fails the phase), solved in its
              worker thread on the default stream, the room's mean air flow
              finite with shape (4,), no worker alive afterwards, and the
              launches exact per iteration over both threads.
26. module_admm_coord — ``examples/admm_4rooms_coordinator.py``'s ten
              agents for 300 s (one round; two until the fleet phases
              came), 6 ADMM iterations (the example's 15, cut to 8 when
              the ML phases came and to 6 when the scenario phases
              came), in f64 (in f32 the JAX
              package's loop fails two room solves on the pivot-free LDLᵀ:
              ``scripts/admm_f32_witness.py``): an ``admm_coordinator``
              drives four ``CooledRoom`` participants (NLP at (1, 74), one
              factor and three solves per iteration) and the AHU, a
              zero-state QP with the shared capacity constraint and four
              output couplings ((1, 32), one factor and six solves per
              iteration). Five participants registered and four coupling
              aliases before the first round; the ADMM iterations of each
              round as in the same loop in f64 on the CPU; at most one
              failed solve, none a room's (each printed); every round
              assessed by each participant's guard; the example's gates
              (the building cools, the peak total actuated flow at most
              0.075 · 1.10 m³/s); each room's final temperature within
              0.01 K and mean flow within 1e-5 m³/s of the CPU's; the
              allocation order (room 4's mean flow above room 1's) printed
              with its margin; per round the residual trails and rho.
27. module_admm_exchange — ``examples/exchange_admm_4rooms.py``'s nine
              agents for 300 s (one step) in f32: four ``ExchangeRoom``
              agents (NLP at (1, 74), 1:3) and the supplier (QP at (1, 8),
              1:6) as ``admm_local`` modules on one exchange alias; every
              solve successful at guard level 0 with no warm-start reset,
              4 ADMM iterations per step on all five (the example's 12,
              cut for the script's time limit: to 6 when the ML phases
              came, to 4 when the scenario phases came), each registered its
              four peers; the example's balance gate (supplier against the
              rooms' total within 0.02 m³/s) and the building cools; each
              room's final temperature within 0.01 K and the supplier's
              flow within 1e-4 m³/s of the same loop in f64 on the CPU; a
              profiled room solve.
28. module_ml_mpc — ``examples/ml_mpc_one_room.py`` through the port: the
              example's 500 seeded plant steps train its ANN NARX
              surrogate (hidden (16, 16), 300 epochs, lr 3e-3) on the card
              in f64 with ``ANNTrainerCore``; a CPU f64 training of the same
              seed (in the reference subprocess) gives the reference
              weights, and the card's final validation MSE must lie within
              1 % of the CPU's (the largest weight difference printed).
              Then the example's loop on ``jax_ml`` (N=10, ``max_iter``
              60, KKT (1, 42)) for 6 000 s (20 steps) in f64 on the card
              with the CPU-trained surrogate, held against the same loop
              in f64 on the CPU: the example's gates (the mean of the last
              five temperatures below 295.45 K, at most two failed solves),
              every plant temperature within 1e-4 K, launches exact (one
              factor and three solves per iteration); cold and warm solve
              ms, training seconds and a profiled warm solve (``ml.predict``
              inside ``ipm.eval_jac``).
29. module_ml_admm — ``examples/three_zone_datadriven_admm.py``'s seven
              agents through LocalMAS for one control step (300 s) in f64:
              three ``ZoneSurrogate`` zones on ``jax_admm_ml`` (HORIZON 8,
              ``max_iter`` 60) and the physical AHU on ``jax_admm``, 8 ADMM
              iterations (the example's 10, cut when the scenario phases
              came), rho 20. The three surrogates are trained on the
              card (seeds as in the example) and their validation MSEs held
              within 1 % of the CPU's; the loop runs with the CPU-trained
              surrogates, held against the same step in f64 on the CPU:
              every local solve successful, the ADMM iterations and the
              zones' coupling gap at the last iteration equal to the CPU's,
              each zone's first move within 1e-6 m³/s of the CPU's,
              launches exact.
30. module_fleet_mqtt — the deploy fleet (``deploy/fleet/*.json``, read as
              they are: coordinated ADMM, the CooledRoom with its plant,
              the Cooler) as three container processes on the card in
              f64, joined over a ``MiniBroker`` of the port in this
              process, on the wall clock: the coordinator as ``python -m
              agentlib_mpc_torch.runtime.container``, the room and the
              cooler through ``--fleet-container`` (the same ``main()``,
              then one JSON line with their launch counts, solves, CUDA
              context seconds and peak memory), device and dtype from
              ``AGENT_DEVICE``/``AGENT_DTYPE``. The participants stop
              after 15 s of their clocks (20 s until the ML phases
              came; at 12 s the relay fleet completed only its two
              rounds), then the coordinator gets
              SIGTERM. Every process exits 0, messages crossed the
              broker, both participants registered, at least two rounds
              completed, every solve successful with exact launches only
              at the real-time pair's shapes in float64, the
              coordinator's CSV has its residual columns and the room's
              ADMM CSV loads through ``utils.analysis``.
31. module_fleet_mp — the same four agents through ``MultiProcessingMAS``
              (one ``spawn``ed process each on its TCP relay, device
              ``cuda``, f64, real time at factor 1.0); each child's
              launch counts and solves are written at its exit by the
              ``bootstrap`` hook (:func:`fleet_child_bootstrap`): results
              from all four agents, at least two rounds, every solve
              successful, launches exact.
32. path_shapes — every (B, M) a path launched, in each type it launched
              in, is held bitwise against the plain versions; a shape no
              earlier phase timed gets its device time, bound, plain and
              library times.

The f64 CPU references of the slice, qp_slice, fused_slice,
fused_linear, scenario_ab and serve paths and of the module phases run in subprocesses of this
script (``--cpu-reference NAME``) started at the beginning, beside the
card's phases (the module phases' at a lower scheduling priority), and are
ended with the script; they and the replays of the linear-QP and CIA
card solves (``--cpu-replay NAME``) run on the last five of the cores this process
may use, the card's process on the others (where there are eight or
more; the ``summary`` line names them). Then the run's wall time, the
``nvidia-smi`` line, the ``kernels`` JSON line and, last,
``{"ok": true, "device": {...}}``. Needs one card; exits non-zero when
``torch.cuda.is_available()`` is False. Imports nothing of JAX, of the JAX
package or of ``bench.py``.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): device memory rate, and the fp32 and
# fp64 rates outside the tensor cores (NVIDIA's data sheet: 67 and 34
# TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12

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
#: a library yardstick call longer than this is timed once (ms)
LIBRARY_ONE_CALL_MS = 500.0
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
#: warm steps after the cold one on every path (their median is the warm
#: time): with three, the whole script took 1 329 s on an H100 at 700 W,
#: over the 1 200 s it may take. Not one: qp_quality's converged QP/NLP
#: check solves the subproblems at the last step's state, and after one
#: warm step a lane's objectives differ by 14 % (NVIDIA H100 80GB HBM3,
#: 700.00 W)
N_WARM = 2
#: warm steps of the day-ahead paths (long_horizon with its two LU
#: references, qp_day_ahead, sparse_day_ahead): one, for the same limit
LONG_N_WARM = 1
#: the stage sweep's kernel shapes (B, M): the factor of the stage blocks
#: of 256 zones (collocation blocks of 10, shooting blocks of 5); the solve
#: of ldl_solve_many's right-hand sides (10 per block of 10, 5 per block
#: of 5) and of the block substitutions
STAGE_FACTOR_SHAPES = ((256, 10), (256, 5))
STAGE_SOLVE_SHAPES = ((2560, 10), (256, 10), (1280, 5), (256, 5))
#: the day-ahead horizon: 96 intervals of 15 min
LONG_N, LONG_DT = 96, 900.0
#: f32 card (stage sweep) vs f64 card ("lu") of the day-ahead steps. z̄:
#: slice 1's limit. The spread max|u − z̄|, a max over 256 × 96 controls,
#: is set by the few lanes whose budget-limited solves stall (half the
#: zones miss tol 1e-4 in the cold iteration's 10 steps; their f32 and f64
#: iterates part by up to 0.04 in u while the median |Δu| is 1e-6). In the
#: same steps f32 dense LU misses the f64 spread by up to 1.37e-2 (the
#: lu32 rows below, PERF.md), so the limit is 2e-2 here, and the sweep is
#: also held against f32 dense LU on z̄
LONG_ZBAR_TOL = 2e-3
LONG_SPREAD_TOL = 2e-2
LONG_SWEEP_VS_DENSE_TOL = 1e-3
#: multiple shooting: integrator, substeps, and the cold solve's budget
SHOOT_INTEGRATOR, SHOOT_SUBSTEPS, SHOOT_MAX_ITER = "rk4", 3, 50
#: f32 vs f64 of the shooting solve's first controls (range 0..0.05 m³/s)
#: on the lanes both runs solve to tol 1e-4 (some zones of this fleet do
#: not converge within the budget in either precision; their iterates are
#: compared by nothing but finiteness), the share of the fleet that f64
#: solves and f32 does not, and the plant step's temperatures (K, about
#: 300): 10 rk4 sub-steps in f32 at 300 K carry eps 6e-8 × 300 × 10 ≈
#: 2e-4 K. f32 may solve lanes f64 does not: its stall exit accepts
#: points at its precision floor, and the JAX package's f32 solves 72 % of
#: a 32-zone fleet where its f64 solves 47 % (scripts/shooting_f32_share.py)
SHOOT_U0_TOL = 1e-3
SHOOT_SUCCESS_SHARE_TOL = 0.05
PLANT_X_TOL = 1e-3
#: the linear fleet's gates. Its controls are cooling powers in 0..500 W,
#: and its ADMM steps are far from converged: with inner budgets 10/1
#: only 1-10 % of the zones meet tol 1e-4 in a step, so f32 round-off
#: moves the budget-limited iterates by watts, not milliwatts. Measured
#: on the CPU at 256 zones (N=10, 4 steps, f32 vs f64, both on the plain
#: LDLᵀ): z̄ apart by 2.0-10.4 W; per-control |Δu| median 0.04-0.13 W,
#: 99th percentile 6.6-13 W; and in the fourth step one f32 lane ran off
#: to 495 W from a z̄ of 0.8 W. The JAX package does the same in f32 on
#: its LDLᵀ (spread 492.8 W in that step; 6.0 W with pivoted LU in
#: both packages), so the spread max|u − z̄| reads that lane and is
#: reported, not gated. A day ahead (N=96, 32 zones, the sparse path
#: against f64 dense LU): z̄ apart by 1.2-4.8 W, median |Δu| 0.02-0.54 W,
#: no lane off by 50 W; a 4-zone rehearsal at N=10 gave a median of
#: 0.60 W. Lanes with a control more than 50 W (10 % of the range) from
#: f64, at 256 zones on the CPU: 5, 0, 0, 3 over the four steps (the
#: cold step's at most 70 W off); on the card (PR 4's first run) 7 in
#: the cold step. Gated: z̄ within 5 % of the 500 W range; the median
#: |Δu| within 2 W; at most 5 % of the lanes (12 of 256) more than
#: 50 W off. (The first run held the lanes to 2.5 %, set before the
#: lane count had been measured at 256 zones; it stopped on the 7.)
QP_ZBAR_TOL = 25.0
QP_U_MEDIAN_TOL = 2.0
QP_U_OUTLIER_W = 50.0
QP_U_OUTLIER_SHARE_TOL = 0.05
#: converged QP against converged NLP solves of the same 256 subproblems
#: in f32 on the card (tol 1e-6, budget 100; f32 accepts at its own
#: floor). The LQ optimum is flat in u (the energy weight r_Q is 1e-3
#: against the comfort slack), so the two solvers stop at different u of
#: nearly equal cost; the gate is on the objective, on the lanes both
#: solve. Measured on the CPU at 256 lanes in f32: 93 % solved by both;
#: relative objective gap median 9.9e-5, max 6.6e-3 (u apart by up to
#: 27 W; in f64 the u gap is 0.018 W, the objective gap 1.2e-7).
QP_NLP_BOTH_SHARE_MIN = 0.8
QP_NLP_OBJ_REL_MEDIAN_TOL = 1e-3
QP_NLP_OBJ_REL_MAX_TOL = 5e-2
QP_NLP_TOL, QP_NLP_MAX_ITER = 1e-6, 100
#: the fused engine's workloads. fused_slice is bench.py's --mesh-ab at
#: one device: 256 ZoneWithSupply zones, N=10, the benchmark's inner
#: budgets (cold 10, warm 1) and 10 ADMM iterations at rho 20, through
#: FusedADMM. fused_linear: the linear fleet (LINEAR_*) the same way,
#: routed to the QP by its certificate. Their quality runs pin the Boyd
#: exits to zero (bench.py's convention for A/B identity), so the card's
#: engine and the CPU's f64 engine run exactly the same 10 iterations,
#: for two rounds; gates: the slice's (ZBAR_TOL, SPREAD_TOL) and
#: FUSED_LINEAR_F64_TOL_W
FUSED_ADMM_ITERS, FUSED_RHO = 10, 20.0
FUSED_QUALITY_STEPS = 2
#: the fused linear fleet in f32 runs off its f64 rounds in the JAX
#: package as in the port: the engine weights the penalty by dt, so
#: ρ·dt = 1.5 against build_step's 5e-3, a stiffer QP than f32 keeps on
#: budget-limited solves. The JAX package on the CPU, pinned exits, f32
#: against f64 (scripts/fused_linear_f32.py): 16 zones on LDLᵀ z̄
#: 235 W and median |Δu| 141 W off; 256 zones on pivoted LU z̄ 36 W,
#: median 15 W, spread 255 W against 1.25 W (ROADMAP Queue 3). So the
#: card's f32 rounds are reported, and the gate holds the card's engine
#: in f64 (pivoted LU, torch.linalg) against the CPU's f64 plain LDLᵀ
#: rounds, z̄ and every control. Set after the first runs: the card's f64
#: rounds stayed within 6.3e-8 W. The port's f32 rounds are held against
#: the JAX package's f32 rounds on the CPU at 8 zones, where neither runs
#: off (tests/test_torch_fused_f32.py)
FUSED_LINEAR_F64_TOL_W = 1e-3
#: fused_fleet: examples/fused_fleet_rooms.py at 256 rooms (room_config
#: below is its config with the model named by its zoo name), three
#: control intervals in closed loop, a checkpoint after the first
FLEET_N, FLEET_INTERVALS = 256, 3
FLEET_DT, FLEET_HORIZON, FLEET_MAX_ITERATIONS = 300.0, 6, 8
FLEET_UB, FLEET_T_IN, FLEET_START = 295.15, 290.15, 298.16
#: restored fleet vs the uninterrupted one, same next step: bitwise where
#: no op of the step is nondeterministic (named in the phase's line)
FLEET_RESUME_TOL = 0.0


#: the module path (LocalMAS, one MPC agent, the jax backend, the
#: simulator, the actuation guard) over the reference's configs
#: (agentlib_mpc_torch/reference_configs.py): the two-agent one-room MAS
#: at its full size (N=15, degree-2 Legendre collocation, the plant every
#: 10 s) and the linear-QP agent (N=8, LinearRCZone on the QP fast path,
#: the plant every 300 s), 1 800 s (one-room: 7 solves and 180 plant
#: steps; cut from 7 200 s, from 3 600 s when the fleet phases came and
#: from 2 400 s when the ML phases came, for the script's time limit) and
#: 7 200 s of closed loop
ONE_ROOM_UNTIL = 1800.0
MODULE_UNTIL = 7200.0
#: card f32 against the CPU's f64 with the plain LDLᵀ, relative, on the
#: one-room loop's comfort error (AIE) and cooling energy: the JAX
#: package's one-room example keeps f32 within 0.4 % of f64 (BASELINE.md)
MODULE_METRIC_RTOL = 0.01
#: the linear-QP example's own test: the plant at (or just at) the band
#: after 7 200 s. The loop runs in float64 on the card: in float32 the
#: pivot-free LDLᵀ of this QP breaks down near convergence in both
#: packages (a soft-constraint barrier weight near 1e12 condensed into the
#: primal block cancels every bit of the pivot it leaves; PERF.md,
#: scripts/linear_qp_f32_witness.py), so float32 cannot meet these gates
LINEAR_QP_T_LIMIT = 295.25
#: each solve of the card's f64 loop (float64 kernels) replayed on the CPU
#: in f64 (plain LDLᵀ) from the same inputs and warm state: the same
#: iterations, and u0 (cooling power, 0..500 W) within 1e-6 W, 2e-9 of the
#: range: the two differ only by the order of f64 sums. The closed loops
#: themselves are compared by nothing: with tol 1e-4 where a solve stops
#: moves u0 by watts, so the loop amplifies any rounding (on the CPU, a
#: start 1e-12 K warmer moves the last u0 by 1.86 W, 1e-9 K by 24 W); the
#: card's loop and the CPU's are reported side by side
LINEAR_QP_U0_TOL_W = 1e-6

#: moving-horizon estimation and mixed-integer MPC on the module path, over
#: the reference's examples (agentlib_mpc_torch/reference_configs.py): the
#: MHE example in float32, the module path's default, and the two MINLP
#: phases in float64 on the card (the kernels' float64 instantiations):
#: the JAX package's own float32 loops fail solves of both MINLP examples
#: on its CPU (CIA 1 of 25, branch-and-bound 2 of 25;
#: scripts/module_f32_witness.py)
#:
#: examples/mhe_one_room.py's two agents (MHE beside MPC, the plant with
#: the true load) for 1 800 s (cut from the example's 3 600 s when the ML
#: phases came; the f64 CPU loop then estimates 262.4 W and ends 1.7 K
#: below the start), and its gates: the estimate within 40 W of the true
#: 260 W, the room 1 K below its 298.16 K start
MHE_UNTIL = 1800.0
MHE_LOAD_GATE_W = 40.0
MHE_COOLING_K = 1.0
#: the card's final load estimate against the same loop in f64 on the CPU
#: (plain LDLᵀ), relative
MHE_LOAD_RTOL = 0.01
#: examples/minlp_switched_room.py's gates: the actuated chiller command
#: binary, the zone below UB + 0.5 K, a duty cycle strictly inside (0, 1)
MINLP_UB_MARGIN_K = 0.5
#: the jax_cia agent for a quarter of the example's run (7 controller
#: steps; cut from 7 200 s, and from 3 600 s when the ML phases came, for
#: the script's time limit; the f64 CPU loop then ends at 292.89 K with a
#: duty of 0.83), against the same loop in f64 on the CPU: final zone
#: temperature (K) and duty cycle
MINLP_CIA_UNTIL = 1800.0
MINLP_CIA_T_TOL_K = 0.05
MINLP_CIA_DUTY_TOL = 0.02
#: each solve of the card's f64 CIA loop replayed on the CPU in f64 (plain
#: LDLᵀ) from the same inputs and warm state: the same command and
#: relaxed-QP iterations, and the relaxed state trajectory within 1e-6 K
#: (the two differ only by the order of f64 sums, as on the linear-QP
#: loop). The fixed program is reported, not gated: its optimum is flat,
#: and from the loop's state at t = 3 900 s starts 1e-10 apart stop at
#: iterations 15 to 17 with objectives 3e-4 apart in both packages
#: (scripts/module_f32_witness.py, ``fixed_3900``)
MINLP_CIA_REPLAY_TOL_K = 1e-6
#: the jax_minlp_bb agent at the example's width (N=8, batch_pairs 4),
#: cut in depth to 2 100 s (8 controller steps): the example's controller
#: keeps the chiller on until it has cooled the zone to ~291.5 K and first
#: switches it off at t = 1 800 s (both packages, f64 on the CPU), so
#: 2 100 s is the shortest run whose duty cycle can fall inside (0, 1).
#: Its node budget is cut from the example's 48 to 16 when the scenario
#: phases came, for the script's time limit: at 48 the card's steps
#: explored 9-52 nodes and proved 6 of 8 incumbents optimal (the phase's
#: bb_nodes and bb_proven_optimal); at 16 a step stops after its sweep
#: that passes 16 nodes, and what it proves and how its incumbent compares
#: with the rounding heuristic's are in the same line. Cut again to 8 when
#: the serve phase came, for the script's time limit
MINLP_BB_UNTIL = 2100.0
MINLP_BB_MAX_NODES = 8

#: decentralized consensus ADMM on the module path: examples/admm_cooled_
#: room.py's room and cooler (admm_local over jax_admm, N=8, 6 ADMM
#: iterations per step) and its plant, in float32 on the card (with the
#: plain LDLᵀ on the CPU the port's float32 loop fails none of its 36 + 36
#: solves, the JAX package's 1: scripts/admm_f32_witness.py, ``loop``
#: lines), to 600 s (2 control steps, 12 solves per agent; cut from the
#: 1 800 s of tests/test_admm_module.py, and from 900 s when the ML phases
#: came, for the script's time limit: the f64 CPU loop then ends at
#: 296.97 K, with the agents 3.7e-3 m³/s apart; the port's f32 loop ends
#: 2.6e-3 K from its f64 loop at 900 s on the CPU). Its
#: gates: the room cools and ends below
#: 297.0 K, the actuated air flow at most 0.05 m³/s, and at the last
#: step's last iteration the two agents' air-flow trajectories within
#: 5e-3 m³/s of each other (tests/test_admm_module.py:127-140)
ADMM_UNTIL = 600.0
ADMM_ITERATIONS = 6
ADMM_T_LIMIT_K = 297.0
ADMM_MDOT_MAX = 0.05 + 1e-9
ADMM_COUPLING_GAP_TOL = 5e-3
#: the card's final room temperature against the same loop in f64 on the
#: CPU (plain LDLᵀ), fixed before any card run; on the CPU the float32
#: loop ends 2.4e-3 K (JAX package) and 2.6e-3 K (port) from float64
#: (scripts/admm_f32_witness.py)
ADMM_T_F64_TOL_K = 0.02
#: tests/test_admm_realtime.py's wall-clock pair (admm modules, N=4, a
#: step every 8 s, 3 iterations, a 0.3 s registration window): a 10 s run
#: of the MAS's clock, then the rounds the triggers started run to their
#: end in the worker threads. In float64 (the kernels' float64
#: instantiations): on the pivot-free LDLᵀ the room's N=4 problem fails
#: most of its float32 solves in both packages (JAX 6 of 9, the port 8 of
#: 9; float64 0 and 0: scripts/admm_f32_witness.py, ``rt`` lines), so
#: float32 cannot meet the test's gates
ADMM_RT_UNTIL = 10.0
ADMM_RT_DTYPE = "float64"
#: the two four-room examples at their full width, to 300 s (one control
#: step each; two until module_fleet_mqtt and module_fleet_mp came, for
#: the script's time limit). examples/admm_4rooms_coordinator.py's
#: coordinator, four CooledRoom participants, the AHU and four simulators
#: in float64: on the pivot-free LDLᵀ the JAX package's float32 loop fails
#: two room solves (KKT errors near 300), its float64 loop only the AHU at
#: t = 300 s, on LU and LDLᵀ alike, in the second round, which this depth
#: no longer reaches (scripts/admm_f32_witness.py, ``coord4`` and
#: ``failed`` lines). examples/exchange_admm_4rooms.py's four ExchangeRoom
#: agents and the supplier (admm_local, 12 iterations) and four simulators
#: in float32, the module path's default: clean in both types and both
#: packages there
COORD_UNTIL = EXCHANGE_UNTIL = 300.0
COORD_DTYPE, EXCHANGE_DTYPE = "float64", "float32"
ROOMS = tuple(f"Room_{i}" for i in range(1, 5))
SIMULATORS = tuple((f"Simulation_{i}", "simulator") for i in range(1, 5))
#: the coordinator's ADMM iterations per round: the example's 15, of which
#: the last 7 were cut when the ML phases came and 2 more when the
#: scenario phases came, for the script's time limit (the f64 CPU loop
#: then fails no solve, the building cools and the peak total flow is
#: 0.08 m³/s, at 8 as at 10 iterations; at 6 the reference line's)
COORD_ADMM_ITER_MAX = 6
#: the coordinator loop may fail one solve (of 40 in one round), and no
#: room's (the JAX package's own float64 loop fails the AHU's at t = 300 s,
#: in the second round)
COORD_MAX_FAILED = 1
#: each room's final temperature (K) and mean actuated flow (m³/s) against
#: the same loop in f64 on the CPU (plain LDLᵀ). Set before any card run at
#: about 100× and 12× the JAX package's own f32/f64 gap at this depth
#: (1e-4 K, 8e-7 m³/s), to leave room for a failed AHU solve that falls one
#: iteration apart on the card
COORD_T_TOL_K, COORD_FLOW_TOL = 0.01, 1e-5
#: examples/admm_4rooms_coordinator.py's capacity gate on the peak total
#: actuated flow
COORD_PEAK_FLOW = 0.075 * 1.10 + 1e-9
#: the exchange loop: every solve succeeds; 4 ADMM iterations per step on
#: every agent (the example's last 6 of 12 cut when the ML phases came,
#: for the script's time limit: the f64 CPU loop then balances within
#: 1.5e-9 m³/s; 2 more when the scenario phases came: the f64 CPU loop's
#: rooms, flows and balance are the reference line's, beside the card's);
#: the example's balance gate |supplier − total room flow| at the last
#: step; each room's final temperature within 0.01 K of f64 on the CPU
#: (the JAX package's own f32/f64 gap is at most 7e-5 K) and the
#: supplier's flow within 1e-4 m³/s of it
EXCHANGE_ITERATIONS = 4
EXCHANGE_BALANCE_TOL = 0.02
EXCHANGE_T_TOL_K, EXCHANGE_SUPPLY_TOL = 0.01, 1e-4

#: the deploy fleet (deploy/fleet/*.json, read as they are: the
#: coordinator, the CooledRoom participant with its plant as one local
#: group, the Cooler; coordinated ADMM, N=4, admm_iter_max 5, a round every
#: 5 s of wall clock) across process boundaries on the card, in float64 (the
#: room is the real-time pair's CooledRoom, whose f32 solves fail on the
#: pivot-free LDLᵀ in both packages). module_fleet_mqtt: three container
#: processes over a MiniBroker; module_fleet_mp: the four agents through
#: MultiProcessingMAS on its TCP relay. Each participant's clock runs
#: FLEET_UNTIL seconds; at least FLEET_MIN_ROUNDS rounds must complete
HERE = os.path.dirname(os.path.abspath(__file__))
FLEET_DIR = os.path.join(HERE, "deploy", "fleet")
FLEET_OUT = os.path.join(HERE, "fleet_out")
FLEET_DTYPE = "float64"
FLEET_UNTIL = 15.0
FLEET_MIN_ROUNDS = 2
FLEET_AGENTS = ("Coordinator", "CooledRoom", "Simulation", "Cooler")

#: module_ml_mpc (examples/ml_mpc_one_room.py): the example's 20 steps,
#: its epochs and gates; every plant temperature within ML_MPC_T_TOL_K of
#: the f64 CPU loop with the same surrogate; the card's validation MSE
#: within ML_VAL_MSE_RTOL of the CPU's
ML_DTYPE = "float64"
ML_MPC_UNTIL = 6000.0
ML_MPC_N = 10
ML_EPOCHS = 300
ML_MPC_T_TOL_K = 1e-4
ML_MPC_MAX_FAILED = 2
ML_MPC_TAIL_MARGIN_K = 0.3
ML_VAL_MSE_RTOL = 0.01
#: module_ml_admm (examples/three_zone_datadriven_admm.py): one control
#: step of 8 ADMM iterations (the example's 10, of which the last 2 were
#: cut when the scenario phases came, for the script's time limit; the
#: f64 CPU step runs the same 8); the zones' first moves (m³/s) and the
#: coupling gap against the f64 CPU step
ML_ADMM_UNTIL = 300.0
ML_ADMM_ITERATIONS = 8
ML_ADMM_MOVE_TOL = 1e-6
ML_ADMM_GAP_TOL = 1e-6
ZONES = ("Zone_1", "Zone_2", "Zone_3")
ZONE_SIMULATORS = tuple((f"Simulation_{i}", "simulator")
                        for i in range(1, 4))


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

    from agentlib_mpc_torch import native

    t0 = time.perf_counter()
    results = cuda_build.build_all()
    # the host C++ of the MINLP path (the CIA branch-and-bound), by g++
    t_cxx = time.perf_counter()
    cia_lib = native.build("cia")
    host = {"cia": {"seconds": time.perf_counter() - t_cxx,
                    "library": cia_lib.name}}
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
              for name, r in results.items()},
          "host_libraries": host})
    for name, lines in reports.items():
        # each usage line follows the line naming its kernel
        spills = [(entry, ln) for entry, ln in zip([""] + lines, lines)
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        check(not spills, f"{name}: ptxas reports spills: {spills}")


#: kernel timings taken from per-launch CUDA events because the profiler
#: delivered too few kernel events (reported in the summary line)
DEVICE_MS_FROM_EVENTS: list = []


def events_ms_per_launch(torch, fn, launches: int) -> float:
    """Mean of per-launch CUDA-event times: each launch bracketed by its
    own pair of events on the stream (the kernel plus the events' own few
    microseconds)."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(launches)]
    torch.cuda.synchronize()
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / launches


def device_ms(torch, fn, kernel: str, launches: int = 100,
              attempts: int = 3) -> float:
    """Mean device time per launch of ``kernel`` over ``launches`` calls of
    ``fn``, from torch.profiler's CUDA kernel events (sum / count) of one
    profiled window that follows a warm-up window of as many calls. When
    every window falls short of the events (CUPTI on that machine has
    delivered none at all for a whole session), the time comes from
    per-launch CUDA events instead, said on a line of its own and listed
    in the summary line."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        spans: list = []

        def ready(prof, spans=spans):
            spans.extend(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and kernel in e.name)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):          # the warm-up window, then the one
                for _ in range(launches):   # measured
                    fn()
                    if attempt:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                prof.step()
        # the mean is over the kernel events the profiler saw, at least
        # 90 % of the launches. Without the warm-up window CUPTI dropped
        # about a tenth of the events of a 5 µs kernel on an H100; a
        # window short of them is profiled again, each launch synchronised
        # (which leaves a kernel's own device time as it is)
        if len(spans) >= 0.9 * launches:
            return sum(spans) / len(spans) / 1e3
    ms = events_ms_per_launch(torch, fn, launches)
    DEVICE_MS_FROM_EVENTS.append({"kernel": kernel, "ms": ms,
                                  "profiler_events": len(spans),
                                  "launches": launches})
    print(f"chip_smoke: profiler saw {len(spans)} {kernel} events of "
          f"{launches} launches in each of {attempts} windows; device time "
          f"from per-launch CUDA events instead: {ms:.5f} ms", flush=True)
    return ms


def bounds(B: int, M: int, itemsize: int = 4):
    """(bound_ms, bound_by) of the factor and the solve on B systems of size
    M of ``itemsize``-byte elements: bytes each function must move (the
    lower triangle and diagonal it reads, each output written once) over
    the memory rate, against its flops over the fp32 (fp64) rate."""
    tri = B * M * (M + 1) // 2 * itemsize
    factor_bytes = tri + B * M * M * itemsize
    factor_flops = B * sum(n + n * (n + 1) for n in range(M))
    solve_bytes = tri + 2 * B * M * itemsize
    solve_flops = B * (2 * M * (M - 1) + M)
    rate = FP64_FLOP_PER_S if itemsize == 8 else FP32_FLOP_PER_S

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / rate * 1e3
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


def run_steps(torch, step, args, sync, n_warm=N_WARM):
    """One cold step and ``n_warm`` warm steps; per-step wall ms, outputs,
    stats and (on the card) per-step kernel launches."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel.admm_step import warm_step

    outs, ms, launches = [], [], []
    out = None
    for k in range(1 + n_warm):
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
    from agentlib_mpc_torch.ops.solver import KKT_PATHS
    from agentlib_mpc_torch.parallel.admm_step import (
        N_AGENTS, build_step, warm_step, zone_ocp)

    step, args = build_step(N_AGENTS, device=dev, dtype=torch.float32,
                            record_stats=True)
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    outs, ms, launches = run_steps(torch, step, args, torch.cuda.synchronize)
    totals = launch_totals(kkt)
    ocp = zone_ocp()
    carry, (prim, dual, iters, ok, *_paths) = outs[-1]
    for k, (nf, ns) in enumerate(launches):
        check(0 < nf <= 19 and 0 < ns <= 114,
              f"step {k}: {nf} factor / {ns} solve launches (limits 19/114)")
        check(bool((outs[k][1][5] == KKT_PATHS.index("ldl")).all()),
              f"step {k}: the slice did not run on the dense LDLᵀ path")
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
    phase_profile(torch, lambda: warm_step(step, args, outs[-1][0]),
                  float(np.median(ms[1:])))
    return outs, totals, ocp


def phase_profile(torch, run, warm_ms, name="profile"):
    """``run()``, one warm step, under the profiler (not counted as
    main-path launches): device time by operator and the device's busy
    share of the unprofiled median warm step."""
    from torch.profiler import ProfilerActivity, profile

    from agentlib_mpc_torch.ops import kkt

    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before

    # straight from the profiler's raw events: building its event tree
    # (``prof.events()``, ``key_averages()``) takes about a minute for the
    # ~500 000 events of a day-ahead step. Device time from the kernel and
    # copy events themselves; the solver's and the fused engine's named
    # ranges (also on the device timeline, skipped there) give inclusive
    # host time; the other host events their inclusive time per name
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    by_name: dict = {}
    phases: dict = {}
    host: dict = {}
    n_dev = 0
    for e in prof.profiler.kineto_results.events():
        event_name = e.name()
        ranged = event_name.startswith(("ipm.", "admm.", "ml.",
                                        "scenario."))
        kind = e.device_type()
        if kind == cuda and not ranged:
            table = by_name
            n_dev += 1
        elif kind == cpu:
            table = phases if ranged else host
        else:
            continue
        duration = getattr(e, "duration_ns", None)
        count, us = table.get(event_name, (0, 0.0))
        table[event_name] = (count + 1, us + (
            duration() / 1e3 if duration else e.duration_us()))
    device_ms = sum(us for _, us in by_name.values()) / 1e3
    top_dev = sorted(by_name.items(), key=lambda kv: kv[1][1],
                     reverse=True)[:10]
    top_host = sorted(host.items(), key=lambda kv: kv[1][1],
                      reverse=True)[:8]
    phases = {k: {"count": c, "host_ms": us / 1e3}
              for k, (c, us) in phases.items()}
    record = {"phase": name, "profiled_step_ms": wall_ms,
          "device_ms": device_ms if device_ms > 0 else None,
          "device_kernels": n_dev,
          "busy_share_of_median_warm_step":
              device_ms / warm_ms if device_ms > 0 else None,
          "solver_phases": phases,
          "top_device_ms": [[name[:100], count, us / 1e3]
                            for name, (count, us) in top_dev],
          "top_host_ms": [[name, count, us / 1e3]
                          for name, (count, us) in top_host]}
    emit(record)
    return record


def slice_reference(torch, **fleet) -> dict:
    """The slice's steps (``fleet``: the linear fleet's, ``model=`` and
    ``inner=`` of ``build_step``) in f64 with the plain versions on the
    CPU: the carried state of every step, as lists, and the seconds they
    took."""
    from agentlib_mpc_torch.parallel.admm_step import N_AGENTS, build_step

    step, args = build_step(N_AGENTS, {"kkt_method": "ldl"}, device="cpu",
                            dtype=torch.float64, record_stats=True, **fleet)
    t0 = time.perf_counter()
    outs64, _, _ = run_steps(torch, step, args, lambda: None)
    return {"seconds": time.perf_counter() - t0,
            "carries": [[t.tolist() for t in o[0]] for o in outs64]}


def phase_quality(torch, outs32, ocp, ref):
    seconds = ref["seconds"]
    rows = []
    for k, (o32, carry64) in enumerate(zip(outs32, ref["carries"])):
        c32 = tuple(t.double().cpu() for t in o32[0])
        c64 = tuple(torch.tensor(t, dtype=torch.float64) for t in carry64)
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


def kernel_row(torch, name, K, b):
    """One kernel at one shape (B, M) against its plain version (bitwise)
    and its times there: device time per launch, raw-launch events, the
    plain version, the bound and the library yardstick."""
    from agentlib_mpc_torch.ops import kkt

    B, M = K.shape[0], K.shape[-1]
    LD = kkt.ldl_factor_plain(K)
    (f_bound, f_by), (s_bound, s_by) = bounds(B, M, K.element_size())
    if name == "ldl_factor":
        err = float((kkt.ldl_factor(K) - LD).abs().max())
        raw = kkt.raw_launcher("ldl_factor", K, torch.empty_like(K))
        plain = lambda: kkt.ldl_factor_plain(K)
        library = lambda: torch.linalg.ldl_factor(K)
        bound, by = f_bound, f_by
    else:
        err = float((kkt.ldl_solve(LD, b) - kkt.ldl_solve_plain(LD, b))
                    .abs().max())
        raw = kkt.raw_launcher("ldl_solve", LD, b, torch.empty_like(b))
        LDlib, piv = torch.linalg.ldl_factor(K)
        plain = lambda: kkt.ldl_solve_plain(LD, b)
        library = lambda: torch.linalg.ldl_solve(LDlib, piv, b[..., None])
        bound, by = s_bound, s_by
    dtype = str(K.dtype).replace("torch.", "")
    check(err <= KERNEL_ABS_TOL, f"{name} vs plain at {B}x{M} in {dtype}: "
          f"{err}")
    return {"shape": [B, M], "dtype": dtype, "max_abs_err": err,
            "device_ms": device_ms(torch, raw, f"{name}_kernel"),
            "ms": time_ms(raw, 200), "plain_ms": time_ms(plain, 10),
            "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms(library)}


def library_ms(library) -> float:
    """The library yardstick's ms per call: five calls after a warm-up,
    or one first call alone where it takes over LIBRARY_ONE_CALL_MS
    (``torch.linalg.ldl_*`` at 2 048 systems of 92: seconds a call)."""
    once = time_ms(library, 1, 0)
    return once if once > LIBRARY_ONE_CALL_MS else time_ms(library, 5, 1)


def phase_stage_kernels(torch, dev):
    """Both kernels against their plain versions at the stage sweep's
    shapes (bitwise), and their times there."""
    def batch(B, M, seed):
        n = (M + 1) // 2 + 1
        K_np, b_np = quasi_definite_batch(B, n, M - n, seed)
        return (torch.as_tensor(K_np, dtype=torch.float32, device=dev),
                torch.as_tensor(b_np, dtype=torch.float32, device=dev))

    rows = {"ldl_factor": [], "ldl_solve": []}
    for seed, (B, M) in enumerate(STAGE_FACTOR_SHAPES):
        K, _ = batch(B, M, 100 + seed)
        rows["ldl_factor"].append(kernel_row(torch, "ldl_factor", K, None))
    for seed, (B, M) in enumerate(STAGE_SOLVE_SHAPES):
        K, b = batch(B, M, 200 + seed)
        rows["ldl_solve"].append(kernel_row(torch, "ldl_solve", K, b))
    emit({"phase": "stage_kernels", **rows})
    return rows


def ip_iterations(stats) -> int:
    """Interior-point iterations the batched loop ran over one step: per
    ADMM iteration the slowest lane's count."""
    return int(stats[2].max(dim=1).values.sum())


def phase_long_horizon(torch, dev, smi):
    """The 256-zone step a day ahead, "auto" on the stage sweep with dense
    derivatives. Returns the launch totals and, for sparse_day_ahead, the
    f32 and f64 LU outputs and the median warm step."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.ops.solver import JAC_PATHS, KKT_PATHS
    from agentlib_mpc_torch.parallel.admm_step import (
        N_AGENTS, build_step, zone_ocp)

    ocp = zone_ocp(LONG_N, LONG_DT)
    part = ocp.stage_partition
    size = ocp.n_w + ocp.n_g
    check(kkt.resolve_kkt_method("auto", size, dev, part) == "stage",
          f"auto does not resolve to stage at KKT {size}")
    # dense derivatives forced: this path and its numbers stay PR 3's
    # (sparse_day_ahead runs the same steps on the sparse pipeline)
    parts = {}
    t0 = time.perf_counter()
    step, args = build_step(N_AGENTS, {"jacobian": "dense"}, device=dev,
                            dtype=torch.float32, record_stats=True,
                            horizon=LONG_N, dt=LONG_DT)
    parts["build"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    t0 = time.perf_counter()
    outs, ms, launches = run_steps(torch, step, args, torch.cuda.synchronize,
                                   LONG_N_WARM)
    parts["steps"] = time.perf_counter() - t0
    totals = launch_totals(kkt)
    copied = kkt.ldl_solve_many.copied_bytes
    peak = torch.cuda.max_memory_allocated(dev)
    stage = KKT_PATHS.index("stage")
    per_step = []
    for k, (out, (nf, ns)) in enumerate(zip(outs, launches)):
        stats = out[1]
        check(bool((stats[5] == stage).all()),
              f"step {k}: kkt_path is not 'stage' on every lane")
        check(bool((stats[6] == JAC_PATHS.index("dense")).all()),
              f"step {k}: jac_path is not 'dense' on every lane")
        ip = ip_iterations(stats)
        # S factor launches per interior-point iteration; S-1 many-rhs
        # solves in the factor sweep plus (2S-1) solves x (1 + 2
        # refinement steps) x (predictor, corrector) in the resolves
        S = part.n_stages
        check(nf == S * ip and ns == ((S - 1) + (2 * S - 1) * 3 * 2) * ip,
              f"step {k}: {nf} factor / {ns} solve launches for {ip} "
              f"interior-point iterations")
        per_step.append({"ip_iterations": ip, "factor_launches": nf,
                         "solve_launches": ns})
    check(totals["ldl_factor"] > 0 and totals["ldl_solve"] > 0,
          "the long-horizon path launched no kernel")
    carry, stats = outs[-1]
    check(all(bool(torch.isfinite(t).all()) for t in carry),
          "non-finite long-horizon output")
    warm_ms = float(np.median(ms[1:]))
    emit({"phase": "long_horizon", "zones": N_AGENTS, "horizon": LONG_N,
          "dt": LONG_DT, "kkt_size": size, "stages": part.n_stages,
          "block": part.block, "dtype": "float32", "kkt_path": "stage",
          "cold_step_ms": ms[0], "warm_step_ms": ms[1:],
          "warm_step_ms_median": warm_ms, "per_step": per_step,
          "launches": totals,
          "many_rhs_copy_bytes_per_step": copied / len(outs),
          "ip_iterations_per_admm_iteration_max":
              stats[2].max(dim=1).values.tolist(),
          "lane_success_fraction": stats[3].double().mean(dim=1).tolist(),
          "spread": spread(ocp, carry), "peak_memory_bytes": peak,
          "nvidia_smi": smi})
    # quality gate: the same steps in f64 on the card through pivoted LU,
    # and in f32 through dense LU (the f32 round-off of the dense path)
    refs, seconds = {}, {}
    for name, dtype in (("f64", torch.float64), ("lu32", torch.float32)):
        t0 = time.perf_counter()
        step_r, args_r = build_step(N_AGENTS, {"kkt_method": "lu"},
                                    device=dev, dtype=dtype,
                                    record_stats=True, horizon=LONG_N,
                                    dt=LONG_DT)
        parts[f"build_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        refs[name], _, _ = run_steps(torch, step_r, args_r,
                                     torch.cuda.synchronize, LONG_N_WARM)
        seconds[name] = parts[f"steps_{name}"] = time.perf_counter() - t0
    rows = []
    for k, (o32, o64, olu) in enumerate(zip(outs, refs["f64"],
                                            refs["lu32"])):
        c32, c64, clu = (tuple(t.double() for t in o[0])
                         for o in (o32, o64, olu))
        for o in (o64, olu):
            check(bool((o[1][5] == KKT_PATHS.index("lu")).all()),
                  "a reference did not run on LU")
        check(all(bool(torch.isfinite(t).all()) for t in c64),
              f"non-finite f64 long-horizon reference at step {k}")
        row = {"step": k, "zbar_max_abs_diff": float((c32[3] - c64[3])
                                                     .abs().max()),
               "spread_diff": abs(spread(ocp, c32) - spread(ocp, c64)),
               "spread_f64": spread(ocp, c64),
               "lu32_zbar_max_abs_diff": float((clu[3] - c64[3])
                                               .abs().max()),
               "lu32_spread_diff": abs(spread(ocp, clu) - spread(ocp, c64)),
               "zbar_stage_vs_lu32": float((c32[3] - clu[3]).abs().max())}
        du = (ocp.unflatten(c32[0])["u"] - ocp.unflatten(c64[0])["u"]).abs()
        row.update(u_max_abs_diff=float(du.max()),
                   u_median_abs_diff=float(du.median()))
        rows.append(row)
        check(row["zbar_max_abs_diff"] <= LONG_ZBAR_TOL,
              f"long horizon step {k}: z̄ differs from f64 by "
              f"{row['zbar_max_abs_diff']}")
        check(row["spread_diff"] <= LONG_SPREAD_TOL,
              f"long horizon step {k}: spread differs from f64 by "
              f"{row['spread_diff']}")
        check(row["zbar_stage_vs_lu32"] <= LONG_SWEEP_VS_DENSE_TOL,
              f"long horizon step {k}: z̄ of the sweep differs from f32 "
              f"dense LU by {row['zbar_stage_vs_lu32']}")
    emit({"phase": "long_horizon_quality",
          "reference": "f64 lu on the card; f32 lu on the card (lu32)",
          "seconds": seconds, "zbar_tol": LONG_ZBAR_TOL,
          "spread_tol": LONG_SPREAD_TOL,
          "sweep_vs_dense_tol": LONG_SWEEP_VS_DENSE_TOL, "steps": rows,
          "phase_seconds_by_part": parts})
    return totals, {"f32": outs, "f64": refs["f64"], "warm_ms": warm_ms}


def phase_shooting(torch, dev):
    """256 zones a day ahead by multiple shooting on the stage sweep, then
    one plant step of every zone."""
    from agentlib_mpc_torch.models.zoo import ZoneWithSupply
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.ops.solver import (
        KKT_PATHS, SolverOptions, attach_stage_partition, solve_nlp_batched)
    from agentlib_mpc_torch.ops.transcription import transcribe
    from agentlib_mpc_torch.parallel.admm_step import (
        N_AGENTS, SOLVER_BASE, ZONE_D_ROW_TAIL, fleet_inputs)

    model = ZoneWithSupply()
    ocp = transcribe(model, ["mDot"], N=LONG_N, dt=LONG_DT,
                     method="multiple_shooting", integrator=SHOOT_INTEGRATOR,
                     integrator_substeps=SHOOT_SUBSTEPS)
    x0s_np, loads_np = fleet_inputs(N_AGENTS)

    def solve(dtype, overrides):
        theta0 = ocp.default_params(device=dev, dtype=dtype)
        x0s = torch.as_tensor(x0s_np, dtype=dtype, device=dev)[:, None]
        loads = torch.as_tensor(loads_np, dtype=dtype, device=dev)
        tail = torch.tensor(ZONE_D_ROW_TAIL, dtype=dtype, device=dev)
        d_row = torch.cat([loads[:, None], tail.expand(N_AGENTS, 2)], -1)
        theta = theta0._replace(
            x0=x0s, d_traj=d_row[:, None, :].expand(N_AGENTS, LONG_N, 3),
            **{k: v.expand((N_AGENTS,) + v.shape)
               for k, v in theta0._asdict().items()
               if k not in ("x0", "d_traj")})
        lb, ub = torch.func.vmap(ocp.bounds)(theta)
        w0 = torch.func.vmap(ocp.initial_guess)(theta)
        opts = attach_stage_partition(
            SolverOptions(**{**SOLVER_BASE, "max_iter": SHOOT_MAX_ITER,
                             **overrides}), ocp.stage_partition)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_nlp_batched(ocp.nlp, w0, theta, lb, ub, opts)
        torch.cuda.synchronize()
        return res, theta, (time.perf_counter() - t0) * 1e3

    kkt.reset_launch_counts()
    res, theta, solve_ms = solve(torch.float32, {})
    totals = launch_totals(kkt)
    check(res.stats.kkt_path == KKT_PATHS.index("stage"),
          "the shooting solve did not run on the stage sweep")
    check(totals["ldl_factor"] > 0 and totals["ldl_solve"] > 0,
          "the shooting path launched no kernel")
    check(bool(torch.isfinite(res.w).all()), "non-finite shooting solution")
    res64, _, solve64_ms = solve(torch.float64, {"kkt_method": "lu"})
    check(res64.stats.kkt_path == KKT_PATHS.index("lu"),
          "the f64 shooting reference did not run on LU")
    u0 = ocp.unflatten(res.w)["u"][:, 0]                         # (n, 1)
    u0_64 = ocp.unflatten(res64.w)["u"][:, 0]
    solved = res.stats.success & res64.stats.success
    share32 = float(res.stats.success.double().mean())
    share64 = float(res64.stats.success.double().mean())
    # lanes f64 solves and f32 does not, as a share of the fleet
    lost = float((res64.stats.success & ~res.stats.success).double().mean())
    check(bool(solved.any()), "no lane solved in both precisions")
    check(lost <= SHOOT_SUCCESS_SHARE_TOL,
          f"f32 fails {lost} of the lanes f64 solves (solved shares: f32 "
          f"{share32}, f64 {share64})")
    du0 = float((u0.double() - u0_64).abs()[solved].max())
    du0_all = float((u0.double() - u0_64).abs().max())
    check(du0 <= SHOOT_U0_TOL,
          f"shooting u0 differs from f64 by {du0} on solved lanes")

    # one plant step of every zone from its solved first control
    d0 = theta.d_traj[:, 0]                                      # (n, 3)
    u_full = torch.cat([u0, d0], dim=-1)                         # (n, 4)
    p = theta.p[0]
    x0s = theta.x0
    x_next, y = model.simulate_step(x0s, u_full, p, LONG_DT)
    x_ref, _ = model.simulate_step(x0s.double().cpu(), u_full.double().cpu(),
                                   p.double().cpu(), LONG_DT)
    dx = float((x_next.double().cpu() - x_ref).abs().max())
    check(bool(torch.isfinite(x_next).all()) and x_next.shape == x0s.shape
          and y.shape == (N_AGENTS, len(model.output_names)),
          "plant step: non-finite or misshapen output")
    check(dx <= PLANT_X_TOL, f"plant step differs from f64 by {dx} K")
    emit({"phase": "shooting", "zones": N_AGENTS, "horizon": LONG_N,
          "integrator": SHOOT_INTEGRATOR, "substeps": SHOOT_SUBSTEPS,
          "kkt_size": ocp.n_w + ocp.n_g,
          "stages": ocp.stage_partition.n_stages,
          "block": ocp.stage_partition.block, "kkt_path": "stage",
          "solve_ms": solve_ms, "solve64_lu_ms": solve64_ms,
          "ip_iterations_max": int(res.stats.iterations.max()),
          "lane_success_fraction": share32,
          "lane_success_fraction_f64": share64,
          "lanes_solved_by_f64_only": lost,
          "lanes_solved_by_f32_only": float(
              (res.stats.success & ~res64.stats.success).double().mean()),
          "launches": totals, "u0_max_abs_diff_f64_solved": du0,
          "u0_max_abs_diff_f64_all_lanes": du0_all,
          "u0_tol": SHOOT_U0_TOL, "plant_x_max_abs_diff_f64": dx,
          "plant_x_tol": PLANT_X_TOL})
    return totals


def launch_totals(kkt):
    """Launch counts since the last reset, and the (B, M) shapes launched."""
    return {"ldl_factor": kkt.ldl_factor.launches,
            "ldl_solve": kkt.ldl_solve.launches,
            "shapes": {"ldl_factor": sorted(kkt.ldl_factor.shapes),
                       "ldl_solve": sorted(kkt.ldl_solve.shapes)},
            "shapes_f64": {"ldl_factor": sorted(kkt.ldl_factor.shapes_f64),
                           "ldl_solve": sorted(kkt.ldl_solve.shapes_f64)}}


def phase_path_shapes(torch, dev, by_path):
    """Every (B, M) a path launched either was held bitwise against the
    plain version in the kernels/stage_kernels phases, or is held here,
    with its times beside its bound and the library yardstick."""
    from agentlib_mpc_torch.ops import kkt

    f32, f64 = torch.float32, torch.float64
    checked = {"ldl_factor": {(B, M, f32) for B, M, _ in CHECK_SHAPES}
               | {(B, M, f32) for B, M in STAGE_FACTOR_SHAPES},
               "ldl_solve": {(B, M, f32) for B, M, _ in CHECK_SHAPES}
               | {(B, M, f32) for B, M in STAGE_SOLVE_SHAPES}}
    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    rows = []
    for path, totals in by_path.items():
        for key, dtype in (("shapes", f32), ("shapes_f64", f64)):
            for name, shapes in totals.get(key, {}).items():
                for B, M in shapes:
                    if (B, M, dtype) in checked[name]:
                        continue
                    checked[name].add((B, M, dtype))
                    n = (M + 1) // 2 + 1
                    K_np, b_np = quasi_definite_batch(B, n, M - n, 300 + M)
                    K = torch.as_tensor(K_np, dtype=dtype, device=dev)
                    b = torch.as_tensor(b_np, dtype=dtype, device=dev)
                    rows.append({"kernel": name, "path": path,
                                 **kernel_row(torch, name, K, b)})
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    emit({"phase": "path_shapes",
          "launched": {path: {"float32": t.get("shapes"),
                              "float64": t.get("shapes_f64")}
                       for path, t in by_path.items()},
          "checked_here": rows})
    return rows


def linear_quality_rows(torch, ocp, outs32, outs64):
    """Per step: z̄, spreads and the |Δu| statistics of the linear fleet
    against its f64 reference: median and largest over all controls, and
    the lanes with a control more than QP_U_OUTLIER_W apart."""
    rows = []
    for k, (o32, o64) in enumerate(zip(outs32, outs64)):
        c32 = tuple(t.double().cpu() for t in o32[0])
        c64 = tuple(t.double().cpu() for t in o64[0])
        du = (ocp.unflatten(c32[0])["u"] - ocp.unflatten(c64[0])["u"]).abs()
        outliers = du.reshape(du.shape[0], -1).amax(dim=-1) > QP_U_OUTLIER_W
        rows.append({"step": k,
                     "f64_finite": all(bool(torch.isfinite(t).all())
                                       for t in c64),
                     "zbar_max_abs_diff": float((c32[3] - c64[3])
                                                .abs().max()),
                     "spread": spread(ocp, c32),
                     "spread_f64": spread(ocp, c64),
                     "u_median_abs_diff": float(du.median()),
                     "u_max_abs_diff": float(du.max()),
                     "lanes_over_outlier": int(outliers.sum()),
                     "lane_outlier_share": float(outliers.double().mean())})
    return rows


def check_linear_quality(name, rows):
    """The linear fleet's gate (QP_* above), step by step: z̄, median
    |Δu|, share of outlier lanes; the spread is reported. Called after
    the rows are printed, so a failing run still shows them."""
    for row in rows:
        k = row["step"]
        check(row["f64_finite"], f"{name} step {k}: non-finite f64 reference")
        check(row["zbar_max_abs_diff"] <= QP_ZBAR_TOL,
              f"{name} step {k}: z̄ differs from f64 by "
              f"{row['zbar_max_abs_diff']} W")
        check(row["u_median_abs_diff"] <= QP_U_MEDIAN_TOL,
              f"{name} step {k}: median |Δu| {row['u_median_abs_diff']} W")
        check(row["lane_outlier_share"] <= QP_U_OUTLIER_SHARE_TOL,
              f"{name} step {k}: {row['lanes_over_outlier']} lanes with a "
              f"control more than {QP_U_OUTLIER_W} W from f64")


def check_launches_per_iteration(name, outs, launches, factor_per_it,
                                 solve_per_it, kkt_path, jac_path):
    """Launches of every step must be exactly ``factor_per_it`` factor and
    ``solve_per_it`` solve launches per inner iteration, and every lane
    must have run the named KKT and derivative paths."""
    from agentlib_mpc_torch.ops.solver import JAC_PATHS, KKT_PATHS

    per_step = []
    for k, (out, (nf, ns)) in enumerate(zip(outs, launches)):
        stats = out[1]
        check(bool((stats[5] == KKT_PATHS.index(kkt_path)).all()),
              f"{name} step {k}: kkt_path is not {kkt_path!r} on every lane")
        check(bool((stats[6] == JAC_PATHS.index(jac_path)).all()),
              f"{name} step {k}: jac_path is not {jac_path!r} on every lane")
        ip = ip_iterations(stats)
        check(nf == factor_per_it * ip and ns == solve_per_it * ip,
              f"{name} step {k}: {nf} factor / {ns} solve launches for {ip} "
              f"inner iterations (expected {factor_per_it}/{solve_per_it} "
              f"per iteration)")
        per_step.append({"inner_iterations": ip, "factor_launches": nf,
                         "solve_launches": ns})
    return per_step


def phase_qp_slice(torch, dev, smi):
    """The linear fleet on the QP fast path at N=10, with the certified
    routing verdicts of both fleets."""
    import logging

    from agentlib_mpc_torch.lint.fx import certify_lq
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.ops.qp import is_lq, resolve_qp_routing
    from agentlib_mpc_torch.parallel.admm_step import (
        MODELS, N_AGENTS, augmented_nlp, augmented_theta, build_step,
        warm_step)

    log = logging.getLogger("chip_smoke")
    verdicts = {}
    for model, expected in (("linear", "lq"), ("zone", "not_lq")):
        ocp = MODELS[model][0]()
        nlp, theta = augmented_nlp(ocp), augmented_theta(ocp, model, dev)
        t0 = time.perf_counter()
        cert = certify_lq(nlp, theta, ocp.n_w)
        seconds = time.perf_counter() - t0
        routed = resolve_qp_routing(
            "auto", lambda: is_lq(nlp, theta, ocp.n_w), logger=log,
            label=f"the {model} fleet", certifier=lambda: cert)
        verdicts[model] = {"certificate": cert.describe(),
                           "routed_to_qp": routed,
                           "certify_seconds": seconds}
        check(cert.status == expected and routed == (expected == "lq"),
              f"{model} fleet: certificate {cert.describe()}, routed "
              f"{routed}; expected {expected}")
    emit({"phase": "qp_routing", "verdicts": verdicts})

    step, args = build_step(N_AGENTS, device=dev, dtype=torch.float32,
                            record_stats=True, model="linear", inner="qp")
    check(step.solver_options.stage_jacobian_plan is None,
          "a stage-sparse plan was attached at N=10")
    ocp = step.ocp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    outs, ms, launches = run_steps(torch, step, args, torch.cuda.synchronize)
    totals = launch_totals(kkt)
    peak = torch.cuda.max_memory_allocated(dev)
    # one factor and two re-solves (predictor, corrector) of one solve and
    # two refinement steps each per QP iteration
    per_step = check_launches_per_iteration("qp_slice", outs, launches, 1, 6,
                                            "ldl", "dense")
    carry, stats = outs[-1]
    check(all(bool(torch.isfinite(t).all()) for t in carry),
          "non-finite qp_slice output")
    warm_ms = float(np.median(ms[1:]))
    emit({"phase": "qp_slice", "zones": N_AGENTS, "model": "linear",
          "inner": "qp", "dtype": "float32", "kkt_size": ocp.n_w + ocp.n_g,
          "cold_step_ms": ms[0], "warm_step_ms": ms[1:],
          "warm_step_ms_median": warm_ms, "per_step": per_step,
          "launches": totals,
          "qp_iterations_per_admm_iteration_max":
              stats[2].max(dim=1).values.tolist(),
          "lane_success_fraction": stats[3].double().mean(dim=1).tolist(),
          "spread": spread(ocp, carry), "peak_memory_bytes": peak,
          "nvidia_smi": smi})
    phase_profile(torch, lambda: warm_step(step, args, outs[-1][0]),
                  warm_ms, name="qp_slice_profile")
    return outs, totals, step, args, ms[0]


def phase_qp_quality(torch, dev, outs32, step32, args32, qp_cold_ms, ref):
    """The linear fleet's QP steps against f64 on the CPU (``ref``, from
    :func:`slice_reference`), one cold step with the NLP inner solver on
    the card, and converged QP against converged NLP solves of the same
    subproblems."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.ops.qp import solve_qp
    from agentlib_mpc_torch.ops.solver import SolverOptions, solve_nlp_batched
    from agentlib_mpc_torch.parallel.admm_step import (
        N_AGENTS, augmented_nlp, build_step)

    ocp = step32.ocp
    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    seconds64 = ref["seconds"]
    outs64 = [(tuple(torch.tensor(t, dtype=torch.float64) for t in carry),)
              for carry in ref["carries"]]
    rows = linear_quality_rows(torch, ocp, outs32, outs64)

    # the JAX package's --qp-ab: one cold step of the same fleet through
    # the NLP inner solver (the budget-limited iterates of the two inner
    # solvers differ by design; their agreement is held at convergence
    # below)
    step_n, args_n = build_step(N_AGENTS, device=dev, dtype=torch.float32,
                                record_stats=True, model="linear",
                                inner="nlp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_n = step_n(*args_n)
    torch.cuda.synchronize()
    nlp_step_ms = (time.perf_counter() - t0) * 1e3
    check(all(bool(torch.isfinite(t).all()) for t in out_n[0]),
          "non-finite output of the NLP-inner step")
    zbar_qp_vs_nlp = float((outs32[0][0][3] - out_n[0][3]).abs().max())

    # converged solves of the 256 subproblems at the last step's state
    carry = outs32[-1][0]
    n = N_AGENTS
    theta = step32.zone_params(args32[0], args32[1])
    lb, ub = torch.func.vmap(ocp.bounds)(theta)
    th = (theta, carry[3].expand((n,) + carry[3].shape), carry[4],
          args32[7].expand(n))
    nlp = augmented_nlp(ocp)
    opts = SolverOptions(tol=QP_NLP_TOL, max_iter=QP_NLP_MAX_ITER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rq = solve_qp(nlp, carry[0], th, lb, ub, opts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rn = solve_nlp_batched(nlp, carry[0], th, lb, ub, opts)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    both = rq.stats.success & rn.stats.success
    share = float(both.double().mean())
    rel = ((rq.stats.objective - rn.stats.objective).abs()
           / rn.stats.objective.abs().clamp_min(1.0))[both].double()
    du = (ocp.unflatten(rq.w)["u"] - ocp.unflatten(rn.w)["u"]).abs()
    du_lane = du.reshape(n, -1).amax(dim=-1)[both]
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    emit({"phase": "qp_quality", "reference": "f64 plain on cpu",
          "f64_seconds": seconds64, "zbar_tol_W": QP_ZBAR_TOL,
          "u_median_tol_W": QP_U_MEDIAN_TOL,
          "u_outlier_W": QP_U_OUTLIER_W,
          "lane_outlier_share_tol": QP_U_OUTLIER_SHARE_TOL, "steps": rows,
          "qp_ab": {"qp_cold_step_ms": qp_cold_ms,
                    "nlp_cold_step_ms": nlp_step_ms,
                    "zbar_qp_vs_nlp_cold_step_W": zbar_qp_vs_nlp,
                    "nlp_ip_iterations_per_admm_iteration_max":
                        out_n[1][2].max(dim=1).values.tolist()},
          "converged": {
              "tol": QP_NLP_TOL, "max_iter": QP_NLP_MAX_ITER,
              "qp_ms": (t1 - t0) * 1e3, "nlp_ms": (t2 - t1) * 1e3,
              "qp_iterations_max": int(rq.stats.iterations.max()),
              "nlp_iterations_max": int(rn.stats.iterations.max()),
              "qp_success": float(rq.stats.success.double().mean()),
              "nlp_success": float(rn.stats.success.double().mean()),
              "both_share": share,
              "objective_rel_gap_median": float(rel.median()),
              "objective_rel_gap_max": float(rel.max()),
              "u_max_abs_diff_median_lane_W": float(du_lane.median()),
              "u_max_abs_diff_W": float(du_lane.max()),
              "both_share_min": QP_NLP_BOTH_SHARE_MIN,
              "objective_rel_median_tol": QP_NLP_OBJ_REL_MEDIAN_TOL,
              "objective_rel_max_tol": QP_NLP_OBJ_REL_MAX_TOL}})
    check_linear_quality("qp_slice", rows)
    check(share >= QP_NLP_BOTH_SHARE_MIN,
          f"QP and NLP both solve only {share} of the subproblems")
    check(float(rel.median()) <= QP_NLP_OBJ_REL_MEDIAN_TOL
          and float(rel.max()) <= QP_NLP_OBJ_REL_MAX_TOL,
          f"QP vs NLP objective gap median {float(rel.median())}, max "
          f"{float(rel.max())}")


def phase_qp_day_ahead(torch, dev, smi):
    """The linear fleet a day ahead on the QP fast path, "auto" routed to
    the stage-sparse pipeline by the certified plan."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel.admm_step import N_AGENTS, build_step

    t0 = time.perf_counter()
    step, args = build_step(N_AGENTS, device=dev, dtype=torch.float32,
                            record_stats=True, horizon=LONG_N, dt=LONG_DT,
                            model="linear", inner="qp")
    build_s = time.perf_counter() - t0
    plan = step.solver_options.stage_jacobian_plan
    check(plan is not None, "no stage-sparse plan attached at N=96")
    ocp = step.ocp
    S = plan.partition.n_stages
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    outs, ms, launches = run_steps(torch, step, args, torch.cuda.synchronize,
                                   LONG_N_WARM)
    totals = launch_totals(kkt)
    peak = torch.cuda.max_memory_allocated(dev)
    # the banded sweep: S factors and S-1 many-rhs solves, then two
    # re-solves of (2S-1) block solves x (1 + 2 refinement steps)
    per_step = check_launches_per_iteration(
        "qp_day_ahead", outs, launches, S, (S - 1) + (2 * S - 1) * 3 * 2,
        "stage", "sparse")
    carry, stats = outs[-1]
    check(all(bool(torch.isfinite(t).all()) for t in carry),
          "non-finite qp_day_ahead output")
    emit({"phase": "qp_day_ahead", "zones": N_AGENTS, "horizon": LONG_N,
          "dt": LONG_DT, "kkt_size": ocp.n_w + ocp.n_g, "stages": S,
          "plan": repr(plan), "plan_attached": True,
          "build_and_certify_seconds": build_s, "dtype": "float32",
          "cold_step_ms": ms[0], "warm_step_ms": ms[1:],
          "warm_step_ms_median": float(np.median(ms[1:])),
          "per_step": per_step, "launches": totals,
          "lane_success_fraction": stats[3].double().mean(dim=1).tolist(),
          "spread": spread(ocp, carry), "peak_memory_bytes": peak,
          "nvidia_smi": smi})
    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    step64, args64 = build_step(N_AGENTS, {"kkt_method": "lu",
                                           "jacobian": "dense"},
                                device=dev, dtype=torch.float64,
                                record_stats=True, horizon=LONG_N,
                                dt=LONG_DT, model="linear", inner="qp")
    t0 = time.perf_counter()
    outs64, _, _ = run_steps(torch, step64, args64, torch.cuda.synchronize,
                             LONG_N_WARM)
    seconds64 = time.perf_counter() - t0
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    rows = linear_quality_rows(torch, ocp, outs, outs64)
    emit({"phase": "qp_day_ahead_quality",
          "reference": "f64 lu, dense derivatives, on the card",
          "seconds": seconds64, "zbar_tol_W": QP_ZBAR_TOL,
          "u_median_tol_W": QP_U_MEDIAN_TOL, "u_outlier_W": QP_U_OUTLIER_W,
          "lane_outlier_share_tol": QP_U_OUTLIER_SHARE_TOL, "steps": rows})
    check_linear_quality("qp_day_ahead", rows)
    return totals


def phase_sparse_day_ahead(torch, dev, smi, lh):
    """The zone fleet a day ahead with "auto" (now the stage-sparse
    pipeline), held against long_horizon's outputs."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel.admm_step import N_AGENTS, build_step

    t0 = time.perf_counter()
    step, args = build_step(N_AGENTS, device=dev, dtype=torch.float32,
                            record_stats=True, horizon=LONG_N, dt=LONG_DT)
    build_s = time.perf_counter() - t0
    plan = step.solver_options.stage_jacobian_plan
    check(plan is not None, "no stage-sparse plan attached at N=96")
    ocp = step.ocp
    S = plan.partition.n_stages
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    t0 = time.perf_counter()
    outs, ms, launches = run_steps(torch, step, args, torch.cuda.synchronize,
                                   LONG_N_WARM)
    steps_s = time.perf_counter() - t0
    totals = launch_totals(kkt)
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = check_launches_per_iteration(
        "sparse_day_ahead", outs, launches, S,
        (S - 1) + (2 * S - 1) * 3 * 2, "stage", "sparse")
    carry, stats = outs[-1]
    check(all(bool(torch.isfinite(t).all()) for t in carry),
          "non-finite sparse_day_ahead output")
    warm_ms = float(np.median(ms[1:]))
    emit({"phase": "sparse_day_ahead", "zones": N_AGENTS, "horizon": LONG_N,
          "kkt_size": ocp.n_w + ocp.n_g, "plan": repr(plan),
          "plan_attached": True, "build_and_certify_seconds": build_s,
          "dtype": "float32", "cold_step_ms": ms[0], "warm_step_ms": ms[1:],
          "warm_step_ms_median": warm_ms,
          "long_horizon_warm_step_ms_median": lh["warm_ms"],
          "per_step": per_step, "launches": totals,
          "lane_success_fraction": stats[3].double().mean(dim=1).tolist(),
          "spread": spread(ocp, carry), "peak_memory_bytes": peak,
          "nvidia_smi": smi})
    # no profiled step on either day-ahead path: processing one's ~115 000
    # device events takes ~28 s of the time limit, and PERF.md keeps both
    # profiles
    # quality: long_horizon's f64 LU outputs (reused) with its gate, and
    # its dense f32 run on z̄
    rows = []
    for k, (o32, o64, od) in enumerate(zip(outs, lh["f64"], lh["f32"])):
        c32, c64, cd = (tuple(t.double() for t in o[0])
                        for o in (o32, o64, od))
        row = {"step": k,
               "zbar_max_abs_diff": float((c32[3] - c64[3]).abs().max()),
               "spread_diff": abs(spread(ocp, c32) - spread(ocp, c64)),
               "zbar_sparse_vs_dense_f32": float((c32[3] - cd[3])
                                                 .abs().max())}
        rows.append(row)
    emit({"phase": "sparse_day_ahead_quality",
          "reference": "long_horizon's f64 lu and dense f32 outputs",
          "zbar_tol": LONG_ZBAR_TOL, "spread_tol": LONG_SPREAD_TOL,
          "sparse_vs_dense_tol": LONG_SWEEP_VS_DENSE_TOL, "steps": rows,
          "phase_seconds_by_part": {"build": build_s, "steps": steps_s}})
    for row in rows:
        k = row["step"]
        check(row["zbar_max_abs_diff"] <= LONG_ZBAR_TOL,
              f"sparse_day_ahead step {k}: z̄ differs from f64 by "
              f"{row['zbar_max_abs_diff']}")
        check(row["spread_diff"] <= LONG_SPREAD_TOL,
              f"sparse_day_ahead step {k}: spread differs from f64 by "
              f"{row['spread_diff']}")
        check(row["zbar_sparse_vs_dense_f32"] <= LONG_SWEEP_VS_DENSE_TOL,
              f"sparse_day_ahead step {k}: z̄ differs from the dense f32 "
              f"run by {row['zbar_sparse_vs_dense_f32']}")
    return totals


def room_config(i: int, load: float) -> dict:
    """One room's admm_local config (examples/fused_fleet_rooms.py's,
    with the model named by its zoo name)."""
    return {
        "id": f"Room_{i}",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "admm", "type": "admm_local",
             "optimization_backend": {
                 "type": "jax_admm",
                 "model": {"class": "CooledRoom"},
                 "discretization_options": {"collocation_order": 2,
                                            "collocation_method": "legendre"},
                 "solver": {"max_iter": 30},
             },
             "time_step": FLEET_DT,
             "prediction_horizon": FLEET_HORIZON,
             "max_iterations": FLEET_MAX_ITERATIONS,
             "penalty_factor": 20.0,
             "parameters": [{"name": "s_T", "value": 1.0}],
             "inputs": [
                 {"name": "load", "value": load},
                 {"name": "T_in", "value": FLEET_T_IN},
                 {"name": "T_upper", "value": FLEET_UB},
             ],
             "states": [{"name": "T", "value": FLEET_START}],
             "couplings": [
                 {"name": "mDot", "alias": "mDotShared", "value": 0.02,
                  "lb": 0.0, "ub": 0.05},
             ]},
        ],
    }


def fused_engine(torch, model: str, dev, dtype, pinned: bool = False,
                 kkt_method: str = "auto"):
    """(engine, thetas, ocp, alias): bench.py's --mesh-ab workload at one
    device (``model="zone"``) or the linear fleet (``"linear"``) through
    FusedADMM; ``pinned`` zeroes the Boyd exits."""
    from agentlib_mpc_torch.ops.solver import SolverOptions
    from agentlib_mpc_torch.parallel import admm_step
    from agentlib_mpc_torch.parallel.fused_admm import (
        AgentGroup, FusedADMM, FusedADMMOptions, pad_group_to_devices)

    ocp_fn, tail, _zbar0, rho = admm_step.MODELS[model]
    if model == "zone":
        rho = FUSED_RHO
    ocp = ocp_fn()
    control = ocp.control_names[0]
    alias = "mDotCoolAir" if model == "zone" else control
    n = admm_step.N_AGENTS
    cold = SolverOptions(**admm_step.SOLVER_BASE, mu_init=admm_step.COLD_MU,
                         kkt_method=kkt_method)
    warm = cold._replace(max_iter=admm_step.WARM_BUDGET,
                         mu_init=admm_step.WARM_MU)
    exits = dict(abs_tol=0.0, rel_tol=0.0, primal_tol=0.0,
                 dual_tol=0.0) if pinned else {}
    opts = FusedADMMOptions(max_iterations=FUSED_ADMM_ITERS, rho=rho,
                            **exits)
    x0s, loads = admm_step.fleet_inputs(n)
    base = ocp.default_params(device=dev, dtype=dtype)
    d_rows = torch.tensor([[load, *tail] for load in loads], dtype=dtype,
                          device=dev)
    thetas = base._replace(
        x0=torch.as_tensor(x0s, dtype=dtype, device=dev).reshape(n, 1),
        d_traj=d_rows[:, None, :].expand(n, ocp.N, 3).contiguous(),
        **{k: v.expand((n,) + v.shape).contiguous()
           for k, v in base._asdict().items() if k not in ("x0", "d_traj")})
    group = AgentGroup(name="zones", ocp=ocp, n_agents=n,
                       couplings={alias: control}, solver_options=cold,
                       warm_solver_options=warm)
    group, thetas, mask = pad_group_to_devices(group, thetas, 1)
    engine = FusedADMM([group], opts, active=[mask], device=dev)
    return engine, thetas, ocp, alias


def fused_rounds(torch, engine, thetas, steps: int, sync):
    """``steps`` rounds (the first cold); per round wall ms, the state,
    trajectories and stats, and the kernel launches."""
    from agentlib_mpc_torch.ops import kkt

    state = engine.init_state([thetas])
    rows = []
    for _ in range(steps):
        before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
        t0 = time.perf_counter()
        state, trajs, stats = engine.step(state, [thetas])
        sync()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "state": state, "trajs": trajs, "stats": stats,
                     "launches": (kkt.ldl_factor.launches - before[0],
                                  kkt.ldl_solve.launches - before[1])})
    return rows


def check_fused_launches(name, rows, cold_budget, warm_budget):
    """Every round: exactly 6 solve launches per factor launch (one factor
    and the predictor/corrector re-solves with two refinement solves each
    per inner iteration), at most the inner budgets' factor launches."""
    per_round = []
    for k, row in enumerate(rows):
        nf, ns = row["launches"]
        its = int(row["stats"].iterations)
        limit = cold_budget + (its - 1) * warm_budget
        check(nf > 0 and ns == 6 * nf,
              f"{name} round {k}: {nf} factor / {ns} solve launches (must "
              f"be 1:6)")
        check(nf <= limit,
              f"{name} round {k}: {nf} factor launches for {its} ADMM "
              f"iterations (at most {limit})")
        per_round.append({"admm_iterations": its, "factor_launches": nf,
                          "solve_launches": ns, "ms": row["ms"],
                          "converged": bool(row["stats"].converged)})
    return per_round


def fused_reference(torch, model: str) -> dict:
    """The fused engine's rounds (``model`` as :func:`fused_engine`) in f64
    with the plain versions on the CPU, Boyd exits pinned: per round the
    first control of every lane, z̄ and the ADMM iterations, as lists, and
    the seconds they took."""
    t0 = time.perf_counter()
    engine, thetas, _, alias = fused_engine(torch, model, "cpu",
                                            torch.float64, pinned=True,
                                            kkt_method="ldl")
    rows = fused_rounds(torch, engine, thetas, FUSED_QUALITY_STEPS,
                        lambda: None)
    return {"seconds": time.perf_counter() - t0,
            "rounds": [{"u": r["trajs"][0]["u"][..., 0].tolist(),
                        "zbar": r["state"].zbar[alias].tolist(),
                        "iterations": int(r["stats"].iterations)}
                       for r in rows]}


def fused_quality_rows(torch, alias, rows, rows64):
    """Per round: z̄ and spread max|u − z̄| of the card's engine against
    the CPU's f64 engine (``rows64``: :func:`fused_reference`'s rounds),
    and the per-lane |Δu| statistics."""
    out = []
    for k, (r32, r64) in enumerate(zip(rows, rows64)):
        u32 = r32["trajs"][0]["u"][..., 0].double().cpu()
        u64 = torch.tensor(r64["u"], dtype=torch.float64)
        z32 = r32["state"].zbar[alias].double().cpu()
        z64 = torch.tensor(r64["zbar"], dtype=torch.float64)
        du = (u32 - u64).abs()
        outliers = du.amax(dim=-1) > QP_U_OUTLIER_W
        out.append({
            "round": k, "f64_finite": bool(torch.isfinite(u64).all()),
            "iterations": [int(r32["stats"].iterations),
                           r64["iterations"]],
            "zbar_max_abs_diff": float((z32 - z64).abs().max()),
            "spread": float((u32 - z32).abs().max()),
            "spread_f64": float((u64 - z64).abs().max()),
            "spread_diff": abs(float((u32 - z32).abs().max())
                               - float((u64 - z64).abs().max())),
            "u_median_abs_diff": float(du.median()),
            "u_max_abs_diff": float(du.max()),
            "lanes_over_outlier": int(outliers.sum()),
            "lane_outlier_share": float(outliers.double().mean())})
    return out


def phase_fused(torch, dev, smi, model: str, ref):
    """One fused engine at 256 zones on the card: launch counts of a cold
    and two warm rounds, a profiled warm round, the quality gate
    against f64 on the CPU with pinned exits (``ref``, from
    :func:`fused_reference`), and (zone fleet) a quarantined NaN lane."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel import admm_step

    name = "fused_slice" if model == "zone" else "fused_linear"
    t0 = time.perf_counter()
    engine, thetas, ocp, alias = fused_engine(torch, model, dev,
                                              torch.float32)
    build_s = time.perf_counter() - t0
    if model == "linear":
        check(engine.group_uses_qp == (True,),
              f"{name}: the linear group is not routed to the QP "
              f"({engine.group_uses_qp})")
    else:
        check(engine.group_uses_qp == (False,),
              f"{name}: the zone group was routed to the QP")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    rows = fused_rounds(torch, engine, thetas, 1 + N_WARM,
                        torch.cuda.synchronize)
    totals = launch_totals(kkt)
    peak = torch.cuda.max_memory_allocated(dev)
    per_round = check_fused_launches(name, rows, admm_step.COLD_BUDGET,
                                     admm_step.WARM_BUDGET)
    M = ocp.n_w + ocp.n_g
    check(totals["shapes"]["ldl_factor"] == [(admm_step.N_AGENTS, M)],
          f"{name}: factor shapes {totals['shapes']['ldl_factor']}, "
          f"expected the dense LDLᵀ at ({admm_step.N_AGENTS}, {M})")
    last = rows[-1]
    for leaf in (*last["state"].w, *last["state"].y, *last["state"].z,
                 *last["state"].zbar.values()):
        check(bool(torch.isfinite(leaf).all()), f"non-finite {name} state")
    warm_ms = float(np.median([r["ms"] for r in rows[1:]]))
    u = last["trajs"][0]["u"][..., 0]
    emit({"phase": name, "zones": admm_step.N_AGENTS, "model": model,
          "dtype": "float32", "kkt_size": M,
          "group_uses_qp": list(engine.group_uses_qp),
          "build_seconds": build_s, "cold_round_ms": rows[0]["ms"],
          "warm_round_ms": [r["ms"] for r in rows[1:]],
          "warm_round_ms_median": warm_ms, "per_round": per_round,
          "launches": totals,
          "spread": float((u - last["state"].zbar[alias]).abs().max()),
          "peak_memory_bytes": peak, "nvidia_smi": smi})
    state = last["state"]
    phase_profile(torch, lambda: engine.step(state, [thetas]), warm_ms,
                  name=f"{name}_profile")

    # quality: pinned exits, the card's engine against the CPU's f64 (the
    # linear fleet: FUSED_LINEAR_* above)
    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    rows64, seconds64 = ref["rounds"], ref["seconds"]
    runs = {"f32 auto": (torch.float32, "auto")}
    if model == "linear":
        runs["f64 lu"] = (torch.float64, "lu")
    gated = "f32 auto" if model == "zone" else "f64 lu"
    rows = {}
    for key, (dtype, method) in runs.items():
        e, th, _, _ = fused_engine(torch, model, dev, dtype, pinned=True,
                                   kkt_method=method)
        rounds = fused_rounds(torch, e, th, FUSED_QUALITY_STEPS,
                              torch.cuda.synchronize)
        rows[key] = fused_quality_rows(torch, alias, rounds, rows64)
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    gates = ({"zbar_tol": ZBAR_TOL, "spread_tol": SPREAD_TOL}
             if model == "zone" else {"f64_tol_W": FUSED_LINEAR_F64_TOL_W})
    emit({"phase": f"{name}_quality",
          "reference": "f64 plain on cpu, Boyd exits pinned to zero",
          "f64_seconds": seconds64,
          "default_exit_iterations": [r["admm_iterations"]
                                      for r in per_round],
          "gated": gated, **gates, "rounds": rows})
    for row in rows[gated]:
        k = row["round"]
        check(row["f64_finite"], f"{name} round {k}: non-finite f64")
        check(row["iterations"] == [FUSED_ADMM_ITERS] * 2,
              f"{name} round {k}: iterations {row['iterations']} with "
              f"pinned exits")
        if model == "zone":
            check(row["zbar_max_abs_diff"] <= ZBAR_TOL,
                  f"{name} round {k}: z̄ differs from f64 by "
                  f"{row['zbar_max_abs_diff']}")
            check(row["spread_diff"] <= SPREAD_TOL,
                  f"{name} round {k}: spread differs from f64 by "
                  f"{row['spread_diff']}")
        else:
            check(max(row["zbar_max_abs_diff"], row["u_max_abs_diff"])
                  <= FUSED_LINEAR_F64_TOL_W,
                  f"{name} round {k}: the card's f64 rounds differ from "
                  f"the CPU's by {row['zbar_max_abs_diff']} W (z̄), "
                  f"{row['u_max_abs_diff']} W (u)")
    if model == "zone":
        phase_quarantine(torch, engine, state, thetas, name)
    return totals


def phase_quarantine(torch, engine, state, thetas, name):
    """Two more warm rounds with one lane's x0 set to NaN. A NaN theta
    alone leaves the lane's iterate finite (the solver's step guard keeps
    the warm start and the lane reports failure), which the first round
    shows; the second also sets the lane's carried warm start to NaN (the
    JAX package's own quarantine test): that lane alone is quarantined
    and the returned state stays finite."""
    from agentlib_mpc_torch.ops import kkt

    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    lane = thetas.x0.shape[0] * 3 // 8
    x0 = thetas.x0.clone()
    x0[lane] = float("nan")
    poisoned = thetas._replace(x0=x0)
    _, _, stats_theta = engine.step(state, [poisoned])
    w = state.w[0].clone()
    w[lane] = float("nan")
    state, _trajs, stats = engine.step(state._replace(w=(w,)), [poisoned])
    torch.cuda.synchronize()
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    counts = stats.lane_quarantined[0].cpu()
    others = torch.cat([counts[:lane], counts[lane + 1:]])
    leaves = [*state.w, *state.y, *state.z, *state.zbar.values(),
              *state.rho.values(), *(t for v in state.lam.values()
                                     for t in v)]
    finite = all(bool(torch.isfinite(t).all()) for t in leaves)
    emit({"phase": f"{name}_quarantine", "nan_lane": lane,
          "nan_x0_only": {
              "lane_quarantined": int(stats_theta.lane_quarantined[0][lane]),
              "iterations": int(stats_theta.iterations)},
          "lane_quarantined": int(counts[lane]),
          "other_lanes_quarantined": int(others.sum()),
          "quarantined_per_iteration": stats.quarantined.tolist(),
          "iterations": int(stats.iterations), "state_finite": finite})
    check(int(counts[lane]) >= 1, f"{name}: the NaN lane was not quarantined")
    check(int(others.sum()) == 0, f"{name}: healthy lanes were quarantined")
    check(finite, f"{name}: non-finite state after the quarantined round")


def phase_fused_fleet(torch, dev, smi):
    """FusedFleet over 256 room configs on the card: three control
    intervals in closed loop (round, plant step of every room, feedback,
    shift), a checkpoint after the first, restored into a fresh fleet
    whose next round must equal the uninterrupted one."""
    import tempfile

    from agentlib_mpc_torch.models.zoo import CooledRoom
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel.config_bridge import FusedFleet

    loads = np.linspace(80.0, 220.0, FLEET_N)
    configs = [room_config(i, float(loads[i])) for i in range(FLEET_N)]
    t0 = time.perf_counter()
    fleet = FusedFleet.from_configs(configs, device=dev,
                                    dtype=torch.float32)
    build_s = time.perf_counter() - t0
    ocp = fleet.engine.groups[0].ocp
    check(len(fleet.engine.groups) == 1, "identical rooms must batch")
    opts = fleet.engine.groups[0].solver_options
    # a solve and two refinement solves per re-solve; the corrector (off
    # in these configs) adds a second re-solve
    solves_per_factor = 6 if opts.corrector else 3
    factor_limit = lambda its: opts.max_iter + (its - 1) * min(opts.max_iter,
                                                               6)
    plant = CooledRoom()
    p = plant.default_vector("parameters", device=dev,
                             dtype=torch.float32).expand(FLEET_N, -1)
    ids = [f"Room_{i}" for i in range(FLEET_N)]
    temps = torch.full((FLEET_N, 1), FLEET_START, dtype=torch.float32,
                       device=dev)
    exo = torch.tensor([[ld, FLEET_T_IN, FLEET_UB] for ld in loads],
                       dtype=torch.float32, device=dev)
    intervals, out_round2 = [], None
    tmp = tempfile.TemporaryDirectory(prefix="fleet_ckpt_")
    ckpt = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    for k in range(FLEET_INTERVALS):
        if k == 1:
            ckpt = fleet.save_checkpoint(f"{tmp.name}/fleet")
        before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
        t0 = time.perf_counter()
        out = fleet.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = (kkt.ldl_factor.launches - before[0],
                    kkt.ldl_solve.launches - before[1])
        if k == 1:
            out_round2 = {aid: out[aid]["u"]["mDot"].copy() for aid in ids}
        mdot = torch.tensor([float(out[aid]["u"]["mDot"][0]) for aid in ids],
                            dtype=torch.float32, device=dev)
        x_next, _ = plant.simulate_step(
            temps, torch.cat([mdot[:, None], exo], dim=-1), p, FLEET_DT)
        temps = x_next
        host = temps.cpu().numpy()
        for i, aid in enumerate(ids):
            fleet.update_agent(aid, x0=host[i])
        fleet.advance()
        torch.cuda.synchronize()
        intervals.append({
            "interval": k, "round_ms": step_ms,
            "interval_ms": (time.perf_counter() - t0) * 1e3,
            "admm_iterations": out[ids[0]]["iterations"],
            "converged": out[ids[0]]["converged"],
            "factor_launches": launches[0], "solve_launches": launches[1],
            "mdot0_range": [float(mdot.min()), float(mdot.max())],
            "temperature_range": [float(temps.min()), float(temps.max())]})
        check(launches[0] > 0
              and launches[1] == solves_per_factor * launches[0],
              f"fused_fleet interval {k}: {launches} launches (must be "
              f"1:{solves_per_factor})")
        check(launches[0] <= factor_limit(out[ids[0]]["iterations"]),
              f"fused_fleet interval {k}: {launches[0]} factor launches "
              f"over the inner budgets")
    totals = launch_totals(kkt)
    peak = torch.cuda.max_memory_allocated(dev)
    check(bool(torch.isfinite(temps).all()), "non-finite plant states")
    check(bool((temps < FLEET_START).all()), "every room must cool")

    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    resumed = FusedFleet.from_configs(configs, device=dev,
                                      dtype=torch.float32)
    resumed.restore_checkpoint(ckpt)
    out_resumed = resumed.step()
    torch.cuda.synchronize()
    tmp.cleanup()
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    resume_diff = max(float(np.abs(out_resumed[aid]["u"]["mDot"]
                                   - out_round2[aid]).max()) for aid in ids)
    M = ocp.n_w + ocp.n_g
    emit({"phase": "fused_fleet", "rooms": FLEET_N, "horizon": ocp.N,
          "kkt_size": M, "dtype": "float32", "build_seconds": build_s,
          "solves_per_factor": solves_per_factor,
          "intervals": intervals, "launches": totals,
          "resume_max_abs_diff": resume_diff,
          "resume_tol": FLEET_RESUME_TOL,
          "nondeterministic_ops": "none on this path (dense derivatives "
                                  "and the dense LDLᵀ kernels)",
          "peak_memory_bytes": peak, "nvidia_smi": smi})
    check(resume_diff <= FLEET_RESUME_TOL,
          f"fused_fleet: the restored fleet's next round differs by "
          f"{resume_diff}")
    return totals


#: scenario trees (PR 13). The tree KKT: the zone OCP's stage partition per
#: branch (N=10, KKT 92) under a fan of 8 scenarios (u_0 shared: 7
#: coupling rows) and a (4, 2) branching tree (u_0 and u_1 shared: 11
#: rows), on the synthetic systems of scenario.tree.synthetic_tree_kkt.
#: Residual of the coupled system (scenario.tree.tree_kkt_residual): the
#: JAX package's probe bound in f32 (TREE_PROBE_TOL, 1e-3, with its
#: coupling regularization δ_c = 1e-8); in f64 the exact coupled system
#: (δ_c = 0: the Schur complement A K⁻¹ Aᵀ is SPD on its own; with
#: δ_c = 1e-8, A x is δ_c·ν ≈ 2e-8 by construction), held to 1e-8, and
#: the card's f64 solution to the plain versions' on the CPU within
#: TREE_CPU_TOL
SCENARIOS = 8
TREE_F64_TOL = 1e-8
TREE_CPU_TOL = 1e-10
#: bench.py's --scenario-ab workload (bench.py:1266-1431): 4 zones × 8
#: scenarios coupled on the supply air flow, the slice's solver and
#: budgets, ρ = ρ_na = 20; each zone's load perturbed per scenario by
#: ensemble_thetas (seed = zone, scale 0.15 of its load). The identity
#: gate is bench.py's own: the uncoupled batched round (robust horizon 0,
#: Boyd exits pinned to zero) within 1e-3 of the serial single-scenario
#: rounds in z̄
SCENARIO_AB_ZONES = 4
SCENARIO_AB_LOAD_SCALE = 0.15
SCENARIO_AB_IDENTITY_TOL = 1e-3
SCENARIO_ALIAS = "mDotCoolAir"


def scenario_options(pinned: bool = False):
    """The scenario fleets' options: the slice's ADMM iterations and
    budgets, ρ = ρ_na = FUSED_RHO; ``pinned`` zeroes the Boyd exits."""
    from agentlib_mpc_torch.parallel import admm_step
    from agentlib_mpc_torch.scenario import ScenarioFleetOptions

    exits = dict(abs_tol=0.0, rel_tol=0.0, primal_tol=0.0,
                 dual_tol=0.0) if pinned else {}
    return ScenarioFleetOptions(
        max_iterations=admm_step.ADMM_ITERS, rho=FUSED_RHO,
        rho_na=FUSED_RHO, warm_budget=admm_step.WARM_BUDGET,
        warm_mu=admm_step.WARM_MU, **exits)


def scenario_thetas(torch, ocp, n_zones: int, dev, dtype):
    """(n_zones, SCENARIOS) parameters: each zone's x0 and load
    (``fleet_inputs``), the load perturbed per scenario by ensemble_thetas
    (seed = zone, scale SCENARIO_AB_LOAD_SCALE of the load), built in f64
    on the CPU and cast once."""
    from agentlib_mpc_torch.parallel import admm_step
    from agentlib_mpc_torch.parallel.fused_admm import stack_params
    from agentlib_mpc_torch.scenario import ensemble_thetas, fan_tree

    x0s, loads = admm_step.fleet_inputs(n_zones)
    tree = fan_tree(SCENARIOS)
    f64 = torch.float64
    rows = []
    for i in range(n_zones):
        d = np.tile([loads[i], *admm_step.ZONE_D_ROW_TAIL], (ocp.N, 1))
        th = ocp.default_params(device="cpu", dtype=f64,
                                x0=torch.tensor([x0s[i]], dtype=f64),
                                d_traj=torch.tensor(d, dtype=f64))
        rows.append(ensemble_thetas(
            th, tree, seed=i, scale=SCENARIO_AB_LOAD_SCALE * loads[i],
            channels=(0,)))
    batch = stack_params(rows)
    return batch._replace(**{k: v.to(device=dev, dtype=dtype)
                             for k, v in batch._asdict().items()})


def scenario_fleet(torch, n_zones: int, tree, dev, pinned: bool = False,
                   kkt_method: str = "auto"):
    """(engine, ocp): the zone fleet's ScenarioFleet on ``dev``."""
    from agentlib_mpc_torch.ops.solver import SolverOptions
    from agentlib_mpc_torch.parallel import admm_step
    from agentlib_mpc_torch.parallel.fused_admm import AgentGroup
    from agentlib_mpc_torch.scenario import ScenarioFleet

    ocp = admm_step.zone_ocp()
    group = AgentGroup(
        name="zones", ocp=ocp, n_agents=n_zones,
        couplings={SCENARIO_ALIAS: "mDot"},
        solver_options=SolverOptions(**admm_step.SOLVER_BASE,
                                     mu_init=admm_step.COLD_MU,
                                     kkt_method=kkt_method))
    return ScenarioFleet(group, tree, scenario_options(pinned),
                         device=dev), ocp


def scenario_rounds(torch, fleet, thetas, steps: int, sync):
    """``steps`` rounds, the first cold, the others after shift_state:
    per round wall ms, state, stats and the kernel launches."""
    from agentlib_mpc_torch.ops import kkt

    state = fleet.init_state(thetas)
    rows = []
    for k in range(steps):
        if k:
            state = fleet.shift_state(state)
        before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
        t0 = time.perf_counter()
        state, _trajs, stats = fleet.step(state, thetas)
        sync()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "state": state, "stats": stats,
                     "u0": fleet.actuated_u0(state),
                     "launches": (kkt.ldl_factor.launches - before[0],
                                  kkt.ldl_solve.launches - before[1])})
    return rows


def phase_scenario_tree_kkt(torch, dev, smi):
    """The coupled tree KKT solve (scenario.tree.solve_kkt_tree: stage
    sweeps of every branch and the non-anticipativity Schur complement,
    all on the kernels) on the zone OCP's partition for a fan of 8 and a
    (4, 2) branching tree, in f32 and f64: the probe, the coupled
    residual, the card's f64 solution against the plain versions' on the
    CPU, and the time of one solve."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel import admm_step
    from agentlib_mpc_torch.scenario import tree as st

    ocp = admm_step.zone_ocp()
    trees = {"fan8_r1": st.fan_tree(SCENARIOS, robust_horizon=1),
             "branching_4x2": st.branching_tree((4, 2))}
    parts = {name: st.tree_partition_for_ocp(ocp, t)
             for name, t in trees.items()}
    probes = {f"{name} {str(dtype)[6:]}": st.tree_method_available(
        tp, dev, dtype) for name, tp in parts.items()
        for dtype in (torch.float32, torch.float64)}
    for key, ok in probes.items():
        check(ok, f"scenario_tree_kkt: tree_method_available false for {key}")
    rows = []
    torch.cuda.synchronize()
    kkt.reset_launch_counts()
    for name, tp in parts.items():
        K_np, r_np = st.synthetic_tree_kkt(tp, seed=7)
        for dtype, delta, tol in ((torch.float32, 1e-8, st.TREE_PROBE_TOL),
                                  (torch.float64, 0.0, TREE_F64_TOL)):
            K = torch.as_tensor(K_np, dtype=dtype, device=dev)
            r = torch.as_tensor(r_np, dtype=dtype, device=dev)
            x = st.solve_kkt_tree(K, r, tp, delta_c=delta)
            res = float(st.tree_kkt_residual(K, r, x, tp))
            row = {"tree": name, "dtype": str(dtype)[6:],
                   "coupling_rows": tp.n_coupling_rows, "delta_c": delta,
                   "residual": res, "tol": tol}
            if dtype == torch.float64:
                x_cpu = st.solve_kkt_tree(K.cpu(), r.cpu(), tp, delta_c=delta)
                row["cpu_plain_max_abs_diff"] = float(
                    (x.cpu() - x_cpu).abs().max())
                check(row["cpu_plain_max_abs_diff"] <= TREE_CPU_TOL,
                      f"scenario_tree_kkt {name}: the card's f64 solve is "
                      f"{row['cpu_plain_max_abs_diff']} from the CPU's")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.solve_kkt_tree(K, r, tp, delta_c=delta)
            torch.cuda.synchronize()
            row["solve_ms"] = (time.perf_counter() - t0) * 1e3
            check(np.isfinite(res) and res < tol,
                  f"scenario_tree_kkt {name} {row['dtype']}: residual {res}")
            rows.append(row)
    totals = launch_totals(kkt)
    emit({"phase": "scenario_tree_kkt", "kkt_size": ocp.n_w + ocp.n_g,
          "stage_block": parts["fan8_r1"].base.block,
          "stages": parts["fan8_r1"].base.n_stages, "probes": probes,
          "solves": rows, "launches": totals, "nvidia_smi": smi})
    return totals


def scenario_ab_run(torch, dev, dtype, sync, serial: bool = True) -> dict:
    """bench.py's --scenario-ab legs on ``dev`` in ``dtype`` (the card's
    f32 run and the CPU's f64 reference): the serial single-scenario
    rounds (left out with ``serial=False``) and the uncoupled batched
    round with pinned exits, the robust round with live exits, and
    robust_scenario_controls for zone 0 with its warm re-solve. Per leg
    its ms, z̄, u0, iterations and converged, as plain data."""
    from agentlib_mpc_torch.backends.mpc_backend import (
        robust_scenario_controls,
    )
    from agentlib_mpc_torch.scenario import fan_tree, single_scenario

    n, S = SCENARIO_AB_ZONES, SCENARIOS
    kkt_method = "ldl" if torch.device(dev).type == "cpu" else "auto"
    one, ocp = scenario_fleet(torch, n, single_scenario(), dev,
                              pinned=True, kkt_method=kkt_method)
    thetas = scenario_thetas(torch, ocp, n, dev, dtype)

    def leg(fleet, th):
        row = scenario_rounds(torch, fleet, th, 1, sync)[0]
        st = row["stats"]
        return {"ms": row["ms"],
                "zbar": row["state"].zbar[SCENARIO_ALIAS].double().cpu()
                .tolist(),
                "u0": row["u0"].double().cpu().tolist(),
                "iterations": int(st.iterations),
                "converged": bool(st.converged),
                "local_solves_ok": bool(st.local_solves_ok),
                "na_spread": float(st.na_spread),
                "launches": list(row["launches"])}

    out = {"serial": [leg(one, thetas._replace(**{
        k: v[:, s:s + 1] for k, v in thetas._asdict().items()}))
        for s in range(S)] if serial else []}
    free, _ = scenario_fleet(torch, n, fan_tree(S, robust_horizon=0), dev,
                             pinned=True, kkt_method=kkt_method)
    out["batched"] = leg(free, thetas)
    robust, _ = scenario_fleet(torch, n, fan_tree(S, robust_horizon=1), dev,
                               kkt_method=kkt_method)
    out["robust"] = leg(robust, thetas)
    theta0 = thetas._replace(**{k: v[0] for k, v in thetas._asdict()
                                .items()})
    controls, state = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        u0, state, stats = robust_scenario_controls(
            ocp, theta0, fan_tree(S, robust_horizon=1),
            robust.group.solver_options, scenario_options(), state=state)
        sync()
        controls.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "u0": u0.tolist(),
                         "iterations": int(stats.iterations),
                         "converged": bool(stats.converged)})
    out["robust_controls"] = controls
    return out


def scenario_ab_quality(card, ref) -> dict:
    """Per leg of :func:`scenario_ab_run`: iterations and ``converged`` of
    both runs, and the largest z̄ and u0 differences."""
    pairs = {"serial": list(zip(card["serial"], ref["serial"])),
             "batched": [(card["batched"], ref["batched"])],
             "robust": [(card["robust"], ref["robust"])],
             "robust_controls": list(zip(card["robust_controls"],
                                         ref["robust_controls"]))}
    diff = lambda c, r, k: float(np.max(np.abs(np.asarray(c[k])
                                               - np.asarray(r[k]))))
    return {name: [{
        "iterations": [c["iterations"], r["iterations"]],
        "converged": [c["converged"], r["converged"]],
        "zbar_max_abs_diff": diff(c, r, "zbar") if "zbar" in c else None,
        "u0_max_abs_diff": diff(c, r, "u0")} for c, r in rows]
        for name, rows in pairs.items()}


def phase_scenario_ab(torch, dev, smi, ref):
    """bench.py's --scenario-ab at 4 zones × 8 scenarios on the card
    (:func:`scenario_ab_run`): in f32 with the launch counters reset just
    before and read just after, bench.py's identity gate and the robust u0
    identical across branches; the batched, robust and robust-controls
    legs in f64 on the card held against the CPU's f64 legs with the plain
    versions (``ref``): z̄ and u0 within ZBAR_TOL, the same iterations and
    ``converged`` (the serial rounds are the batched round's 8 branches
    one by one: the identity gate holds them to it in f32, so their f64
    run on the card would repeat the batched leg's check).
    The f32 legs' distance from the f64 reference is reported: at 4 zones
    the budget-limited solves carry f32 round-off into z̄ and u0 by up to
    ~5e-3 and ~1e-2 in both packages on the CPU
    (scripts/scenario_f32_witness.py), so the ZBAR_TOL gate, set for the
    256-zone mean, is not theirs."""
    from agentlib_mpc_torch.ops import kkt

    torch.cuda.synchronize()
    kkt.reset_launch_counts()
    card = scenario_ab_run(torch, dev, torch.float32, torch.cuda.synchronize)
    totals = launch_totals(kkt)
    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    card64 = scenario_ab_run(torch, dev, torch.float64,
                             torch.cuda.synchronize, serial=False)
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    S = SCENARIOS
    identity = max(
        float(np.max(np.abs(np.asarray(card["batched"]["zbar"])[s]
                            - np.asarray(card["serial"][s]["zbar"])[0])))
        for s in range(S))
    u0 = np.asarray(card["robust"]["u0"])
    serial_ms = sum(r["ms"] for r in card["serial"])
    gated = scenario_ab_quality(card64, ref)
    emit({"phase": "scenario_ab", "zones": SCENARIO_AB_ZONES,
          "scenarios": S, "dtype": "float32",
          "per_scenario_ms": {"serial": serial_ms / S,
                              "batched": card["batched"]["ms"] / S,
                              "robust": card["robust"]["ms"] / S},
          "serial_over_batched": serial_ms / card["batched"]["ms"],
          "identity_zbar_max_abs_diff": identity,
          "identity_tol": SCENARIO_AB_IDENTITY_TOL,
          "robust": {k: card["robust"][k] for k in (
              "iterations", "converged", "na_spread", "local_solves_ok")},
          "robust_u0_group_identical": bool(np.all(u0 == u0[:, :1])),
          "robust_controls": [{k: c[k] for k in ("ms", "u0", "iterations",
                                                 "converged")}
                              for c in card["robust_controls"]],
          "reference": "f64 plain on cpu",
          "reference_seconds": ref["seconds"],
          "f32_vs_reference": scenario_ab_quality(card, ref),
          "f64_ms": {"batched": card64["batched"]["ms"],
                     "robust": card64["robust"]["ms"]},
          "zbar_tol": ZBAR_TOL, "f64_vs_reference": gated,
          "launches": totals, "nvidia_smi": smi})
    check(identity < SCENARIO_AB_IDENTITY_TOL,
          f"scenario_ab: the uncoupled batched round is {identity} from "
          f"the serial rounds")
    check(bool(np.all(u0 == u0[:, :1])),
          "scenario_ab: the robust u0 differs across branches")
    for name, rows in gated.items():
        for k, row in enumerate(rows):
            check(row["iterations"][0] == row["iterations"][1]
                  and row["converged"][0] == row["converged"][1],
                  f"scenario_ab {name} {k}: iterations/converged "
                  f"{row['iterations']} {row['converged']} (card f64, cpu)")
            check(max(row["zbar_max_abs_diff"] or 0.0,
                      row["u0_max_abs_diff"]) <= ZBAR_TOL,
                  f"scenario_ab {name} {k}: the card's f64 leg is {row} "
                  f"off the CPU's")
    return totals


def scenario_ab_reference(torch) -> dict:
    t0 = time.perf_counter()
    out = scenario_ab_run(torch, "cpu", torch.float64, lambda: None)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_scenario_fleet(torch, dev, smi):
    """The main path's fleet (256 zones, N=10, KKT 92) × a fan of 8
    scenarios (u_0 shared) through ScenarioFleet: one cold and one warm
    round in f32 with the launch counters reset just before and read just
    after (2 048 lanes: every factor at (2048, 92), 6 solves per factor,
    at most the inner budgets' factors), peak memory, a profiled warm
    round; the same two rounds in f64 on the card: z̄ within ZBAR_TOL,
    u0 within ZBAR_TOL in the median and on all but at most 5 % of the
    zones (the linear fleet's outlier share: the budget-limited solves
    carry f32 round-off into single lanes, by up to 1.9e-2 in u on
    fused_slice, and by 2.1e-3 in u0 here in the port on the CPU,
    scripts/scenario_f32_witness.py), u0 identical across each zone's
    branches in both types; the spreads max|u − z̄| are reported."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.parallel import admm_step
    from agentlib_mpc_torch.scenario import fan_tree

    n, S = admm_step.N_AGENTS, SCENARIOS
    tree = fan_tree(S, robust_horizon=1)
    t0 = time.perf_counter()
    fleet, ocp = scenario_fleet(torch, n, tree, dev)
    thetas = scenario_thetas(torch, ocp, n, dev, torch.float32)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    rows = scenario_rounds(torch, fleet, thetas, 2, torch.cuda.synchronize)
    totals = launch_totals(kkt)
    peak = torch.cuda.max_memory_allocated(dev)
    per_round = check_fused_launches("scenario_fleet", rows,
                                     admm_step.COLD_BUDGET,
                                     admm_step.WARM_BUDGET)
    M = ocp.n_w + ocp.n_g
    check(totals["shapes"]["ldl_factor"] == [(n * S, M)],
          f"scenario_fleet: factor shapes {totals['shapes']['ldl_factor']}, "
          f"expected ({n * S}, {M})")
    for k, row in enumerate(rows):
        u0 = row["u0"]
        check(bool(torch.equal(u0, u0[:, :1].expand_as(u0))),
              f"scenario_fleet round {k}: u0 differs across branches")
        for leaf in (row["state"].w, row["state"].zbar[SCENARIO_ALIAS]):
            check(bool(torch.isfinite(leaf).all()),
                  f"scenario_fleet round {k}: non-finite state")
        st = row["stats"]
        per_round[k].update(
            local_solves_ok=bool(st.local_solves_ok),
            na_spread=float(st.na_spread),
            lane_quarantined=int(st.lane_quarantined.sum()),
            quarantined_lanes=int((st.lane_quarantined > 0).sum()))
    emit({"phase": "scenario_fleet", "zones": n, "scenarios": S,
          "lanes": n * S, "dtype": "float32", "kkt_size": M,
          "build_seconds": build_s, "cold_round_ms": rows[0]["ms"],
          "warm_round_ms": rows[1]["ms"], "per_round": per_round,
          "launches": totals, "peak_memory_bytes": peak,
          "nvidia_smi": smi})
    state = fleet.shift_state(rows[0]["state"])
    phase_profile(torch, lambda: fleet.step(state, thetas), rows[1]["ms"],
                  name="scenario_fleet_profile")

    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    fleet64, _ = scenario_fleet(torch, n, tree, dev)
    rows64 = scenario_rounds(torch, fleet64, scenario_thetas(
        torch, ocp, n, dev, torch.float64), 2, torch.cuda.synchronize)
    kkt.ldl_factor.launches, kkt.ldl_solve.launches = before
    quality = []
    for k, (r32, r64) in enumerate(zip(rows, rows64)):
        u0_64 = r64["u0"]
        du = (r32["u0"].double() - u0_64).abs()
        spreads = [scenario_spread(fleet, r["state"]) for r in (r32, r64)]
        row = {"round": k,
               "iterations": [int(r32["stats"].iterations),
                              int(r64["stats"].iterations)],
               "zbar_max_abs_diff": float(
                   (r32["state"].zbar[SCENARIO_ALIAS].double()
                    - r64["state"].zbar[SCENARIO_ALIAS]).abs().max()),
               "spread": spreads, "spread_diff": abs(spreads[0] - spreads[1]),
               "u0_max_abs_diff": float(du.max()),
               "u0_median_abs_diff": float(du.median()),
               "zones_u0_over_zbar_tol": int(
                   (du.amax(dim=(1, 2)) > ZBAR_TOL).sum()),
               "f64_u0_group_identical": bool(torch.equal(
                   u0_64, u0_64[:, :1].expand_as(u0_64))),
               "f64_ms": r64["ms"],
               "f64_local_solves_ok": bool(r64["stats"].local_solves_ok)}
        quality.append(row)
    emit({"phase": "scenario_fleet_quality",
          "reference": "the same rounds in f64 on the card",
          "zbar_tol": ZBAR_TOL,
          "zones_u0_over_tol_share_max": QP_U_OUTLIER_SHARE_TOL,
          "rounds": quality})
    for row in quality:
        check(row["f64_u0_group_identical"],
              f"scenario_fleet f64 round {row['round']}: u0 differs across "
              f"branches")
        check(row["zbar_max_abs_diff"] <= ZBAR_TOL
              and row["u0_median_abs_diff"] <= ZBAR_TOL
              and row["zones_u0_over_zbar_tol"]
              <= QP_U_OUTLIER_SHARE_TOL * n,
              f"scenario_fleet round {row['round']}: f32 is {row} off f64")
    return totals


def scenario_spread(fleet, state) -> float:
    """The consensus spread max|u − z̄| over agents, scenarios and the
    horizon (the slice's spread, per scenario mean)."""
    u = fleet.group.ocp.unflatten(state.w)["u"][..., 0]
    return float((u - state.zbar[SCENARIO_ALIAS][None]).abs().max())


#: the serving plane: bench.py --serve's workload (bench.py:
#: 2188-2330), built from the port: LinearRCZone tenants coupled on
#: ``power``, the slice's solver options, 5 ADMM iterations at ρ 5e-3,
#: deadline 60 s, a queue of 4n, initial capacity n, x0 drifting by
#: U(-0.5, 0.5) K per round, membership from churn_schedule(0, n, rounds)
SERVE_SEED = 0
SERVE_TENANTS = 256
SERVE_ROUNDS = 16
SERVE_DEADLINE_S = 60.0
SERVE_ADMM_ITERATIONS = 5
SERVE_RHO = 5e-3
SERVE_D_ROW = (150.0, 303.15, 295.15)
#: the sync plane's checkpoint is taken after this round; the restored
#: plane serves the rounds after it and must give the uninterrupted
#: plane's u0 bitwise
SERVE_CKPT_ROUND = 8
#: the f64 leg: churn_schedule(0, 16, 8) on the card against the same
#: schedule in f64 on the CPU (a reference subprocess); equal actions,
#: u0 within SERVE_F64_U_TOL_W watts
SERVE_F64_TENANTS = 16
SERVE_F64_ROUNDS = 8
SERVE_F64_U_TOL_W = 1e-6
#: the pipelined f32 leg runs under the watchdog; no round may time out
SERVE_WATCHDOG_S = 60.0


@functools.cache
def serve_ocp():
    """The tenants' one transcribed OCP object (one transcription per
    process: the serving plane memoizes fingerprints per OCP object)."""
    from agentlib_mpc_torch.parallel import admm_step

    return admm_step.linear_zone_ocp()


def serve_workload(torch, n: int, dtype):
    """(make_spec, theta_for) of bench.py --serve's tenants in the port."""
    from agentlib_mpc_torch.ops.solver import SolverOptions
    from agentlib_mpc_torch.parallel import admm_step
    from agentlib_mpc_torch.serving import TenantSpec

    ocp = serve_ocp()
    x0_base = {f"t{i:03d}": 294.0 + 6.0 * i / max(n - 1, 1)
               for i in range(n)}
    d_traj = torch.tensor(SERVE_D_ROW, dtype=dtype).expand(ocp.N, 3)
    base = ocp.default_params(device="cpu", dtype=dtype)

    def theta_for(tid, drift=0.0):
        return base._replace(
            x0=torch.tensor([x0_base[tid] + drift], dtype=dtype),
            d_traj=d_traj.clone())

    def make_spec(tid):
        return TenantSpec(
            tenant_id=tid, ocp=ocp, theta=theta_for(tid),
            couplings={"power": "Q"},
            solver_options=SolverOptions(**admm_step.SOLVER_BASE),
            deadline_s=SERVE_DEADLINE_S)

    return make_spec, theta_for


def serve_plane(torch, n: int, dev, dtype, pipelined: bool,
                cache=None, watchdog_s=None):
    from agentlib_mpc_torch.parallel.fused_admm import FusedADMMOptions
    from agentlib_mpc_torch.serving import ServingPlane

    return ServingPlane(
        FusedADMMOptions(max_iterations=SERVE_ADMM_ITERATIONS,
                         rho=SERVE_RHO),
        initial_capacity=n, pipelined=pipelined, donate=pipelined,
        queue_limit=4 * n, cache=cache, watchdog_timeout_s=watchdog_s,
        device=dev, dtype=dtype)


def serve_run(torch, n: int, rounds: int, dev, dtype, pipelined: bool,
              sync, watchdog_s=None, ckpt_dir=None, plane=None,
              start=0, drifts=None) -> dict:
    """bench.py --serve's loop on one plane: round ``start`` to
    ``rounds - 1`` of churn_schedule(SERVE_SEED, n, rounds), every member
    submitting its drifted theta, one serve_round each. Per round the
    wall ms and the delivered results ``{tid: [action, u0]}``; the joins'
    latencies by cache outcome; the drifts drawn (``drifts`` replays
    recorded ones); with ``ckpt_dir``, the plane's checkpoint after round
    SERVE_CKPT_ROUND and its state's host copy."""
    import random

    from agentlib_mpc_torch.resilience.chaos import churn_schedule

    schedule = churn_schedule(SERVE_SEED, n, rounds)
    make_spec, theta_for = serve_workload(torch, n, dtype)
    rng = random.Random(f"bench-serve:{SERVE_SEED}")
    if plane is None:
        plane = serve_plane(torch, n, dev, dtype, pipelined,
                            watchdog_s=watchdog_s)
    drifts = {} if drifts is None else drifts
    joins = {"cold": [], "cached": []}
    walls, results, misses0 = [], [], None
    ckpt = None
    for r in range(start, rounds):
        for kind, tid in schedule[r]:
            if kind == "join":
                rec = plane.join(make_spec(tid))
                joins["cached" if rec.engine_cached
                      else "cold"].append(rec.latency_s)
            elif tid in plane.tenants:
                plane.leave(tid)
        for tid in plane.tenants:
            if (r, tid) not in drifts:
                drifts[(r, tid)] = rng.uniform(-0.5, 0.5)
            plane.submit(tid, theta=theta_for(tid, drifts[(r, tid)]))
        t0 = time.perf_counter()
        res = plane.serve_round()
        walls.append(time.perf_counter() - t0)
        results.append(serve_results(res))
        if r == start:
            misses0 = plane.cache.misses
        if ckpt_dir is not None and r == SERVE_CKPT_ROUND:
            sync()
            ckpt = {"path": plane.save_checkpoint(ckpt_dir),
                    "state": {key.digest: tree_host(torch, b.state)
                              for key, b in plane._buckets.items()}}
    tail = serve_results(plane.flush())
    sync()
    delivered = sum(len(r) for r in results) + len(tail)
    serving_s = float(np.sum(walls))
    warm = np.asarray(walls[1:] if len(walls) > 1 else walls) * 1e3
    return {"plane": plane, "joins": joins, "results": results,
            "flushed": tail, "drifts": drifts, "ckpt": ckpt,
            "delivered": delivered, "serving_s": serving_s,
            "solves_per_sec": delivered / serving_s if serving_s else 0.0,
            "round_ms": [w * 1e3 for w in walls],
            "round_ms_mean": float(warm.mean()),
            "round_ms_p50": float(np.percentile(warm, 50)),
            "round_ms_p99": float(np.percentile(warm, 99)),
            "engines_built_after_round0": plane.cache.misses - misses0}


def serve_results(res) -> dict:
    """``{tid: [action, u0 or None, reasons, stats success]}``."""
    return {tid: [r.action,
                  None if r.action != "actuate" or not r.controls
                  else float(r.controls["Q"]),
                  list(r.reasons),
                  None if r.stats is None else r.stats.get("success")]
            for tid, r in res.items()}


def tree_host(torch, tree):
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: t.detach().cpu().clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def check_serve_results(name, run):
    """Every delivered result actuated a finite solve, or was shed by the
    deadline or the queue only."""
    allowed = {"shed_deadline", "shed_overload"}
    bad = []
    for r, res in enumerate([*run["results"], run["flushed"]]):
        for tid, (action, u0, reasons, success) in res.items():
            if action == "actuate":
                if u0 is None or not np.isfinite(u0) or success is False:
                    bad.append((r, tid, "non-finite"))
            elif not set(reasons) <= allowed:
                bad.append((r, tid, reasons))
    check(not bad, f"{name}: results neither finite nor shed by deadline "
                   f"or queue: {bad[:5]}")
    return sum(1 for res in run["results"] for v in res.values()
               if v[0] != "actuate")


def serve_summary(run) -> dict:
    stats = run["plane"].stats()
    join_ms = lambda v: 1e3 * float(np.mean(v)) if v else None
    return {"solves_per_sec": run["solves_per_sec"],
            "delivered": run["delivered"],
            "round_ms_p50": run["round_ms_p50"],
            "round_ms_p99": run["round_ms_p99"],
            "round_ms_mean": run["round_ms_mean"],
            "round_ms": run["round_ms"],
            "join_cold_ms": join_ms(run["joins"]["cold"]),
            "join_cached_ms": join_ms(run["joins"]["cached"]),
            "joins": {k: len(v) for k, v in run["joins"].items()},
            "cache": stats["cache"], "queue": stats["queue"],
            "watchdog": stats["watchdog"],
            "engines_built_after_round0":
                run["engines_built_after_round0"]}


def serve_reference(torch) -> dict:
    """The f64 leg's schedule on the CPU in f64 (sync plane): per round
    the delivered results."""
    t0 = time.perf_counter()
    run = serve_run(torch, SERVE_F64_TENANTS, SERVE_F64_ROUNDS, "cpu",
                    torch.float64, False, lambda: None)
    return {"seconds": time.perf_counter() - t0,
            "results": run["results"]}


def phase_serve(torch, dev, smi, ref):
    """The serving plane on the card (bench.py --serve's workload): the
    f32 legs sync then pipelined under the watchdog, a crash and restore
    of the sync plane's checkpoint, the f64 leg against the CPU, and a
    profiled warm round."""
    import tempfile

    from torch.utils._pytree import tree_flatten

    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.resilience.chaos import churn_schedule
    from agentlib_mpc_torch.serving.checkpoint import (
        plane_checkpoint_topology)

    sync = torch.cuda.synchronize
    n = SERVE_TENANTS
    torch.cuda.reset_peak_memory_stats(dev)
    kkt.reset_launch_counts()
    tmp = tempfile.TemporaryDirectory(prefix="serve_ckpt_")
    t0 = time.perf_counter()
    run_sync = serve_run(torch, n, SERVE_ROUNDS, dev, torch.float32, False,
                         sync, ckpt_dir=f"{tmp.name}/plane")
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_pipe = serve_run(torch, n, SERVE_ROUNDS, dev, torch.float32, True,
                         sync, watchdog_s=SERVE_WATCHDOG_S)
    pipe_s = time.perf_counter() - t0
    legs = {}
    for name, run in (("sync", run_sync), ("pipelined", run_pipe)):
        sheds = check_serve_results(f"serve {name}", run)
        check(run["engines_built_after_round0"] == 0,
              f"serve {name}: {run['engines_built_after_round0']} engines "
              f"built after round 0")
        legs[name] = {**serve_summary(run), "not_actuated": sheds}
    check(run_pipe["plane"].dispatcher.pipelined
          and run_pipe["plane"].dispatcher.stalls == 0,
          f"serve pipelined: the watchdog fired "
          f"({run_pipe['plane'].dispatcher.stalls} stalls)")
    check(not run_sync["plane"].dispatcher.pipelined,
          "serve sync: the sync plane must not pipeline")

    # crash and restore: a fresh plane sharing the sync plane's cache
    ckpt = run_sync["ckpt"]
    fresh = serve_plane(torch, n, dev, torch.float32, False,
                        cache=run_sync["plane"].cache)
    make_spec, _ = serve_workload(torch, n, torch.float32)
    sched = churn_schedule(SERVE_SEED, n, SERVE_ROUNDS)
    members: set = set()
    for r in range(SERVE_CKPT_ROUND + 1):
        for kind, tid in sched[r]:
            (members.add if kind == "join" else members.discard)(tid)
    specs = {tid: make_spec(tid) for tid in members}
    topology = plane_checkpoint_topology(ckpt["path"])
    t0 = time.perf_counter()
    report = fresh.restore_checkpoint(ckpt["path"], specs)
    sync()
    restore_s = time.perf_counter() - t0
    check(report.cold_builds == 0 and report.cache_hits == len(members),
          f"serve restore: {report.cold_builds} cold builds, "
          f"{report.cache_hits} cache hits for {len(members)} tenants")
    state_diff = 0.0
    for key, bucket in fresh._buckets.items():
        saved = ckpt["state"][key.digest]
        for a, b in zip(tree_flatten(saved)[0],
                        tree_flatten(tree_host(torch, bucket.state))[0]):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  "serve restore: state leaf shape or dtype differs")
            d = (a.double() - b.double()).abs()
            state_diff = max(state_diff, float(d.max()) if d.numel()
                             else 0.0)
    check(state_diff == 0.0,
          f"serve restore: restored state differs by {state_diff}")
    t0 = time.perf_counter()
    resumed = serve_run(torch, n, SERVE_ROUNDS, dev, torch.float32, False,
                        sync, plane=fresh, start=SERVE_CKPT_ROUND + 1,
                        drifts=run_sync["drifts"])
    resumed_s = time.perf_counter() - t0
    u_diff, action_diff = 0.0, []
    for k, res in enumerate(resumed["results"]):
        r = SERVE_CKPT_ROUND + 1 + k
        want = run_sync["results"][r]
        check(set(res) == set(want),
              f"serve restore round {r}: other tenants delivered")
        for tid, (action, u0, _reasons, _ok) in res.items():
            if action != want[tid][0]:
                action_diff.append((r, tid, action, want[tid][0]))
            elif u0 is not None:
                u_diff = max(u_diff, abs(u0 - want[tid][1]))
    check(not action_diff, f"serve restore: actions differ {action_diff[:5]}")
    check(u_diff == 0.0,
          f"serve restore: resumed rounds' u0 differ by {u_diff} W from "
          f"the uninterrupted plane's")
    tmp.cleanup()

    # the f64 leg, against the CPU's f64 run of the same schedule
    f32_launches = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    t0 = time.perf_counter()
    run64 = serve_run(torch, SERVE_F64_TENANTS, SERVE_F64_ROUNDS, dev,
                      torch.float64, False, sync)
    f64_s = time.perf_counter() - t0
    check_serve_results("serve f64", run64)
    check(len(run64["results"]) == len(ref["results"]) == SERVE_F64_ROUNDS,
          "serve f64: the card's and the CPU's runs differ in rounds")
    f64_u, f64_actions = 0.0, []
    for r, (card, cpu) in enumerate(zip(run64["results"], ref["results"])):
        check(set(card) == set(cpu), f"serve f64 round {r}: other tenants")
        for tid, (action, u0, _reasons, _ok) in card.items():
            if action != cpu[tid][0]:
                f64_actions.append((r, tid, action, cpu[tid][0]))
            elif u0 is not None:
                f64_u = max(f64_u, abs(u0 - cpu[tid][1]))
    check(not f64_actions, f"serve f64: actions differ from the CPU's "
                           f"{f64_actions[:5]}")
    check(f64_u <= SERVE_F64_U_TOL_W,
          f"serve f64: u0 {f64_u} W from the CPU's (tolerance "
          f"{SERVE_F64_U_TOL_W} W)")
    totals = launch_totals(kkt)
    peak = torch.cuda.max_memory_allocated(dev)

    # one more warm round of the sync plane under the profiler
    plane = run_sync["plane"]
    _, theta_for = serve_workload(torch, n, torch.float32)

    def one_round():
        for tid in plane.tenants:
            plane.submit(tid, theta=theta_for(tid))
        plane.serve_round()

    t0 = time.perf_counter()
    profile = phase_profile(torch, one_round,
                            legs["sync"]["round_ms_p50"],
                            name="serve_profile")
    profile_s = time.perf_counter() - t0
    emit({"phase": "serve", "tenants": n, "rounds": SERVE_ROUNDS,
          "seed": SERVE_SEED, "dtype": "float32",
          "admm_iterations": SERVE_ADMM_ITERATIONS,
          "legs": legs,
          "dispatch_overhead_saved_ms":
              legs["sync"]["round_ms_mean"]
              - legs["pipelined"]["round_ms_mean"],
          "leg_seconds": {"sync": sync_s, "pipelined": pipe_s,
                          "restore": restore_s, "resumed": resumed_s,
                          "f64": f64_s, "profile": profile_s},
          "restore": {"after_round": SERVE_CKPT_ROUND,
                      "tenants": len(report.tenants),
                      "cold_builds": report.cold_builds,
                      "cache_hits": report.cache_hits,
                      "requeued": report.requeued,
                      "restore_ms": report.total_s * 1e3,
                      "state_max_abs_diff": state_diff,
                      "resumed_rounds": len(resumed["results"]),
                      "u0_max_abs_diff_w": u_diff,
                      "topology": topology},
          "f64": {"tenants": SERVE_F64_TENANTS, "rounds": SERVE_F64_ROUNDS,
                  "u0_max_abs_diff_w": f64_u, "tol_w": SERVE_F64_U_TOL_W,
                  "cpu_seconds": ref["seconds"],
                  **{k: v for k, v in serve_summary(run64).items()
                     if k in ("solves_per_sec", "round_ms_mean",
                              "delivered", "cache")}},
          "launches": totals, "launches_f32_legs": f32_launches,
          "peak_memory_bytes": peak,
          "busy_share": profile["busy_share_of_median_warm_step"],
          "nvidia_smi": smi})
    return totals


def drive_mas(torch, configs, dev, dtype, until, mpc_at, sim_at,
              count_launches: bool, capture: bool = False, extra_at=(),
              instrument=None):
    """Build a LocalMAS on ``dev`` in ``dtype`` and run it ``until``: per
    solve its wall ms, stats row, guard level and (on the card) kernel
    launches; the simulators' rows and their total wall time (``sim_at``
    is one (agent, module) pair or a list of them; ``rows`` holds the
    first one's rows, ``sim_rows`` every one's by ``agent/module``). Launch counts
    are reset just before the run. With ``capture``, each solve's row also
    keeps its inputs and the warm state it started from (on the host),
    for :func:`replay_solves`. The backends of the modules ``extra_at``
    ((agent, module) pairs beside the guarded MPC) are counted the same
    way, into ``run["extra"]["agent/module"]`` (with their guard's level
    where they have one: a second solving agent); ``instrument(mas)`` runs
    just before the launch counts are reset."""
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    t0 = time.perf_counter()
    mas = LocalMAS(configs, env={"rt": False}, device=dev, dtype=dtype)
    build_s = time.perf_counter() - t0
    mpc = mas.agents[mpc_at[0]].get_module(mpc_at[1])
    sim_pairs = [sim_at] if isinstance(sim_at[0], str) else list(sim_at)
    sims = {f"{a}/{m}": mas.agents[a].get_module(m) for a, m in sim_pairs}
    sim = next(iter(sims.values()))
    solves, sim_s = [], [0.0]
    solve, assess = mpc.backend.solve, mpc.guard.assess
    extra = {}
    for agent, module_id in extra_at:
        module = mas.agents[agent].get_module(module_id)
        rows = []

        def counted_extra(now, variables, _solve=module.backend.solve,
                          _rows=rows):
            before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
            result = _solve(now, variables)
            _rows.append({"factor": kkt.ldl_factor.launches - before[0],
                          "solve": kkt.ldl_solve.launches - before[1]})
            return result

        module.backend.solve = counted_extra
        guard = getattr(module, "guard", None)
        if guard is not None:
            def recorded_extra_assess(*args, _assess=guard.assess,
                                      _guard=guard, _rows=rows, **kwargs):
                decision = _assess(*args, **kwargs)
                _rows[-1]["guard_level"] = _guard.level
                return decision

            guard.assess = recorded_extra_assess
        extra[f"{agent}/{module_id}"] = {"module": module, "solves": rows}

    def counted_solve(now, variables):
        if capture:
            start = (now, copy.deepcopy(variables),
                     {k: v.detach().cpu() if torch.is_tensor(v) else v
                      for k, v in mpc.backend.warm_state().items()})
        before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
        result = solve(now, variables)
        solves.append({"factor": kkt.ldl_factor.launches - before[0],
                       "solve": kkt.ldl_solve.launches - before[1],
                       "u0": dict(result["u0"])})
        if capture:
            solves[-1].update(start=start, traj=result["traj"],
                              traj_relaxed=result.get("traj_relaxed"))
        return result

    for module in sims.values():
        def timed_sim_step(*args, _step=module.do_step):
            t = time.perf_counter()
            _step(*args)
            sim_s[0] += time.perf_counter() - t

        module.do_step = timed_sim_step

    def recorded_assess(*args, **kwargs):
        decision = assess(*args, **kwargs)
        solves[-1]["guard_level"] = mpc.guard.level
        return decision

    mpc.backend.solve = counted_solve
    mpc.guard.assess = recorded_assess
    if instrument is not None:
        instrument(mas)
    if count_launches:
        torch.cuda.synchronize()
        kkt.reset_launch_counts()
    t0 = time.perf_counter()
    mas.run(until=until)
    wall_s = time.perf_counter() - t0
    totals = launch_totals(kkt) if count_launches else None
    for rows, backend in [(solves, mpc.backend)] + [
            (e["solves"], e["module"].backend) for e in extra.values()]:
        for row, stats in zip(rows, backend.stats_history):
            row.update(ms=stats["solve_wall_time"] * 1e3,
                       iterations=stats["iterations"],
                       success=stats["success"], kkt_path=stats["kkt_path"],
                       stats=stats)
    return {"mas": mas, "mpc": mpc, "sim": sim, "solves": solves,
            "extra": extra, "totals": totals, "build_s": build_s,
            "wall_s": wall_s, "sim_s": sim_s[0],
            "rows": [dict(r) for r in sim._rows],
            "sim_rows": {key: [dict(r) for r in module._rows]
                         for key, module in sims.items()}}


def replay_solves(torch, configs, mpc_at, run):
    """Every solve of ``run`` (captured by :func:`drive_mas`) once more on
    the CPU in float64 with the plain LDLᵀ, from the same inputs and warm
    state: per solve the iterations and u0."""
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    mas = LocalMAS(configs, env={"rt": False}, device="cpu",
                   dtype=torch.float64)
    backend = mas.agents[mpc_at[0]].get_module(mpc_at[1]).backend
    out = []
    for row in run["solves"]:
        now, variables, warm = row["start"]
        backend.set_warm_state(warm)
        result = backend.solve(now, variables)
        out.append({"iterations": int(result["stats"]["iterations"]),
                    "u0": dict(result["u0"]), "stats": result["stats"],
                    "traj": result["traj"],
                    "traj_relaxed": result.get("traj_relaxed")})
    return out


def check_module_run(name, run, solves_per_factor, shape, dtype):
    """Every solve succeeded, with the guard at level 0, on the LDLᵀ path;
    the kernels launched only at ``shape`` and only in ``dtype``, one
    factor and ``solves_per_factor`` solves per inner iteration; the warm
    start was never reset."""
    for k, row in enumerate(run["solves"]):
        check(row["success"] and row.get("guard_level") == 0,
              f"{name} solve {k}: success {row['success']}, guard level "
              f"{row.get('guard_level')}")
        check(row["kkt_path"] == "ldl",
              f"{name} solve {k}: kkt_path {row['kkt_path']}")
        check(row["factor"] == row["iterations"]
              and row["solve"] == solves_per_factor * row["iterations"],
              f"{name} solve {k}: {row['factor']} factor / {row['solve']} "
              f"solve launches for {row['iterations']} iterations (expected "
              f"1/{solves_per_factor} per iteration)")
    check(run["mpc"].backend.warm_start_resets == 0,
          f"{name}: the warm start was reset")
    totals = run["totals"]
    want, other = (("shapes_f64", "shapes") if dtype == "float64"
                   else ("shapes", "shapes_f64"))
    for kernel in ("ldl_factor", "ldl_solve"):
        check(totals[want][kernel] == [shape] and not totals[other][kernel],
              f"{name}: {kernel} launched at {totals[want][kernel]} "
              f"({dtype}) and {totals[other][kernel]} (other), expected only "
              f"{shape} in {dtype}")


def module_summary(run) -> dict:
    ms = [row["ms"] for row in run["solves"]]
    return {"solves": len(ms), "build_seconds": run["build_s"],
            "run_seconds": run["wall_s"], "first_solve_ms": ms[0],
            "warm_solve_ms_median": float(np.median(ms[1:])),
            "warm_solve_ms_max": max(ms[1:]),
            "iterations_per_solve": [r["iterations"] for r in run["solves"]],
            "simulator_steps": len(run["rows"]),
            "simulator_seconds": run["sim_s"]}


def one_room_metrics(rows):
    """AIE (K·h) and cooling energy of the one-room example's printout
    (examples/one_room_mpc.py) over the simulator's rows."""
    temps = np.array([r["T_out"] for r in rows])
    mdot = np.array([r["mDot"] for r in rows])
    from agentlib_mpc_torch import reference_configs as rc

    dt_h = rc.ONE_ROOM_PLANT_DT / 3600.0
    return (float(np.sum(np.abs(temps - rc.ONE_ROOM_UB)) * dt_h),
            float(np.sum(mdot * (temps - rc.ONE_ROOM_T_IN)) * dt_h))


def profile_module_solve(torch, run, name):
    """One more solve of the finished loop under the profiler, from its
    last inputs (not counted as main-path launches)."""
    mpc = run["mpc"]
    variables = mpc.collect_variables_for_optimization()
    now = float(mpc.env.now)
    warm_ms = float(np.median([r["ms"] for r in run["solves"][1:]]))
    return phase_profile(torch, lambda: mpc.backend.solve(now, variables),
                         warm_ms, name=name)


#: the module phases' f64 references on the CPU, each run as
#: (configs, mpc_at, sim_at, extra_at, until): they run in subprocesses
#: started at the beginning of the script, beside the card's phases
def reference_specs():
    from agentlib_mpc_torch import reference_configs as rc

    plain = {"kkt_method": "ldl"}
    return {
        "module_one_room": (lambda: rc.one_room_configs(solver=plain),
                            ("myMPCAgent", "myMPC"), ("SimAgent", "room"),
                            (), ONE_ROOM_UNTIL),
        "module_linear_qp": (lambda: [rc.linear_qp_config(plain)],
                             ("LinearZone", "mpc"), ("LinearZone", "sim"),
                             (), MODULE_UNTIL),
        "module_mhe": (lambda: rc.mhe_one_room_configs(solver=plain),
                       ("Controller", "mpc"), ("Plant", "room"),
                       (("Controller", "mhe"),), MHE_UNTIL),
        "module_minlp_cia": (lambda: rc.minlp_switched_room_configs(
            backend_type="jax_cia", solver=plain), ("Controller", "mpc"),
            ("Plant", "room"), (), MINLP_CIA_UNTIL),
        "module_admm": (lambda: rc.admm_cooled_room_configs(solver=plain),
                        ("CooledRoom", "admm"), ("Simulation", "simulator"),
                        (("Cooler", "admm"),), ADMM_UNTIL),
        "module_admm_coord": (
            lambda: rc.admm_4rooms_coordinator_configs(
                admm_iter_max=COORD_ADMM_ITER_MAX, solver=plain),
            (ROOMS[0], "admm"), SIMULATORS,
            tuple((aid, "admm") for aid in (*ROOMS[1:], "AHU")),
            COORD_UNTIL),
        "module_admm_exchange": (
            lambda: rc.exchange_admm_4rooms_configs(
                max_iterations=EXCHANGE_ITERATIONS, solver=plain),
            (ROOMS[0], "admm"), SIMULATORS,
            tuple((aid, "admm") for aid in (*ROOMS[1:], "Supplier")),
            EXCHANGE_UNTIL),
    }


def reference_run(name: str) -> dict:
    """One module phase's loop in f64 on the CPU with the plain LDLᵀ, as
    plain data: the simulator's rows, per solve its row (success,
    iterations, u0, ms, stats), the wall times, and the values the phase
    reads off the finished loop; or a fleet path's f64 steps
    (``"quality"``: the slice's, ``"qp_quality"``: the linear fleet's on
    the QP) or rounds (``"fused_slice"``, ``"fused_linear"``)."""
    import torch

    if name == "quality":
        return slice_reference(torch)
    if name == "qp_quality":
        return slice_reference(torch, model="linear", inner="qp")
    if name in ("fused_slice", "fused_linear"):
        return fused_reference(torch, "zone" if name == "fused_slice"
                               else "linear")

    if name == "scenario_ab":
        return scenario_ab_reference(torch)
    if name == "serve":
        return serve_reference(torch)
    if name in ("module_ml_mpc", "module_ml_admm"):
        return ml_reference(name)

    configs, mpc_at, sim_at, extra_at, until = reference_specs()[name]
    run = drive_mas(torch, configs(), "cpu", torch.float64, until, mpc_at,
                    sim_at, count_launches=False, extra_at=extra_at)
    keep = ("success", "iterations", "u0", "ms", "stats", "guard_level")
    out = {"rows": run["rows"], "wall_s": run["wall_s"],
           "build_s": run["build_s"], "sim_s": run["sim_s"],
           "solves": [{k: r[k] for k in keep if k in r}
                      for r in run["solves"]],
           "extra": {key: [{k: r[k] for k in keep if k in r}
                           for r in e["solves"]]
                     for key, e in run["extra"].items()}}
    if name == "module_mhe":
        out["load"] = float(run["extra"]["Controller/mhe"]["module"]
                            .get_value("load"))
    if name == "module_admm":
        out["steps"] = admm_steps(
            run["mpc"], run["extra"]["Cooler/admm"]["module"])
    if name == "module_admm_coord":
        out["outcome"] = four_room_outcome(
            run, coordinator=run["mas"].agents["Coordinator"]
            .get_module("coordinator"))
    if name == "module_admm_exchange":
        out["outcome"] = four_room_outcome(
            run, supplier=run["extra"]["Supplier/admm"]["module"])
    return out


def replay_run(name: str, starts) -> dict:
    """:func:`replay_solves` of the card solves ``starts`` (captured
    inputs and warm states) of one module phase, as plain data: per solve
    the iterations, u0, the relaxed and fixed iterations and the fixed
    and relaxed state trajectories."""
    import torch

    configs, mpc_at = replay_specs()[name]
    rows = replay_solves(torch, configs(), mpc_at,
                         {"solves": [{"start": st} for st in starts]})
    return {"rows": [{
        "iterations": r["iterations"], "u0": r["u0"],
        "relaxed_iterations": r["stats"].get("relaxed_iterations"),
        "fixed_iterations": r["stats"].get("fixed_iterations"),
        "x": np.asarray(r["traj"]["x"]).tolist(),
        "x_relaxed": (None if r["traj_relaxed"] is None else
                      np.asarray(r["traj_relaxed"]["x"]).tolist())}
        for r in rows]}


#: the phases whose card solves are replayed on the CPU in f64 in a
#: subprocess (``--cpu-replay NAME``): (configs, mpc_at)
def replay_specs():
    from agentlib_mpc_torch import reference_configs as rc

    return {"module_minlp_cia": (lambda: rc.minlp_switched_room_configs(
        backend_type="jax_cia", solver={"kkt_method": "ldl"}),
        ("Controller", "mpc")),
        "module_linear_qp": (lambda: [rc.linear_qp_config(
            {"kkt_method": "ldl"})], ("LinearZone", "mpc"))}


def split_cores():
    """(cores of this process, cores of its CPU subprocesses): the last
    five cores this process may use go to the subprocesses (the four fleet
    paths' and the seven module phases' references, one thread each)
    where at least three stay for the card's host thread; else no
    split."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 8:
        return cores[:-5], cores[-5:]
    return cores, cores


class References:
    """The f64 CPU references of the fleet paths (``early``) and of the
    module phases (``late``, needed later in the run: they run at a lower
    scheduling priority, so the early ones finish first), each computed by
    a subprocess of this script (``--cpu-reference NAME``, one CPU thread)
    started at once, and the CPU replays of card solves
    (``--cpu-replay NAME``, started by :meth:`replay`), all on the cores
    ``cores``; :meth:`get` waits for one, :meth:`close` ends every one
    still running."""

    def __init__(self, early, late, cores):
        self.env = {**os.environ, "OMP_NUM_THREADS": "1"}
        self.cores = cores
        self.procs = {name: self._start("--cpu-reference", name)
                      for name in early}
        self.procs.update({name: self._start("--cpu-reference", name,
                                             nice=10) for name in late})

    def _start(self, flag: str, name: str, stdin=None, nice: int = 0):
        cores = self.cores

        def pin():
            os.sched_setaffinity(0, cores)
            os.nice(nice)

        return subprocess.Popen(
            [sys.executable, __file__, flag, name], stdin=stdin,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=self.env, preexec_fn=pin)

    def start_late(self, names) -> None:
        """Start more module references now (at the lower priority)."""
        self.procs.update({name: self._start("--cpu-reference", name,
                                             nice=10) for name in names})

    def replay(self, name: str, starts) -> None:
        """Replay the card solves ``starts`` of phase ``name`` on the CPU
        (:func:`replay_run`); :meth:`get` (``"replay:" + name``) waits."""
        proc = self._start("--cpu-replay", name, stdin=subprocess.PIPE)
        # the child's pickle.load stops at the pickle's end; communicate()
        # in :meth:`get` closes the pipe
        proc.stdin.buffer.write(pickle.dumps(starts))
        proc.stdin.flush()
        self.procs["replay:" + name] = proc

    def get(self, name: str) -> dict:
        out, err = self.procs[name].communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        check(self.procs[name].returncode == 0 and bool(lines),
              f"{name}: the f64 CPU run failed:\n{err[-2000:]}")
        return json.loads(lines[-1])

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def phase_module_one_room(torch, dev, smi, ref):
    """The two-agent one-room MAS through LocalMAS on the card in f32,
    held against the same MAS in f64 on the CPU with the plain LDLᵀ."""
    from agentlib_mpc_torch.reference_configs import one_room_configs

    run = drive_mas(torch, one_room_configs(), dev, torch.float32,
                    ONE_ROOM_UNTIL, ("myMPCAgent", "myMPC"),
                    ("SimAgent", "room"), count_launches=True)
    backend = run["mpc"].backend
    opts = backend.solver_options
    M = backend.ocp.n_w + backend.ocp.n_g
    # one factor per interior-point iteration; its solve and two
    # refinement solves (the corrector, off here, adds a second re-solve)
    per_factor = 6 if opts.corrector else 3
    check(all(r["success"] for r in ref["solves"]),
          "module_one_room: the f64 CPU reference failed a solve")
    aie, energy = one_room_metrics(run["rows"])
    aie64, energy64 = one_room_metrics(ref["rows"])
    mdot = np.array([r["mDot"] for r in run["rows"]])
    mdot64 = np.array([r["mDot"] for r in ref["rows"]])
    temps = [r["T_out"] for r in run["rows"]]
    record = {"phase": "module_one_room", "dtype": "float32", "kkt_size": M,
              "horizon": backend.N, "until_s": ONE_ROOM_UNTIL,
              **module_summary(run), "launches": run["totals"],
              "solves_per_factor": per_factor,
              "final_room_temperature_K": temps[-1],
              "aie_kh": aie, "energy_kwh": energy,
              "aie_kh_f64_cpu": aie64, "energy_kwh_f64_cpu": energy64,
              "aie_rel_diff": abs(aie - aie64) / aie64,
              "energy_rel_diff": abs(energy - energy64) / energy64,
              "metric_rtol": MODULE_METRIC_RTOL,
              "mdot_max_abs_diff_f64": float(np.abs(mdot - mdot64).max()),
              "f64_cpu_run_seconds": ref["wall_s"],
              "f64_cpu_warm_solve_ms_median": module_summary(
                  ref)["warm_solve_ms_median"],
              "guard_level_max": max(r.get("guard_level", -1)
                                     for r in run["solves"]),
              "warm_start_resets": backend.warm_start_resets,
              "nvidia_smi": smi}
    emit(record)
    check_module_run("module_one_room", run, per_factor, (1, M), "float32")
    check(np.isfinite(temps).all() and temps[-1] < temps[0],
          "module_one_room: the room did not cool")
    check(record["aie_rel_diff"] <= MODULE_METRIC_RTOL
          and record["energy_rel_diff"] <= MODULE_METRIC_RTOL,
          f"module_one_room: AIE {aie} / energy {energy} against f64 "
          f"{aie64} / {energy64}")
    profile_module_solve(torch, run, "module_one_room_profile")
    return run["totals"]


def phase_module_linear_qp(torch, dev, smi, ref):
    """examples/linear_qp_mpc.py's agent through LocalMAS on the card in
    f64 on the QP fast path (the float64 kernels), held against the same
    run in f64 on the CPU with the plain LDLᵀ."""
    from agentlib_mpc_torch.reference_configs import linear_qp_config

    run = drive_mas(torch, [linear_qp_config()], dev, torch.float64,
                    MODULE_UNTIL, ("LinearZone", "mpc"), ("LinearZone", "sim"),
                    count_launches=True, capture=True)
    backend = run["mpc"].backend
    check(backend.uses_qp_fast_path is True,
          "module_linear_qp: LinearRCZone did not route to the QP fast path")
    M = backend.ocp.n_w + backend.ocp.n_g
    u0 = np.array([row["u0"]["Q"] for row in run["solves"]])
    u0_64 = np.array([row["u0"]["Q"] for row in ref["solves"]])
    check(len(u0) == len(u0_64), "module_linear_qp: solve counts differ")
    gap = np.abs(u0 - u0_64)
    t_final = run["rows"][-1]["T_out"]
    emit({"phase": "module_linear_qp", "dtype": "float64", "kkt_size": M,
          "horizon": backend.N, "until_s": MODULE_UNTIL,
          "qp_fast_path": backend.uses_qp_fast_path,
          **module_summary(run), "launches": run["totals"],
          "final_plant_temperature_K": t_final,
          "t_final_limit_K": LINEAR_QP_T_LIMIT,
          "u0_W": u0.tolist(),
          "u0_closed_loop_f64_cpu_W": u0_64.tolist(),
          "u0_closed_loop_max_abs_diff_W": float(gap.max()),
          "iterations_per_solve_f64_cpu": [r["iterations"]
                                           for r in ref["solves"]],
          "f64_cpu_final_plant_temperature_K": ref["rows"][-1]["T_out"],
          "f64_cpu_run_seconds": ref["wall_s"],
          "f64_cpu_all_success": all(r["success"] for r in ref["solves"]),
          "guard_level_max": max(r.get("guard_level", -1)
                                 for r in run["solves"]),
          "warm_start_resets": backend.warm_start_resets,
          "nvidia_smi": smi})
    # one factor and two re-solves (predictor, corrector) of one solve and
    # two refinement steps each per QP iteration
    check_module_run("module_linear_qp", run, 6, (1, M), "float64")
    check(all(r["success"] for r in ref["solves"]),
          "module_linear_qp: the f64 CPU reference failed a solve")
    check(t_final <= LINEAR_QP_T_LIMIT,
          f"module_linear_qp: plant at {t_final} K")
    loop_solves = list(run["solves"])   # the profiled solve adds a row
    profile_module_solve(torch, run, "module_linear_qp_profile")
    return run["totals"], loop_solves


def phase_linear_qp_replay(card, rep):
    """Every card solve ``card`` of ``module_linear_qp``'s loop (f64) once
    more on the CPU in f64 with the plain LDLᵀ, from the same inputs and
    warm state (a subprocess, :meth:`References.replay`): the same
    iterations, u0 within ``LINEAR_QP_U0_TOL_W``."""
    cpu = rep["rows"]
    check(len(card) == len(cpu), "module_linear_qp_replay: solve counts "
          f"differ ({len(card)} on the card, {len(cpu)} replayed)")
    gap = np.abs(np.array([a["u0"]["Q"] for a in card])
                 - np.array([b["u0"]["Q"] for b in cpu]))
    iterations_differ = [k for k, (a, b) in enumerate(zip(card, cpu))
                         if a["iterations"] != b["iterations"]]
    emit({"phase": "module_linear_qp_replay", "solves": len(card),
          "u0_replay_max_abs_diff_W": float(gap.max()),
          "u0_replay_tol_W": LINEAR_QP_U0_TOL_W,
          "replay_iterations_differ": iterations_differ})
    check(not iterations_differ and float(gap.max()) <= LINEAR_QP_U0_TOL_W,
          f"module_linear_qp_replay: the CPU's replay of the card's solves "
          f"differs by {gap.max()} W in u0, iterations at "
          f"{iterations_differ}")


def check_solve_launches(name, rows, factor_per_it, solve_per_it):
    """Every solve successful, on the LDLᵀ path, with exactly
    ``factor_per_it`` factor and ``solve_per_it`` solve launches per inner
    iteration (``rows`` from :func:`drive_mas`)."""
    for k, row in enumerate(rows):
        check(row["success"] and row["kkt_path"] == "ldl",
              f"{name} solve {k}: success {row['success']}, kkt_path "
              f"{row['kkt_path']}")
        it = row["iterations"]
        check(row["factor"] == factor_per_it * it
              and row["solve"] == solve_per_it * it,
              f"{name} solve {k}: {row['factor']} factor / {row['solve']} "
              f"solve launches for {it} iterations (expected "
              f"{factor_per_it}/{solve_per_it} per iteration)")


def check_shapes(name, totals, shapes, dtype):
    """The kernels launched only at ``shapes``, only in ``dtype``."""
    want, other = (("shapes_f64", "shapes") if dtype == "float64"
                   else ("shapes", "shapes_f64"))
    for kernel in ("ldl_factor", "ldl_solve"):
        check(totals[want][kernel] == sorted(shapes)
              and not totals[other][kernel],
              f"{name}: {kernel} launched at {totals[want][kernel]} "
              f"({dtype}) and {totals[other][kernel]} (other), expected "
              f"only {sorted(shapes)} in {dtype}")


def per_factor(backend) -> int:
    """Solve launches per factor of one NLP iteration: the step and two
    refinement solves, twice with the corrector."""
    return 6 if backend.solver_options.corrector else 3


def phase_module_mhe(torch, dev, smi, ref):
    """examples/mhe_one_room.py's two agents through LocalMAS on the card
    in f32 (the module path's default): the MHE (QP fast path) and the MPC
    consuming its estimate, held against the same MAS in f64 on the CPU
    with the plain LDLᵀ."""
    from agentlib_mpc_torch import reference_configs as rc

    run = drive_mas(torch, rc.mhe_one_room_configs(), dev, torch.float32,
                    MHE_UNTIL, ("Controller", "mpc"), ("Plant", "room"),
                    count_launches=True, extra_at=[("Controller", "mhe")])
    mhe = run["extra"]["Controller/mhe"]
    mhe_backend, mpc_backend = mhe["module"].backend, run["mpc"].backend
    sizes = {"mhe": mhe_backend.ocp.n_w + mhe_backend.ocp.n_g,
             "mpc": mpc_backend.ocp.n_w + mpc_backend.ocp.n_g}
    load = float(mhe["module"].get_value("load"))
    load64 = ref["load"]
    temps = [r["T_out"] for r in run["rows"]]
    emit({"phase": "module_mhe", "dtype": "float32",
          "kkt_size": sizes, "horizon": mhe_backend.N, "until_s": MHE_UNTIL,
          "qp_fast_path": {"mhe": mhe_backend.uses_qp_fast_path,
                           "mpc": mpc_backend.uses_qp_fast_path},
          "mpc": module_summary(run),
          "mhe": module_summary({**run, "solves": mhe["solves"]}),
          "launches": run["totals"],
          "solves_per_factor": {"mhe": 6, "mpc": per_factor(mpc_backend)},
          "load_estimate_W": load, "true_load_W": rc.MHE_TRUE_LOAD,
          "load_estimates_W": [float(r["traj"]["x"][-1, -1])
                               for r in mhe["module"]._history_rows],
          "load_estimate_f64_cpu_W": load64,
          "load_rel_diff_f64": abs(load - load64) / abs(load64),
          "load_rtol": MHE_LOAD_RTOL,
          "final_room_temperature_K": temps[-1],
          "f64_cpu_final_room_temperature_K": ref["rows"][-1]["T_out"],
          "f64_cpu_run_seconds": ref["wall_s"],
          "guard_level_max": max(r.get("guard_level", -1)
                                 for r in run["solves"]),
          "warm_start_resets": mhe_backend.warm_start_resets
          + mpc_backend.warm_start_resets,
          "nvidia_smi": smi})
    check(sizes == {"mhe": 142, "mpc": 92},
          f"module_mhe: KKT sizes {sizes}, expected MHE 142 and MPC 92")
    check(mhe_backend.uses_qp_fast_path and
          not mpc_backend.uses_qp_fast_path,
          "module_mhe: the MHE OCP must route to the QP, the MPC to the NLP")
    check(all(r.get("guard_level") == 0 for r in run["solves"]),
          "module_mhe: the MPC's guard left level 0")
    check(mhe_backend.warm_start_resets == mpc_backend.warm_start_resets
          == 0, "module_mhe: a warm start was reset")
    # the QP: one factor and six solves (predictor and corrector, each with
    # two refinement steps) per QP iteration
    check_solve_launches("module_mhe (MHE)", mhe["solves"], 1, 6)
    check_solve_launches("module_mhe (MPC)", run["solves"], 1,
                         per_factor(mpc_backend))
    check_shapes("module_mhe", run["totals"], [(1, 142), (1, 92)],
                 "float32")
    check(all(r["success"] for r in ref["solves"]
              + ref["extra"]["Controller/mhe"]),
          "module_mhe: the f64 CPU reference failed a solve")
    check(abs(load - rc.MHE_TRUE_LOAD) < MHE_LOAD_GATE_W,
          f"module_mhe: load estimate {load} W, true {rc.MHE_TRUE_LOAD} W")
    check(np.isfinite(temps).all()
          and temps[-1] < rc.MHE_START - MHE_COOLING_K,
          f"module_mhe: the room ended at {temps[-1]} K")
    check(abs(load - load64) <= MHE_LOAD_RTOL * abs(load64),
          f"module_mhe: load estimate {load} W against f64 CPU {load64} W")
    variables = mhe["module"].collect_variables_for_optimization()
    now = float(mhe["module"].env.now)
    warm_ms = float(np.median([r["ms"] for r in mhe["solves"][1:]]))
    phase_profile(torch, lambda: mhe_backend.solve(now, variables), warm_ms,
                  name="module_mhe_profile")
    return run["totals"]


def minlp_metrics(rows):
    """The example's printout: final zone temperature and the chiller's
    duty cycle over the plant's rows, and whether every command was
    binary."""
    on = np.array([r["on"] for r in rows], dtype=float)
    return (float(rows[-1]["T_out"]), float(on.mean()),
            bool(set(np.unique(on)) <= {0.0, 1.0}))


def phase_module_minlp(torch, dev, smi, backend_type, ref=None):
    """examples/minlp_switched_room.py's agent (``minlp_mpc`` over
    ``jax_cia`` or ``jax_minlp_bb``) through LocalMAS on the card in f64:
    the relaxed program on the QP fast path (1, 34), the schedule on the
    host (native CIA or the tree search, whose node relaxations run as one
    batched NLP per sweep at (8, 34)), the fixed program (1, 26)."""
    from agentlib_mpc_torch import reference_configs as rc
    from agentlib_mpc_torch.ops import cia, kkt

    bb = backend_type == "jax_minlp_bb"
    name = "module_minlp_bb" if bb else "module_minlp_cia"
    until = MINLP_BB_UNTIL if bb else MINLP_CIA_UNTIL
    calls = []   # per exact (fixed) solve and per node sweep, on the card

    def instrument(mas):
        backend = mas.agents["Controller"].get_module("mpc").backend

        def counted(kind, fn):
            def wrapper(*args):
                before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
                out = fn(*args)
                stats = out[-1]
                calls.append({
                    "kind": kind,
                    "factor": kkt.ldl_factor.launches - before[0],
                    "solve": kkt.ldl_solve.launches - before[1],
                    "iterations": int(stats.iterations.max()),
                    "success": bool(stats.success.all())})
                return out
            return wrapper

        backend._solve_fixed = counted("fixed", backend._solve_fixed)
        if bb:
            backend._solve_nodes = counted("nodes", backend._solve_nodes)

    native_before = cia.solve_cia.native_calls
    configs = rc.minlp_switched_room_configs(backend_type=backend_type)
    if bb:
        configs[0]["modules"][1]["optimization_backend"]["bb_options"][
            "max_nodes"] = MINLP_BB_MAX_NODES
    run = drive_mas(torch, configs, dev, torch.float64, until,
        ("Controller", "mpc"), ("Plant", "room"), count_launches=True,
        capture=not bb, instrument=instrument)
    native_runs = cia.solve_cia.native_calls - native_before
    backend = run["mpc"].backend
    sizes = {"relaxed": backend.ocp.n_w + backend.ocp.n_g,
             "fixed": backend.ocp_fixed.n_w + backend.ocp_fixed.n_g}
    t_final, duty, binary = minlp_metrics(run["rows"])
    stats = [r["stats"] for r in run["solves"]]
    record = {"phase": name, "dtype": "float64", "backend": backend_type,
              "kkt_size": sizes, "horizon": backend.N, "until_s": until,
              "qp_fast_path": backend.uses_qp_fast_path,
              **module_summary(run), "launches": run["totals"],
              "relaxed_iterations": [s["relaxed_iterations"] for s in stats],
              "fixed_iterations": [s["fixed_iterations"] for s in stats],
              "final_zone_temperature_K": t_final, "duty_cycle": duty,
              "on_binary": binary, "cia_native_runs": native_runs,
              "guard_level_max": max(r.get("guard_level", -1)
                                     for r in run["solves"]),
              "warm_start_resets": backend.warm_start_resets,
              "nvidia_smi": smi}
    rel_it = sum(s["relaxed_iterations"] for s in stats)
    record["launches_by_program"] = {
        "relaxed": [rel_it, 6 * rel_it],
        **{kind: [sum(c["factor"] for c in calls if c["kind"] == kind),
                  sum(c["solve"] for c in calls if c["kind"] == kind)]
           for kind in ("fixed", "nodes") if any(c["kind"] == kind
                                                  for c in calls)}}
    if bb:
        record.update(
            bb_max_nodes=MINLP_BB_MAX_NODES,
            bb_nodes=[s["bb_nodes"] for s in stats],
            bb_sweeps=[s["bb_sweeps"] for s in stats],
            bb_proven_optimal=[bool(s["bb_proven_optimal"]) for s in stats],
            bb_improved_on_heuristic=[bool(s["bb_improved_on_heuristic"])
                                      for s in stats],
            bb_incumbent=[s["bb_incumbent"] for s in stats],
            bb_heuristic=[s["bb_heuristic"] for s in stats],
            exact_solves=sum(c["kind"] == "fixed" for c in calls))
    else:
        t64, duty64, _ = minlp_metrics(ref["rows"])
        record.update(f64_cpu_final_zone_temperature_K=t64,
                      f64_cpu_duty_cycle=duty64,
                      f64_cpu_run_seconds=ref["wall_s"],
                      f64_cpu_all_success=all(r["success"]
                                              for r in ref["solves"]))
    emit(record)
    check(sizes == {"relaxed": 34, "fixed": 26},
          f"{name}: KKT sizes {sizes}, expected relaxed 34 and fixed 26")
    check(backend.uses_qp_fast_path,
          f"{name}: the relaxed OCP did not route to the QP fast path")
    for k, row in enumerate(run["solves"]):
        s = row["stats"]
        check(row["success"] and s["relaxed_success"]
              and row.get("guard_level") == 0,
              f"{name} solve {k}: success {row['success']}, relaxed "
              f"{s['relaxed_success']}, guard level {row.get('guard_level')}")
    check(backend.warm_start_resets == 0, f"{name}: a warm start was reset")
    # per solve: the relaxed QP (1 factor, 6 solves per QP iteration), then
    # every fixed NLP and node sweep (1 factor and per_factor solves per
    # iteration; a sweep iterates as long as its slowest lane)
    per_nlp = per_factor(backend)
    for c in calls:
        check(c["factor"] == c["iterations"]
              and c["solve"] == per_nlp * c["iterations"],
              f"{name}: {c['kind']} solve launched {c['factor']} factor / "
              f"{c['solve']} solve for {c['iterations']} iterations")
    factor_calls = sum(c["factor"] for c in calls)
    solve_calls = sum(c["solve"] for c in calls)
    factor_all = sum(r["factor"] for r in run["solves"])
    solve_all = sum(r["solve"] for r in run["solves"])
    check(factor_all == factor_calls + rel_it
          and solve_all == solve_calls + 6 * rel_it,
          f"{name}: {factor_all} factor / {solve_all} solve launches, "
          f"expected {factor_calls + rel_it} / {solve_calls + 6 * rel_it}")
    check_shapes(name, run["totals"],
                 [(1, 34), (1, 26)] + ([(8, 34)] if bb else []), "float64")
    check(binary, f"{name}: an actuated chiller command was not binary")
    check(t_final < rc.MINLP_UB + MINLP_UB_MARGIN_K,
          f"{name}: the zone ended at {t_final} K")
    check(0.0 < duty < 1.0, f"{name}: duty cycle {duty}")
    if bb:
        for k, s in enumerate(stats):
            check(s["bb_incumbent"] <= s["bb_heuristic"],
                  f"{name} solve {k}: incumbent {s['bb_incumbent']} above "
                  f"the heuristic's {s['bb_heuristic']}")
        check(any(c["kind"] == "nodes" for c in calls),
              f"{name}: no node sweep ran")
    else:
        check(native_runs == len(run["solves"]),
              f"{name}: the native CIA ran {native_runs} times for "
              f"{len(run['solves'])} solves")
        check(record["f64_cpu_all_success"],
              f"{name}: the f64 CPU reference failed a solve")
        check(abs(t_final - record["f64_cpu_final_zone_temperature_K"])
              <= MINLP_CIA_T_TOL_K
              and abs(duty - record["f64_cpu_duty_cycle"])
              <= MINLP_CIA_DUTY_TOL,
              f"{name}: {t_final} K / duty {duty} against f64 CPU "
              f"{record['f64_cpu_final_zone_temperature_K']} K / "
              f"{record['f64_cpu_duty_cycle']}")
    # no profiled solve: a MINLP solve launches ~40 000 (CIA) to ~300 000
    # (B&B) device ops, which the profiler takes minutes to read back
    return run["totals"], run


def phase_cia_replay(run, rep):
    """Every card solve of ``module_minlp_cia`` (f64) once more on the CPU
    in f64 with the plain LDLᵀ, from the same inputs and warm state (a
    subprocess, :meth:`References.replay`): the same actuated command, the
    same relaxed-QP iterations and its state trajectory within
    ``MINLP_CIA_REPLAY_TOL_K``; the fixed program's iterations and
    trajectory are reported beside them."""
    card, cpu = run["solves"], rep["rows"]
    check(len(card) == len(cpu), "module_minlp_cia_replay: solve counts "
          f"differ ({len(card)} on the card, {len(cpu)} replayed)")

    def gap(key, cpu_key):
        return [float(np.abs(np.asarray(a[key]["x"])
                             - np.asarray(b[cpu_key])).max())
                for a, b in zip(card, cpu)]

    relaxed_gap, fixed_gap = gap("traj_relaxed", "x_relaxed"), gap(
        "traj", "x")
    u0_differ = [k for k, (a, b) in enumerate(zip(card, cpu))
                 if a["u0"] != b["u0"]]
    relaxed_it_differ = [
        k for k, (a, b) in enumerate(zip(card, cpu))
        if a["stats"]["relaxed_iterations"] != b["relaxed_iterations"]]
    emit({"phase": "module_minlp_cia_replay", "solves": len(card),
          "u0_differ": u0_differ, "relaxed_iterations_differ":
          relaxed_it_differ,
          "relaxed_x_max_abs_diff_K": max(relaxed_gap),
          "relaxed_x_tol_K": MINLP_CIA_REPLAY_TOL_K,
          "fixed_iterations_card": [a["stats"]["fixed_iterations"]
                                    for a in card],
          "fixed_iterations_cpu": [b["fixed_iterations"] for b in cpu],
          "fixed_x_max_abs_diff_K": fixed_gap})
    check(not u0_differ and not relaxed_it_differ
          and max(relaxed_gap) <= MINLP_CIA_REPLAY_TOL_K,
          f"module_minlp_cia_replay: the CPU's replay differs in u0 at "
          f"{u0_differ}, in relaxed iterations at {relaxed_it_differ}, by "
          f"{max(relaxed_gap)} K in the relaxed trajectory")


def admm_steps(room, cooler):
    """Per control step of the cooled-room pair: the ADMM iterations each
    agent ran and, at the step's last iteration, the largest gap between
    the room's and the cooler's air-flow trajectories (m³/s)."""
    def step(row):   # each iteration is recorded just after its start
        return int(np.floor(row["time"] / room.time_step + 1e-9))

    out = []
    for k in sorted({step(r) for r in room._iter_rows}):
        rows = {name: [r for r in module._iter_rows if step(r) == k]
                for name, module in (("room", room), ("cooler", cooler))}
        last = {name: r[-1]["couplings"] for name, r in rows.items() if r}
        gap = (float(np.abs(np.asarray(last["room"]["mDot"]) - np.asarray(
            last["cooler"]["mDot_out"])).max()) if len(last) == 2
            else float("nan"))
        out.append({"time": k * room.time_step,
                    "iterations": {name: [r["iteration"] for r in rs]
                                   for name, rs in rows.items()},
                    "last_iteration_gap": gap})
    return out


def phase_module_admm(torch, dev, smi, ref):
    """examples/admm_cooled_room.py's three agents through LocalMAS on the
    card in f32: the room's augmented NLP at (1, 74) and the cooler's
    augmented QP at (1, 8), six ADMM iterations per control step, held
    against the same loop in f64 on the CPU with the plain LDLᵀ."""
    from agentlib_mpc_torch import reference_configs as rc

    t_phase = time.perf_counter()
    run = drive_mas(torch, rc.admm_cooled_room_configs(), dev,
                    torch.float32, ADMM_UNTIL, ("CooledRoom", "admm"),
                    ("Simulation", "simulator"), count_launches=True,
                    extra_at=[("Cooler", "admm")])
    cooler = run["extra"]["Cooler/admm"]
    room_m, cooler_m = run["mpc"], cooler["module"]
    backends = {"room": room_m.backend, "cooler": cooler_m.backend}
    solves = {"room": run["solves"], "cooler": cooler["solves"]}
    sizes = {k: b.ocp.n_w + b.ocp.n_g for k, b in backends.items()}
    steps = admm_steps(room_m, cooler_m)
    temps = [r["T_out"] for r in run["rows"]]
    mdot_max = max(r["mDot"] for r in run["rows"])
    t64 = ref["rows"][-1]["T_out"]
    levels = {k: [r["guard_level"] for r in rows if "guard_level" in r]
              for k, rows in solves.items()}
    emit({"phase": "module_admm", "dtype": "float32", "kkt_size": sizes,
          "horizon": backends["room"].N, "until_s": ADMM_UNTIL,
          "qp_fast_path": {k: b.uses_qp_fast_path
                           for k, b in backends.items()},
          "room": module_summary(run),
          "cooler": module_summary({**run, "solves": cooler["solves"]}),
          "launches": run["totals"],
          "solves_per_factor": {"room": per_factor(backends["room"]),
                                "cooler": 6},
          "steps": steps,
          "guard_levels": levels,
          "final_room_temperature_K": temps[-1],
          "f64_cpu_final_room_temperature_K": t64,
          "t_f64_abs_diff_K": abs(temps[-1] - t64),
          "t_f64_tol_K": ADMM_T_F64_TOL_K,
          "f64_cpu_steps": ref["steps"],
          "f64_cpu_iterations_per_solve": {
              "room": [r["iterations"] for r in ref["solves"]],
              "cooler": [r["iterations"]
                         for r in ref["extra"]["Cooler/admm"]]},
          "f64_cpu_run_seconds": ref["wall_s"],
          "mdot_actuated_max": mdot_max,
          "warm_start_resets": {k: b.warm_start_resets
                                for k, b in backends.items()},
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    check(sizes == {"room": 74, "cooler": 8},
          f"module_admm: KKT sizes {sizes}, expected room 74, cooler 8")
    check(not backends["room"].uses_qp_fast_path
          and backends["cooler"].uses_qp_fast_path,
          "module_admm: the room must route to the NLP, the cooler to the "
          "QP")
    n_steps = int(round(ADMM_UNTIL / rc.ADMM_DT))
    for name, rows in solves.items():
        check(len(rows) == n_steps * ADMM_ITERATIONS,
              f"module_admm ({name}): {len(rows)} solves")
        check(levels[name] == [0] * n_steps,
              f"module_admm ({name}): guard levels per step {levels[name]}")
        check(backends[name].warm_start_resets == 0,
              f"module_admm ({name}): a warm start was reset")
    check_solve_launches("module_admm (room)", solves["room"], 1,
                         per_factor(backends["room"]))
    check_solve_launches("module_admm (cooler)", solves["cooler"], 1, 6)
    check_shapes("module_admm", run["totals"], [(1, 74), (1, 8)],
                 "float32")
    iterations = list(range(ADMM_ITERATIONS))
    check(all(st["iterations"] == {"room": iterations, "cooler": iterations}
              for st in steps) and len(steps) == n_steps,
          f"module_admm: ADMM iterations per step "
          f"{[st['iterations'] for st in steps]}")
    check(all(r["success"] for r in ref["solves"]
              + ref["extra"]["Cooler/admm"]),
          "module_admm: the f64 CPU reference failed a solve")
    check(np.isfinite(temps).all() and temps[0] > temps[-1]
          and temps[-1] < ADMM_T_LIMIT_K,
          f"module_admm: the room went {temps[0]} -> {temps[-1]} K")
    check(mdot_max <= ADMM_MDOT_MAX,
          f"module_admm: actuated air flow {mdot_max}")
    check(steps[-1]["last_iteration_gap"] < ADMM_COUPLING_GAP_TOL,
          f"module_admm: the agents' air flows are "
          f"{steps[-1]['last_iteration_gap']} apart at the last iteration")
    check(abs(temps[-1] - t64) <= ADMM_T_F64_TOL_K,
          f"module_admm: final room temperature {temps[-1]} K against f64 "
          f"CPU {t64} K")
    profile_module_solve(torch, run, "module_admm_profile")
    return run["totals"]


def phase_module_admm_rt(torch, dev, smi):
    """tests/test_admm_realtime.py's pair of real-time ``admm`` modules
    through LocalMAS on the card in f64, on the wall clock for 10 s of the
    MAS's clock; the rounds its triggers started run on to their end in
    the modules' worker threads; then ``terminate()``."""
    import threading

    from agentlib_mpc_torch import reference_configs as rc
    from agentlib_mpc_torch.modules.admm import ModuleStatus
    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.runtime.mas import LocalMAS
    from agentlib_mpc_torch.runtime.variables import Source

    t_phase = time.perf_counter()
    mas = LocalMAS(rc.admm_realtime_pair_configs(),
                   env={"rt": True, "factor": 1.0}, device=dev,
                   dtype=getattr(torch, ADMM_RT_DTYPE))
    build_s = time.perf_counter() - t_phase
    modules = {aid: mas.agents[aid].get_module("admm")
               for aid in ("Room", "Cooler")}
    where = {aid: set() for aid in modules}   # (thread, stream) per solve
    for aid, module in modules.items():
        def located(now, variables, _solve=module.backend.solve,
                    _where=where[aid]):
            _where.add((threading.current_thread().name,
                        torch.cuda.current_stream(dev).cuda_stream))
            return _solve(now, variables)

        module.backend.solve = located

    def settled(m):
        return (m.rounds_run + m.failed_rounds >= 1
                and not m.start_step.is_set()
                and m._status == ModuleStatus.sleeping)

    try:
        torch.cuda.synchronize()
        kkt.reset_launch_counts()
        t0 = time.perf_counter()
        mas.run(until=ADMM_RT_UNTIL)
        run_s = time.perf_counter() - t0
        m0 = modules["Room"]
        deadline = time.perf_counter() + m0.registration_period \
            + m0.max_iterations * m0.iteration_timeout + 5.0
        while time.perf_counter() < deadline and not all(
                settled(m) for m in modules.values()):
            time.sleep(0.05)
        drain_s = time.perf_counter() - t0 - run_s
        torch.cuda.synchronize()
        totals = launch_totals(kkt)
        threads = {aid: m._thread for aid, m in modules.items()}
    finally:
        mas.terminate()
    alive = [t.name for t in threads.values()
             if t is not None and t.is_alive()]
    wire = "admm_coupling_air"
    registered = {aid: sorted(src.agent_id for src in
                              m._registered_participants[wire])
                  for aid, m in modules.items()}
    backends = {aid: m.backend for aid, m in modules.items()}
    sizes = {aid: b.ocp.n_w + b.ocp.n_g for aid, b in backends.items()}
    iterations = {aid: sum(r["iterations"] for r in b.stats_history)
                  for aid, b in backends.items()}
    mean = np.asarray(modules["Room"]._admm_values[
        "admm_coupling_mean_mDot"], dtype=float)
    default_stream = torch.cuda.default_stream(dev).cuda_stream
    emit({"phase": "module_admm_rt", "dtype": ADMM_RT_DTYPE,
          "kkt_size": sizes, "until_s": ADMM_RT_UNTIL,
          "build_seconds": build_s, "run_seconds": run_s,
          "drain_seconds": drain_s,
          "rounds_run": {aid: m.rounds_run for aid, m in modules.items()},
          "overruns": {aid: m.overruns for aid, m in modules.items()},
          "failed_rounds": {aid: m.failed_rounds
                            for aid, m in modules.items()},
          "admm_iterations": {aid: len(m._iter_rows)
                              for aid, m in modules.items()},
          "solves": {aid: [{"iterations": r["iterations"],
                            "success": r["success"],
                            "ms": r["solve_wall_time"] * 1e3}
                           for r in b.stats_history]
                     for aid, b in backends.items()},
          "solve_threads_and_streams": {aid: sorted(map(list, w))
                                        for aid, w in where.items()},
          "default_stream": default_stream,
          "registered": registered, "room_mean_mDot": mean.tolist(),
          "threads_alive_after_terminate": alive,
          "launches": totals, "nvidia_smi": smi})
    for aid, m in modules.items():
        other = "Cooler" if aid == "Room" else "Room"
        check(Source(agent_id=other, module_id="admm")
              in m._registered_participants[wire],
              f"module_admm_rt: {aid} did not register {other} on {wire}")
        check(m.failed_rounds == 0 and m.rounds_run >= 1,
              f"module_admm_rt: {aid} ran {m.rounds_run} rounds, "
              f"{m.failed_rounds} failed")
        check(bool(m._iter_rows)
              and all(r["stats"]["success"] for r in m._iter_rows),
              f"module_admm_rt: {aid} completed "
              f"{len(m._iter_rows)} iterations, not all successful")
        check(bool(where[aid]) and all(
            name.startswith("admm_loop_") and stream == default_stream
            for name, stream in where[aid]),
              f"module_admm_rt: {aid} solved on {sorted(where[aid])}")
    check(mean.shape == (4,) and np.isfinite(mean).all(),
          f"module_admm_rt: the room's mean air flow {mean.tolist()}")
    check(not alive and all(m._thread is None for m in modules.values()),
          f"module_admm_rt: worker threads alive after terminate: {alive}")
    check_shapes("module_admm_rt", totals,
                 [(1, sizes["Room"]), (1, sizes["Cooler"])], ADMM_RT_DTYPE)
    want_factor = sum(iterations.values())
    want_solve = per_factor(backends["Room"]) * iterations["Room"] \
        + 6 * iterations["Cooler"]
    check(totals["ldl_factor"] == want_factor
          and totals["ldl_solve"] == want_solve,
          f"module_admm_rt: {totals['ldl_factor']} factor / "
          f"{totals['ldl_solve']} solve launches, expected {want_factor} / "
          f"{want_solve} for {iterations} iterations")
    return totals


def four_room_outcome(run, coordinator=None, supplier=None) -> dict:
    """A four-room loop's outcome as plain data: each room's final
    temperature and mean actuated air flow, whether the building cooled on
    average, the peak total actuated flow and the allocation margin
    (room 4's mean flow less room 1's); with ``coordinator`` its rounds
    (per round the ADMM iterations and the primal and dual residual and
    penalty trails); with ``supplier`` its last flow and the rooms' total
    at the last plant step."""
    rows = [run["sim_rows"][f"{a}/{m}"] for a, m in SIMULATORS]
    temps = np.array([[r["T_out"] for r in rs] for rs in rows])
    flows = np.array([[r["mDot"] for r in rs] for rs in rows])
    total = flows.sum(axis=0)
    out = {"final_room_temperature_K": temps[:, -1].tolist(),
           "mean_flow": flows.mean(axis=1).tolist(),
           "mean_flow_4_minus_1": float(flows[3].mean() - flows[0].mean()),
           "building_cools": bool(temps[:, -1].mean() < temps[:, 0].mean()),
           "peak_total_flow": float(total.max()),
           "finite": bool(np.isfinite(temps).all()
                          and np.isfinite(flows).all())}
    if coordinator is not None:
        stats = coordinator.results()
        out["rounds"] = [{
            "time": float(t), "iterations": len(g),
            "primal_residual": g["primal_residual"].tolist(),
            "dual_residual": g["dual_residual"].tolist(),
            "penalty_parameter": g["penalty_parameter"].tolist()}
            for t, g in stats.groupby(level="time")]
    if supplier is not None:
        out["supplier_flow"] = float(supplier.vars["mDot"].value)
        out["total_room_flow_last"] = float(total[-1])
    return out


def four_room_agents(run, aids):
    """Per solving agent of a four-room loop (``run`` from
    :func:`drive_mas`, the first agent its ``mpc_at``, the others its
    ``extra_at``): the module and its solve rows, each with the control
    step and the ADMM iteration within it."""
    out = {}
    for k, aid in enumerate(aids):
        if k == 0:
            module, rows = run["mpc"], run["solves"]
        else:
            extra = run["extra"][f"{aid}/admm"]
            module, rows = extra["module"], extra["solves"]
        per_step: dict = {}
        for row, it_row in zip(rows, module._iter_rows):
            step = int(np.floor(it_row["time"] / module.time_step + 1e-9))
            row["step"] = step
            row["admm_iteration"] = per_step.get(step, 0)
            per_step[step] = row["admm_iteration"] + 1
        out[aid] = {"module": module, "rows": rows,
                    "iterations_per_step": [per_step[k]
                                            for k in sorted(per_step)]}
    return out


def check_four_room_launches(name, agents):
    """Exact launches of every solve: one factor per inner iteration and
    the solves of its path (3 for a room's NLP iteration, 6 for a
    QP's)."""
    for aid, a in agents.items():
        backend = a["module"].backend
        solves = 6 if getattr(backend, "uses_qp_fast_path", False) \
            else per_factor(backend)
        for k, row in enumerate(a["rows"]):
            check(row["kkt_path"] == "ldl"
                  and row["factor"] == row["iterations"]
                  and row["solve"] == solves * row["iterations"],
                  f"{name} ({aid}) solve {k}: {row['factor']} factor / "
                  f"{row['solve']} solve launches for {row['iterations']} "
                  f"iterations on {row['kkt_path']} (expected 1/{solves})")


def four_room_summary(agents) -> dict:
    return {aid: {"solves": len(a["rows"]),
                  "first_solve_ms": a["rows"][0]["ms"],
                  "warm_solve_ms_median": float(np.median(
                      [r["ms"] for r in a["rows"][1:]])),
                  "iterations_per_solve": [r["iterations"]
                                           for r in a["rows"]],
                  "admm_iterations_per_step": a["iterations_per_step"],
                  "qp_fast_path": getattr(a["module"].backend,
                                          "uses_qp_fast_path", False),
                  "warm_start_resets": a["module"].backend.warm_start_resets,
                  "guard_levels": [r["guard_level"] for r in a["rows"]
                                   if "guard_level" in r]}
            for aid, a in agents.items()}


def phase_module_admm_coord(torch, dev, smi, ref):
    """examples/admm_4rooms_coordinator.py's ten agents through LocalMAS on
    the card in f64: the coordinator drives four CooledRoom participants
    (augmented NLPs, KKT 74) and the AHU (a zero-state QP with the shared
    capacity constraint, KKT 32) through 6 ADMM iterations per round,
    held against the same loop in f64 on the CPU with the plain LDLᵀ."""
    from agentlib_mpc_torch import reference_configs as rc

    t_phase = time.perf_counter()
    aids = (*ROOMS, "AHU")
    seen = {}

    def instrument(mas):
        coord = mas.agents["Coordinator"].get_module("coordinator")
        trigger = coord.trigger_optimizations

        def first_trigger():
            seen.setdefault("registered", sorted(
                s.agent_id for s, e in coord.agent_dict.items()
                if e.status.value != "pending"))
            seen.setdefault("aliases", sorted(coord._coupling_variables))
            trigger()

        coord.trigger_optimizations = first_trigger

    run = drive_mas(torch, rc.admm_4rooms_coordinator_configs(
        admm_iter_max=COORD_ADMM_ITER_MAX), dev,
                    getattr(torch, COORD_DTYPE), COORD_UNTIL,
                    (ROOMS[0], "admm"), SIMULATORS, count_launches=True,
                    extra_at=[(aid, "admm") for aid in aids[1:]],
                    instrument=instrument)
    coord = run["mas"].agents["Coordinator"].get_module("coordinator")
    agents = four_room_agents(run, aids)
    outcome = four_room_outcome(run, coordinator=coord)
    sizes = {aid: a["module"].backend.ocp.n_w + a["module"].backend.ocp.n_g
             for aid, a in agents.items()}
    failed = [{"agent": aid, "time": row["step"] * rc.ADMM_DT,
               "admm_iteration": row["admm_iteration"],
               "ip_iterations": row["iterations"],
               "kkt_error": float(row["stats"]["kkt_error"])}
              for aid, a in agents.items() for row in a["rows"]
              if not row["success"]]
    ref_failed = [{"agent": aid, "solve": k}
                  for aid, rows in [(ROOMS[0], ref["solves"])] + [
                      (aid, ref["extra"][f"{aid}/admm"]) for aid in aids[1:]]
                  for k, r in enumerate(rows) if not r["success"]]
    t_diff = [abs(a - b) for a, b in zip(
        outcome["final_room_temperature_K"],
        ref["outcome"]["final_room_temperature_K"])]
    flow_diff = [abs(a - b) for a, b in zip(outcome["mean_flow"],
                                            ref["outcome"]["mean_flow"])]
    emit({"phase": "module_admm_coord", "dtype": COORD_DTYPE,
          "until_s": COORD_UNTIL, "kkt_size": sizes,
          "registered_before_first_round": seen.get("registered"),
          "coupling_aliases": seen.get("aliases"),
          "agents": four_room_summary(agents),
          "failed_solves": failed, "f64_cpu_failed_solves": ref_failed,
          "launches": run["totals"], "outcome": outcome,
          "f64_cpu_outcome": ref["outcome"],
          "final_T_abs_diff_K": t_diff, "mean_flow_abs_diff": flow_diff,
          "tolerances": {"T_K": COORD_T_TOL_K, "flow": COORD_FLOW_TOL,
                         "peak_total_flow": COORD_PEAK_FLOW},
          "allocation_order_margin_not_gated":
              outcome["mean_flow_4_minus_1"],
          "build_seconds": run["build_s"], "run_seconds": run["wall_s"],
          "f64_cpu_run_seconds": ref["wall_s"],
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    check(seen.get("registered") == sorted(aids)
          and seen.get("aliases") == [f"mDotCoolAir_{i}"
                                      for i in range(1, 5)],
          f"module_admm_coord: before the first round the coordinator held "
          f"{seen.get('registered')} on {seen.get('aliases')}")
    check(sizes == {**{r: 74 for r in ROOMS}, "AHU": 32},
          f"module_admm_coord: KKT sizes {sizes}")
    check(not any(agents[r]["module"].backend.uses_qp_fast_path
                  for r in ROOMS)
          and agents["AHU"]["module"].backend.uses_qp_fast_path,
          "module_admm_coord: the rooms must route to the NLP, the AHU to "
          "the QP")
    rounds = [r["iterations"] for r in outcome["rounds"]]
    n_rounds = int(round(COORD_UNTIL / rc.ADMM_DT))
    check(len(rounds) == n_rounds
          and rounds == [r["iterations"] for r in ref["outcome"]["rounds"]],
          f"module_admm_coord: ADMM iterations per round {rounds}, the f64 "
          f"CPU reference's "
          f"{[r['iterations'] for r in ref['outcome']['rounds']]}")
    check(len(failed) <= COORD_MAX_FAILED
          and not any(f["agent"] in ROOMS for f in failed),
          f"module_admm_coord: failed solves {failed}")
    for aid, a in agents.items():
        check(len(a["rows"]) == sum(rounds)
              and a["iterations_per_step"] == rounds,
              f"module_admm_coord ({aid}): {len(a['rows'])} solves, "
              f"{a['iterations_per_step']} per round")
        levels = [r["guard_level"] for r in a["rows"] if "guard_level" in r]
        check(len(levels) == n_rounds,
              f"module_admm_coord ({aid}): the guard assessed "
              f"{len(levels)} of {n_rounds} rounds")
        check(aid == "AHU" or levels == [0] * n_rounds,
              f"module_admm_coord ({aid}): guard levels {levels}")
        check(a["module"].backend.warm_start_resets == 0,
              f"module_admm_coord ({aid}): a warm start was reset")
    check_four_room_launches("module_admm_coord", agents)
    check_shapes("module_admm_coord", run["totals"], [(1, 74), (1, 32)],
                 COORD_DTYPE)
    check(outcome["finite"] and outcome["building_cools"]
          and outcome["peak_total_flow"] <= COORD_PEAK_FLOW,
          f"module_admm_coord: the building {outcome}")
    check(max(t_diff) <= COORD_T_TOL_K and max(flow_diff) <= COORD_FLOW_TOL,
          f"module_admm_coord: final temperatures {t_diff} K and mean flows "
          f"{flow_diff} m³/s from the f64 CPU reference")
    check(not ref_failed or all(f["agent"] == "AHU" for f in ref_failed),
          f"module_admm_coord: the f64 CPU reference failed {ref_failed}")
    return run["totals"]


def phase_module_admm_exchange(torch, dev, smi, ref):
    """examples/exchange_admm_4rooms.py's nine agents through LocalMAS on
    the card in f32: four ExchangeRoom agents (augmented NLPs, KKT 74) and
    the supplier (a QP, KKT 8) on one exchange alias, 6 ADMM iterations
    per step, held against the same loop in f64 on the CPU with the plain
    LDLᵀ."""
    from agentlib_mpc_torch import reference_configs as rc

    t_phase = time.perf_counter()
    aids = (*ROOMS, "Supplier")
    run = drive_mas(torch, rc.exchange_admm_4rooms_configs(
        max_iterations=EXCHANGE_ITERATIONS), dev,
                    getattr(torch, EXCHANGE_DTYPE), EXCHANGE_UNTIL,
                    (ROOMS[0], "admm"), SIMULATORS, count_launches=True,
                    extra_at=[(aid, "admm") for aid in aids[1:]])
    agents = four_room_agents(run, aids)
    supplier = agents["Supplier"]["module"]
    outcome = four_room_outcome(run, supplier=supplier)
    sizes = {aid: a["module"].backend.ocp.n_w + a["module"].backend.ocp.n_g
             for aid, a in agents.items()}
    wire = supplier._wire_alias(supplier.exchange[0])
    peers = {aid: sorted(src.agent_id for src in
                         a["module"]._registered_participants[wire])
             for aid, a in agents.items()}
    t_diff = [abs(a - b) for a, b in zip(
        outcome["final_room_temperature_K"],
        ref["outcome"]["final_room_temperature_K"])]
    supply_diff = abs(outcome["supplier_flow"]
                      - ref["outcome"]["supplier_flow"])
    balance = abs(outcome["supplier_flow"] - outcome["total_room_flow_last"])
    emit({"phase": "module_admm_exchange", "dtype": EXCHANGE_DTYPE,
          "until_s": EXCHANGE_UNTIL, "kkt_size": sizes,
          "registered_peers": peers, "agents": four_room_summary(agents),
          "launches": run["totals"], "outcome": outcome,
          "f64_cpu_outcome": ref["outcome"],
          "final_T_abs_diff_K": t_diff, "supplier_flow_abs_diff":
              supply_diff, "balance": balance,
          "tolerances": {"T_K": EXCHANGE_T_TOL_K,
                         "supplier_flow": EXCHANGE_SUPPLY_TOL,
                         "balance": EXCHANGE_BALANCE_TOL},
          "allocation_order_margin_not_gated":
              outcome["mean_flow_4_minus_1"],
          "build_seconds": run["build_s"], "run_seconds": run["wall_s"],
          "f64_cpu_run_seconds": ref["wall_s"],
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    check(sizes == {**{r: 74 for r in ROOMS}, "Supplier": 8},
          f"module_admm_exchange: KKT sizes {sizes}")
    check(not any(agents[r]["module"].backend.uses_qp_fast_path
                  for r in ROOMS) and supplier.backend.uses_qp_fast_path,
          "module_admm_exchange: the rooms must route to the NLP, the "
          "supplier to the QP")
    n_steps = int(round(EXCHANGE_UNTIL / rc.ADMM_DT))
    for aid, a in agents.items():
        check(all(r["success"] for r in a["rows"]),
              f"module_admm_exchange ({aid}): failed solves at "
              f"{[k for k, r in enumerate(a['rows']) if not r['success']]}")
        check(a["iterations_per_step"] == [EXCHANGE_ITERATIONS] * n_steps,
              f"module_admm_exchange ({aid}): ADMM iterations per step "
              f"{a['iterations_per_step']}")
        levels = [r["guard_level"] for r in a["rows"] if "guard_level" in r]
        check(levels == [0] * n_steps,
              f"module_admm_exchange ({aid}): guard levels {levels}")
        check(a["module"].backend.warm_start_resets == 0,
              f"module_admm_exchange ({aid}): a warm start was reset")
        check(peers[aid] == sorted(set(aids) - {aid}),
              f"module_admm_exchange ({aid}): registered {peers[aid]} on "
              f"{wire}")
    check_four_room_launches("module_admm_exchange", agents)
    check_shapes("module_admm_exchange", run["totals"], [(1, 74), (1, 8)],
                 EXCHANGE_DTYPE)
    check(outcome["finite"] and outcome["building_cools"]
          and balance < EXCHANGE_BALANCE_TOL,
          f"module_admm_exchange: the building {outcome}, balance "
          f"{balance}")
    check(max(t_diff) <= EXCHANGE_T_TOL_K
          and supply_diff <= EXCHANGE_SUPPLY_TOL,
          f"module_admm_exchange: final temperatures {t_diff} K and the "
          f"supplier's flow {supply_diff} m³/s from the f64 CPU reference")
    check(all(r["success"] for r in ref["solves"]) and all(
        r["success"] for rows in ref["extra"].values() for r in rows),
          "module_admm_exchange: the f64 CPU reference failed a solve")
    profile_module_solve(torch, run, "module_admm_exchange_profile")
    return run["totals"]


# -- the data-driven examples -------------------------------------------------

def ml_val_mse(doc, data) -> float:
    """Validation MSE (raw units) of a serialized surrogate on its
    validation split, evaluated on the host in f64."""
    import torch

    from agentlib_mpc_torch.ml import load_serialized_model, make_predictor

    pred = make_predictor(load_serialized_model(doc))
    X = torch.as_tensor(np.array(data.validation_inputs, dtype=float))
    with torch.no_grad():
        out = pred.apply_batch(pred.params, X).numpy()
    y = np.asarray(data.validation_outputs, dtype=float)
    return float(np.mean((out - y) ** 2))


def ml_weight_diff(doc_a, doc_b) -> float:
    """Largest absolute difference of two ANN documents' weights and
    biases."""
    from agentlib_mpc_torch.ml import load_serialized_model

    a, b = (load_serialized_model(d) for d in (doc_a, doc_b))
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a.weights + a.biases, b.weights + b.biases))


def ml_train(torch, dev, which: str):
    """The example's surrogates trained on ``dev`` in f64: ``"room"``
    (examples/ml_mpc_one_room.py) or ``"zones"`` (the three zones of
    examples/three_zone_datadriven_admm.py, seeds 0, 1, 2): per surrogate
    its JSON, its validation MSE and its training seconds."""
    from agentlib_mpc_torch import reference_configs as rc

    dtype = getattr(torch, ML_DTYPE)
    jobs = ([lambda: rc.train_room_surrogate(
        rc.ml_room_training_data(), epochs=ML_EPOCHS, device=dev,
        dtype=dtype, return_data=True)] if which == "room" else
        [lambda i=i: rc.train_zone_surrogate(
            rc.ZONES_LOADS[i], epochs=ML_EPOCHS, seed=i, device=dev,
            dtype=dtype, return_data=True) for i in range(rc.ZONES_N)])
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        doc, data = job()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        out.append({"doc": doc.to_json(), "val_mse": ml_val_mse(doc, data),
                    "train_s": time.perf_counter() - t0})
    return out


def ml_mpc_loop(torch, doc, dev, count_launches: bool) -> dict:
    """examples/ml_mpc_one_room.py's closed loop on ``jax_ml`` with the
    surrogate ``doc`` (a JSON string) on ``dev`` in f64 (on the CPU with
    the plain LDLᵀ): per solve the plant temperature after it, the
    control, success, iterations, ms and (on the card) launches."""
    from agentlib_mpc_torch import reference_configs as rc
    from agentlib_mpc_torch.backends.backend import (
        VariableReference,
        create_backend,
    )
    from agentlib_mpc_torch.ops import kkt

    on_cpu = torch.device(dev).type == "cpu"
    solver = {"kkt_method": "ldl"} if on_cpu else {}
    t0 = time.perf_counter()
    backend = create_backend(rc.ml_mpc_backend_config(doc, solver),
                             device=dev, dtype=getattr(torch, ML_DTYPE))
    backend.setup_optimization(
        VariableReference(states=["T"], controls=["Q"], inputs=["T_upper"],
                          parameters=["s_T", "r_Q"]),
        time_step=rc.ML_DT, prediction_horizon=ML_MPC_N)
    build_s = time.perf_counter() - t0
    if count_launches:
        torch.cuda.synchronize()
        kkt.reset_launch_counts()
    T, rows = 297.5, []
    t0 = time.perf_counter()
    for k in range(int(ML_MPC_UNTIL // rc.ML_DT)):
        before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
        res = backend.solve(k * rc.ML_DT, {"T": T})
        stats = res["stats"]
        T = rc.ml_room_plant_step(T, res["u0"]["Q"])
        rows.append({"T": T, "Q": res["u0"]["Q"],
                     "success": stats["success"],
                     "iterations": stats["iterations"],
                     "ms": stats["solve_wall_time"] * 1e3,
                     "kkt_path": stats["kkt_path"],
                     "factor": kkt.ldl_factor.launches - before[0],
                     "solve": kkt.ldl_solve.launches - before[1]})
    return {"backend": backend, "rows": rows, "build_s": build_s,
            "wall_s": time.perf_counter() - t0,
            "totals": launch_totals(kkt) if count_launches else None}


def ml_admm_run(torch, docs, dev, count_launches: bool) -> dict:
    """The three-zone example's seven agents with the surrogates ``docs``
    through LocalMAS for one control step on ``dev`` in f64 (on the CPU
    with the plain LDLᵀ), and the step's outcome."""
    from agentlib_mpc_torch import reference_configs as rc

    solver = ({"kkt_method": "ldl"} if torch.device(dev).type == "cpu"
              else None)
    run = drive_mas(torch, rc.three_zone_datadriven_configs(
        docs, max_iterations=ML_ADMM_ITERATIONS, solver=solver), dev,
        getattr(torch, ML_DTYPE), ML_ADMM_UNTIL,
        (ZONES[0], "admm"), ZONE_SIMULATORS, count_launches=count_launches,
        extra_at=[(aid, "admm") for aid in (*ZONES[1:], "AHU")])
    run["agents"] = four_room_agents(run, (*ZONES, "AHU"))
    run["outcome"] = ml_admm_outcome(run["agents"])
    return run


def ml_admm_outcome(agents) -> dict:
    """One three-zone step as plain data: each agent's ADMM iterations and
    solves, and at the last ADMM iteration each zone's first move and its
    coupling gap to the AHU's outlet (largest over the horizon)."""
    ahu = agents["AHU"]["module"]._iter_rows[-1]["couplings"]
    moves, gaps = [], []
    for i, aid in enumerate(ZONES, 1):
        zone = np.asarray(agents[aid]["module"]._iter_rows[-1]["couplings"]
                          ["mDot"], dtype=float)
        moves.append(float(zone[0]))
        gaps.append(float(np.abs(zone - np.asarray(
            ahu[f"mDot_out_{i}"], dtype=float)).max()))
    return {"admm_iterations": {aid: a["iterations_per_step"]
                                for aid, a in agents.items()},
            "solves": {aid: [{"success": bool(r["success"]),
                              "iterations": int(r["iterations"])}
                             for r in a["rows"]]
                       for aid, a in agents.items()},
            "first_moves": moves, "gaps": gaps}


def ml_reference(name: str) -> dict:
    """The f64 CPU reference of one data-driven phase: the surrogates
    trained on the CPU, then the loop (``module_ml_mpc``) or the step
    (``module_ml_admm``) with them, as plain data."""
    import torch

    trained = ml_train(torch, "cpu", "room" if name == "module_ml_mpc"
                       else "zones")
    docs = [t["doc"] for t in trained]
    if name == "module_ml_mpc":
        run = ml_mpc_loop(torch, docs[0], "cpu", False)
        return {"trained": trained, "rows": run["rows"],
                "wall_s": run["wall_s"]}
    run = ml_admm_run(torch, docs, "cpu", False)
    return {"trained": trained, "outcome": run["outcome"],
            "wall_s": run["wall_s"]}


def check_training(name, card, cpu) -> list:
    """The card's validation MSEs within ML_VAL_MSE_RTOL of the CPU's; per
    surrogate the MSEs, the largest weight difference and the seconds."""
    rows = []
    for k, (c, r) in enumerate(zip(card, cpu)):
        rows.append({"val_mse_card": c["val_mse"], "val_mse_cpu": r["val_mse"],
                     "val_mse_rel_diff": abs(c["val_mse"] - r["val_mse"])
                     / r["val_mse"],
                     "max_weight_abs_diff": ml_weight_diff(c["doc"],
                                                           r["doc"]),
                     "train_seconds_card": c["train_s"],
                     "train_seconds_cpu": r["train_s"]})
        check(rows[-1]["val_mse_rel_diff"] <= ML_VAL_MSE_RTOL,
              f"{name} surrogate {k}: validation MSE {c['val_mse']} on the "
              f"card, {r['val_mse']} on the CPU")
    return rows


def phase_module_ml_mpc(torch, dev, smi, ref):
    """examples/ml_mpc_one_room.py through the port on the card in f64:
    the surrogate trained on the card against the CPU's training, then
    the example's loop with the CPU-trained surrogate against the same
    loop on the CPU."""
    from agentlib_mpc_torch import reference_configs as rc

    t_phase = time.perf_counter()
    training = check_training("module_ml_mpc", ml_train(torch, dev, "room"),
                              ref["trained"])
    run = ml_mpc_loop(torch, ref["trained"][0]["doc"], dev, True)
    rows, backend = run["rows"], run["backend"]
    temps = [r["T"] for r in rows]
    t_diff = [abs(a - b["T"]) for a, b in zip(temps, ref["rows"])]
    tail = float(np.mean(temps[-5:]))
    failed = [k for k, r in enumerate(rows) if not r["success"]]
    ms = [r["ms"] for r in rows]
    size = backend.ocp.n_w + backend.ocp.n_g
    emit({"phase": "module_ml_mpc", "dtype": ML_DTYPE,
          "until_s": ML_MPC_UNTIL, "kkt_size": size, "training": training,
          "solves": len(rows), "failed_solves": failed,
          "iterations_per_solve": [r["iterations"] for r in rows],
          "f64_cpu_iterations_per_solve": [r["iterations"]
                                           for r in ref["rows"]],
          "first_solve_ms": ms[0], "warm_solve_ms_median":
              float(np.median(ms[1:])), "warm_solve_ms_max": max(ms[1:]),
          "temperatures_K": temps, "tail_mean_K": tail,
          "max_T_abs_diff_K": max(t_diff), "launches": run["totals"],
          "tolerances": {"T_K": ML_MPC_T_TOL_K,
                         "val_mse_rel": ML_VAL_MSE_RTOL},
          "build_seconds": run["build_s"], "run_seconds": run["wall_s"],
          "f64_cpu_run_seconds": ref["wall_s"],
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    check(tail < rc.ML_UB + ML_MPC_TAIL_MARGIN_K
          and len(failed) <= ML_MPC_MAX_FAILED,
          f"module_ml_mpc: the example's gates: tail {tail} K, failed "
          f"solves {failed}")
    check(max(t_diff) <= ML_MPC_T_TOL_K,
          f"module_ml_mpc: temperatures {max(t_diff)} K from the f64 CPU "
          f"loop")
    for k, r in enumerate(rows):
        check(r["kkt_path"] == "ldl" and r["factor"] == r["iterations"]
              and r["solve"] == per_factor(backend) * r["iterations"],
              f"module_ml_mpc solve {k}: {r['factor']} factor / "
              f"{r['solve']} solve launches for {r['iterations']} "
              f"iterations on {r['kkt_path']}")
    check_shapes("module_ml_mpc", run["totals"], [(1, size)], ML_DTYPE)
    now = len(rows) * rc.ML_DT
    phase_profile(torch, lambda: backend.solve(now, {"T": temps[-1]}),
                  float(np.median(ms[1:])), name="module_ml_mpc_profile")
    return run["totals"]


def phase_module_ml_admm(torch, dev, smi, ref):
    """examples/three_zone_datadriven_admm.py's seven agents through
    LocalMAS on the card in f64 for one control step, the zones' surrogates
    trained on the card against the CPU's, the step run with the
    CPU-trained ones against the same step on the CPU."""
    t_phase = time.perf_counter()
    training = check_training("module_ml_admm",
                              ml_train(torch, dev, "zones"), ref["trained"])
    run = ml_admm_run(torch, [t["doc"] for t in ref["trained"]], dev, True)
    agents, outcome, cpu = run["agents"], run["outcome"], ref["outcome"]
    sizes = {aid: a["module"].backend.ocp.n_w + a["module"].backend.ocp.n_g
             for aid, a in agents.items()}
    move_diff = [abs(a - b) for a, b in zip(outcome["first_moves"],
                                            cpu["first_moves"])]
    gap_diff = [abs(a - b) for a, b in zip(outcome["gaps"], cpu["gaps"])]
    emit({"phase": "module_ml_admm", "dtype": ML_DTYPE,
          "until_s": ML_ADMM_UNTIL, "kkt_size": sizes,
          "training": training, "agents": four_room_summary(agents),
          "outcome": outcome, "f64_cpu_outcome": cpu,
          "first_move_abs_diff": move_diff, "gap_abs_diff": gap_diff,
          "launches": run["totals"],
          "tolerances": {"first_move": ML_ADMM_MOVE_TOL,
                         "gap": ML_ADMM_GAP_TOL,
                         "val_mse_rel": ML_VAL_MSE_RTOL},
          "build_seconds": run["build_s"], "run_seconds": run["wall_s"],
          "f64_cpu_run_seconds": ref["wall_s"],
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    for aid, solves in (*outcome["solves"].items(),
                        *cpu["solves"].items()):
        check(all(r["success"] for r in solves),
              f"module_ml_admm ({aid}): failed solves at "
              f"{[k for k, r in enumerate(solves) if not r['success']]}")
    check(all(its == [ML_ADMM_ITERATIONS]
              for its in outcome["admm_iterations"].values())
          and outcome["admm_iterations"] == cpu["admm_iterations"],
          f"module_ml_admm: ADMM iterations {outcome['admm_iterations']}, "
          f"the f64 CPU step {cpu['admm_iterations']}")
    check(max(move_diff) <= ML_ADMM_MOVE_TOL
          and max(gap_diff) <= ML_ADMM_GAP_TOL,
          f"module_ml_admm: first moves {move_diff} and gaps {gap_diff} "
          f"from the f64 CPU step")
    check_four_room_launches("module_ml_admm", agents)
    check_shapes("module_ml_admm", run["totals"],
                 sorted({(1, m) for m in sizes.values()}), ML_DTYPE)
    return run["totals"]


def fleet_configs() -> list:
    """The deploy fleet's four agent configs, read as they are."""
    from agentlib_mpc_torch.runtime.container import load_configs

    return [cfg for name in ("coordinator", "room", "cooler")
            for cfg in load_configs(os.path.join(FLEET_DIR, f"{name}.json"))]


def cuda_context_seconds(torch, dev) -> float | None:
    """Seconds to the first tensor on ``dev`` in this process (the CUDA
    context, on a card; None on the CPU)."""
    if torch.device(dev).type != "cuda":
        return None
    t0 = time.perf_counter()
    torch.zeros((), device=dev)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fleet_process_report(torch, dev, agents, context_s, build_s,
                         kkt) -> dict:
    """One fleet process as plain data: its agents, CUDA context and build
    seconds, per solving backend the KKT size, routing and every solve
    (ms, iterations, success), cold (first) and median warm solve ms, the
    peak device memory and the launch counts since the build."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    backends = {f"{a.id}/{mid}": m.backend for a in agents
                for mid, m in a.modules.items()
                if getattr(m, "backend", None) is not None}
    solves = {key: [{"ms": r["solve_wall_time"] * 1e3,
                     "iterations": int(r["iterations"]),
                     "success": bool(r["success"])}
                    for r in b.stats_history]
              for key, b in backends.items()}
    return {
        "pid": os.getpid(), "agents": [a.id for a in agents],
        "cuda_context_seconds": context_s, "build_seconds": build_s,
        "kkt_size": {k: b.ocp.n_w + b.ocp.n_g for k, b in backends.items()},
        "dtype": {k: str(b.dtype) for k, b in backends.items()},
        "solves_per_factor": {k: 6 if b.uses_qp_fast_path else per_factor(b)
                              for k, b in backends.items()},
        "solves": solves,
        "cold_solve_ms": {k: s[0]["ms"] if s else None
                          for k, s in solves.items()},
        "warm_solve_ms_median": {
            k: float(np.median([r["ms"] for r in s[1:]])) if len(s) > 1
            else None for k, s in solves.items()},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                              if torch.device(dev).type == "cuda" else None),
        "launches": launch_totals(kkt)}


def fleet_container_child() -> int:
    """``--fleet-container``: the port's container ``main()`` (configured by
    its environment variables, as ``python -m
    agentlib_mpc_torch.runtime.container`` is), then this process's
    :func:`fleet_process_report` as one JSON line. The launch counts are
    reset once the MAS is built (after its backends' precompile solves);
    the results frames ``main()`` cannot write as CSV (a module's dict of
    frames) are written by ``utils.analysis.save_results``."""
    import torch

    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.runtime import container
    from agentlib_mpc_torch.utils import analysis

    dev = os.environ["AGENT_DEVICE"]
    context_s = cuda_context_seconds(torch, dev)
    built = {}
    build = container.build_mas

    def counted_build(*args, **kwargs):
        t0 = time.perf_counter()
        mas, buses = build(*args, **kwargs)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        built.update(mas=mas, seconds=time.perf_counter() - t0)
        kkt.reset_launch_counts()
        return mas, buses

    container.build_mas = counted_build
    rc = container.main([])
    mas = built["mas"]
    analysis.save_results(mas.get_results(), os.environ["RESULTS_DIR"])
    report = fleet_process_report(torch, dev, list(mas.agents.values()),
                                  context_s, built["seconds"], kkt)
    print(json.dumps({"rc": rc, **report}, default=float), flush=True)
    return rc


def fleet_child_bootstrap(dev: str, out_dir: str, cores) -> None:
    """``MultiProcessingMAS`` bootstrap of module_fleet_mp's children: the
    cores, the CUDA context (timed), and, once the child's agent is built
    (after its precompile solves), the launch counts reset; at the child's
    exit its :func:`fleet_process_report` goes to ``out_dir/<agent>.json``
    (the MAS returns the modules' results, not the process's counts)."""
    import atexit

    import torch

    from agentlib_mpc_torch.ops import kkt
    from agentlib_mpc_torch.runtime import agent as agent_module

    os.sched_setaffinity(0, cores)
    context_s = cuda_context_seconds(torch, dev)
    built = []
    init = agent_module.Agent.__init__

    def counted_init(self, *args, **kwargs):
        t0 = time.perf_counter()
        init(self, *args, **kwargs)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        built.append((self, time.perf_counter() - t0))
        kkt.reset_launch_counts()

    def report():
        agent, build_s = built[0]
        rep = fleet_process_report(torch, dev, [agent], context_s, build_s,
                                   kkt)
        with open(os.path.join(out_dir, f"{agent.id}.json"), "w") as fh:
            json.dump(rep, fh, default=float)

    agent_module.Agent.__init__ = counted_init
    atexit.register(report)


def fleet_totals(reports) -> dict:
    """The launch totals of the fleet's processes, summed."""
    out = {"ldl_factor": 0, "ldl_solve": 0,
           "shapes": {"ldl_factor": [], "ldl_solve": []},
           "shapes_f64": {"ldl_factor": [], "ldl_solve": []}}
    for rep in reports:
        t = rep["launches"]
        for kernel in ("ldl_factor", "ldl_solve"):
            out[kernel] += t[kernel]
            for key in ("shapes", "shapes_f64"):
                out[key][kernel] = sorted(
                    set(out[key][kernel]) | {tuple(x) for x in
                                             t[key][kernel]})
    return out


def check_fleet_solves(name, reports):
    """Every solve of every solving process successful, at least one each;
    the launches exact per process (one factor per inner iteration and the
    solves of its path); every backend in FLEET_DTYPE."""
    for rep in reports:
        iterations = {k: sum(r["iterations"] for r in s)
                      for k, s in rep["solves"].items()}
        for key, rows in rep["solves"].items():
            check(rows and all(r["success"] for r in rows),
                  f"{name} ({key}): {len(rows)} solves, failed at "
                  f"{[k for k, r in enumerate(rows) if not r['success']]}")
            check(rep["dtype"][key] == f"torch.{FLEET_DTYPE}",
                  f"{name} ({key}): solved in {rep['dtype'][key]}")
        t = rep["launches"]
        want_f = sum(iterations.values())
        want_s = sum(rep["solves_per_factor"][k] * n
                     for k, n in iterations.items())
        check(t["ldl_factor"] == want_f and t["ldl_solve"] == want_s,
              f"{name} ({rep['agents']}): {t['ldl_factor']} factor / "
              f"{t['ldl_solve']} solve launches, expected {want_f} / "
              f"{want_s} for {iterations} iterations")


def fleet_process_line(name, rep) -> dict:
    return {"phase": f"{name}_process",
            **{k: rep[k] for k in ("agents", "pid", "cuda_context_seconds",
                                   "build_seconds", "kkt_size",
                                   "cold_solve_ms", "warm_solve_ms_median",
                                   "peak_memory_bytes")},
            "solves": {k: len(s) for k, s in rep["solves"].items()},
            "iterations": {k: [r["iterations"] for r in s]
                           for k, s in rep["solves"].items()},
            "launches": {k: rep["launches"][k]
                         for k in ("ldl_factor", "ldl_solve")}}


def fresh_dir(path: str) -> str:
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def phase_module_fleet_mqtt(torch, dev, smi, cores):
    """The deploy fleet as three container processes on the card over a
    port ``MiniBroker`` in this process, as deploy/run_fleet_local.sh runs
    it: the coordinator literally as ``python -m
    agentlib_mpc_torch.runtime.container`` (it launches no kernel), the
    room group and the cooler through ``--fleet-container`` (the same
    ``main()``, then their launch counts); device and dtype from
    ``AGENT_DEVICE``/``AGENT_DTYPE``, ``REALTIME=1``; the participants stop
    after FLEET_UNTIL s of their clocks, then the coordinator gets
    SIGTERM."""
    import signal

    from agentlib_mpc_torch.runtime.mqtt_native import MiniBroker
    from agentlib_mpc_torch.utils import analysis

    t_phase = time.perf_counter()
    out_dir = fresh_dir(os.path.join(FLEET_OUT, "fleet_mqtt"))
    broker = MiniBroker()
    base = {**os.environ, "PYTHONPATH": HERE, "AGENT_DEVICE": str(dev),
            "AGENT_DTYPE": FLEET_DTYPE, "MQTT_HOST": "127.0.0.1",
            "MQTT_PORT": str(broker.port), "REALTIME": "1",
            "RESULTS_DIR": out_dir, "LOG_LEVEL": "INFO"}
    base.pop("RUN_UNTIL", None)

    def start(config, argv, until=None):
        env = {**base, "AGENT_CONFIG": os.path.join(FLEET_DIR, config)}
        if until is not None:
            env["RUN_UNTIL"] = str(until)
        return subprocess.Popen(
            [sys.executable, *argv], env=env, cwd=HERE, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            preexec_fn=lambda: os.sched_setaffinity(0, cores))

    procs, out = {}, {}
    try:
        procs["Coordinator"] = start(
            "coordinator.json",
            ["-m", "agentlib_mpc_torch.runtime.container"])
        for name, config in (("CooledRoom", "room.json"),
                             ("Cooler", "cooler.json")):
            procs[name] = start(config, [__file__, "--fleet-container"],
                                FLEET_UNTIL)
        for name in ("CooledRoom", "Cooler"):
            out[name] = procs[name].communicate(timeout=300)
        run_s = time.perf_counter() - t_phase
        procs["Coordinator"].send_signal(signal.SIGTERM)
        out["Coordinator"] = procs["Coordinator"].communicate(timeout=60)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        broker.stop()
    rcs = {name: p.returncode for name, p in procs.items()}
    with open(os.path.join(out_dir, "logs.txt"), "w") as fh:
        for name, (o, e) in out.items():
            fh.write(f"===== {name} (rc {rcs[name]})\n{o}\n{e}\n")
    for name, rc in rcs.items():
        check(rc == 0, f"module_fleet_mqtt: {name} exited {rc}:\n"
              f"{out[name][1][-3000:]}")
    reports = {}
    for name in ("CooledRoom", "Cooler"):
        lines = [ln for ln in out[name][0].splitlines()
                 if ln.startswith("{")]
        check(bool(lines), f"module_fleet_mqtt: {name} printed no report")
        reports[name] = json.loads(lines[-1])
        emit(fleet_process_line("module_fleet_mqtt", reports[name]))
    coord_log = out["Coordinator"][1]
    emit({"phase": "module_fleet_mqtt_process", "agents": ["Coordinator"],
          "pid": procs["Coordinator"].pid,
          "entry": "python -m agentlib_mpc_torch.runtime.container",
          "cuda_context_seconds": "not measured (the entry point as is)",
          "peak_memory_bytes": "not measured (the entry point as is)",
          "solves": {}})
    registered = sorted(a for a in ("CooledRoom", "Cooler")
                        if f"registered agent Source(agent_id='{a}'"
                        in coord_log)
    round_ends = sum(1 for ln in coord_log.splitlines()
                     if "converged in" in ln or "no convergence within" in ln)
    stats = analysis.load_mpc_stats(
        os.path.join(out_dir, "Coordinator__coordinator.csv"))
    rounds = [{"time": float(t), "iterations": len(g),
               "primal_residual": g["primal_residual"].tolist(),
               "dual_residual": g["dual_residual"].tolist(),
               "penalty_parameter": g["penalty_parameter"].tolist()}
              for t, g in stats.groupby(level="time")]
    room_admm = analysis.load_admm(
        os.path.join(out_dir, "CooledRoom_admm_admm.csv"))
    sim = analysis.load_sim(
        os.path.join(out_dir, "Simulation__simulator.csv"))
    totals = fleet_totals(reports.values())
    emit({"phase": "module_fleet_mqtt", "dtype": FLEET_DTYPE,
          "until_s": FLEET_UNTIL, "returncodes": rcs,
          "messages_routed": broker.messages_routed,
          "client_impl": "native" if "using the first-party MQTT"
          in out["CooledRoom"][1] else "paho",
          "registered": registered, "rounds_ended_in_log": round_ends,
          "rounds": rounds,
          "room_admm_csv": {"rows": len(room_admm),
                            "index": list(room_admm.index.names),
                            "columns": [list(c) for c in room_admm.columns]},
          "plant_T_out": sim["T_out"].tolist(),
          "launches": totals, "run_seconds": run_s,
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    check(broker.messages_routed > 0,
          "module_fleet_mqtt: no MQTT message crossed the broker")
    check(registered == ["CooledRoom", "Cooler"],
          f"module_fleet_mqtt: the coordinator registered {registered}")
    check(len(rounds) >= FLEET_MIN_ROUNDS and round_ends >= FLEET_MIN_ROUNDS
          and all(np.isfinite(r["primal_residual"]).all() for r in rounds),
          f"module_fleet_mqtt: {len(rounds)} rounds in the coordinator's "
          f"CSV, {round_ends} ended in its log")
    check({"primal_residual", "dual_residual", "penalty_parameter"}
          <= set(stats.columns),
          f"module_fleet_mqtt: coordinator CSV columns {list(stats.columns)}")
    check(room_admm.index.nlevels == 3 and len(room_admm) > 0
          and ("variable", "mDot") in room_admm.columns,
          "module_fleet_mqtt: the room's ADMM CSV")
    check_fleet_solves("module_fleet_mqtt", reports.values())
    sizes = [(1, s) for rep in reports.values()
             for s in rep["kkt_size"].values()]
    check_shapes("module_fleet_mqtt", totals, sizes, FLEET_DTYPE)
    for kernel in ("ldl_factor", "ldl_solve"):
        check(all(rep["launches"][kernel] > 0 for rep in reports.values()),
              f"module_fleet_mqtt: {kernel} not launched in every solving "
              f"process")
    return totals


def phase_module_fleet_mp(torch, dev, smi, cores):
    """The deploy fleet's four agents through ``MultiProcessingMAS`` (one
    spawned process each, the TCP relay, ``rt`` with factor 1.0) on the
    card in float64; each child's report is written at its exit by
    :func:`fleet_child_bootstrap`."""
    import functools

    from agentlib_mpc_torch.runtime.multiprocessing_mas import (
        MultiProcessingMAS,
    )

    t_phase = time.perf_counter()
    out_dir = fresh_dir(os.path.join(FLEET_OUT, "fleet_mp"))
    mas = MultiProcessingMAS(
        fleet_configs(), env={"rt": True, "factor": 1.0},
        bootstrap=functools.partial(fleet_child_bootstrap, str(dev), out_dir,
                                    cores),
        device=dev, dtype=getattr(torch, FLEET_DTYPE))
    mas.run(until=FLEET_UNTIL, join_timeout=FLEET_UNTIL + 240.0)
    run_s = time.perf_counter() - t_phase
    results = mas.get_results()
    reports = {}
    for aid in FLEET_AGENTS:
        path = os.path.join(out_dir, f"{aid}.json")
        check(os.path.exists(path),
              f"module_fleet_mp: the {aid} process wrote no report")
        with open(path) as fh:
            reports[aid] = json.load(fh)
        emit(fleet_process_line("module_fleet_mp", reports[aid]))
    stats = results.get("Coordinator", {}).get("coordinator")
    rounds = [] if stats is None else [
        {"time": float(t), "iterations": len(g),
         "primal_residual": g["primal_residual"].tolist()}
        for t, g in stats.groupby(level="time")]
    solving = [reports[a] for a in ("CooledRoom", "Cooler")]
    totals = fleet_totals(solving)
    emit({"phase": "module_fleet_mp", "dtype": FLEET_DTYPE,
          "until_s": FLEET_UNTIL, "results_from": sorted(results),
          "results_modules": {a: sorted(m) for a, m in results.items()},
          "rounds": rounds, "launches": totals,
          "launches_elsewhere": {a: {k: reports[a]["launches"][k] for k in
                                     ("ldl_factor", "ldl_solve")}
                                 for a in ("Coordinator", "Simulation")},
          "run_seconds": run_s,
          "phase_seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    check(sorted(results) == sorted(FLEET_AGENTS),
          f"module_fleet_mp: results from {sorted(results)}")
    check(len(rounds) >= FLEET_MIN_ROUNDS
          and all(np.isfinite(r["primal_residual"]).all() for r in rounds),
          f"module_fleet_mp: {len(rounds)} rounds completed")
    check_fleet_solves("module_fleet_mp", solving)
    check_shapes("module_fleet_mp", totals,
                 [(1, s) for rep in solving
                  for s in rep["kkt_size"].values()], FLEET_DTYPE)
    for kernel in ("ldl_factor", "ldl_solve"):
        check(all(rep["launches"][kernel] > 0 for rep in solving),
              f"module_fleet_mp: {kernel} not launched in every solving "
              f"process")
    return totals


def main() -> int:
    import torch

    # ``--cpu-reference NAME``: one module phase's f64 CPU reference, one
    # JSON line (the subprocesses of :class:`References`)
    if "--cpu-reference" in sys.argv:
        torch.set_num_threads(1)
        name = sys.argv[sys.argv.index("--cpu-reference") + 1]
        print(json.dumps(reference_run(name), default=float), flush=True)
        return 0
    # ``--cpu-replay NAME``: card solves (pickled on stdin) replayed on the
    # CPU, one JSON line (the subprocesses of :meth:`References.replay`)
    # ``--fleet-container``: one container process of module_fleet_mqtt
    if "--fleet-container" in sys.argv:
        return fleet_container_child()
    if "--cpu-replay" in sys.argv:
        torch.set_num_threads(1)
        name = sys.argv[sys.argv.index("--cpu-replay") + 1]
        print(json.dumps(replay_run(name, pickle.load(sys.stdin.buffer)),
                         default=float), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    seconds: dict = {}
    # the f64 CPU references of the module phases run in subprocesses from
    # the start, beside the card's phases, on cores of their own
    main_cores, ref_cores = split_cores()
    os.sched_setaffinity(0, main_cores)
    torch.set_num_threads(len(main_cores))
    cores = {"card_process": main_cores, "cpu_subprocesses": ref_cores}
    refs = References(["quality", "qp_quality", "fused_slice",
                       "fused_linear", "scenario_ab", "serve"],
                      list(reference_specs()), ref_cores)
    try:
        return run_phases(torch, dev, refs, seconds, t_start, cores)
    finally:
        refs.close()


def run_phases(torch, dev, refs, seconds, t_start, cores) -> int:
    """Every phase in order, each timed into ``seconds``; the result lines
    last."""

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("env", phase_env, torch)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, torch, dev)
    outs, slice_totals, ocp = timed("slice", phase_slice, torch, dev)
    timed("quality", phase_quality, torch, outs, ocp, refs.get("quality"))
    stage_rows = timed("stage_kernels", phase_stage_kernels, torch, dev)
    lh_totals, lh = timed("long_horizon", phase_long_horizon, torch, dev,
                          smi)
    by_path = {"slice": slice_totals, "long_horizon": lh_totals,
               "shooting": timed("shooting", phase_shooting, torch, dev)}
    qp_outs, by_path["qp_slice"], qp_step, qp_args, qp_cold_ms = timed(
        "qp_slice", phase_qp_slice, torch, dev, smi)
    timed("qp_quality", phase_qp_quality, torch, dev, qp_outs, qp_step,
          qp_args, qp_cold_ms, refs.get("qp_quality"))
    by_path["qp_day_ahead"] = timed("qp_day_ahead", phase_qp_day_ahead,
                                    torch, dev, smi)
    by_path["sparse_day_ahead"] = timed(
        "sparse_day_ahead", phase_sparse_day_ahead, torch, dev, smi, lh)
    by_path["fused_slice"] = timed("fused_slice", phase_fused, torch, dev,
                                   smi, "zone", refs.get("fused_slice"))
    by_path["fused_linear"] = timed("fused_linear", phase_fused, torch, dev,
                                    smi, "linear", refs.get("fused_linear"))
    by_path["fused_fleet"] = timed("fused_fleet", phase_fused_fleet, torch,
                                   dev, smi)
    by_path["scenario_tree_kkt"] = timed(
        "scenario_tree_kkt", phase_scenario_tree_kkt, torch, dev, smi)
    by_path["scenario_ab"] = timed("scenario_ab", phase_scenario_ab, torch,
                                   dev, smi, refs.get("scenario_ab"))
    by_path["scenario_fleet"] = timed("scenario_fleet", phase_scenario_fleet,
                                      torch, dev, smi)
    by_path["serve"] = timed("serve", phase_serve, torch, dev, smi,
                             refs.get("serve"))
    # the data-driven phases' references (their trainings and loops)
    # start once the fleet paths, the ones the CPU references slow most,
    # are done
    refs.start_late(["module_ml_mpc", "module_ml_admm"])
    by_path["module_one_room"] = timed(
        "module_one_room", phase_module_one_room, torch, dev, smi,
        refs.get("module_one_room"))
    by_path["module_linear_qp"], qp_solves = timed(
        "module_linear_qp", phase_module_linear_qp, torch, dev, smi,
        refs.get("module_linear_qp"))
    refs.replay("module_linear_qp", [row["start"] for row in qp_solves])
    by_path["module_mhe"] = timed("module_mhe", phase_module_mhe, torch,
                                  dev, smi, refs.get("module_mhe"))
    by_path["module_minlp_cia"], cia_run = timed(
        "module_minlp_cia", phase_module_minlp, torch, dev, smi, "jax_cia",
        refs.get("module_minlp_cia"))
    refs.replay("module_minlp_cia",
                [row["start"] for row in cia_run["solves"]])
    by_path["module_minlp_bb"], _ = timed(
        "module_minlp_bb", phase_module_minlp, torch, dev, smi,
        "jax_minlp_bb")
    by_path["module_admm"] = timed("module_admm", phase_module_admm, torch,
                                   dev, smi, refs.get("module_admm"))
    by_path["module_admm_rt"] = timed("module_admm_rt",
                                      phase_module_admm_rt, torch, dev, smi)
    by_path["module_admm_coord"] = timed(
        "module_admm_coord", phase_module_admm_coord, torch, dev, smi,
        refs.get("module_admm_coord"))
    by_path["module_admm_exchange"] = timed(
        "module_admm_exchange", phase_module_admm_exchange, torch, dev, smi,
        refs.get("module_admm_exchange"))
    by_path["module_ml_mpc"] = timed(
        "module_ml_mpc", phase_module_ml_mpc, torch, dev, smi,
        refs.get("module_ml_mpc"))
    by_path["module_ml_admm"] = timed(
        "module_ml_admm", phase_module_ml_admm, torch, dev, smi,
        refs.get("module_ml_admm"))
    fleet_cores = sorted(set(cores["card_process"])
                         | set(cores["cpu_subprocesses"]))
    by_path["module_fleet_mqtt"] = timed(
        "module_fleet_mqtt", phase_module_fleet_mqtt, torch, dev, smi,
        fleet_cores)
    by_path["module_fleet_mp"] = timed(
        "module_fleet_mp", phase_module_fleet_mp, torch, dev, smi,
        fleet_cores)
    timed("module_minlp_cia_replay", phase_cia_replay, cia_run,
          refs.get("replay:module_minlp_cia"))
    timed("module_linear_qp_replay", phase_linear_qp_replay, qp_solves,
          refs.get("replay:module_linear_qp"))
    new_shapes = timed("path_shapes", phase_path_shapes, torch, dev,
                       by_path)
    for k in kernels:
        k["launches_by_path"] = {path: totals[k["name"]]
                                 for path, totals in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        for path, n in k["launches_by_path"].items():
            check(n > 0, f"{k['name']} never launched on the {path} path")
        k["stage_shapes"] = stage_rows[k["name"]]
        k["path_shapes"] = [r for r in new_shapes if r["kernel"] == k["name"]]
    emit({"phase": "summary", "wall_seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds, "cores": cores,
          "device_ms_from_events": DEVICE_MS_FROM_EVENTS})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
