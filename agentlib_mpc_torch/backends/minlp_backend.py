"""Mixed-integer MPC backends: relaxed NLP + rounding / CIA + fixed re-solve.

Port of ``agentlib_mpc_tpu/backends/minlp_backend.py``, counterparts of
the reference's MINLP backends:
- ``jax_minlp`` ↔ ``casadi_minlp`` (``optimization_backends/casadi_/
  minlp.py:16-199``): the schedule is obtained by rounding the relaxed
  optimum and re-solving with the binaries fixed.
- ``jax_cia`` ↔ ``casadi_cia`` (``casadi_/minlp_cia.py:75-171``): the
  3-phase combinatorial-integer-approximation scheme — relaxed NLP →
  branch-and-bound CIA (host C++, ``ops/cia.py`` replacing pycombina) →
  NLP with the binary schedule fixed.
- ``jax_minlp_bb``: exact best-first branch-and-bound over binary fixings
  (the Bonmin role), each sweep's child relaxations solved as ONE batched
  interior-point call.

Two programs, not one with degenerate bounds: the relaxed phase
transcribes binaries as ordinary [0,1] controls; the fixed phase is a
*separate* transcription in which the binaries are exogenous inputs — the
schedule rides the ``d_traj`` parameter, so the log-barrier never sees a
(near-)zero-width box. Where the JAX package compiles each with
``jax.jit`` (and the node program with ``jax.jit(jax.vmap(...))``), the
port runs them as plain functions on tensors on the backend's device.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Any

import numpy as np
import torch

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.backends.backend import (
    VariableReference,
    register_backend,
)
from agentlib_mpc_torch.backends.mpc_backend import (
    JAXBackend,
    attach_derivative_plan,
    attach_stage_partition,
    solver_options_from_config,
    transcription_kwargs_from_config,
)
from agentlib_mpc_torch.ops.cia import cia_objective, solve_cia, sum_up_rounding
from agentlib_mpc_torch.ops.solver import solve_nlp, solve_nlp_batched
from agentlib_mpc_torch.ops.transcription import OCPParams, transcribe


@register_backend("jax_minlp", "casadi_minlp")
class MINLPBackend(JAXBackend):
    """Relaxed solve + binary schedule + fixed solve.

    Config additions:
        binary_method: "rounding" (default) | "sur" | "cia"
        cia_options: {"max_switches": int | [int...], "sos1": bool,
                      "max_nodes": int}
    """

    default_binary_method = "rounding"

    def setup_optimization(self, var_ref: VariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        self.binary_names = list(var_ref.binary_controls)
        if not self.binary_names:
            raise ValueError(
                "MINLP backend configured without binary_controls; use the "
                "'jax' backend for purely continuous problems")
        merged = dataclasses.replace(
            var_ref,
            controls=list(var_ref.controls) + self.binary_names,
            binary_controls=[],
        )
        super().setup_optimization(merged, time_step, prediction_horizon)
        self._bin_idx = np.array(
            [merged.controls.index(n) for n in self.binary_names])
        self._cont_names = list(var_ref.controls)
        self._method = self.config.get(
            "binary_method", self.default_binary_method)
        self._cia_options = dict(self.config.get("cia_options", {}))
        self._build_fixed_program(var_ref)

    def _build_fixed_program(self, var_ref: VariableReference) -> None:
        """Second transcription: binaries as exogenous inputs."""
        kw = transcription_kwargs_from_config(
            self.config.get("discretization_options"))
        self.ocp_fixed = transcribe(self.model, self._cont_names, N=self.N,
                                    dt=self.time_step, **kw)
        # schedule-tracking phase: binaries are data, so what matters is
        # feasibility + complementarity; the f32 stationarity floor scales
        # with the (large) comfort-slack gradient when the fixed schedule
        # forces a violation, so the stall-acceptance dual tolerance is wide
        fixed_solver_cfg = {"dual_inf_tol": 100.0, "compl_inf_tol": 1e-2,
                            **dict(self.config.get("solver", {}) or {}),
                            **dict(self.config.get("fixed_solver", {}) or {})}
        self._fixed_options = attach_derivative_plan(
            attach_stage_partition(
                solver_options_from_config(fixed_solver_cfg),
                self.ocp_fixed),
            self.ocp_fixed, logger=self.logger,
            label="the fixed-binaries MINLP OCP", device=self.device)
        # exo vector of the fixed program = binaries ∪ relaxed program's exo;
        # map both into its declaration order
        fixed_exo = list(self.ocp_fixed.exo_names)
        self._fixed_bin_cols = np.array(
            [fixed_exo.index(n) for n in self.binary_names])
        self._fixed_exo_cols = np.array(
            [fixed_exo.index(n) for n in self._exo_names], dtype=int) \
            if self._exo_names else np.zeros(0, dtype=int)
        self._cont_idx = np.array(
            [self.var_ref.controls.index(n) for n in self._cont_names],
            dtype=int)
        ocp = self.ocp_fixed
        opts = self._fixed_options
        theta0 = ocp.default_params(device=self.device, dtype=self.dtype)
        n_cont = len(self._cont_names)

        def step_fixed(x0, u_prev_c, d_traj_fixed, p, x_lb, x_ub,
                       u_lb_c, u_ub_c, mu0, t0):
            theta = theta0._replace(
                x0=x0, u_prev=u_prev_c, d_traj=d_traj_fixed, p=p,
                x_lb=x_lb, x_ub=x_ub, u_lb=u_lb_c, u_ub=u_ub_c, t0=t0)
            lb, ub = ocp.bounds(theta)
            # fresh guess every solve: the schedule changes step to step, and
            # empirically the program's own guess (x ≡ x0) converges in a few
            # iterations where a rebased relaxed optimum stalls in f32
            res = solve_nlp(ocp.nlp, ocp.initial_guess(theta), theta, lb, ub,
                            opts, mu0=mu0)
            traj = ocp.trajectories(res.w, theta)
            u0_c = (torch.clamp(traj["u"][0], theta.u_lb[0], theta.u_ub[0])
                    if n_cont else traj["u"].new_zeros((0,)))
            return u0_c, traj, res.stats

        self._step_fixed = step_fixed

    def trajectory_layout(self) -> dict[str, list[str]]:
        """The returned ``traj`` comes from the *fixed* phase-3 program, so
        its "u" columns are the continuous controls only (binaries ride in
        ``binary_schedule``)."""
        layout = super().trajectory_layout()
        layout["u"] = list(self.ocp_fixed.control_names)
        return layout

    # -- binary scheduling (host side, between the two device solves) ---------

    def _binary_schedule(self, b_rel: np.ndarray) -> tuple[np.ndarray, float]:
        dt = np.full(len(b_rel), self.time_step)
        if self._method == "rounding":
            B = np.round(np.clip(b_rel, 0.0, 1.0))
            return B, cia_objective(b_rel, B, dt)
        if self._method == "sur":
            B = sum_up_rounding(b_rel, dt,
                                sos1=bool(self._cia_options.get("sos1")))
            return B, cia_objective(b_rel, B, dt)
        if self._method == "cia":
            ms = self._cia_options.get("max_switches")
            if isinstance(ms, int):
                ms = [ms] * len(self.binary_names)
            return solve_cia(
                b_rel, self.time_step, max_switches=ms,
                sos1=bool(self._cia_options.get("sos1")),
                max_nodes=int(self._cia_options.get("max_nodes", 2_000_000)))
        raise ValueError(f"unknown binary_method {self._method!r}")

    # -- three-phase solve ----------------------------------------------------

    def _tensors(self, *arrays):
        return [torch.as_tensor(a, dtype=self.dtype, device=self.device)
                for a in arrays]

    def _solve_fixed(self, B: np.ndarray, ctx: dict) -> tuple:
        """Phase-3 solve for one binary schedule ``B`` (N, n_bin): binaries
        ride as exogenous data of the fixed program. Returns
        ``(u0_c, traj, stats)``; ``stats.objective`` is the TRUE objective
        of the schedule (no relaxation box involved), which is what the
        branch-and-bound backend uses to score incumbents."""
        ci = self._cont_idx
        n_fixed_exo = len(self.ocp_fixed.exo_names)
        d_fixed = np.zeros((self.N, n_fixed_exo))
        d_fixed[:, self._fixed_bin_cols] = B
        if len(self._fixed_exo_cols):
            d_fixed[:, self._fixed_exo_cols] = ctx["d_traj"]
        args = self._tensors(
            ctx["x0"], ctx["u_prev"][ci] if len(ci) else np.zeros(0),
            d_fixed, ctx["p"], ctx["x_lb"], ctx["x_ub"],
            ctx["u_lb"][:, ci], ctx["u_ub"][:, ci])
        t_now, = self._tensors(ctx["t_now"])
        return self._step_fixed(*args, self.solver_options.mu_init, t_now)

    def _schedule(self, b_rel: np.ndarray, ctx: dict) -> tuple:
        """Phase 2: turn the relaxed binary trajectories into a {0,1}
        schedule. The base class runs the configured combinatorial
        heuristic; :class:`BranchAndBoundBackend` overrides this with an
        exact tree search. Must respect ``ctx['b_min']``/``ctx['b_max']``
        (bound lock-outs)."""
        B, eta = self._binary_schedule(b_rel)
        return np.clip(B, ctx["b_min"], ctx["b_max"]), eta

    def solve(self, now: float, variables: dict[str, Any]) -> dict:
        x0, u_prev, d_traj, p, x_lb, x_ub, u_lb, u_ub = \
            self._collect(now, variables)
        bi = self._bin_idx
        # relaxed box = externally supplied bound trajectories intersected
        # with [0,1] — a published ``on__ub = 0`` (lock-out) must carry
        # through to the schedule (reference pins binaries via bounds,
        # ``minlp_cia.py:152-171``)
        u_lb = u_lb.copy()
        u_ub = u_ub.copy()
        u_lb[:, bi] = np.clip(u_lb[:, bi], 0.0, 1.0)
        u_ub[:, bi] = np.clip(u_ub[:, bi], 0.0, 1.0)
        mu0 = self.solver_options.mu_init if self._cold else 1e-2
        t_now = float(now)
        t_start = _time.perf_counter()

        # phase 1: relaxed NLP
        with telemetry.span("backend.solve", backend=type(self).__name__,
                            instance=f"{id(self):x}",
                            phase="relaxed"):
            _, traj_rel, w_next, y_next, z_next, stats_rel = self._step(
                *self._tensors(x0, u_prev, d_traj, p, x_lb, x_ub, u_lb,
                               u_ub),
                self._w_guess, self._y_guess, self._z_guess, mu0,
                *self._tensors(t_now))
            traj_rel = {k: v.detach().cpu().numpy()
                        for k, v in traj_rel.items()}
            b_rel = traj_rel["u"][:, bi]

        # phase 2: binary schedule, clamped to the binary values the bound
        # trajectories actually admit (an interval with ub < 1 cannot
        # switch on; lb > 0 cannot switch off)
        eps = 1e-9
        ctx = {
            "x0": x0, "u_prev": u_prev, "d_traj": d_traj, "p": p,
            "x_lb": x_lb, "x_ub": x_ub, "u_lb": u_lb, "u_ub": u_ub,
            "t_now": t_now,
            "b_min": (u_lb[:, bi] > eps).astype(float),
            "b_max": (u_ub[:, bi] >= 1.0 - eps).astype(float),
            "root_objective": float(stats_rel.objective),
            "root_success": bool(stats_rel.success),
            "root_kkt": float(stats_rel.kkt_error),
        }
        self._schedule_stats = {}
        B, eta = self._schedule(b_rel, ctx)

        # phase 3: binaries enter as exogenous data of the fixed program
        ci = self._cont_idx
        with telemetry.span("backend.solve", backend=type(self).__name__,
                            instance=f"{id(self):x}",
                            phase="fixed"):
            u0_c, traj, stats = self._solve_fixed(B, ctx)
            u0_c = u0_c.cpu().numpy()
        wall = _time.perf_counter() - t_start

        # warm-start bookkeeping rides the relaxed program; the shared
        # guard resets on non-finite iterates (duals included) instead
        # of poisoning the next step
        self._carry_warm_start(w_next, y_next, z_next, now=now)

        # assemble the actuation vector in merged-control order
        u0 = np.zeros(len(self.var_ref.controls))
        if len(ci):
            u0[ci] = u0_c
        u0[bi] = B[0]
        stats_row = self.solver_stats_row(
            stats, now, wall,
            iterations=int(stats_rel.iterations) + int(stats.iterations),
            cia_objective=float(eta),
            relaxed_objective=float(stats_rel.objective),
            relaxed_success=bool(stats_rel.success),
            relaxed_iterations=int(stats_rel.iterations),
            fixed_iterations=int(stats.iterations),
            **self._schedule_stats,
        )
        self._record_solve(stats_row)
        return {
            "u0": {n: float(u0[i])
                   for i, n in enumerate(self.var_ref.controls)},
            "traj": {k: v.detach().cpu().numpy() for k, v in traj.items()},
            "traj_relaxed": traj_rel,
            "binary_schedule": B,
            "stats": stats_row,
        }


@register_backend("jax_cia", "casadi_cia")
class CIABackend(MINLPBackend):
    """MINLP backend defaulting to the branch-and-bound CIA schedule."""

    default_binary_method = "cia"


@register_backend("jax_minlp_bb")
class BranchAndBoundBackend(MINLPBackend):
    """Exact MINLP via best-first branch-and-bound over binary fixings —
    the equivalent of the reference's Bonmin solve
    (``data_structures/casadi_utils.py:264-280``).

    Where Bonmin walks the tree sequentially with one NLP per node, here
    the frontier's children are relaxed in ONE batched interior-point
    call per sweep (``batch_pairs`` nodes → ``2·batch_pairs`` child
    relaxations, padded to that fixed batch). Node fixings enter as
    narrow bound boxes on the relaxed program — fixed-to-1 means
    ``[1−δ, 1]``, fixed-to-0 means ``[0, δ]`` — so the log-barrier always
    has an interior and every node solves the SAME program. Because a
    binary point of the subtree lies inside its δ-box, each node's
    relaxation objective is a valid lower bound for the subtree — up to
    the error the node solve actually achieved, so every node bound is
    deflated by its own achieved KKT error, floored at ``tol``, before it
    is used for pruning. ``bb_proven_optimal`` is therefore rigorous
    relative to the deflated bounds. Incumbents are scored EXACTLY by the
    phase-3 fixed program (binaries as data, no box), so the returned
    schedule's objective is the true mixed-integer objective.

    The search starts from the configured combinatorial heuristic
    (``binary_method``: rounding/sur/cia) as the initial incumbent, so it
    can only improve on the heuristic backends. The node budget
    (``bb_options.max_nodes``) bounds wall time; on exhaustion the best
    incumbent so far is returned (anytime behaviour, like Bonmin's
    iteration limits).

    Config additions::

        bb_options: {
          "max_nodes": 256,     # explored-node budget (anytime cutoff)
          "batch_pairs": 8,     # frontier nodes expanded per batched sweep
          "box_width": 1e-3,    # δ of the fixing boxes
          "gap_tol": 1e-6,      # absolute optimality gap for pruning
          "int_tol": 1e-3,      # integrality tolerance on relaxed binaries
        }
    """

    def setup_optimization(self, var_ref: VariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        super().setup_optimization(var_ref, time_step, prediction_horizon)
        self._bb = dict(self.config.get("bb_options", {}))
        self._batch_pairs = int(self._bb.get("batch_pairs", 8))

    def _node_thetas(self, node_bounds, ctx: dict) -> list[OCPParams]:
        """The relaxed program's parameters of each node."""
        x0, u_prev, d_traj, p, x_lb, x_ub = self._tensors(
            ctx["x0"], ctx["u_prev"], ctx["d_traj"], ctx["p"], ctx["x_lb"],
            ctx["x_ub"])
        t_now, = self._tensors(ctx["t_now"])
        base = self._theta0._replace(x0=x0, u_prev=u_prev, d_traj=d_traj,
                                     p=p, x_lb=x_lb, x_ub=x_ub, t0=t_now)
        return [base._replace(u_lb=u_lb, u_ub=u_ub)
                for u_lb, u_ub in (self._tensors(*b) for b in node_bounds)]

    def _solve_nodes(self, node_bounds, ctx: dict):
        """Relax every node of ``node_bounds`` (a list of (u_lb, u_ub)) in
        one batched interior-point call from the program's own guess.
        Returns the batch's control trajectories (B, N, n_u) and stats."""
        ocp = self.ocp
        lanes = self._node_thetas(node_bounds, ctx)
        theta = OCPParams(*(torch.stack(leaves) for leaves in zip(*lanes)))
        w0 = torch.stack([ocp.initial_guess(th) for th in lanes])
        lb, ub = (torch.stack(b) for b in zip(*(ocp.bounds(th)
                                                for th in lanes)))
        res = solve_nlp_batched(ocp.nlp, w0, theta, lb, ub,
                                self.solver_options,
                                mu0=self.solver_options.mu_init)
        return ocp.unflatten(res.w)["u"], res.stats

    # -- tree search ----------------------------------------------------------

    def _node_bounds(self, lo: np.ndarray, hi: np.ndarray,
                     ctx: dict, delta: float):
        """Control-bound trajectories for a node fixing. ``lo``/``hi`` are
        (N, n_bin) in {0,1}: (0,1)=free, (0,0)=fixed 0, (1,1)=fixed 1.
        Returns (u_lb, u_ub) or None when the box is empty (a fixing that
        contradicts an external lock-out)."""
        bi = self._bin_idx
        u_lb = ctx["u_lb"].copy()
        u_ub = ctx["u_ub"].copy()
        u_lb[:, bi] = np.maximum(u_lb[:, bi],
                                 np.where(lo == 1, 1.0 - delta, 0.0))
        u_ub[:, bi] = np.minimum(u_ub[:, bi],
                                 np.where(hi == 0, delta, 1.0))
        if np.any(u_lb[:, bi] > u_ub[:, bi] + 1e-12):
            return None
        return u_lb, u_ub

    def _exact_objective(self, B: np.ndarray, ctx: dict) -> float:
        _, _, stats = self._solve_fixed(B, ctx)
        return (float(stats.objective) if bool(stats.success)
                else float("inf"))

    def _schedule(self, b_rel: np.ndarray, ctx: dict) -> tuple:
        import heapq
        import itertools

        delta = float(self._bb.get("box_width", 1e-3))
        gap = float(self._bb.get("gap_tol", 1e-6))
        int_tol = float(self._bb.get("int_tol", 1e-3))
        # an inexactly-converged node objective is only a lower bound up
        # to the error the node ACHIEVED — which under the solver's
        # "acceptable" exit can sit far above the nominal tol. Deflate
        # every bound by its own achieved KKT error (floored at tol) so
        # pruning and the optimality certificate never rest on unearned
        # digits.
        tol = float(self.solver_options.tol)

        def node_slack(kkt: float) -> float:
            return max(tol, kkt) if np.isfinite(kkt) else np.inf
        max_nodes = int(self._bb.get("max_nodes", 256))
        dt_vec = np.full(len(b_rel), self.time_step)
        counter = itertools.count()

        # exact incumbent scoring is one phase-3 device solve per DISTINCT
        # schedule: many near-integral nodes round to the same B, so a
        # memo keeps the per-sweep device traffic bounded, and every
        # unique exact solve counts toward the node budget (the class
        # docstring's anytime guarantee)
        exact_memo: dict[bytes, float] = {}

        def exact(B: np.ndarray) -> float:
            nonlocal explored
            key = np.ascontiguousarray(B).tobytes()
            if key not in exact_memo:
                exact_memo[key] = self._exact_objective(B, ctx)
                explored += 1
            return exact_memo[key]

        # initial incumbent: the heuristic schedule, scored exactly — the
        # search can only improve on the rounding/SUR/CIA backends
        explored = 1          # the root relaxation (phase 1) counts
        B_heur, _ = self._binary_schedule(b_rel)
        B_heur = np.clip(B_heur, ctx["b_min"], ctx["b_max"])
        inc_obj = exact(B_heur)
        heur_obj = inc_obj
        inc_B = B_heur

        def sanitize(brel, lo, hi):
            """A diverged relaxation can carry NaN trajectories; NaN
            defeats the leaf check AND the free-entry mask (NaN·0 = NaN),
            which would let argmax branch on an already-fixed entry.
            Replace non-finite entries by a neutral fractional guess on
            free entries and by the fixing elsewhere."""
            if np.all(np.isfinite(brel)):
                return brel
            free = (lo == 0) & (hi == 1)
            return np.where(np.isfinite(brel), brel,
                            np.where(free, 0.5, lo))

        lo0 = np.zeros_like(b_rel)
        hi0 = np.ones_like(b_rel)
        root_bound = (ctx["root_objective"] - node_slack(ctx["root_kkt"])
                      if ctx["root_success"] else -np.inf)
        heap = [(root_bound, next(counter), lo0, hi0,
                 sanitize(b_rel, lo0, hi0))]
        best_open = root_bound

        def try_incumbent(brel_node, lo, hi):
            nonlocal inc_obj, inc_B
            B = np.round(np.clip(brel_node, 0.0, 1.0))
            B = np.clip(np.clip(B, lo, hi), ctx["b_min"], ctx["b_max"])
            obj = exact(B)
            if obj < inc_obj:
                inc_obj, inc_B = obj, B

        sweeps = 0
        while heap and explored < max_nodes:
            best_open = heap[0][0]
            if best_open >= inc_obj - gap:
                break  # optimality proven within gap
            # pop a frontier batch, branch each node on its most
            # fractional free entry
            children = []
            while heap and len(children) < 2 * self._batch_pairs:
                bound, _, lo, hi, brel = heapq.heappop(heap)
                if bound >= inc_obj - gap:
                    continue
                free = (lo == 0) & (hi == 1)
                frac = np.abs(brel - np.round(brel)) * free
                if frac.max() <= int_tol:
                    # relaxation optimum is (essentially) binary → the
                    # bound is attained by a feasible point: leaf
                    try_incumbent(brel, lo, hi)
                    continue
                k, j = np.unravel_index(np.argmax(frac), frac.shape)
                for fix in (0.0, 1.0):
                    lo_c, hi_c = lo.copy(), hi.copy()
                    lo_c[k, j] = hi_c[k, j] = fix
                    children.append((bound, lo_c, hi_c))
            if not children:
                continue

            # batched child relaxations: pad to the fixed batch size
            node_bounds, meta = [], []
            for parent_bound, lo_c, hi_c in children:
                bounds = self._node_bounds(lo_c, hi_c, ctx, delta)
                if bounds is None:
                    continue  # fixing contradicts a lock-out
                node_bounds.append(bounds)
                meta.append((parent_bound, lo_c, hi_c))
            if not node_bounds:
                continue
            n_real = len(node_bounds)
            pad = 2 * self._batch_pairs - n_real
            node_bounds += [node_bounds[0]] * pad
            # sequential by construction: each wave's nodes depend on the
            # previous wave's bounds, and the wave itself is one batched
            # solve
            u_batch, stats = self._solve_nodes(node_bounds, ctx)
            sweeps += 1
            u_host = u_batch.detach().cpu().numpy()[:n_real]
            objs = stats.objective.detach().cpu().numpy()[:n_real]
            oks = stats.success.detach().cpu().numpy()[:n_real]
            kkts = stats.kkt_error.detach().cpu().numpy()[:n_real]
            explored += n_real

            for i, (parent_bound, lo_c, hi_c) in enumerate(meta):
                brel_c = sanitize(u_host[i][:, self._bin_idx], lo_c, hi_c)
                # bounds are monotone down the tree; a failed child solve
                # cannot tighten the parent's bound
                bound_c = (max(parent_bound,
                               float(objs[i]) - node_slack(float(kkts[i])))
                           if oks[i] else parent_bound)
                if bound_c >= inc_obj - gap:
                    continue  # prune
                free = (lo_c == 0) & (hi_c == 1)
                frac = np.abs(brel_c - np.round(brel_c)) * free
                if frac.max() <= int_tol:
                    try_incumbent(brel_c, lo_c, hi_c)
                    continue
                heapq.heappush(
                    heap, (bound_c, next(counter), lo_c, hi_c, brel_c))

        best_open = heap[0][0] if heap else inc_obj
        self._schedule_stats = {
            "bb_nodes": explored,
            "bb_sweeps": sweeps,
            "bb_heuristic": heur_obj,
            "bb_incumbent": inc_obj,
            "bb_bound": min(best_open, inc_obj),
            "bb_gap": max(0.0, inc_obj - best_open) if heap else 0.0,
            "bb_proven_optimal": not heap or best_open >= inc_obj - gap,
            "bb_improved_on_heuristic": inc_obj < heur_obj - gap,
        }
        return inc_B, cia_objective(b_rel, inc_B, dt_vec)
