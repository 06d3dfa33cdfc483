"""ScenarioFleet: the fused robust-MPC round over (agents × scenarios).

Port of ``agentlib_mpc_tpu/scenario/fleet.py`` on one device. Each agent
solves its interior-point problem for S disturbance branches; two
couplings join the solutions per ADMM iteration:

* **agents**: the consensus update of every coupling alias, per scenario
  (``z̄`` is (S, T), one mean per scenario shared by all agents);
* **scenarios**: non-anticipativity, consensus-ADMM onto the mean of each
  tree node group (:meth:`ScenarioTree.groups_at`) with multipliers per
  (agent, scenario). The actuated ``u0`` is the projected group mean, so
  it is identical across a group's branches by construction.

The JAX package runs the round as one ``lax.while_loop`` over a double
``vmap`` (scenarios inside, agents outside). Here the (agent, scenario)
pairs are ``n_agents·S`` lanes of ONE batched solve
(``solve_nlp_batched``), agent-major: lane ``a·S + s`` is agent ``a``'s
branch ``s`` (:meth:`ScenarioFleet.lane_of` and the ``_lanes`` /
``_unlanes`` reshapes are the one place that mapping lives). The state and
the statistics keep the JAX package's (n_agents, S, ...) layout, so
quarantine counts blame the (agent, scenario) pair. The iteration loop is
a Python loop that reads the Boyd exit once per iteration, like the
port's ``FusedADMM``: the cold iteration runs the group's full budget and
barrier, the warm ones ``warm_budget`` and ``warm_mu``, and the
non-anticipativity penalty is 0 on iteration 0 (no projection target
yet). The group-mean projection runs with TF32 off (the JAX package's
``Precision.HIGHEST``).

Deferred, as in the port's ``FusedADMM``: ``mesh=``,
``watchdog_timeout_s=``, ``warmstart=`` and :meth:`ScenarioFleet.
shard_args` raise ``NotImplementedError`` naming ROADMAP Queue 1 item 5
(multi-GPU, serving and resilience); a certificate mode ``"require"``
names item 7 (certifiers); ``"auto"`` and ``"off"`` are accepted and
certify nothing on one device. Device-memory telemetry waits for item 6.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch
from torch.func import vmap
from torch.profiler import record_function
from torch.utils._pytree import tree_leaves, tree_map

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.ops import admm as admm_ops
from agentlib_mpc_torch.ops.admm import AdmmResiduals, consensus_penalty
from agentlib_mpc_torch.ops.solver import (
    NLPFunctions,
    _resolve_precision,
    _true_f32_matmul,
    solve_nlp,
    solve_nlp_batched,
)
from agentlib_mpc_torch.scenario.tree import ScenarioTree
from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "ScenarioFleet",
    "ScenarioFleetOptions",
    "ScenarioState",
    "ScenarioStats",
    "pad_scenarios",
    "solve_nlp_scenarios",
]

_CERTIFY_MODES = ("auto", "require", "off")
#: dtype of the build-time templates the derivative-plan certifier traces
#: (the port's ``FusedADMM`` convention)
_TEMPLATE_DTYPE = torch.float64


def solve_nlp_scenarios(nlp, w0_batch, theta_batch, lb_batch, ub_batch,
                        options, tree: "ScenarioTree | None" = None,
                        y0_batch=None, z0_batch=None):
    """S independent per-branch solves as one scenario-batched call
    (leading axis S on every tensor and theta leaf). An S=1 batch calls
    :func:`~agentlib_mpc_torch.ops.solver.solve_nlp` unwrapped; S > 1 is
    the batched solve the fleet uses."""
    S = int(w0_batch.shape[0])
    if tree is not None and tree.n_scenarios != S:
        raise ValueError(
            f"w0_batch carries {S} scenarios, tree has "
            f"{tree.n_scenarios}")
    if S == 1:
        row = lambda leaf: None if leaf is None else leaf[0]
        res = solve_nlp(nlp, w0_batch[0],
                        tree_map(lambda leaf: leaf[0], theta_batch),
                        lb_batch[0], ub_batch[0], options,
                        y0=row(y0_batch), z0=row(z0_batch))
        dev = w0_batch.device
        return tree_map(lambda leaf: torch.as_tensor(leaf, device=dev)[None],
                        res)
    return solve_nlp_batched(nlp, w0_batch, theta_batch, lb_batch, ub_batch,
                             options, y0=y0_batch, z0=z0_batch)


class ScenarioFleetOptions(NamedTuple):
    max_iterations: int = 20
    #: consensus penalty of the agent couplings (one value for every alias)
    rho: float = 10.0
    #: non-anticipativity penalty over the scenario groups
    rho_na: float = 10.0
    #: Boyd relative-tolerance exit (as FusedADMMOptions)
    abs_tol: float = 1e-3
    rel_tol: float = 1e-2
    use_relative_tolerances: bool = True
    primal_tol: float = 1e-3
    dual_tol: float = 1e-3
    #: inner interior-point budget of the warm iterations (iteration 0 runs
    #: the group's full cold budget)
    warm_budget: int = 6
    #: initial barrier of the warm iterations
    warm_mu: float = 1e-2
    #: replace a non-finite (agent, scenario) branch solution by its
    #: previous iterate so it cannot poison a consensus or group mean
    quarantine: bool = True
    #: consecutive quarantined iterations before a branch's warm start is
    #: reset to the (sanitized) OCP initial guess
    quarantine_reset_after: int = 3


class ScenarioState(NamedTuple):
    """Carried between control steps (the robust warm-start memory)."""

    zbar: dict              # alias -> (S, T) per-scenario consensus means
    lam: dict               # alias -> (n_agents, S, T) multipliers
    nu: torch.Tensor        # (n_agents, S, R, n_u) non-anticipativity mult.
    na_target: torch.Tensor  # (n_agents, S, R, n_u) last group-mean proj.
    w: torch.Tensor         # (n_agents, S, n_w) primal warm starts
    y: torch.Tensor         # (n_agents, S, n_g)
    z: torch.Tensor         # (n_agents, S, n_h)


class ScenarioStats(NamedTuple):
    iterations: torch.Tensor          # ()
    primal_residuals: torch.Tensor    # (max_iter,) NaN-padded
    dual_residuals: torch.Tensor
    converged: torch.Tensor           # () bool
    local_solves_ok: torch.Tensor     # () bool
    #: final non-anticipativity primal residual: how far the branch
    #: controls sit from their group projection (0 without coupling)
    na_spread: torch.Tensor           # ()
    #: (n_agents, S) int32: in how many of the round's iterations each
    #: (agent, scenario) branch was quarantined; None with quarantine off
    lane_quarantined: "torch.Tensor | None" = None


class ScenarioFleet:
    """Robust-MPC round: one structure group × S disturbance scenarios on
    one device. Build once per (group structure, tree); call :meth:`step`
    once per control step with an (n_agents, S)-leading theta batch."""

    def __init__(self, group, tree: ScenarioTree,
                 options: ScenarioFleetOptions = ScenarioFleetOptions(),
                 active=None, mesh=None,
                 collective_certify: str = "auto",
                 memory_certify: str = "auto",
                 dispatch_certify: str = "auto",
                 precision_certify: str = "auto",
                 watchdog_timeout_s: "float | None" = None,
                 warmstart=None, device=None):
        """``group``: an :class:`~agentlib_mpc_torch.parallel.fused_admm.
        AgentGroup` with consensus couplings only. ``tree``: the static
        scenario tree; one scenario builds the degenerate engine with no
        non-anticipativity terms. ``device``: where the engine runs (None:
        the card); a round runs in the dtype of its theta batch. ``mesh``,
        ``watchdog_timeout_s``, ``warmstart`` and the certificate modes
        ``"require"`` are not ported (``NotImplementedError``; module
        docstring)."""
        from agentlib_mpc_torch.parallel.fused_admm import FusedADMM

        if group.exchanges:
            raise ValueError(
                "ScenarioFleet lifts consensus couplings only; "
                f"group {group.name!r} declares exchanges "
                f"{sorted(group.exchanges)}")
        modes = {"collective_certify": collective_certify,
                 "memory_certify": memory_certify,
                 "dispatch_certify": dispatch_certify,
                 "precision_certify": precision_certify}
        for name, mode in modes.items():
            if mode not in _CERTIFY_MODES:
                raise ValueError(
                    f"{name} must be 'auto', 'require' or 'off', got "
                    f"{mode!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (the sharded (agents x scenarios) round) is not "
                "ported yet (ROADMAP Queue 1 item 5: multi-GPU)")
        if watchdog_timeout_s is not None:
            raise NotImplementedError(
                "watchdog_timeout_s= (the collective watchdog) is not "
                "ported yet (ROADMAP Queue 1 item 5: multi-GPU)")
        if warmstart is not None:
            raise NotImplementedError(
                "warmstart= (learned warm starts) is not ported yet "
                "(ROADMAP Queue 1 item 5)")
        required = sorted(k for k, v in modes.items() if v == "require")
        if required:
            raise NotImplementedError(
                f"{', '.join(required)}='require' needs the jaxpr "
                f"certifiers, which are not ported yet (ROADMAP Queue 1 "
                f"item 7)")
        for o in (group.solver_options, group.warm_solver_options):
            if o is None:
                continue
            if o.fusion == "require":
                raise NotImplementedError(
                    f"group {group.name!r}: SolverOptions.fusion='require' "
                    f"needs the fusion certifier, which is not ported yet "
                    f"(ROADMAP Queue 1 item 7)")
            _resolve_precision(o)
        self.device = resolve_device(device)
        self.group = FusedADMM._with_stage_partition(group)
        self.tree = tree.validate(group.ocp.N)
        self.options = options
        self.T = group.ocp.N
        self.n_u = len(group.ocp.control_names)
        self.S = tree.n_scenarios
        self.R = tree.robust_horizon if self.S > 1 else 0
        self._aliases = sorted(group.couplings)
        if active is None:
            active = torch.ones((group.n_agents,), dtype=torch.bool)
        self.active = torch.as_tensor(active, device=self.device).to(
            torch.bool)
        if tuple(self.active.shape) != (group.n_agents,):
            raise ValueError(
                f"active mask has shape {tuple(self.active.shape)}, "
                f"expected ({group.n_agents},)")
        self._membership, self._counts = self._build_membership()
        self._scen_weight = torch.tensor(
            self.tree.probabilities, dtype=torch.float64,
            device=self.device) * float(self.S)
        self._step_fn = self._build_step()
        if telemetry.enabled():
            telemetry.gauge(
                "scenario_count",
                "disturbance scenarios batched per agent in the "
                "scenario fleet").set(float(self.S))

    # -- static layout --------------------------------------------------------

    def _build_membership(self):
        """(S, R, G) one-hot node membership and (R, G) group sizes, float64
        on the engine's device (cast to a round's dtype where used)."""
        R, S = self.R, self.S
        kw = {"dtype": torch.float64, "device": self.device}
        if R == 0:
            return torch.zeros((S, 0, 1), **kw), torch.ones((0, 1), **kw)
        G = max(len(self.tree.groups_at(t)) for t in range(R))
        M = torch.zeros((S, R, G), **kw)
        counts = torch.ones((R, G), **kw)
        for t in range(R):
            node_ids = sorted(set(self.tree.node_of[t]))
            slot_of = {n: g for g, n in enumerate(node_ids)}
            for s, node in enumerate(self.tree.node_of[t]):
                M[s, t, slot_of[node]] = 1.0
            for g, grp in enumerate(self.tree.groups_at(t)):
                counts[t, g] = float(len(grp))
        return M, counts

    def lane_of(self, agent: int, scenario: int) -> int:
        """The batched solve's lane of (agent, scenario): agent-major."""
        return agent * self.S + scenario

    def _lanes(self, t: torch.Tensor) -> torch.Tensor:
        """(n_agents, S, ...) → (n_agents·S, ...) in :meth:`lane_of`
        order."""
        return t.reshape((self.group.n_agents * self.S,)
                         + tuple(t.shape[2:]))

    def _unlanes(self, t: torch.Tensor) -> torch.Tensor:
        """(n_agents·S, ...) → (n_agents, S, ...)."""
        return t.reshape((self.group.n_agents, self.S) + tuple(t.shape[1:]))

    # -- state ----------------------------------------------------------------

    def init_state(self, theta_batch) -> ScenarioState:
        """Fresh state for an (n_agents, S)-leading theta batch, in its
        dtype and on its device: zero means and multipliers, ``w`` from
        each branch's OCP initial guess, ``y`` zero and ``z`` 0.1."""
        g = self.group
        like = _first_float(theta_batch)
        kw = {"dtype": like.dtype, "device": like.device}
        n_a, S, T = g.n_agents, self.S, self.T
        zbar = {a: torch.zeros((S, T), **kw) for a in self._aliases}
        lam = {a: torch.zeros((n_a, S, T), **kw) for a in self._aliases}
        nu = torch.zeros((n_a, S, self.R, self.n_u), **kw)
        w = self._unlanes(vmap(g.ocp.initial_guess)(
            tree_map(self._lanes, theta_batch)))
        y = torch.zeros((n_a, S, g.ocp.n_g), **kw)
        z = torch.full((n_a, S, g.ocp.n_h), 0.1, **kw)
        return ScenarioState(zbar=zbar, lam=lam, nu=nu,
                             na_target=torch.zeros_like(nu), w=w, y=y, z=z)

    def shift_state(self, state: ScenarioState) -> ScenarioState:
        """Shift-by-one warm start between control steps (trajectory
        leaves only; multipliers and primal iterates carry over)."""
        sh = lambda a: admm_ops.shift_one(a, self.T)
        return state._replace(
            zbar={k: sh(v) for k, v in state.zbar.items()},
            lam={k: sh(v) for k, v in state.lam.items()})

    # -- the round --------------------------------------------------------------

    def _build_step(self):
        g = self.group
        ocp = g.ocp
        opts = self.options
        aliases = self._aliases
        R, n_u, S = self.R, self.n_u, self.S
        n_a = g.n_agents
        cols = {a: g.control_index(n) for a, n in sorted(g.couplings.items())}
        dev = self.device

        def f_aug(w_flat, theta):
            # the scenario weight rides theta (probabilities are data);
            # the coupling penalties are dt-integrated like the base cost
            ocp_theta, weight, aug, na = theta
            val = weight * ocp.nlp.f(w_flat, ocp_theta)
            u = ocp.unflatten(w_flat)["u"]
            for k, alias in enumerate(aliases):
                zbar_s, lam_s, rho = aug[k]
                val = val + ocp.dt * consensus_penalty(
                    u[:, cols[alias]], zbar_s, lam_s, rho)
            if R:
                target, nu_s, rho_na = na
                val = val + ocp.dt * consensus_penalty(
                    u[:R], target, nu_s, rho_na)
            return val

        nlp_aug = NLPFunctions(
            f=f_aug,
            g=lambda w, th: ocp.nlp.g(w, th[0]),
            h=lambda w, th: ocp.nlp.h(w, th[0]),
        )

        # stage-sparse derivative plan of the AUGMENTED problem, which all
        # branches share, through the one gate+certify seam
        from agentlib_mpc_torch.ops import stagejac

        tkw = {"dtype": _TEMPLATE_DTYPE, "device": dev}
        one = torch.tensor(1.0, **tkw)
        aug0 = tuple((torch.zeros((self.T,), **tkw),
                      torch.zeros((self.T,), **tkw), one) for _ in aliases)
        na0 = (torch.zeros((R, n_u), **tkw), torch.zeros((R, n_u), **tkw),
               one) if R else ()
        part = getattr(ocp, "stage_partition", None)
        solver_opts = stagejac.attach_plan_if_worthwhile(
            g.solver_options, part, nlp_aug,
            (ocp.default_params(**tkw), one, aug0, na0), ocp.n_w,
            log=logger, label=f"scenario group {g.name!r}", device=dev)

        def local_solves(state, theta_lanes, wgt_lanes, cold):
            """The (agent, scenario) branch solves as ONE batch of
            n_agents·S lanes: (w, y, z, u, ok), each (n_agents, S, ...)."""
            like = state.w
            B = n_a * S
            rho = like.new_full((B,), float(opts.rho))
            aug = tuple(
                (self._lanes(state.zbar[a].expand(n_a, S, self.T)),
                 self._lanes(state.lam[a]), rho) for a in aliases)
            if R:
                rho_na = like.new_full((B,), 0.0 if cold
                                       else float(opts.rho_na))
                na = (self._lanes(state.na_target), self._lanes(state.nu),
                      rho_na)
            else:
                na = ()
            lb, ub = vmap(ocp.bounds)(theta_lanes)
            res = solve_nlp_batched(
                nlp_aug, self._lanes(state.w),
                (theta_lanes, wgt_lanes, aug, na), lb, ub, solver_opts,
                y0=self._lanes(state.y), z0=self._lanes(state.z),
                mu0=solver_opts.mu_init if cold else opts.warm_mu,
                max_iter=solver_opts.max_iter if cold else opts.warm_budget)
            u = ocp.unflatten(res.w)["u"]
            return (self._unlanes(res.w), self._unlanes(res.y),
                    self._unlanes(res.z), self._unlanes(u),
                    self._unlanes(res.stats.success))

        quarantine = bool(opts.quarantine)
        q_reset_after = max(int(opts.quarantine_reset_after), 1)

        def lane_finite(arr):
            """All-finite per (agent, scenario) branch."""
            return torch.isfinite(arr).reshape(n_a, S, -1).all(dim=-1)

        def apply_quarantine(state, theta_lanes, streak, w_b, y_b, z_b, u_b,
                             active):
            """Replace non-finite branches by their previous iterate;
            branches quarantined ``quarantine_reset_after`` iterations in a
            row restart from the (sanitized) initial guess; then zero any
            non-finite entry left (0.1 for z), so no NaN reaches a
            consensus or group mean."""
            bad = ~(lane_finite(w_b) & lane_finite(y_b) & lane_finite(z_b)
                    & lane_finite(u_b))
            u_prev = ocp.unflatten(state.w)["u"]
            sub2 = bad[:, :, None]
            w_b = torch.where(sub2, state.w, w_b)
            y_b = torch.where(sub2, state.y, y_b)
            z_b = torch.where(sub2, state.z, z_b)
            u_b = torch.where(bad[:, :, None, None], u_prev, u_b)
            streak = torch.where(bad, streak + 1, torch.zeros_like(streak))
            resetting = streak >= q_reset_after
            w_init = self._unlanes(vmap(ocp.initial_guess)(theta_lanes))
            w_init = torch.where(torch.isfinite(w_init), w_init, 0.0)
            w_b = torch.where(resetting[:, :, None], w_init, w_b)
            y_b = torch.where(resetting[:, :, None], 0.0, y_b)
            z_b = torch.where(resetting[:, :, None], 0.1, z_b)
            streak = torch.where(resetting, torch.zeros_like(streak), streak)
            w_b = torch.where(torch.isfinite(w_b), w_b, 0.0)
            y_b = torch.where(torch.isfinite(y_b), y_b, 0.0)
            z_b = torch.where(torch.isfinite(z_b), z_b, 0.1)
            u_b = torch.where(torch.isfinite(u_b), u_b, 0.0)
            return w_b, y_b, z_b, u_b, streak, bad & active[:, None]

        def gnorm(arr):
            return torch.linalg.vector_norm(arr)

        def na_project(u_na, membership, counts):
            """Group-mean projection of the robust-horizon controls across
            the scenario axis (true-f32 products)."""
            with _true_f32_matmul():
                sums = torch.einsum("astu,stg->atgu", u_na, membership)
                means = sums / counts[None, :, :, None]
                return torch.einsum("stg,atgu->astu", membership, means)

        def iteration(state, it, theta_lanes, wgt_lanes, active, hist):
            cold = it == 0
            like = state.w
            w_b, y_b, z_b, u_b, ok_b = local_solves(state, theta_lanes,
                                                    wgt_lanes, cold)
            if quarantine:
                w_b, y_b, z_b, u_b, hist["streak"], q_bad = apply_quarantine(
                    state, theta_lanes, hist["streak"], w_b, y_b, z_b, u_b,
                    active)
                hist["q_lane"] = hist["q_lane"] + q_bad.to(torch.int32)
            n_failed = (~(ok_b | ~active[:, None])).sum(dtype=torch.int32)
            hist["ok"] = hist["ok"] & (n_failed == 0)

            residuals = []
            zbar_new = dict(state.zbar)
            lam_new = dict(state.lam)
            for alias in aliases:
                cnew, res = admm_ops.consensus_update(
                    u_b[:, :, :, cols[alias]], admm_ops.ConsensusState(
                        zbar=state.zbar[alias], lam=state.lam[alias],
                        rho=like.new_tensor(float(opts.rho))),
                    active=active)
                residuals.append(res)
                zbar_new[alias] = cnew.zbar
                lam_new[alias] = cnew.lam

            if R:
                act4 = active[:, None, None, None].to(like.dtype)
                u_na = u_b[:, :, :R, :]
                target = na_project(u_na, self._membership.to(like.dtype),
                                    self._counts.to(like.dtype))
                prim_per = (target - u_na) * act4
                nu_new = state.nu - opts.rho_na * prim_per
                # constraint elements: active agents x ALL scenarios x
                # coupled coordinates
                n_el = active.to(like.dtype).sum() * float(S * R * n_u)
                na_res = AdmmResiduals(
                    primal=gnorm(prim_per),
                    dual=gnorm(opts.rho_na * (target - state.na_target)
                               * act4),
                    scale_primal=torch.maximum(gnorm(u_na * act4),
                                               gnorm(target * act4)),
                    scale_dual=gnorm(nu_new * act4),
                    n_primal=n_el, n_dual=n_el)
                residuals.append(na_res)
                hist["na_last"] = na_res.primal
            else:
                target, nu_new = state.na_target, state.nu

            if residuals:
                res_all = admm_ops.combine_residuals(*residuals)
            else:
                res_all = AdmmResiduals(*([like.new_zeros(())] * 6))
            is_conv = admm_ops.converged(
                res_all, abs_tol=opts.abs_tol, rel_tol=opts.rel_tol,
                use_relative=opts.use_relative_tolerances,
                primal_tol=opts.primal_tol, dual_tol=opts.dual_tol)
            hist["prim"][it] = res_all.primal
            hist["dual"][it] = res_all.dual
            state = state._replace(
                zbar=zbar_new, lam=lam_new, nu=nu_new, na_target=target,
                w=w_b, y=y_b, z=z_b)
            return state, is_conv

        def step_fn(state: ScenarioState, theta_batch, active):
            max_it = opts.max_iterations
            like = state.w
            fkw = {"dtype": like.dtype, "device": like.device}
            ikw = {"dtype": torch.int32, "device": like.device}
            theta_lanes = tree_map(self._lanes, theta_batch)
            wgt_lanes = self._scen_weight.to(like.dtype).expand(
                n_a, S).reshape(-1)
            hist = {
                "prim": torch.full((max_it,), float("nan"), **fkw),
                "dual": torch.full((max_it,), float("nan"), **fkw),
                "streak": torch.zeros((n_a, S), **ikw),
                "q_lane": torch.zeros((n_a, S), **ikw),
                "ok": torch.ones((), dtype=torch.bool, device=like.device),
                "na_last": torch.zeros((), **fkw),
            }
            it = 0
            done = torch.zeros((), dtype=torch.bool, device=like.device)
            # the Boyd exit: read on the host once per iteration
            while it < max_it and not bool(done):
                state, done = iteration(state, it, theta_lanes, wgt_lanes,
                                        active, hist)
                it += 1
            stats = ScenarioStats(
                iterations=torch.tensor(it, device=like.device),
                primal_residuals=hist["prim"], dual_residuals=hist["dual"],
                converged=done, local_solves_ok=hist["ok"],
                na_spread=hist["na_last"],
                lane_quarantined=hist["q_lane"] if quarantine else None)
            trajs = tree_map(self._unlanes, vmap(ocp.trajectories)(
                self._lanes(state.w), theta_lanes))
            return state, trajs, stats

        return step_fn

    # -- public API -----------------------------------------------------------

    def step(self, state: ScenarioState, theta_batch, active=None):
        """One robust round. ``theta_batch``: OCPParams with (n_agents, S)
        leading axes (``scenario.generate`` builds it). Returns (new_state,
        per-(agent, scenario) trajectory dict, :class:`ScenarioStats`).
        Runs under the profiler range ``scenario.fused_step`` and, with
        telemetry on, the span of the same name and the round's metrics."""
        mask = self.active if active is None else \
            torch.as_tensor(active, device=self.device).to(torch.bool)
        with record_function("scenario.fused_step"):
            if not telemetry.enabled():
                return self._step_fn(state, theta_batch, mask)
            with telemetry.span("scenario.fused_step",
                                group=self.group.name,
                                scenarios=str(self.S)):
                out = self._step_fn(state, theta_batch, mask)
        self._record_round(out[2])
        return out

    def _record_round(self, stats: ScenarioStats) -> None:
        telemetry.gauge(
            "scenario_count",
            "disturbance scenarios batched per agent in the scenario "
            "fleet").set(float(self.S))
        telemetry.histogram(
            "scenario_spread",
            "final non-anticipativity primal residual per fused robust "
            "round (distance of branch controls from their group "
            "projection)").observe(float(stats.na_spread))
        telemetry.counter(
            "scenario_rounds_total",
            "fused scenario-tree robust rounds run").inc(
            group=self.group.name)
        if stats.lane_quarantined is not None:
            n_q = int(stats.lane_quarantined.sum())
            if n_q:
                telemetry.counter(
                    "scenario_quarantined_iters",
                    "quarantined (branch, iteration) events inside "
                    "fused scenario rounds — non-finite branch "
                    "solutions substituted by the previous iterate"
                    ).inc(n_q, group=self.group.name)

    def actuated_u0(self, state: ScenarioState) -> torch.Tensor:
        """The robust controls to actuate, (n_agents, S, n_u): the
        non-anticipativity projection's first-interval rows, identical
        across every scenario of a root node group by construction; the
        raw per-scenario trajectory heads for an uncoupled tree."""
        if self.R:
            return state.na_target[:, :, 0, :]
        return self.group.ocp.unflatten(state.w)["u"][:, :, 0, :]

    def shard_args(self, mesh, state: ScenarioState, theta_batch):
        """Placement on an (agents, scenarios) mesh; not ported."""
        raise NotImplementedError(
            "shard_args (the sharded scenario fleet) is not ported yet "
            "(ROADMAP Queue 1 item 5: multi-GPU)")


def _first_float(tree) -> torch.Tensor:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf
    raise ValueError("theta batch holds no floating tensor")


def pad_scenarios(tree: ScenarioTree, theta_batch, n_shards: int):
    """Pad the scenario axis to a multiple of ``n_shards``: padded branches
    replicate the LAST scenario's data with probability 0 and join no
    non-anticipativity group beyond their own. Returns ``(tree,
    theta_batch)`` grown to the padded count."""
    S = tree.n_scenarios
    n_pad = (-S) % n_shards
    if n_pad == 0:
        return tree, theta_batch
    leaves = [t for t in tree_leaves(theta_batch)
              if isinstance(t, torch.Tensor)]
    branch_bytes = sum(
        t.nbytes // max(int(t.shape[1]) if t.ndim > 1 else 1, 1)
        for t in leaves)
    logger.warning(
        "scenario tree: padding %d → %d branches for the %d-shard "
        "scenario axis (%.1f%% compute overhead, ≈%.2f MiB projected "
        "per-scenario-shard byte overhead from the padded parameter "
        "branches)", S, S + n_pad, n_shards, 100.0 * n_pad / max(S, 1),
        n_pad * branch_bytes / n_shards / 2**20)
    node_of = tuple(
        nodes + tuple(1_000_000 + i for i in range(n_pad))
        for nodes in tree.node_of)
    probs = tuple(tree.probabilities) + (0.0,) * n_pad
    padded_tree = ScenarioTree(
        n_scenarios=S + n_pad, node_of=node_of, probabilities=probs)
    theta_batch = tree_map(
        lambda leaf: torch.cat(
            [leaf, leaf[:, -1:].repeat_interleave(n_pad, dim=1)], dim=1),
        theta_batch)
    return padded_tree, theta_batch
