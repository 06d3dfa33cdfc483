"""Fused ADMM over structure groups: the production form of the fleet step.

Port of ``agentlib_mpc_tpu/parallel/fused_admm.py`` on one device. One
round runs, per ADMM iteration, the batched augmented local solves of
every structure group (``solve_nlp_batched``, or ``solve_qp`` where the
group's augmented problem is certified LQ), quarantines lanes whose
solution is not finite, then the consensus and exchange updates over the
concatenated participants with the ``active`` masks, the combined Boyd
residuals, the per-alias adaptive penalty and the convergence test.

Heterogeneous fleets are *structure groups*: agents that share one
transcribed OCP (and coupling layout and solver options) are one batch;
:func:`bucket_agents` partitions a mixed fleet that way and
:func:`pad_group_to_devices` pads a group with masked lanes. A coupling is
named by a global alias; each group maps the alias to one of its control
inputs.

The JAX package runs the round as one ``lax.while_loop`` inside ``jit``.
Here it is a Python loop over ADMM iterations that reads the convergence
flag on the host once per iteration (at most ``max_iterations`` syncs per
round), so it stops where the JAX loop stops. The per-iteration solver
schedule is the JAX package's: the first iteration runs the cold options
(``solver_options``), the others the warm ones with the warm barrier
(``warm_solver_options.mu_init`` when given, else 1e-2).

What the single-device engine does not do yet raises
``NotImplementedError`` naming the ROADMAP Queue 1 item that brings it:
``mesh=`` and ``watchdog_timeout_s=`` (item 5, multi-GPU), ``warmstart=``
(item 5, learned warm starts), any certificate mode ``"require"`` and a
group with ``SolverOptions.fusion="require"`` (item 7, certifiers). The
JAX package's ``"auto"`` certificates run only where the build already
traces a program for them (a mesh) or where the backend reports a
capacity or routes mixed precision; on the CPU it skips them all, and
the port's eager step, which has no traced program to certify, skips
them likewise. Telemetry recording of the rounds waits for item 6.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Sequence

import torch
from torch.func import vmap
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from agentlib_mpc_torch.ops import admm as admm_ops
from agentlib_mpc_torch.ops.admm import (
    AdmmResiduals,
    combine_residuals,
    consensus_penalty,
    converged,
    exchange_penalty,
    vary_penalty,
)
from agentlib_mpc_torch.ops.solver import (
    NLPFunctions,
    SolverOptions,
    _resolve_precision,
    solve_nlp_batched,
)
from agentlib_mpc_torch.ops.transcription import OCPParams, TranscribedOCP
from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_CERTIFY_MODES = ("auto", "require", "off")
#: dtype of the build-time parameter templates the certifiers and the LQ
#: probe evaluate: the certificates hold for every theta value and dtype,
#: and the probe runs in float64 anyway
_TEMPLATE_DTYPE = torch.float64


def stack_params(thetas: Sequence[OCPParams]) -> OCPParams:
    """Stack per-agent OCPParams into one batched pytree (agent axis 0)."""
    flats = [tree_flatten(t) for t in thetas]
    spec = flats[0][1]
    return tree_unflatten(
        [torch.stack(leaves) for leaves in zip(*(f[0] for f in flats))],
        spec)


def _first_float(tree) -> torch.Tensor:
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf
    raise ValueError("theta batch holds no floating tensor")


@dataclasses.dataclass(frozen=True)
class AgentGroup:
    """A set of structure-identical agents (one OCP shape, batched params).

    ``couplings``/``exchanges`` map a global coupling alias to the name of
    the control input of this group's model that carries it. Groups not
    participating in a coupling simply omit the alias.
    """

    name: str
    ocp: TranscribedOCP
    n_agents: int
    couplings: dict[str, str] = dataclasses.field(default_factory=dict)
    exchanges: dict[str, str] = dataclasses.field(default_factory=dict)
    solver_options: SolverOptions = SolverOptions()
    #: inner options of the warm ADMM iterations; None → ``solver_options``
    #: with ``max_iter`` capped at 6
    warm_solver_options: "SolverOptions | None" = None
    #: route the group's inner solves to the Mehrotra QP fast path
    #: (``ops/qp.py``): ``"auto"`` certifies the augmented problem once at
    #: engine build; ``"on"``/``"off"`` force
    qp_fast_path: str = "auto"

    def control_index(self, var_name: str) -> int:
        return self.ocp.control_names.index(var_name)


class FusedADMMOptions(NamedTuple):
    max_iterations: int = 20
    #: initial penalty — one float for every coupling alias, or a dict
    #: ``alias -> float``; carried and adapted per alias
    rho: "float | dict" = 10.0
    #: Boyd relative-tolerance exit
    abs_tol: float = 1e-3
    rel_tol: float = 1e-2
    use_relative_tolerances: bool = True
    primal_tol: float = 1e-3
    dual_tol: float = 1e-3
    #: residual-balancing adaptive penalty per alias; threshold <= 1
    #: disables
    penalty_change_threshold: float = -1.0
    penalty_change_factor: float = 2.0
    #: replace a lane's non-finite local solution by its previous iterate
    #: so one NaN agent cannot poison the consensus mean
    quarantine: bool = True
    #: consecutive quarantined iterations before the lane's warm start is
    #: reset to the OCP initial guess
    quarantine_reset_after: int = 3


class FusedState(NamedTuple):
    """Carried between control steps (the warm-start memory)."""

    zbar: dict            # alias -> (T,) consensus means
    lam: dict             # alias -> tuple per group: (n_i, T) multipliers
    ex_mean: dict         # alias -> (T,) exchange means
    ex_diff: dict         # alias -> tuple per group: (n_i, T) diffs
    ex_lam: dict          # alias -> (T,) shared exchange multiplier
    rho: dict             # alias -> () penalty (consensus AND exchange)
    w: tuple              # per group: (n_i, n_w) primal warm starts
    y: tuple              # per group: (n_i, n_g) equality-dual warm starts
    z: tuple              # per group: (n_i, n_h) inequality-dual warm starts


class IterationStats(NamedTuple):
    iterations: torch.Tensor         # () iterations run
    primal_residuals: torch.Tensor   # (max_iter,) padded with NaN
    dual_residuals: torch.Tensor
    penalty: dict                    # alias -> (max_iter,) ρ history
    converged: torch.Tensor          # () bool
    #: every inner solve of every iteration reached an acceptable point
    local_solves_ok: torch.Tensor    # () bool
    #: per-iteration local coupling trajectories, alias ->
    #: (max_iter, n_participants, T), NaN beyond ``iterations``; rows in
    #: :meth:`FusedADMM.participant_offset` order. None unless the engine
    #: records locals
    coupling_locals: "dict | None" = None
    exchange_locals: "dict | None" = None
    #: per-iteration count of quarantined active agents, (max_iter,)
    #: int32; None with quarantine off
    quarantined: "torch.Tensor | None" = None
    #: per group, (n_agents,) int32: in how many of this round's
    #: iterations each lane was quarantined; None with quarantine off
    lane_quarantined: "tuple | None" = None


class FusedADMM:
    """ADMM round over structure groups. Build once per problem structure;
    call :meth:`step` once per control step."""

    def __init__(self, groups: Sequence[AgentGroup],
                 options: FusedADMMOptions = FusedADMMOptions(),
                 active: "Sequence[torch.Tensor] | None" = None,
                 record_locals: bool = False,
                 donate_state: bool = False,
                 mesh=None,
                 watchdog_timeout_s: "float | None" = None,
                 collective_certify: str = "auto",
                 memory_certify: str = "auto",
                 dispatch_certify: str = "auto",
                 precision_certify: str = "auto",
                 warmstart=None,
                 device=None):
        """``active``: optional per-group boolean masks (n_agents,); False
        lanes are padding (:func:`pad_group_to_devices`): they run the
        dense math but never influence consensus results. A per-call
        override goes to :meth:`step`.
        ``record_locals``: carry per-iteration local coupling trajectories
        into :class:`IterationStats` (:class:`~agentlib_mpc_torch.parallel.
        config_bridge.FusedFleet` turns it on for its results frames).
        ``donate_state``: validated as in the JAX package, where it donates
        the state's buffers to the compiled step; eager PyTorch builds new
        state tensors each iteration anyway, so it has no further effect.
        ``device``: where the engine runs; None means the card
        (``resolve_device``). A round runs in the dtype of its theta
        batches.
        ``mesh``, ``watchdog_timeout_s``, ``warmstart`` and the
        certificate modes ``"require"`` are not ported
        (``NotImplementedError``; module docstring)."""
        self.device = resolve_device(device)
        self.groups = tuple(self._with_stage_partition(g) for g in groups)
        self.options = options
        self.record_locals = bool(record_locals)
        if active is None:
            active = [torch.ones((g.n_agents,), dtype=torch.bool,
                                 device=self.device) for g in self.groups]
        self.active = self._check_masks(active)
        self._aliases = sorted(
            {a for g in self.groups for a in g.couplings})
        self._ex_aliases = sorted(
            {a for g in self.groups for a in g.exchanges})
        horizons = {g.ocp.N for g in self.groups}
        if len(horizons) != 1:
            raise ValueError(
                f"all groups must share one horizon, got {horizons}")
        self.T = horizons.pop()
        for alias in (*self._aliases, *self._ex_aliases):
            if not any(alias in g.couplings or alias in g.exchanges
                       for g in self.groups):
                raise ValueError(f"coupling {alias!r} has no participants")
        both = set(self._aliases) & set(self._ex_aliases)
        if both:
            # per-alias state (rho, residuals) is keyed by the alias alone
            raise ValueError(
                f"alias(es) {sorted(both)} are used as both consensus "
                f"coupling and exchange — give the two couplings "
                f"distinct aliases")
        self.donate_state = bool(donate_state)
        if watchdog_timeout_s is not None and self.donate_state:
            raise ValueError(
                "watchdog_timeout_s is incompatible with donate_state: "
                "a watchdogged round may be retried on a degraded mesh "
                "from the SAME input state, which donation would have "
                "consumed")
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
                "mesh= (the sharded fused round) is not ported yet "
                "(ROADMAP Queue 1 item 5: multi-GPU)")
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
        for g in self.groups:
            for o in (g.solver_options, g.warm_solver_options):
                if o is None:
                    continue
                if o.fusion == "require":
                    raise NotImplementedError(
                        f"group {g.name!r}: SolverOptions.fusion='require' "
                        f"needs the fusion certifier, which is not ported "
                        f"yet (ROADMAP Queue 1 item 7)")
                _resolve_precision(o)
        self._step_fn = self._build_step()

    def _check_masks(self, active) -> tuple:
        if len(active) != len(self.groups):
            raise ValueError(
                f"active has {len(active)} masks for {len(self.groups)} "
                f"groups — one (n_agents,) bool mask per group required")
        masks = tuple(torch.as_tensor(a, device=self.device).to(torch.bool)
                      for a in active)
        for g, a in zip(self.groups, masks):
            if tuple(a.shape) != (g.n_agents,):
                raise ValueError(
                    f"active mask of group {g.name!r} has shape "
                    f"{tuple(a.shape)}, expected ({g.n_agents},)")
        return masks

    @staticmethod
    def _with_stage_partition(g: AgentGroup) -> AgentGroup:
        from agentlib_mpc_torch.ops.solver import attach_stage_partition

        part = getattr(g.ocp, "stage_partition", None)
        if part is None:
            return g

        def attach(opts):
            return None if opts is None else attach_stage_partition(opts,
                                                                    part)

        return dataclasses.replace(
            g, solver_options=attach(g.solver_options),
            warm_solver_options=attach(g.warm_solver_options))

    # -- state ----------------------------------------------------------------

    def init_state(self, theta_batches: Sequence[OCPParams]) -> FusedState:
        """Fresh global state: zero means and multipliers, ``w`` from each
        lane's OCP initial guess, ``y`` zero and ``z`` 0.1, in the dtype
        and on the device of the theta batches."""
        like = _first_float(theta_batches[0])
        kw = {"dtype": like.dtype, "device": like.device}
        zbar, lam = {}, {}
        ex_mean, ex_diff, ex_lam = {}, {}, {}
        for alias in self._aliases:
            zbar[alias] = torch.zeros((self.T,), **kw)
            lam[alias] = tuple(
                torch.zeros((g.n_agents, self.T), **kw) for g in self.groups
                if alias in g.couplings)
        for alias in self._ex_aliases:
            ex_mean[alias] = torch.zeros((self.T,), **kw)
            ex_lam[alias] = torch.zeros((self.T,), **kw)
            ex_diff[alias] = tuple(
                torch.zeros((g.n_agents, self.T), **kw) for g in self.groups
                if alias in g.exchanges)
        w = tuple(vmap(g.ocp.initial_guess)(theta)
                  for g, theta in zip(self.groups, theta_batches))
        y = tuple(torch.zeros((g.n_agents, g.ocp.n_g), **kw)
                  for g in self.groups)
        z = tuple(torch.full((g.n_agents, g.ocp.n_h), 0.1, **kw)
                  for g in self.groups)
        rho_opt = self.options.rho
        all_aliases = (*self._aliases, *self._ex_aliases)
        if isinstance(rho_opt, dict):
            missing = set(all_aliases) - set(rho_opt)
            if missing:
                raise ValueError(
                    f"options.rho is a dict but misses aliases {missing}")
            rho = {a: torch.tensor(float(rho_opt[a]), **kw)
                   for a in all_aliases}
        else:
            rho = {a: torch.tensor(float(rho_opt), **kw)
                   for a in all_aliases}
        return FusedState(zbar=zbar, lam=lam, ex_mean=ex_mean,
                          ex_diff=ex_diff, ex_lam=ex_lam, rho=rho, w=w, y=y,
                          z=z)

    def shift_state(self, state: FusedState) -> FusedState:
        """Shift-by-one warm start between control steps."""
        sh = lambda a: admm_ops.shift_one(a, self.T)
        return state._replace(
            zbar={k: sh(v) for k, v in state.zbar.items()},
            lam={k: tuple(sh(x) for x in v) for k, v in state.lam.items()},
            ex_mean={k: sh(v) for k, v in state.ex_mean.items()},
            ex_diff={k: tuple(sh(x) for x in v)
                     for k, v in state.ex_diff.items()},
            ex_lam={k: sh(v) for k, v in state.ex_lam.items()},
        )

    # -- participants -----------------------------------------------------------

    def _group_participations(self, alias, kind):
        """(group_index, control_index, slot) for every group in coupling
        `alias`; slot is the position in the state's per-group tuples."""
        out = []
        slot = 0
        for gi, g in enumerate(self.groups):
            mapping = g.couplings if kind == "consensus" else g.exchanges
            if alias in mapping:
                out.append((gi, g.control_index(mapping[alias]), slot))
                slot += 1
        return out

    def _participant_count(self, alias, kind) -> int:
        return sum(self.groups[gi].n_agents
                   for gi, _c, _s in self._group_participations(alias, kind))

    def participant_offset(self, alias: str, kind: str, gi: int) -> int:
        """Row offset of group ``gi``'s agents in the stacked
        ``IterationStats.coupling_locals[alias]`` / ``exchange_locals``
        participant axis (agent ``slot`` within the group adds to it)."""
        offs = 0
        for gj, _c, _s in self._group_participations(alias, kind):
            if gj == gi:
                return offs
            offs += self.groups[gj].n_agents
        raise KeyError(f"group {gi} does not participate in {alias!r}")

    # -- the round --------------------------------------------------------------

    def _aug_template(self, n_entries: int, random_gen=None):
        """One agent's augmentation triples (target, λ, ρ) on the engine's
        device in ``_TEMPLATE_DTYPE``: zeros (the certificates hold for
        every value) or, with ``random_gen``, normal samples for the
        probe."""
        kw = {"dtype": _TEMPLATE_DTYPE, "device": self.device}

        def vec():
            if random_gen is None:
                return torch.zeros((self.T,), **kw)
            return torch.randn((self.T,), generator=random_gen,
                               dtype=_TEMPLATE_DTYPE).to(self.device)

        return tuple((vec(), vec(), torch.tensor(1.0, **kw))
                     for _ in range(n_entries))

    def _build_step(self):
        """Attach the certified derivative plans, resolve the QP routing
        and return the round ``step_fn(state, theta_batches, active)``."""
        from agentlib_mpc_torch.ops import stagejac
        from agentlib_mpc_torch.ops.qp import (
            is_lq,
            resolve_qp_routing,
            solve_qp,
        )
        from agentlib_mpc_torch.ops.solver import (
            attach_jacobian_plan,
            plan_worthwhile,
        )

        groups = self.groups
        opts = self.options
        aliases = self._aliases
        ex_aliases = self._ex_aliases
        n_groups = len(groups)
        dev = self.device

        # per group: which (alias, kind, u-column) augment its objective
        aug_map = []
        for g in groups:
            entries = [(a, "consensus", g.control_index(n))
                       for a, n in sorted(g.couplings.items())]
            entries += [(a, "exchange", g.control_index(n))
                        for a, n in sorted(g.exchanges.items())]
            aug_map.append(tuple(entries))

        def make_group_nlp(gi):
            ocp = groups[gi].ocp
            entries = aug_map[gi]

            def f_aug(w_flat, theta):
                # the admm terms are stage objectives, integrated
                # (dt-weighted) like the base cost
                ocp_theta, aug = theta
                val = ocp.nlp.f(w_flat, ocp_theta)
                u = ocp.unflatten(w_flat)["u"]
                for k, (_alias, kind, col) in enumerate(entries):
                    target, lam, rho = aug[k]
                    penalty = (consensus_penalty if kind == "consensus"
                               else exchange_penalty)
                    val = val + ocp.dt * penalty(u[:, col], target, lam, rho)
                return val

            return NLPFunctions(
                f=f_aug,
                g=lambda w, th: ocp.nlp.g(w, th[0]),
                h=lambda w, th: ocp.nlp.h(w, th[0]),
            )

        group_nlps = [make_group_nlp(gi) for gi in range(n_groups)]

        def theta_template(gi):
            g = groups[gi]
            return (g.ocp.default_params(device=dev, dtype=_TEMPLATE_DTYPE),
                    self._aug_template(len(aug_map[gi])))

        # stage-sparse derivative plan per group, certified on the
        # AUGMENTED problem and attached to the cold and warm options
        planned = []
        for gi, g in enumerate(groups):
            part = getattr(g.ocp, "stage_partition", None)
            label = f"group {g.name!r}"
            cold_wants = plan_worthwhile(g.solver_options, part, dev)
            g_opts = stagejac.attach_plan_if_worthwhile(
                g.solver_options, part, group_nlps[gi], theta_template(gi),
                g.ocp.n_w, log=logger, label=label, device=dev)
            wso = g.warm_solver_options
            if wso is not None:
                plan = g_opts.stage_jacobian_plan
                if plan is not None:
                    wso = attach_jacobian_plan(wso, plan)
                elif not cold_wants:
                    # warm-only configuration; a refuted cold pass already
                    # answered for the identical augmented problem
                    wso = stagejac.attach_plan_if_worthwhile(
                        wso, part, group_nlps[gi], theta_template(gi),
                        g.ocp.n_w, log=logger, label=f"{label} (warm)",
                        device=dev)
            if g_opts is not g.solver_options or \
                    wso is not g.warm_solver_options:
                g = dataclasses.replace(g, solver_options=g_opts,
                                        warm_solver_options=wso)
            planned.append(g)
        groups = tuple(planned)
        self.groups = groups

        # per-group solver routing: the fx certificate decides, the probe
        # (at random means, multipliers and penalty) cross-checks
        group_uses_qp = []
        for gi, g in enumerate(groups):
            def certifier(gi=gi, g=g):
                from agentlib_mpc_torch.lint.fx import certify_lq

                return certify_lq(group_nlps[gi], theta_template(gi),
                                  g.ocp.n_w)

            def probe(gi=gi, g=g):
                gen = torch.Generator(device="cpu").manual_seed(17 + gi)
                theta = (g.ocp.default_params(device=dev,
                                              dtype=_TEMPLATE_DTYPE),
                         self._aug_template(len(aug_map[gi]), gen))
                return is_lq(group_nlps[gi], theta, g.ocp.n_w)

            try:
                group_uses_qp.append(resolve_qp_routing(
                    g.qp_fast_path, probe, logger=logger,
                    label=f"group {g.name!r}", certifier=certifier))
            except ValueError as exc:
                raise ValueError(f"group {g.name!r}: {exc}") from exc
        self.group_uses_qp = tuple(group_uses_qp)

        warm_opts = [
            g.warm_solver_options
            or g.solver_options._replace(
                max_iter=min(g.solver_options.max_iter, 6))
            for g in groups]
        # warm options that differ from the cold ones only in budget and
        # barrier: both phases call the solver with the cold options and
        # those two as overrides (the JAX package's shared trace; the
        # same mathematics as the split call)
        shared_trace = all(
            warm_opts[gi]._replace(max_iter=0, mu_init=0.0)
            == groups[gi].solver_options._replace(max_iter=0, mu_init=0.0)
            for gi in range(n_groups))
        self.shared_trace = shared_trace

        def slots(alias, kind):
            return {gj: s for gj, _c, s in
                    self._group_participations(alias, kind)}

        slot_of = {(a, k): slots(a, k)
                   for k, al in (("consensus", aliases),
                                 ("exchange", ex_aliases)) for a in al}

        def local_solves(gi, state: FusedState, theta_batch, cold: bool):
            """Batched augmented solves of one group: (w, y, z, u, ok)."""
            g = groups[gi]
            n = g.n_agents
            cold_opts = g.solver_options
            warm_mu = (g.warm_solver_options.mu_init
                       if g.warm_solver_options is not None else 1e-2)
            if shared_trace:
                solver_opts = cold_opts
                budget = cold_opts.max_iter if cold \
                    else warm_opts[gi].max_iter
            else:
                solver_opts = cold_opts if cold else warm_opts[gi]
                budget = None
            mu0 = cold_opts.mu_init if cold else warm_mu
            # per-lane augmentation triples; replicated leaves (z̄, the
            # shared exchange λ, ρ) expanded to lanes as views
            aug = []
            for alias, kind, _col in aug_map[gi]:
                slot = slot_of[(alias, kind)][gi]
                rho = state.rho[alias].expand(n)
                if kind == "consensus":
                    aug.append((state.zbar[alias].expand(n, self.T),
                                state.lam[alias][slot], rho))
                else:
                    # exchange: target is the agent's own previous diff,
                    # the multiplier is shared
                    aug.append((state.ex_diff[alias][slot],
                                state.ex_lam[alias].expand(n, self.T), rho))
            inner = solve_qp if group_uses_qp[gi] else solve_nlp_batched
            lb, ub = vmap(g.ocp.bounds)(theta_batch)
            res = inner(group_nlps[gi], state.w[gi],
                        (theta_batch, tuple(aug)), lb, ub, solver_opts,
                        y0=state.y[gi], z0=state.z[gi], mu0=mu0,
                        max_iter=budget)
            u = g.ocp.unflatten(res.w)["u"]
            return res.w, res.y, res.z, u, res.stats.success

        record = self.record_locals
        quarantine = bool(opts.quarantine)
        q_reset_after = max(int(opts.quarantine_reset_after), 1)

        def row_finite(arr):
            return torch.isfinite(arr).reshape(arr.shape[0], -1).all(dim=1)

        def apply_quarantine(gi, state, theta_batch, streak, w_b, y_b, z_b,
                             u_b, act_gi):
            """Replace non-finite lanes of one group by their previous
            iterate; lanes quarantined ``quarantine_reset_after`` times in
            a row restart from the (sanitized) initial guess; then any
            non-finite entry left is zeroed (0.1 for z) so no NaN reaches
            a consensus mean. Returns the batches, the streak, the
            quarantined active lanes and their count."""
            ocp = groups[gi].ocp
            bad = ~(row_finite(w_b) & row_finite(y_b) & row_finite(z_b)
                    & row_finite(u_b))
            u_prev = ocp.unflatten(state.w[gi])["u"]
            w_b = torch.where(bad[:, None], state.w[gi], w_b)
            y_b = torch.where(bad[:, None], state.y[gi], y_b)
            z_b = torch.where(bad[:, None], state.z[gi], z_b)
            u_b = torch.where(bad[:, None, None], u_prev, u_b)
            streak = torch.where(bad, streak + 1, torch.zeros_like(streak))
            resetting = streak >= q_reset_after
            w_init = vmap(ocp.initial_guess)(theta_batch)
            # a NaN theta yields a NaN guess; the carried state must stay
            # finite or the next substitution source is poisoned too
            w_init = torch.where(torch.isfinite(w_init), w_init, 0.0)
            w_b = torch.where(resetting[:, None], w_init, w_b)
            y_b = torch.where(resetting[:, None], 0.0, y_b)
            z_b = torch.where(resetting[:, None], 0.1, z_b)
            streak = torch.where(resetting, torch.zeros_like(streak), streak)
            w_b = torch.where(torch.isfinite(w_b), w_b, 0.0)
            y_b = torch.where(torch.isfinite(y_b), y_b, 0.0)
            z_b = torch.where(torch.isfinite(z_b), z_b, 0.1)
            u_b = torch.where(torch.isfinite(u_b), u_b, 0.0)
            q_bad = bad & act_gi
            return w_b, y_b, z_b, u_b, streak, q_bad, \
                q_bad.sum(dtype=torch.int32)

        def iteration(state, it, active, theta_batches, hist):
            cold = it == 0
            u_groups, w_new, y_new, z_new = [], [], [], []
            like = state.w[0]
            n_quarantined = torch.zeros((), dtype=torch.int32,
                                        device=like.device)
            n_failed = torch.zeros((), dtype=torch.int32, device=like.device)
            for gi in range(n_groups):
                w_b, y_b, z_b, u_b, ok_b = local_solves(
                    gi, state, theta_batches[gi], cold)
                if quarantine:
                    w_b, y_b, z_b, u_b, hist["streak"][gi], q_bad, n_q = \
                        apply_quarantine(gi, state, theta_batches[gi],
                                         hist["streak"][gi], w_b, y_b, z_b,
                                         u_b, active[gi])
                    hist["q_lane"][gi] = hist["q_lane"][gi] + \
                        q_bad.to(torch.int32)
                    n_quarantined = n_quarantined + n_q
                w_new.append(w_b)
                y_new.append(y_b)
                z_new.append(z_b)
                u_groups.append(u_b)
                # padded lanes may fail to converge without penalty
                n_failed = n_failed + (~(ok_b | ~active[gi])).sum(
                    dtype=torch.int32)

            residuals = []
            alias_residuals = {}
            zbar_new = dict(state.zbar)
            lam_new = dict(state.lam)
            for alias in aliases:
                parts = self._group_participations(alias, "consensus")
                locals_ = torch.cat(
                    [u_groups[gi][:, :, col] for gi, col, _ in parts], dim=0)
                lam_stack = torch.cat(
                    [state.lam[alias][slot] for _, _, slot in parts], dim=0)
                act = torch.cat([active[gi] for gi, _, _ in parts])
                if record:
                    hist["cl"][alias][it] = locals_
                cnew, res = admm_ops.consensus_update(
                    locals_, admm_ops.ConsensusState(
                        zbar=state.zbar[alias], lam=lam_stack,
                        rho=state.rho[alias]), active=act)
                residuals.append(res)
                alias_residuals[alias] = res
                zbar_new[alias] = cnew.zbar
                lam_new[alias] = tuple(torch.split(
                    cnew.lam, [groups[gi].n_agents for gi, _, _ in parts]))

            ex_mean_new = dict(state.ex_mean)
            ex_diff_new = dict(state.ex_diff)
            ex_lam_new = dict(state.ex_lam)
            for alias in ex_aliases:
                parts = self._group_participations(alias, "exchange")
                locals_ = torch.cat(
                    [u_groups[gi][:, :, col] for gi, col, _ in parts], dim=0)
                diff_stack = torch.cat(
                    [state.ex_diff[alias][slot] for _, _, slot in parts],
                    dim=0)
                act = torch.cat([active[gi] for gi, _, _ in parts])
                if record:
                    hist["ex"][alias][it] = locals_
                enew, res = admm_ops.exchange_update(
                    locals_, admm_ops.ExchangeState(
                        mean=state.ex_mean[alias], diff=diff_stack,
                        lam=state.ex_lam[alias], rho=state.rho[alias]),
                    active=act)
                residuals.append(res)
                alias_residuals[alias] = res
                ex_mean_new[alias] = enew.mean
                ex_lam_new[alias] = enew.lam
                ex_diff_new[alias] = tuple(torch.split(
                    enew.diff, [groups[gi].n_agents for gi, _, _ in parts]))

            if residuals:
                res_all = combine_residuals(*residuals)
            else:
                res_all = AdmmResiduals(*([like.new_zeros(())] * 6))
            # residual balancing PER ALIAS against its own residuals
            rho_next = {
                a: vary_penalty(state.rho[a], alias_residuals[a],
                                threshold=opts.penalty_change_threshold,
                                factor=opts.penalty_change_factor)
                for a in state.rho}
            is_conv = converged(
                res_all, abs_tol=opts.abs_tol, rel_tol=opts.rel_tol,
                use_relative=opts.use_relative_tolerances,
                primal_tol=opts.primal_tol, dual_tol=opts.dual_tol)
            hist["prim"][it] = res_all.primal
            hist["dual"][it] = res_all.dual
            # the penalty each iteration ran with (before the update)
            for a in hist["rho"]:
                hist["rho"][a][it] = state.rho[a]
            hist["q"][it] = n_quarantined
            hist["ok"] = hist["ok"] & (n_failed == 0)
            state = state._replace(
                zbar=zbar_new, lam=lam_new, ex_mean=ex_mean_new,
                ex_diff=ex_diff_new, ex_lam=ex_lam_new, rho=rho_next,
                w=tuple(w_new), y=tuple(y_new), z=tuple(z_new))
            return state, is_conv

        def step_fn(state: FusedState, theta_batches: tuple, active: tuple):
            max_it = opts.max_iterations
            like = state.w[0]
            fkw = {"dtype": like.dtype, "device": like.device}
            ikw = {"dtype": torch.int32, "device": like.device}
            nan = lambda *shape: torch.full(shape, float("nan"), **fkw)
            hist = {
                "prim": nan(max_it), "dual": nan(max_it),
                "rho": {a: nan(max_it) for a in (*aliases, *ex_aliases)},
                "cl": {a: nan(max_it, self._participant_count(a, "consensus"),
                              self.T) for a in aliases} if record else {},
                "ex": {a: nan(max_it, self._participant_count(a, "exchange"),
                              self.T) for a in ex_aliases} if record else {},
                "streak": [torch.zeros((g.n_agents,), **ikw)
                           for g in groups],
                "q": torch.zeros((max_it,), **ikw),
                "q_lane": [torch.zeros((g.n_agents,), **ikw)
                           for g in groups],
                "ok": torch.ones((), dtype=torch.bool, device=like.device),
            }
            it = 0
            done = torch.zeros((), dtype=torch.bool, device=like.device)
            # the Boyd exit: read on the host once per iteration
            while it < max_it and not bool(done):
                state, done = iteration(state, it, active, theta_batches,
                                        hist)
                it += 1
            stats = IterationStats(
                iterations=torch.tensor(it, device=like.device),
                primal_residuals=hist["prim"], dual_residuals=hist["dual"],
                penalty=hist["rho"], converged=done,
                local_solves_ok=hist["ok"],
                coupling_locals=hist["cl"] if record else None,
                exchange_locals=hist["ex"] if record else None,
                quarantined=hist["q"] if quarantine else None,
                lane_quarantined=tuple(hist["q_lane"]) if quarantine
                else None)
            trajs = tuple(
                vmap(g.ocp.trajectories)(state.w[gi], theta_batches[gi])
                for gi, g in enumerate(groups))
            return state, trajs, stats

        return step_fn

    # -- public API -------------------------------------------------------------

    def step(self, state: FusedState, theta_batches: Sequence[OCPParams],
             active: "Sequence[torch.Tensor] | None" = None):
        """Run one full ADMM round (≤ max_iterations, early exit on the
        relative-tolerance criterion). Returns (new_state, per-group
        trajectory dicts, IterationStats). ``active`` overrides the
        constructor masks for this round. Runs under the profiler range
        ``admm.fused_step``, beside the solvers' ``ipm.*`` ranges."""
        masks = self.active if active is None else self._check_masks(active)
        with record_function("admm.fused_step"):
            return self._step_fn(state, tuple(theta_batches), masks)

    def pad_state_rows(self, pads: "dict[int, int]",
                       state: "FusedState | None",
                       theta_batches: Sequence[OCPParams]):
        """Row padding of a (state, thetas) pair: grow each group's agent
        axis by ``pads[gi]`` lanes repeating the last agent's parameters
        and iterates. Does NOT touch the engine. ``state=None`` pads the
        theta batches alone."""

        def pad_rows(leaf, gi):
            if not pads.get(gi):
                return leaf
            return torch.cat([leaf, leaf[-1:].repeat_interleave(
                pads[gi], dim=0)], dim=0)

        theta_batches = tuple(
            tree_map(lambda leaf, gi=gi: pad_rows(leaf, gi), theta)
            for gi, theta in enumerate(theta_batches))
        if state is None:
            return None, theta_batches

        lam = {a: tuple(
            pad_rows(piece, gi) for (gi, _c, _s), piece in zip(
                self._group_participations(a, "consensus"), pieces))
            for a, pieces in state.lam.items()}
        ex_diff = {a: tuple(
            pad_rows(piece, gi) for (gi, _c, _s), piece in zip(
                self._group_participations(a, "exchange"), pieces))
            for a, pieces in state.ex_diff.items()}
        n = len(self.groups)
        state = state._replace(
            w=tuple(pad_rows(state.w[gi], gi) for gi in range(n)),
            y=tuple(pad_rows(state.y[gi], gi) for gi in range(n)),
            z=tuple(pad_rows(state.z[gi], gi) for gi in range(n)),
            lam=lam, ex_diff=ex_diff)
        return state, theta_batches

    def routed_groups(self) -> tuple:
        """The groups with the resolved qp routing forced ("on"/"off") and
        the derived solver options (stage partitions, derivative plans)
        attached: what a sibling engine build takes so it never
        re-certifies."""
        return tuple(
            dataclasses.replace(g, qp_fast_path="on" if use else "off")
            for g, use in zip(self.groups, self.group_uses_qp))


# -- heterogeneous-fleet helpers ------------------------------------------------

def bucket_agents(specs: Sequence[dict]):
    """Partition a mixed fleet into minimal structure groups.

    Each spec: ``{"ocp": TranscribedOCP, "theta": OCPParams,
    "couplings": {...}, "exchanges": {...}, "name": str,
    "solver_options": SolverOptions, "warm_solver_options": ...,
    "qp_fast_path": ...}``. Agents sharing one transcribed OCP *object*,
    coupling layout and (warm) solver options batch together; their
    parameter values may differ freely. Transcribe once per model class.

    Returns ``(groups, theta_batches, index_map)`` where ``index_map[g]``
    lists each group member's position in ``specs``.
    """
    buckets: dict = {}
    order: list = []
    for i, spec in enumerate(specs):
        key = (
            id(spec["ocp"]),
            tuple(sorted(spec.get("couplings", {}).items())),
            tuple(sorted(spec.get("exchanges", {}).items())),
            spec.get("solver_options", SolverOptions()),
            spec.get("warm_solver_options"),
            spec.get("qp_fast_path", "auto"),
        )
        if key not in buckets:
            buckets[key] = {"spec": spec, "members": []}
            order.append(key)
        buckets[key]["members"].append(i)
    groups, thetas, index_map = [], [], []
    for key in order:
        spec = buckets[key]["spec"]
        members = buckets[key]["members"]
        groups.append(AgentGroup(
            name=spec.get("name", f"group{len(groups)}"),
            ocp=spec["ocp"],
            n_agents=len(members),
            couplings=dict(spec.get("couplings", {})),
            exchanges=dict(spec.get("exchanges", {})),
            solver_options=spec.get("solver_options", SolverOptions()),
            warm_solver_options=spec.get("warm_solver_options"),
            qp_fast_path=spec.get("qp_fast_path", "auto"),
        ))
        thetas.append(stack_params([specs[i]["theta"] for i in members]))
        index_map.append(list(members))
    return groups, thetas, index_map


def pad_group_to_devices(group: AgentGroup, theta_batch: OCPParams,
                         n_devices: int):
    """Pad a group's agent axis up to a multiple of ``n_devices``.

    Padding lanes repeat the last agent's parameters; the returned boolean
    mask marks the real agents. Hand it to ``FusedADMM(groups, options,
    active=masks)``: padded lanes then solve but contribute nothing to
    means, multipliers, residuals or the solver-health flag."""
    n = group.n_agents
    n_pad = (-n) % n_devices
    like = _first_float(theta_batch)
    mask = torch.cat([torch.ones((n,), dtype=torch.bool, device=like.device),
                      torch.zeros((n_pad,), dtype=torch.bool,
                                  device=like.device)])
    if n_pad == 0:
        return group, theta_batch, mask
    padded = tree_map(
        lambda leaf: torch.cat(
            [leaf, leaf[-1:].repeat_interleave(n_pad, dim=0)], dim=0),
        theta_batch)
    logger.warning(
        "group %r: padding %d → %d lanes for the %d-device mesh "
        "(%.1f%% compute overhead, ≥%.2f MiB per device from the padded "
        "parameter and solution rows)", group.name, n, n + n_pad,
        n_devices, 100.0 * n_pad / max(n, 1),
        n_pad * _lane_row_bytes(group.ocp, theta_batch) / n_devices / 2**20)
    return dataclasses.replace(group, n_agents=n + n_pad), padded, mask


def _lane_row_bytes(ocp, theta_batch) -> int:
    """Bytes one padded lane adds from its carried solution rows (w/y/z)
    and its parameter row."""
    leaves = [t for t in tree_flatten(theta_batch)[0]
              if isinstance(t, torch.Tensor)]
    theta_row = sum(t.nbytes // max(int(t.shape[0]) if t.ndim else 1, 1)
                    for t in leaves)
    itemsize = _first_float(theta_batch).element_size()
    return int(theta_row + (ocp.n_w + ocp.n_g + ocp.n_h) * itemsize)


__all__ = ["AgentGroup", "FusedADMM", "FusedADMMOptions", "FusedState",
           "IterationStats", "bucket_agents", "pad_group_to_devices",
           "stack_params"]
