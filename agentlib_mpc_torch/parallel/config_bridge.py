"""Reference-shaped agent configs → the fused engine.

Port of ``agentlib_mpc_tpu/parallel/config_bridge.py``. :class:`FusedFleet`
takes the agent configs an ``admm_local`` multi-agent system consumes and
builds the whole fleet into one
:class:`~agentlib_mpc_torch.parallel.fused_admm.FusedADMM`: every agent's
local solve, the consensus updates and the convergence test of one round
in one engine.

Scope: input couplings (the coupling variable is a control input of the
agent's model). Output-expression couplings need the expression machinery
of the ADMM backend and raise a pointed ``NotImplementedError``. ML model
configs (``ml_model_sources``) transcribe through the NARX path
(``ops/ml_transcription.py``); each agent's surrogate weights ride its
theta.

Typical use::

    fleet = FusedFleet.from_configs(configs, device="cpu")
    out = fleet.step()                             # one coordinated round
    u0 = out["Room_3"]["u"]["mDot"][0]             # first control move
    fleet.update_agent("Room_3", x0=[296.2])       # plant feedback
    fleet.advance()                                # shift, clock
    out = fleet.step()                             # warm-started next round
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_torch.backends.backend import load_model_for_backend
from agentlib_mpc_torch.backends.mpc_backend import (
    solver_options_from_config,
    transcription_kwargs_from_config,
)
from agentlib_mpc_torch.models.ml_model import MLModel
from agentlib_mpc_torch.models.model import Model
from agentlib_mpc_torch.ops.ml_transcription import transcribe_ml
from agentlib_mpc_torch.ops.transcription import TranscribedOCP, transcribe
from agentlib_mpc_torch.parallel.fused_admm import (
    FusedADMM,
    FusedADMMOptions,
    bucket_agents,
)
from agentlib_mpc_torch.utils.device import resolve_device

#: module types whose config block the bridge understands
_ADMM_TYPES = ("admm_local", "admm", "admm_coordinated")


@dataclasses.dataclass
class _FleetAgent:
    agent_id: str
    model: Model
    ocp: TranscribedOCP
    couplings: dict[str, str]          # alias -> control input name
    exchanges: dict[str, str]
    solver_options: Any
    x0: np.ndarray                     # (n_diff,)
    p: np.ndarray                      # (n_params,)
    exo: dict[str, float]              # constant disturbance values
    u_bounds: dict[str, tuple[float | None, float | None]]

    def theta(self, N: int, device, dtype: torch.dtype):
        ocp = self.ocp
        kw: dict[str, Any] = {"x0": np.array(self.x0, dtype=float),
                              "p": np.array(self.p, dtype=float)}
        if ocp.exo_names:
            kw["d_traj"] = np.broadcast_to(
                np.array([self.exo[n] for n in ocp.exo_names], dtype=float),
                (N, len(ocp.exo_names))).copy()
        if isinstance(self.model, MLModel):
            # learned weights ride theta (ops/ml_transcription.py): each
            # agent's OWN surrogate parameters, even though
            # structure-identical agents share one transcription
            kw["ml_params"] = self.model.ml_params
        theta = ocp.default_params(device=device, dtype=dtype, **kw)
        # config-level lb/ub on couplings/controls override the model's
        if self.u_bounds:
            u_lb, u_ub = theta.u_lb.clone(), theta.u_ub.clone()
            for name, (lb, ub) in self.u_bounds.items():
                j = ocp.control_names.index(name)
                if lb is not None:
                    u_lb[:, j] = lb
                if ub is not None:
                    u_ub[:, j] = ub
            theta = theta._replace(u_lb=u_lb, u_ub=u_ub)
        return theta


def _find_admm_module(agent_cfg: Mapping) -> Mapping | None:
    for m in agent_cfg.get("modules", []):
        if m.get("type") in _ADMM_TYPES:
            return m
    return None


def _values(entries) -> dict[str, float]:
    return {e["name"]: e["value"] for e in (entries or []) if "value" in e}


class FusedFleet:
    """A fleet of config-defined ADMM agents as one fused engine.

    Build with :meth:`from_configs`; drive with :meth:`step` /
    :meth:`update_agent`. State (consensus means, multipliers, warm
    starts) persists across steps and is shift-warm-started by
    :meth:`advance` between control intervals. Runs on ``device`` (None:
    the card) in ``dtype``.
    """

    def __init__(self, agents: Sequence[_FleetAgent], N: int,
                 options: FusedADMMOptions, dt: float = 300.0,
                 record: bool = True, device=None,
                 dtype: torch.dtype = torch.float32):
        self._agents = list(agents)
        self.N = N
        self.dt = float(dt)
        self.time = 0.0
        self.device = resolve_device(device)
        self.dtype = dtype
        #: record per-step trajectories/residuals for :meth:`results` /
        #: :meth:`iteration_stats`; disable (or call
        #: :meth:`cleanup_results` periodically) for very long runs
        self.record = record
        self._history: dict[str, list[dict]] = {
            a.agent_id: [] for a in self._agents}
        self._stats_rows: list[dict] = []
        self._admm_rows: dict[str, list[dict]] = {}
        specs = [
            {"ocp": a.ocp, "theta": a.theta(N, self.device, dtype),
             "couplings": a.couplings, "exchanges": a.exchanges,
             "name": a.agent_id, "solver_options": a.solver_options}
            for a in self._agents
        ]
        groups, theta_batches, index_map = bucket_agents(specs)
        self.engine = FusedADMM(groups, options, record_locals=record,
                                device=self.device)
        self._theta_batches = list(theta_batches)
        self._index_map = index_map
        # agent_id -> (group index, position in the group batch)
        self._where: dict[str, tuple[int, int]] = {}
        for gi, members in enumerate(index_map):
            for slot, spec_idx in enumerate(members):
                self._where[self._agents[spec_idx].agent_id] = (gi, slot)
        self.state = self.engine.init_state(self._theta_batches)

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_configs(cls, configs: Sequence[Mapping],
                     options: FusedADMMOptions | None = None,
                     device=None, dtype: torch.dtype = torch.float32,
                     ) -> "FusedFleet":
        """Parse ``admm_local``-style agent configs into a fused fleet.

        Agents whose configs share model class, horizon, discretization
        and solver options batch into one group (one transcription per
        structure). Configs without an ADMM module (e.g. simulator agents)
        are skipped; plants stay outside and feed back via
        :meth:`update_agent`.
        """
        agents: list[_FleetAgent] = []
        ocp_cache: dict[tuple, TranscribedOCP] = {}
        N_ref: int | None = None
        dt_ref: float | None = None
        rho = None
        max_iterations = None
        for cfg in configs:
            m = _find_admm_module(cfg)
            if m is None:
                continue
            backend = m.get("optimization_backend") or {}
            N = int(m.get("prediction_horizon", 10))
            dt = float(m.get("time_step", 300.0))
            # ML-aware loading: configs with ml_model_sources come back as
            # MLModel and transcribe through the NARX path below
            model = load_model_for_backend(backend.get("model", {}), dt=dt)
            if N_ref is None:
                N_ref = N
            elif N != N_ref:
                raise ValueError(
                    f"fused fleet needs one shared horizon: agent "
                    f"{cfg.get('id')} has N={N}, fleet has N={N_ref}")
            if dt_ref is None:
                dt_ref = dt
            elif dt != dt_ref:
                raise ValueError(
                    f"fused fleet needs one shared time_step: agent "
                    f"{cfg.get('id')} has dt={dt}, fleet has {dt_ref}")
            for attr, current in (("penalty_factor", rho),
                                  ("max_iterations", max_iterations)):
                val = m.get(attr)
                if val is not None and current is not None and \
                        val != current:
                    raise ValueError(
                        f"fused fleet needs one shared {attr}: agent "
                        f"{cfg.get('id')} has {val}, fleet has {current}")
            rho = m.get("penalty_factor", rho)
            max_iterations = m.get("max_iterations", max_iterations)

            couplings, exchanges, u_bounds = {}, {}, {}
            control_names = [e["name"] for e in m.get("controls", [])]

            def _merge_bounds(e):
                old = u_bounds.get(e["name"], (None, None))
                u_bounds[e["name"]] = (e.get("lb", old[0]),
                                       e.get("ub", old[1]))

            for e in m.get("controls", []):
                if "lb" in e or "ub" in e:
                    _merge_bounds(e)
            model_controls = {v.name for v in model.inputs}
            for kind, target in (("couplings", couplings),
                                 ("exchange", exchanges)):
                for e in m.get(kind, []):
                    name, alias = e["name"], e.get("alias", e["name"])
                    if name not in model_controls:
                        raise NotImplementedError(
                            f"agent {cfg.get('id')}: coupling '{name}' is "
                            f"not a control input of "
                            f"{type(model).__name__} — output-expression "
                            f"couplings run on the module path "
                            f"(modules/admm.py), not the fused bridge")
                    target[alias] = name
                    if name not in control_names:
                        control_names.append(name)
                    if "lb" in e or "ub" in e:
                        _merge_bounds(e)

            if isinstance(model, MLModel):
                # NARX shooting over the learned step (discretization
                # options do not apply: the surrogate is the integrator).
                # The cache key carries the surrogate's lag STRUCTURE:
                # same-structure agents share one transcription (their
                # weights ride theta.ml_params); different lag layouts
                # need their own
                key = (type(model), tuple(control_names), N, dt, "ml",
                       tuple(sorted(model.ml_lags.items())))
                if key not in ocp_cache:
                    ocp_cache[key] = transcribe_ml(model, control_names,
                                                   N=N, dt=dt)
            else:
                trans_kwargs = transcription_kwargs_from_config(
                    backend.get("discretization_options"))
                key = (type(model), tuple(control_names), N, dt,
                       tuple(sorted(trans_kwargs.items())))
                if key not in ocp_cache:
                    ocp_cache[key] = transcribe(model, control_names, N=N,
                                                dt=dt, **trans_kwargs)
            ocp = ocp_cache[key]

            state_vals = _values(m.get("states"))
            # ML OCPs order their state vector by dyn_names (NARX +
            # white-box states); physical OCPs by diff_state_names
            state_names = list(getattr(ocp, "dyn_names", None)
                               or model.diff_state_names)
            x0 = np.array([
                state_vals.get(n, model.get_var(n).value)
                for n in state_names], dtype=float)
            param_vals = _values(m.get("parameters"))
            p = np.array([
                param_vals.get(v.name, v.value) for v in model.parameters],
                dtype=float)
            input_vals = _values(m.get("inputs"))
            exo = {}
            for n in ocp.exo_names:
                val = input_vals.get(n, model.get_var(n).value)
                if val is None:
                    raise ValueError(
                        f"agent {cfg.get('id', f'agent{len(agents)}')!r}: "
                        f"exogenous input {n!r} has no value in the config "
                        f"and no default in the model — add it to the "
                        f"module's 'inputs' list or give the model "
                        f"variable a default value")
                exo[n] = float(val)

            agents.append(_FleetAgent(
                agent_id=str(cfg.get("id", f"agent{len(agents)}")),
                model=model, ocp=ocp, couplings=couplings,
                exchanges=exchanges,
                solver_options=solver_options_from_config(
                    backend.get("solver")),
                x0=x0, p=p, exo=exo, u_bounds=u_bounds))

        if not agents:
            raise ValueError("no ADMM modules found in the given configs")
        if options is None:
            options = FusedADMMOptions(
                max_iterations=int(max_iterations or 10),
                rho=float(rho if rho is not None else 10.0))
        return cls(agents, N_ref, options, dt=dt_ref, device=device,
                   dtype=dtype)

    # -- runtime --------------------------------------------------------------

    def update_agent(self, agent_id: str, x0=None, inputs=None,
                     parameters=None) -> None:
        """Feed plant state / disturbance / parameter updates back into an
        agent before the next :meth:`step`."""
        a = self._agents_by_id()[agent_id]
        if x0 is not None:
            a.x0 = np.asarray(x0, dtype=float)
        for name, val in (inputs or {}).items():
            if name not in a.exo:
                raise KeyError(
                    f"{agent_id}: '{name}' is not an exogenous input of "
                    f"its OCP (has: {sorted(a.exo)}) — controls and "
                    f"couplings are decided by the solver, not fed back")
            a.exo[name] = float(val)
        if parameters is not None:
            byname = {v.name: i for i, v in enumerate(a.model.parameters)}
            for name, val in parameters.items():
                a.p[byname[name]] = float(val)
        gi, slot = self._where[agent_id]
        theta = a.theta(self.N, self.device, self.dtype)

        def put(batch, leaf):
            batch = batch.clone()
            batch[slot] = leaf
            return batch

        self._theta_batches[gi] = tree_map(put, self._theta_batches[gi],
                                           theta)

    def step(self) -> dict[str, dict]:
        """One coordinated ADMM round for the whole fleet.

        Returns per-agent results: ``{"u": {name: (N,) array}, "x": ...,
        "converged": bool, "iterations": int}`` (numpy, on the host).
        ``converged`` and ``iterations`` are fleet-wide values replicated
        into every agent's dict.
        """
        self.state, trajs, stats = self.engine.step(
            self.state, self._theta_batches)
        # one device→host transfer per trajectory leaf, then indexed
        host = [{k: v.detach().cpu().numpy() for k, v in tr.items()}
                for tr in trajs]
        converged = bool(stats.converged)
        it = int(stats.iterations)
        out: dict[str, dict] = {}
        for a in self._agents:
            gi, slot = self._where[a.agent_id]
            tr = host[gi]
            u = tr["u"][slot]                      # (N, n_u)
            res = {
                "u": {n: u[:, j]
                      for j, n in enumerate(a.ocp.control_names)},
                "converged": converged,
                "iterations": it,
            }
            if "x" in tr:
                res["x"] = tr["x"][slot]
            out[a.agent_id] = res
            if self.record:
                self._history[a.agent_id].append({
                    "time": self.time,
                    "traj": {k: v[slot] + (self.time
                             if k in ("time_state", "time_control")
                             else 0.0)
                             for k, v in tr.items()},
                })
        if self.record:
            np_ = lambda t: t.detach().cpu().numpy()
            self._stats_rows.append({
                "time": self.time,
                "primal": np_(stats.primal_residuals)[:it],
                "dual": np_(stats.dual_residuals)[:it],
                # per-alias ρ histories; "rho" keeps the mean trail
                "rho": np.mean([np_(v)[:it]
                                for v in stats.penalty.values()], axis=0),
                "rho_per_alias": {a: np_(v)[:it]
                                  for a, v in stats.penalty.items()},
            })
            # per-iteration local coupling trajectories per agent
            per_agent: dict[str, dict[str, np.ndarray]] = {}
            for kind, hist in (("consensus", stats.coupling_locals),
                               ("exchange", stats.exchange_locals)):
                for alias, arr in (hist or {}).items():
                    arr = np_(arr)[:it]               # (it, n_part, T)
                    for a in self._agents:
                        amap = (a.couplings if kind == "consensus"
                                else a.exchanges)
                        if alias not in amap:
                            continue
                        gi, slot = self._where[a.agent_id]
                        row = self.engine.participant_offset(
                            alias, kind, gi) + slot
                        per_agent.setdefault(a.agent_id, {})[alias] = \
                            arr[:, row, :]           # (it, T)
            for aid, aliases_d in per_agent.items():
                self._admm_rows.setdefault(aid, []).append(
                    {"time": self.time, "aliases": aliases_d})
        self._last_stats = stats
        return out

    def advance(self) -> None:
        """Shift-by-one warm start + clock advance between control
        intervals."""
        self.state = self.engine.shift_state(self.state)
        self.time += self.dt

    # -- checkpoint/resume ------------------------------------------------------

    def _checkpoint_tree(self) -> dict:
        return {"state": self.state, "time": self.time,
                "theta_batches": list(self._theta_batches)}

    def save_checkpoint(self, path: str) -> str:
        """Persist the fleet's control state — consensus means,
        multipliers, primal/dual warm starts, clock and the current
        per-agent parameter batches — to ``path`` (a directory, the port's
        format: ``utils/checkpoint.py``). Results and stats history are
        not included."""
        from agentlib_mpc_torch.utils.checkpoint import save_pytree

        return save_pytree(path, self._checkpoint_tree())

    def restore_checkpoint(self, path: str) -> None:
        """Restore state saved by :meth:`save_checkpoint` into this
        (structurally identical, freshly built) fleet."""
        from agentlib_mpc_torch.utils.checkpoint import load_pytree

        tree = load_pytree(path, self._checkpoint_tree())
        self.state = tree["state"]
        self.time = float(tree["time"])
        self._theta_batches = list(tree["theta_batches"])

    # -- results (reference layouts) --------------------------------------------

    def results(self, agent_id: str):
        """(time, grid) MultiIndex trajectory DataFrame for one agent."""
        from agentlib_mpc_torch.utils.results import (
            mpc_trajectory_frame,
            trajectory_layout,
        )

        a = self._agents_by_id()[agent_id]
        return mpc_trajectory_frame(
            self._history[agent_id],
            trajectory_layout(a.model, a.ocp.control_names, ocp=a.ocp))

    def admm_results(self, agent_id: str):
        """(time, iteration, grid) MultiIndex frame of one agent's local
        coupling trajectories per fused iteration."""
        from agentlib_mpc_torch.utils.results import (
            admm_iteration_frame,
            concat_admm_frames,
        )

        rows = self._admm_rows.get(agent_id)
        if not rows:
            return None
        grid = np.arange(self.N) * self.dt
        frames = []
        for row in rows:
            per_alias = row["aliases"]               # alias -> (it, T)
            n_it = next(iter(per_alias.values())).shape[0]
            frames.append(admm_iteration_frame(
                row["time"], range(n_it), grid, per_alias))
        return concat_admm_frames(frames)

    def cleanup_results(self) -> None:
        """Drop recorded history (bounds memory on long closed loops)."""
        for rows in self._history.values():
            rows.clear()
        self._stats_rows.clear()
        self._admm_rows.clear()

    def iteration_stats(self):
        """(time, iteration)-indexed residual/penalty trail of every
        fused round."""
        import pandas as pd

        if not self._stats_rows:
            return None
        frames = []
        for row in self._stats_rows:
            df = pd.DataFrame({"primal_residual": row["primal"],
                               "dual_residual": row["dual"],
                               "penalty_parameter": row["rho"]})
            df.index = pd.MultiIndex.from_product(
                [[row["time"]], range(len(row["primal"]))],
                names=["time", "iteration"])
            frames.append(df)
        return pd.concat(frames)

    @property
    def last_stats(self):
        return getattr(self, "_last_stats", None)

    def _agents_by_id(self) -> dict[str, _FleetAgent]:
        return {a.agent_id: a for a in self._agents}
