"""Central-MPC backend and the config translators shared by the backends.

Port of ``agentlib_mpc_tpu/backends/mpc_backend.py``. :class:`JAXBackend`
keeps the JAX package's class and registered names (``"jax"``,
``"jax_full"``, ``"casadi"``, ``"casadi_basic"``) so reference configs run
unchanged; where the JAX package compiles one step with ``jax.jit``, the
port runs the same step as a plain function on tensors on the backend's
device: input assembly on the host (numpy, as in the JAX package), then
parameters, bounds, the interior-point (or QP) solve, trajectory
extraction and the shift on the device, and ``u0``, the trajectories and
the stats row back to the host once per solve. The scenario-tree helpers
(:func:`scenario_engine`, :func:`robust_scenario_controls`) run a
single-agent :class:`~agentlib_mpc_torch.scenario.fleet.ScenarioFleet`.
"""

from __future__ import annotations

import time as _time
from typing import Any

import numpy as np
import torch

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.backends.backend import (
    OptimizationBackend,
    VariableReference,
    load_model,
    register_backend,
)
from agentlib_mpc_torch.ops.solver import SolverOptions, solve_nlp
from agentlib_mpc_torch.ops.transcription import transcribe
from agentlib_mpc_torch.utils.sampling import sample

#: dtype of the QP routing's certificate and probe (the fused engine's)
_ROUTING_DTYPE = torch.float64


def transcription_kwargs_from_config(disc: dict) -> dict:
    """Translate reference-style ``discretization_options`` into
    ``transcribe`` keyword arguments."""
    disc = dict(disc or {})
    if disc.get("method", "collocation") == "multiple_shooting":
        return dict(
            method="multiple_shooting",
            integrator=disc.get("integrator", "rk4"),
            integrator_substeps=int(disc.get("integrator_substeps", 3)),
        )
    return dict(
        method="collocation",
        collocation_degree=int(disc.get("collocation_order", 3)),
        collocation_method=disc.get("collocation_method", "radau"),
    )


def solver_options_from_config(cfg: dict) -> SolverOptions:
    """Translate a reference-style solver config into SolverOptions.
    Unknown keys (e.g. the reference's ipopt-specific options) are ignored
    so existing configs keep working."""
    cfg = dict(cfg or {})
    cfg.pop("name", None)  # reference: solver name (ipopt/fatrop/...)
    cfg.pop("options", None)
    # derived, not config-expressible: attached from the transcribed OCP
    cfg.pop("stage_partition", None)
    cfg.pop("stage_jacobian_plan", None)
    known = SolverOptions._fields
    return SolverOptions(**{k: v for k, v in cfg.items() if k in known})


def attach_stage_partition(options: SolverOptions, ocp) -> SolverOptions:
    """Wire a transcribed OCP's stage partition into solver options, so
    ``kkt_method="auto"`` can route long horizons to the stage sweep."""
    from agentlib_mpc_torch.ops.solver import attach_stage_partition as attach

    return attach(options, getattr(ocp, "stage_partition", None))


def attach_derivative_plan(options: SolverOptions, ocp, nlp=None,
                           theta=None, logger=None,
                           label: "str | None" = None,
                           device=None) -> SolverOptions:
    """Wire the certified stage-sparse derivative plan into solver
    options (``stagejac.attach_plan_if_worthwhile``). Pass ``nlp``/
    ``theta`` for an augmented problem; by default the OCP's own ``nlp``
    is certified at its default parameters on ``device`` (None: the
    card)."""
    from agentlib_mpc_torch.ops import stagejac

    return stagejac.attach_plan_if_worthwhile(
        options, getattr(ocp, "stage_partition", None),
        ocp.nlp if nlp is None else nlp,
        ocp.default_params(device=device) if theta is None else theta,
        ocp.n_w, log=logger, label=label or "the transcribed OCP",
        device=device)


def _solve_qp_one(nlp, w0, theta, w_lb, w_ub, options, y0=None, z0=None,
                  mu0=None):
    """One LQ program through the batched QP solver (a batch of one)."""
    from torch.utils._pytree import tree_map

    from agentlib_mpc_torch.ops.qp import solve_qp
    from agentlib_mpc_torch.ops.solver import SolverResult, SolverStats

    add = lambda t: t.unsqueeze(0) if isinstance(t, torch.Tensor) else t
    res = solve_qp(nlp, add(w0), tree_map(add, theta), add(w_lb),
                   add(w_ub), options, y0=add(y0), z0=add(z0), mu0=mu0)
    drop = lambda t: t[0] if isinstance(t, torch.Tensor) else t
    return SolverResult(w=res.w[0], y=res.y[0], z=res.z[0], s=res.s[0],
                        stats=SolverStats(*(drop(v) for v in res.stats)))


@register_backend("jax", "jax_full", "casadi", "casadi_basic")
class JAXBackend(OptimizationBackend):
    """Central MPC: states/controls/inputs/params against one model, on the
    backend's device in its dtype. The JAX package's class name, kept so
    configs and user code that name it run unchanged."""

    def setup_optimization(self, var_ref: VariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        if var_ref.binary_controls:
            raise NotImplementedError(
                "this backend ignores binary_controls; use the MINLP "
                "backend (type 'jax_minlp') for mixed-integer problems")
        self.var_ref = var_ref
        self.time_step = float(time_step)
        self.N = int(prediction_horizon)
        self.model = load_model(self.config["model"])
        trans_kwargs = transcription_kwargs_from_config(
            self.config.get("discretization_options"))
        self.ocp = transcribe(self.model, var_ref.controls, N=self.N,
                              dt=self.time_step, **trans_kwargs)
        self.solver_options = attach_derivative_plan(
            attach_stage_partition(
                solver_options_from_config(self.config.get("solver")),
                self.ocp),
            self.ocp, logger=self.logger,
            label=f"the {type(self).__name__} OCP", device=self.device)
        self._exo_names = list(self.ocp.exo_names)
        #: model-default parameters on the device; each solve replaces the
        #: per-solve leaves
        self._theta0 = self.ocp.default_params(device=self.device,
                                               dtype=self.dtype)
        self._resolve_qp_fast_path()
        self._build_step_fn()
        self._reset_warm_start()
        if self.config.get("precompile"):
            self._precompile()

    def _resolve_qp_fast_path(self) -> None:
        """Route LQ problems (linear model, quadratic objective) to the
        Mehrotra QP solver. Config key ``solver.qp_fast_path``: ``"auto"``
        (default — the ``lint/fx`` LQ certificate decides at setup, sound
        for every theta, with the sampled probe as cross-check/fallback),
        ``"on"`` (force; the caller asserts LQ-ness), ``"off"``."""
        from agentlib_mpc_torch.ops.qp import is_lq, resolve_qp_routing

        theta0 = self.ocp.default_params(device=self.device,
                                         dtype=_ROUTING_DTYPE)
        n = self.ocp.n_w

        def certifier():
            from agentlib_mpc_torch.lint.fx import certify_lq

            return certify_lq(self.ocp.nlp, theta0, n)

        def probe():
            return is_lq(self.ocp.nlp, theta0, n)

        self.uses_qp_fast_path = resolve_qp_routing(
            str((self.config.get("solver") or {})
                .get("qp_fast_path", "auto")),
            probe, logger=self.logger,
            label=f"the {type(self).__name__} OCP",
            certifier=certifier)

    def _precompile(self) -> None:
        """One throwaway solve at setup with default inputs (the JAX
        package compiles its step here; the port has nothing to compile,
        but the first solve still builds the CUDA kernels and warms the
        allocator). Telemetry recording is suppressed for it, and the warm
        start is reset after it."""
        self._suppress_record = True
        try:
            self.solve(0.0, {})
        finally:
            self._suppress_record = False
        self.stats_history.clear()
        self._reset_warm_start()

    # -- the solve step (device side) ------------------------------------------

    def _build_step_fn(self) -> None:
        ocp = self.ocp
        opts = self.solver_options
        solver_fn = _solve_qp_one if self.uses_qp_fast_path else solve_nlp
        theta0 = self._theta0

        def step(x0, u_prev, d_traj, p, x_lb, x_ub, u_lb, u_ub,
                 w_guess, y_guess, z_guess, mu0, t0):
            theta = theta0._replace(
                x0=x0, u_prev=u_prev, d_traj=d_traj, p=p, x_lb=x_lb,
                x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0)
            lb, ub = ocp.bounds(theta)
            res = solver_fn(ocp.nlp, w_guess, theta, lb, ub, opts,
                            y0=y_guess, z0=z_guess, mu0=mu0)
            traj = ocp.trajectories(res.w, theta)
            u0 = torch.clamp(traj["u"][0], theta.u_lb[0], theta.u_ub[0])
            w_next = ocp.shift_guess(res.w, theta)
            return u0, traj, w_next, res.y, res.z, res.stats

        self._step = step

    def _reset_warm_start(self) -> None:
        theta0 = self._theta0
        self._w_guess = self.ocp.initial_guess(theta0)
        self._y_guess = torch.zeros((self.ocp.n_g,), dtype=self.dtype,
                                    device=self.device)
        self._z_guess = torch.full((self.ocp.n_h,), 0.1, dtype=self.dtype,
                                   device=self.device)
        self._cold = True

    # -- per-solve input assembly (host side) ---------------------------------

    def _collect(self, now: float, variables: dict[str, Any]):
        model = self.model
        vr = self.var_ref
        N = self.N
        grid_u = np.arange(N) * self.time_step

        def val_of(name, default):
            v = variables.get(name)
            return default if v is None else v

        x0 = np.array([
            float(np.asarray(val_of(n, model.get_var(n).value)).reshape(-1)[0])
            for n in model.diff_state_names])
        u_prev = np.array([
            float(np.asarray(val_of(n, model.get_var(n).value)).reshape(-1)[0])
            for n in vr.controls]) if vr.controls else np.zeros(0)

        d_traj = np.zeros((N, len(self._exo_names)))
        for j, name in enumerate(self._exo_names):
            d_traj[:, j] = sample(val_of(name, model.get_var(name).value),
                                  grid_u, current=now)

        p = np.array([float(val_of(n, model.get_var(n).value))
                      for n in model.parameter_names])

        def bound_traj(names, grid, kind):
            out = np.zeros((len(grid), len(names)))
            for j, n in enumerate(names):
                b = variables.get(f"{n}__{kind}")
                if b is None:
                    b = getattr(model.get_var(n), kind)
                out[:, j] = sample(b, grid, current=now)
            return out

        grid_x = np.arange(N + 1) * self.time_step
        x_lb = bound_traj(model.diff_state_names, grid_x, "lb")
        x_ub = bound_traj(model.diff_state_names, grid_x, "ub")
        u_lb = bound_traj(vr.controls, grid_u, "lb")
        u_ub = bound_traj(vr.controls, grid_u, "ub")
        return x0, u_prev, d_traj, p, x_lb, x_ub, u_lb, u_ub

    def solve(self, now: float, variables: dict[str, Any]) -> dict:
        host = self._collect(now, variables)
        args = [torch.as_tensor(a, dtype=self.dtype, device=self.device)
                for a in host]
        mu0 = self.solver_options.mu_init if self._cold else 1e-2
        t0 = torch.tensor(float(now), dtype=self.dtype, device=self.device)
        t_start = _time.perf_counter()
        with telemetry.span("backend.solve", backend=type(self).__name__,
                            instance=f"{id(self):x}"):
            u0, traj, w_next, y_next, z_next, stats = self._step(
                *args, self._w_guess, self._y_guess, self._z_guess, mu0,
                t0)
            # the one transfer of the controls back to the host; it
            # waits for the solve
            u0 = u0.cpu().numpy()
        wall = _time.perf_counter() - t_start
        self._carry_warm_start(w_next, y_next, z_next, now=now)

        stats_row = self.solver_stats_row(stats, now, wall)
        self._record_solve(stats_row)
        return {
            "u0": {n: float(u0[i])
                   for i, n in enumerate(self.var_ref.controls)},
            "traj": {k: v.detach().cpu().numpy() for k, v in traj.items()},
            "stats": stats_row,
        }


# -- scenario-tree robust solve ----------------------------------------------


_SCENARIO_ENGINES: dict = {}
_SCENARIO_ENGINES_MAX = 8


def scenario_engine(ocp, tree, solver_options: SolverOptions,
                    fleet_options=None, device=None,
                    dtype: torch.dtype = torch.float32):
    """One cached single-agent scenario engine per (OCP, tree, options,
    device, dtype): the backend-level entry to scenario-tree robust MPC. A
    single agent with no consensus alias leaves exactly the
    non-anticipativity coupling, so a backend evaluates S disturbance
    branches in one batched round instead of S serial solves. Engines are
    memoized (bounded, oldest out); the device and dtype in the key keep a
    card engine and a CPU engine of one OCP apart. ``device`` None is the
    card."""
    from agentlib_mpc_torch.parallel.fused_admm import AgentGroup
    from agentlib_mpc_torch.scenario import (
        ScenarioFleet,
        ScenarioFleetOptions,
    )
    from agentlib_mpc_torch.utils.device import resolve_device

    dev = resolve_device(device)
    fleet_options = fleet_options or ScenarioFleetOptions()
    key = (id(ocp), tree, solver_options, fleet_options, dev, dtype)
    hit = _SCENARIO_ENGINES.get(key)
    if hit is not None:
        return hit[0]
    group = AgentGroup(name="scenario-backend", ocp=ocp, n_agents=1,
                       solver_options=solver_options)
    fleet = ScenarioFleet(group, tree, fleet_options, device=dev)
    while len(_SCENARIO_ENGINES) >= _SCENARIO_ENGINES_MAX:
        _SCENARIO_ENGINES.pop(next(iter(_SCENARIO_ENGINES)))
    # pin the ocp so a recycled id() can never alias another structure
    _SCENARIO_ENGINES[key] = (fleet, ocp)
    return fleet


def robust_scenario_controls(ocp, theta, tree,
                             solver_options: SolverOptions = SolverOptions(),
                             fleet_options=None, state=None):
    """Solve one agent's scenario tree and return the robust controls
    ``(u0 (n_u,) numpy, state, stats)``: ``u0`` is the non-anticipativity
    projection's first-interval group mean, identical across every branch
    by construction (the scenario-tree analogue of the nominal backend's
    ``u[0]``). ``theta`` is a scenario-stacked (S, ...) OCPParams batch
    (:func:`agentlib_mpc_torch.scenario.generate.ensemble_thetas` builds
    it); the engine runs on its device and in its dtype. Pass the returned
    ``state`` back in for warm-started re-solves."""
    from torch.utils._pytree import tree_map

    fleet = scenario_engine(ocp, tree, solver_options, fleet_options,
                            device=theta.d_traj.device,
                            dtype=theta.d_traj.dtype)
    theta_batch = tree_map(lambda leaf: leaf[None], theta)
    if state is None:
        state = fleet.init_state(theta_batch)
    state, _trajs, stats = fleet.step(state, theta_batch)
    u0 = fleet.actuated_u0(state)[0, 0].detach().cpu().numpy()
    return u0, fleet.shift_state(state), stats
