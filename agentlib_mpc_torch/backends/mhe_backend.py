"""MHE backend: backwards-horizon state/parameter/input estimation.

Port of ``agentlib_mpc_tpu/backends/mhe_backend.py`` (the reference's MHE
backend, ``optimization_backends/casadi_/mhe.py``: `MHESystem` :34-123
declares the estimation quantities, `MHEBackend.sample` :414-542 samples
past trajectories onto the backwards grid).

MHE is a *model transformation* plus the standard transcription with a
free initial state:

- estimated parameters become extra states with ``dp/dt = 0`` and a free
  initial value (so both collocation and shooting estimate them natively),
- each tracked state gains ``measured_<s>`` / ``weight_<s>`` exogenous
  inputs and the tracking objective ``Σ w_s (s − s_meas)²``
  (reference objective assembly, ``mhe.py:108-115``),
- estimated inputs are the transcription's "controls",
- ``transcribe(..., fix_initial_state=False)`` leaves the whole state
  trajectory free, anchored only by the tracking cost.

The solve runs on the grid ``[now − N·dt, now]`` with known inputs and
measurements sampled backwards from the module's history. Where the JAX
package compiles the step with ``jax.jit``, the port runs it as a plain
function on tensors on the backend's device, in its dtype; the QP routing
is the port's certificate (``lint/fx``), as in :class:`JAXBackend`.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, List

import numpy as np
import torch

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.backends.backend import (
    OptimizationBackend,
    load_model,
    register_backend,
)
from agentlib_mpc_torch.backends.mpc_backend import (
    _ROUTING_DTYPE,
    _solve_qp_one,
    attach_derivative_plan,
    attach_stage_partition,
    solver_options_from_config,
    transcription_kwargs_from_config,
)
from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.objective import SubObjective
from agentlib_mpc_torch.models.variables import Var
from agentlib_mpc_torch.ops.solver import solve_nlp
from agentlib_mpc_torch.ops.transcription import transcribe
from agentlib_mpc_torch.utils.sampling import sample

MEASURED_PREFIX = "measured_"
WEIGHT_PREFIX = "weight_"


@dataclasses.dataclass
class MHEVariableReference:
    """Roles of the module variables in the estimation problem (reference
    ``mpc_datamodels.MHEVariableReference``)."""

    states: List[str] = dataclasses.field(default_factory=list)
    measured_states: List[str] = dataclasses.field(default_factory=list)
    weights_states: List[str] = dataclasses.field(default_factory=list)
    estimated_inputs: List[str] = dataclasses.field(default_factory=list)
    known_inputs: List[str] = dataclasses.field(default_factory=list)
    estimated_parameters: List[str] = dataclasses.field(default_factory=list)
    known_parameters: List[str] = dataclasses.field(default_factory=list)
    outputs: List[str] = dataclasses.field(default_factory=list)

    def all_names(self) -> list[str]:
        return [*self.states, *self.estimated_inputs, *self.known_inputs,
                *self.estimated_parameters, *self.known_parameters,
                *self.outputs]


def make_mhe_model(base: Model, estimated_parameters: List[str],
                   tracked_states: List[str]) -> Model:
    """Derive the estimation model from the plant model.

    The derived model's ``setup`` reuses the base equations, zeroes the
    base objective (the reference's MHE cost is tracking-only,
    ``mhe.py:108-115``), adds ``dp/dt = 0`` for estimated parameters and
    the weighted tracking cost for measured states.
    """
    for p in estimated_parameters:
        if p not in base.parameter_names:
            raise ValueError(f"estimated parameter {p!r} not in model")
    for s in tracked_states:
        if s not in base.state_names:
            raise ValueError(f"tracked state {s!r} not in model")

    est_set = set(estimated_parameters)
    base_cls = type(base)

    param_states = []
    for p in base.parameters:
        if p.name in est_set:
            param_states.append(Var(
                name=p.name, value=p.value, lb=p.lb, ub=p.ub, role="state",
                unit=p.unit, description=f"estimated parameter {p.name}"))

    aux_inputs = []
    for s in tracked_states:
        sv = base.get_var(s)
        aux_inputs.append(Var(name=MEASURED_PREFIX + s, value=sv.value,
                              role="input"))
        aux_inputs.append(Var(name=WEIGHT_PREFIX + s, value=0.0,
                              role="input"))

    class _MHEModel(Model):
        inputs = [*base.inputs, *aux_inputs]
        states = [*base.states, *param_states]
        parameters = [p for p in base.parameters if p.name not in est_set]
        outputs = list(base.outputs)
        dt = base.dt

        def setup(self, v) -> ModelEquations:
            eq = base_cls.setup(base, v)
            for name in estimated_parameters:
                eq.ode(name, 0.0)
            track = 0.0
            for s in tracked_states:
                track = track + v[WEIGHT_PREFIX + s] * (
                    v[s] - v[MEASURED_PREFIX + s]) ** 2
            eq.objective = SubObjective(track, name="mhe_tracking")
            return eq

    _MHEModel.__name__ = f"MHE_{base_cls.__name__}"
    return _MHEModel()


@register_backend("jax_mhe", "casadi_mhe")
class MHEBackend(OptimizationBackend):
    """Weighted least-squares estimation over a backwards horizon."""

    def setup_optimization(self, var_ref: MHEVariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        self.var_ref = var_ref
        self.time_step = float(time_step)
        self.N = int(prediction_horizon)
        base = load_model(self.config["model"])
        self.base_model = base
        tracked = [n[len(MEASURED_PREFIX):] for n in var_ref.measured_states]
        self.tracked_states = tracked
        self.model = make_mhe_model(base, var_ref.estimated_parameters,
                                    tracked)
        kwargs = transcription_kwargs_from_config(
            self.config.get("discretization_options"))
        self.ocp = transcribe(self.model, var_ref.estimated_inputs,
                              N=self.N, dt=self.time_step,
                              fix_initial_state=False, **kwargs)
        self.solver_options = attach_derivative_plan(
            attach_stage_partition(
                solver_options_from_config(self.config.get("solver")),
                self.ocp),
            self.ocp, logger=self.logger, label="the MHE OCP",
            device=self.device)
        self._exo_names = list(self.ocp.exo_names)
        self._theta0 = self.ocp.default_params(device=self.device,
                                               dtype=self.dtype)
        self._resolve_qp_fast_path()
        self._build_step_fn()
        self._reset_warm_start()

    def _resolve_qp_fast_path(self) -> None:
        """Linear plant + weighted least-squares tracking = an LQ
        estimation program. Measurements and weights ride in theta, so
        the certificate covers every measurement trajectory the module
        will ever sample (the probe remains as cross-check)."""
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
            probe, logger=self.logger, label="the MHE OCP",
            certifier=certifier)

    def _build_step_fn(self) -> None:
        ocp = self.ocp
        opts = self.solver_options
        solver_fn = _solve_qp_one if self.uses_qp_fast_path else solve_nlp
        theta0 = self._theta0

        def step(x0, d_traj, p, x_lb, x_ub, u_lb, u_ub,
                 w_guess, y_guess, z_guess, mu0, t0):
            theta = theta0._replace(
                x0=x0, d_traj=d_traj, p=p, x_lb=x_lb, x_ub=x_ub,
                u_lb=u_lb, u_ub=u_ub, t0=t0)
            lb, ub = ocp.bounds(theta)
            res = solver_fn(ocp.nlp, w_guess, theta, lb, ub, opts,
                            y0=y_guess, z0=z_guess, mu0=mu0)
            traj = ocp.trajectories(res.w, theta)
            return traj, res.w, res.y, res.z, res.stats

        self._step = step

    def _reset_warm_start(self) -> None:
        self._w_guess = self.ocp.initial_guess(self._theta0)
        self._y_guess = torch.zeros((self.ocp.n_g,), dtype=self.dtype,
                                    device=self.device)
        self._z_guess = torch.full((self.ocp.n_h,), 0.1, dtype=self.dtype,
                                   device=self.device)
        self._cold = True

    @property
    def estimation_grid(self) -> np.ndarray:
        """Backwards grid offsets [−N·dt … 0] (reference grid construction,
        ``casadi_/mhe.py:138-196``)."""
        return np.arange(-self.N, 1) * self.time_step

    def _collect(self, now: float, variables: dict[str, Any]):
        """Host-side inputs of one solve: x0 (the trajectory guess's
        anchor), the exogenous trajectories, parameters and bounds over
        ``[now − N·dt, now]``, and ``t0``."""
        model = self.model
        vr = self.var_ref
        N = self.N
        t0 = float(now) - N * self.time_step
        grid_u = np.arange(N) * self.time_step

        def val_of(name, default):
            v = variables.get(name)
            return default if v is None else v

        # backwards-sampled exogenous trajectories. Two grids:
        # - measured states and weights sample at interval END points
        #   ((i+1)·dt past t0): the newest measurement — taken at `now` —
        #   then enters the final interval's tracking cost and anchors the
        #   published estimate x(now) (the reference samples its
        #   measurement grid through `now` likewise,
        #   ``casadi_/mhe.py:414-542``).
        # - known applied inputs sample at interval STARTS: the broker
        #   holds a published value until the next publish (ZOH), so the
        #   value at t_i is what drove the plant over [t_i, t_i+dt].
        grid_end = (np.arange(N) + 1) * self.time_step
        d_traj = np.zeros((N, len(self._exo_names)))
        for j, name in enumerate(self._exo_names):
            is_meas = name.startswith(MEASURED_PREFIX) \
                or name.startswith(WEIGHT_PREFIX)
            d_traj[:, j] = sample(val_of(name, model.get_var(name).value),
                                  grid_end if is_meas else grid_u,
                                  current=t0)

        p = np.array([float(val_of(n, model.get_var(n).value))
                      for n in model.parameter_names])

        # initial-trajectory guess anchor: newest measurement per state,
        # current value for estimated parameter states
        x0 = []
        for n in model.diff_state_names:
            if n in self.tracked_states:
                meas = np.asarray(
                    sample(val_of(MEASURED_PREFIX + n,
                                  model.get_var(n).value),
                           grid_u, current=t0))
                x0.append(meas[0])
            else:
                v = val_of(n, model.get_var(n).value)
                x0.append(float(np.asarray(v, dtype=float).reshape(-1)[-1]))
        x0 = np.asarray(x0)

        grid_x = np.arange(N + 1) * self.time_step

        def bound_traj(names, grid, kind):
            out = np.zeros((len(grid), len(names)))
            for j, n in enumerate(names):
                b = variables.get(f"{n}__{kind}")
                if b is None:
                    b = getattr(model.get_var(n), kind)
                out[:, j] = sample(b, grid, current=t0)
            return out

        x_lb = bound_traj(model.diff_state_names, grid_x, "lb")
        x_ub = bound_traj(model.diff_state_names, grid_x, "ub")
        u_lb = bound_traj(vr.estimated_inputs, grid_u, "lb")
        u_ub = bound_traj(vr.estimated_inputs, grid_u, "ub")
        return x0, d_traj, p, x_lb, x_ub, u_lb, u_ub, t0

    def solve(self, now: float, variables: dict[str, Any]) -> dict:
        model = self.model
        vr = self.var_ref
        *host, t0 = self._collect(now, variables)
        args = [torch.as_tensor(a, dtype=self.dtype, device=self.device)
                for a in host]
        mu0 = self.solver_options.mu_init if self._cold else 1e-2
        t0 = torch.tensor(t0, dtype=self.dtype, device=self.device)
        t_start = _time.perf_counter()
        with telemetry.span("backend.solve", backend=type(self).__name__,
                            instance=f"{id(self):x}"):
            traj, w_next, y_next, z_next, stats = self._step(
                *args, self._w_guess, self._y_guess, self._z_guess, mu0, t0)
            # the one transfer of the trajectories back to the host; it
            # waits for the solve
            traj = {k: v.detach().cpu().numpy() for k, v in traj.items()}
        wall = _time.perf_counter() - t_start
        self._carry_warm_start(w_next, y_next, z_next, now=now)

        stats_row = self.solver_stats_row(stats, now, wall)
        self._record_solve(stats_row)

        x_traj, u_traj = traj["x"], traj["u"]
        estimates: dict[str, Any] = {}
        for i, n in enumerate(model.diff_state_names):
            if n in self.base_model.state_names:
                estimates[n] = float(x_traj[-1, i])
        for n in vr.estimated_parameters:
            estimates[n] = float(x_traj[-1, model.diff_state_names.index(n)])
        est_inputs = {n: u_traj[:, j]
                      for j, n in enumerate(vr.estimated_inputs)}
        return {
            "estimates": estimates,
            "estimated_inputs": est_inputs,
            "traj": traj,
            "stats": stats_row,
        }
