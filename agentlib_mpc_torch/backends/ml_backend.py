"""Data-driven (ML-surrogate) MPC backends.

Port of ``agentlib_mpc_tpu/backends/ml_backend.py``:
- ``jax_ml`` ↔ ``casadi_ml``/``casadi_nn`` (the reference's
  ``optimization_backends/casadi_/casadi_ml.py``: NARX shooting :111-373,
  lag collection contract ``get_lags_per_variable`` :388-397): the OCP
  evolves through the trained surrogate's discrete step instead of an
  integrator; past values of lagged variables arrive per solve and pad
  the pre-horizon window.
- ``jax_admm_ml`` ↔ ``casadi_admm_ml`` (``casadi_/casadi_admm_ml.py``): the
  same NARX OCP with consensus/exchange augmented-Lagrangian coupling
  terms for distributed MPC.

Where the JAX package compiles the step with ``jax.jit``, the port runs it
as a plain function on tensors on the backend's device, in its dtype, as
the other backends of the port do; every solve holds
``ops.solver.SOLVE_LOCK`` (inside ``solve_nlp``). The surrogate's weights
are a tensor argument of the step (a device copy of
``MLModel.ml_params``): a hot swap with the same lag structure replaces
them and keeps the transcription, one with a new lag structure
re-transcribes.
"""

from __future__ import annotations

import time as _time
from typing import Any

import numpy as np
import torch

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.backends.admm_backend import (
    ADMMVariableReference,
    EXCHANGE_MEAN_PREFIX,
    EXCHANGE_MULTIPLIER_PREFIX,
    MEAN_PREFIX,
    MULTIPLIER_PREFIX,
)
from agentlib_mpc_torch.backends.backend import (
    OptimizationBackend,
    VariableReference,
    load_model,
    register_backend,
)
from agentlib_mpc_torch.backends.mpc_backend import solver_options_from_config
from agentlib_mpc_torch.ml.predictors import cast_params
from agentlib_mpc_torch.ml.serialized import load_serialized_model
from agentlib_mpc_torch.models.ml_model import MLModel
from agentlib_mpc_torch.ops.admm import consensus_penalty, exchange_penalty
from agentlib_mpc_torch.ops.ml_transcription import transcribe_ml
from agentlib_mpc_torch.ops.solver import NLPFunctions, solve_nlp
from agentlib_mpc_torch.utils.sampling import sample


def load_ml_model(model_cfg, dt=None) -> MLModel:
    """Like `load_model` but wires ``ml_model_sources`` into the MLModel
    constructor (reference model config key, ``casadi_ml_model.py:61-122``)."""
    if isinstance(model_cfg, MLModel):
        return model_cfg
    model_cfg = dict(model_cfg)
    sources = model_cfg.pop("ml_model_sources", None)
    model = load_model(model_cfg, dt=dt)
    if not isinstance(model, MLModel):
        raise TypeError(
            f"ML backend requires an MLModel subclass, got "
            f"{type(model).__name__}")
    if sources:
        model.register_ml_models(
            *[load_serialized_model(s) for s in sources])
    return model


@register_backend("jax_ml", "casadi_ml", "casadi_nn")
class MLBackend(OptimizationBackend):
    """NARX multiple shooting over the unified ML predict step."""

    def setup_optimization(self, var_ref: VariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        self.var_ref = var_ref
        self.time_step = float(time_step)
        self.N = int(prediction_horizon)
        self.model = load_ml_model(self.config["model"], dt=self.time_step)
        self.solver_options = solver_options_from_config(
            self.config.get("solver"))
        self._transcribe()
        if self.config.get("precompile"):
            # one throwaway solve (the JAX package compiles here; the port
            # builds the CUDA kernels and warms the allocator)
            self._suppress_record = True
            try:
                self.solve(0.0, {})
            finally:
                self._suppress_record = False
            self.stats_history.clear()
            self._reset_warm_start()

    def _transcribe(self) -> None:
        self.ocp = transcribe_ml(self.model, self.var_ref.controls, N=self.N,
                                 dt=self.time_step)
        self._exo_names = list(self.ocp.exo_names)
        #: model-default parameters on the device; each solve replaces the
        #: per-solve leaves
        self._theta0 = self.ocp.default_params(device=self.device,
                                               dtype=self.dtype)
        self._build_step_fn()
        self._reset_warm_start()

    def get_lags_per_variable(self) -> dict[str, int]:
        return self.model.get_lags_per_variable()

    def trajectory_layout(self) -> dict[str, list[str]]:
        """NARX layout: learned (narx) states live in "x" alongside
        white-box ODE states; "z" holds only the remaining slack states
        (the shared ocp-aware contract in utils/results.py)."""
        from agentlib_mpc_torch.utils.results import trajectory_layout

        return trajectory_layout(self.model, self.ocp.control_names,
                                 ocp=self.ocp)

    def update_ml_models(self, *serialized) -> None:
        """Hot-swap retrained surrogates. Same lag structure → the new
        weights replace the step's weight argument; changed lags/columns →
        the NARX transcription's history windows are laid out differently,
        so the OCP is re-transcribed (silently keeping the old layout would
        time-shift every window)."""
        lags_before = dict(self.model.ml_lags)
        self.model.update_ml_models(
            *[load_serialized_model(s) for s in serialized])
        if self.model.ml_lags != lags_before:
            self.logger.info(
                "hot-swapped model changed lag structure %s -> %s; "
                "re-transcribing", lags_before, self.model.ml_lags)
            self._transcribe()
        else:
            self._theta0 = self._theta0._replace(ml_params=cast_params(
                self.model.ml_params, self.device, self.dtype))

    # -- the solve step (device side) -----------------------------------------

    def _build_step_fn(self) -> None:
        ocp = self.ocp
        opts = self.solver_options

        def step(x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub,
                 ml_params, w_guess, y_guess, z_guess, mu0, t0):
            theta = self._theta0._replace(
                x0=x0, u_prev=u_prev, past=past, d_traj=d_traj, p=p,
                x_lb=x_lb, x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0,
                ml_params=ml_params)
            lb, ub = ocp.bounds(theta)
            res = solve_nlp(ocp.nlp, w_guess, theta, lb, ub, opts,
                            y0=y_guess, z0=z_guess, mu0=mu0)
            traj = ocp.trajectories(res.w, theta)
            u0 = torch.clamp(traj["u"][0], theta.u_lb[0], theta.u_ub[0])
            w_next = ocp.shift_guess(res.w, theta)
            return u0, traj, w_next, res.y, res.z, res.stats

        self._step = step

    def _reset_warm_start(self) -> None:
        self._w_guess = self.ocp.initial_guess(self._theta0)
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
        dt = self.time_step
        grid_u = np.arange(N) * dt

        def val_of(name, default):
            v = variables.get(name)
            return default if v is None else v

        def now_value(name):
            """Newest scalar from a value that may be a history series."""
            v = val_of(name, model.get_var(name).value)
            if np.isscalar(v) or (isinstance(v, np.ndarray) and v.ndim == 0):
                return float(v)
            return float(sample(v, [0.0], current=now)[0])

        x0 = np.array([now_value(n) for n in self.ocp.dyn_names])
        u_prev = np.array([now_value(n) for n in vr.controls]) \
            if vr.controls else np.zeros(0)

        # pre-horizon lag windows: values at now−dt, now−2dt, … — history
        # series (pd.Series / (times, values)) interpolate; scalars broadcast
        # (reference pre-horizon grid, casadi_ml.py:121-154)
        past = {}
        for name in model.history_names:
            L = max(model.ml_lags.get(name, 1), 1)
            if L <= 1:
                past[name] = np.zeros((0,))
                continue
            grid_past = -np.arange(1, L) * dt
            v = val_of(name, model.get_var(name).value)
            past[name] = np.asarray(sample(v, grid_past, current=now))

        d_traj = np.zeros((N, len(self._exo_names)))
        for j, name in enumerate(self._exo_names):
            d_traj[:, j] = sample(val_of(name, model.get_var(name).value),
                                  grid_u, current=now)
        p = np.array([now_value(n) for n in model.parameter_names])

        def bound_traj(names, grid, kind):
            out = np.zeros((len(grid), len(names)))
            for j, n in enumerate(names):
                b = variables.get(f"{n}__{kind}")
                if b is None:
                    b = getattr(model.get_var(n), kind)
                out[:, j] = sample(b, grid, current=now)
            return out

        grid_x = np.arange(N + 1) * dt
        x_lb = bound_traj(self.ocp.dyn_names, grid_x, "lb")
        x_ub = bound_traj(self.ocp.dyn_names, grid_x, "ub")
        u_lb = bound_traj(vr.controls, grid_u, "lb")
        u_ub = bound_traj(vr.controls, grid_u, "ub")
        return x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self.dtype,
                               device=self.device)

    def _device_args(self, host) -> list:
        """The collected host arrays as tensors on the device (the
        ``past`` dict entry-wise)."""
        return [{n: self._tensor(v) for n, v in a.items()}
                if isinstance(a, dict) else self._tensor(a) for a in host]

    def solve(self, now: float, variables: dict[str, Any]) -> dict:
        x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub = \
            self._device_args(self._collect(now, variables))
        mu0 = self.solver_options.mu_init if self._cold else 1e-2
        t0 = torch.tensor(float(now), dtype=self.dtype, device=self.device)
        t_start = _time.perf_counter()
        with telemetry.span("backend.solve", backend=type(self).__name__,
                            instance=f"{id(self):x}"):
            u0, traj, w_next, y_next, z_next, stats = self._step(
                x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub,
                self._theta0.ml_params,
                self._w_guess, self._y_guess, self._z_guess, mu0, t0)
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


@register_backend("jax_admm_ml", "casadi_admm_ml")
class MLADMMBackend(MLBackend):
    """NARX OCP + augmented-Lagrangian coupling terms (reference
    ``CasadiADMMNNSystem``, ``casadi_/casadi_admm_ml.py:35-120``)."""

    def setup_optimization(self, var_ref: ADMMVariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        couplings = list(getattr(var_ref, "couplings", []))
        exchange = list(getattr(var_ref, "exchange", []))
        self.coupling_names = couplings
        self.exchange_names = exchange
        self._module_controls = list(var_ref.controls)

        model = load_ml_model(self.config["model"], dt=time_step)
        input_coups = [n for n in (*couplings, *exchange)
                       if n in model.input_names
                       and n not in var_ref.controls]
        merged = ADMMVariableReference(
            states=var_ref.states,
            controls=[*var_ref.controls, *input_coups],
            inputs=[n for n in var_ref.inputs if n not in input_coups],
            parameters=var_ref.parameters,
            outputs=var_ref.outputs,
            couplings=couplings,
            exchange=exchange,
        )
        self.config = dict(self.config)
        self.config["model"] = model
        super().setup_optimization(merged, time_step, prediction_horizon)

    @property
    def coupling_grid(self) -> np.ndarray:
        return np.arange(self.N) * self.time_step

    def _coupling_extractor(self, name):
        ocp = self.ocp
        model = self.model
        N = self.N
        if name in ocp.control_names:
            col = ocp.control_names.index(name)
            return lambda w_flat, theta: ocp.unflatten(w_flat)["u"][:, col]
        if name in model.output_names:
            out_idx = model.output_names.index(name)

            def extract(w_flat, theta):
                traj = ocp.trajectories(w_flat, theta)
                return traj["y"][:N, out_idx]

            return extract
        raise ValueError(
            f"coupling {name!r} is neither an optimized input nor an output")

    def _build_step_fn(self) -> None:
        ocp = self.ocp
        opts = self.solver_options
        extractors = {n: self._coupling_extractor(n)
                      for n in (*self.coupling_names, *self.exchange_names)}
        coup_names = list(self.coupling_names)
        ex_names = list(self.exchange_names)
        dt = ocp.dt

        def f_aug(w_flat, theta):
            ocp_theta, means, lams, ex_diffs, ex_lams, rho = theta
            val = ocp.nlp.f(w_flat, ocp_theta)
            for k, name in enumerate(coup_names):
                x_loc = extractors[name](w_flat, ocp_theta)
                val = val + dt * consensus_penalty(x_loc, means[k], lams[k],
                                                   rho)
            for k, name in enumerate(ex_names):
                x_loc = extractors[name](w_flat, ocp_theta)
                val = val + dt * exchange_penalty(x_loc, ex_diffs[k],
                                                  ex_lams[k], rho)
            return val

        nlp = NLPFunctions(
            f=f_aug,
            g=lambda w, th: ocp.nlp.g(w, th[0]),
            h=lambda w, th: ocp.nlp.h(w, th[0]))
        #: the augmented problem every solve solves
        self.nlp = nlp

        def step(x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub,
                 ml_params, means, lams, ex_diffs, ex_lams, rho,
                 w_guess, y_guess, z_guess, mu0, t0):
            theta = self._theta0._replace(
                x0=x0, u_prev=u_prev, past=past, d_traj=d_traj, p=p,
                x_lb=x_lb, x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0,
                ml_params=ml_params)
            lb, ub = ocp.bounds(theta)
            full_theta = (theta, means, lams, ex_diffs, ex_lams, rho)
            res = solve_nlp(nlp, w_guess, full_theta, lb, ub, opts,
                            y0=y_guess, z0=z_guess, mu0=mu0)
            traj = ocp.trajectories(res.w, theta)
            u0 = torch.clamp(traj["u"][0], theta.u_lb[0], theta.u_ub[0])
            coup_trajs = {n: extractors[n](res.w, theta)
                          for n in (*coup_names, *ex_names)}
            w_next = ocp.shift_guess(res.w, theta)
            return u0, traj, coup_trajs, w_next, res.y, res.z, res.stats

        self._step_admm = step

    def solve(self, now: float, variables: dict[str, Any]) -> dict:
        x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub = \
            self._device_args(self._collect(now, variables))
        grid = self.coupling_grid

        def traj_of(key):
            v = variables.get(key)
            if v is None:
                v = 0.0
            return sample(v, grid, current=now)

        def stack(prefix, names):
            if not names:
                return np.zeros((0, self.N))
            return np.stack([traj_of(f"{prefix}_{n}") for n in names])

        means = stack(MEAN_PREFIX, self.coupling_names)
        lams = stack(MULTIPLIER_PREFIX, self.coupling_names)
        ex_diffs = stack(EXCHANGE_MEAN_PREFIX, self.exchange_names)
        ex_lams = stack(EXCHANGE_MULTIPLIER_PREFIX, self.exchange_names)
        rho = float(variables.get("penalty_factor", 10.0))

        mu0 = self.solver_options.mu_init if self._cold else 1e-2
        t0 = torch.tensor(float(now), dtype=self.dtype, device=self.device)
        t_start = _time.perf_counter()
        with telemetry.span("backend.solve", backend=type(self).__name__,
                            instance=f"{id(self):x}"):
            u0, traj, coup_trajs, w_next, y_next, z_next, stats = \
                self._step_admm(
                    x0, u_prev, past, d_traj, p, x_lb, x_ub, u_lb, u_ub,
                    self._theta0.ml_params,
                    *(self._tensor(a) for a in (means, lams, ex_diffs,
                                                ex_lams, rho)),
                    self._w_guess, self._y_guess, self._z_guess, mu0, t0)
            # the one transfer of the controls back to the host; it
            # waits for the solve
            u0 = u0.cpu().numpy()
        wall = _time.perf_counter() - t_start
        self._carry_warm_start(w_next, y_next, z_next, now=now)

        stats_row = self.solver_stats_row(stats, now, wall)
        self._record_solve(stats_row)
        controls = list(self.ocp.control_names)
        return {
            "u0": {n: float(u0[i]) for i, n in enumerate(controls)
                   if n in self._module_controls},
            "traj": {k: v.detach().cpu().numpy() for k, v in traj.items()},
            "couplings": {n: v.detach().cpu().numpy()
                          for n, v in coup_trajs.items()},
            "stats": stats_row,
        }
