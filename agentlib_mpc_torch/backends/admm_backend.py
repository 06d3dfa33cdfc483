"""ADMM backend: augmented local OCP for distributed MPC.

Port of ``agentlib_mpc_tpu/backends/admm_backend.py``; the port keeps its
own copy and imports nothing of the JAX package.

Counterpart of the reference's ``casadi_admm`` backend
(``optimization_backends/casadi_/admm.py``): the local OCP gains, per
coupling variable, the augmented-Lagrangian terms
``lam * x_local + rho/2 (global - x_local)^2`` as stage objectives
(``admm.py:90-116``), with the global mean / multiplier / penalty arriving
as per-solve parameters under the reference's wire names
(``admm_coupling_mean_<name>``, ``admm_lambda_<name>``,
``admm_exchange_mean_<name>``, ``admm_exchange_lambda_<name>``,
``penalty_factor`` — ``data_structures/admm_datatypes.py:16-23``).

Coupling variables may be model *inputs* (optimized directly: they join
the control vector, like the room's ``mDot``) or model *outputs*
(functions of the state trajectory, like the cooler's ``mDot_out`` —
``examples/admm/models/ca_cooler_model.py``). Both kinds are penalized on
the control grid (N points; the reference's ``coupling_grid``,
``optimization_backends/backend.py:223-231``).

Where the JAX package compiles the augmented step with ``jax.jit``, the
port runs it as a plain function on tensors on the backend's device, in
its dtype; means and multipliers are tensor arguments, so every ADMM
iteration runs the same function. The QP routing and the derivative plan
are certified on the augmented problem with the port's ``lint/fx``.
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
    load_model,
    register_backend,
)
from agentlib_mpc_torch.backends.mpc_backend import (
    _ROUTING_DTYPE,
    JAXBackend,
    _solve_qp_one,
    attach_derivative_plan,
    attach_stage_partition,
    solver_options_from_config,
    transcription_kwargs_from_config,
)
from agentlib_mpc_torch.ops.admm import consensus_penalty, exchange_penalty
from agentlib_mpc_torch.ops.solver import NLPFunctions, solve_nlp
from agentlib_mpc_torch.ops.transcription import _input_splicer, transcribe
from agentlib_mpc_torch.utils.sampling import sample

# reference wire-name prefixes (admm_datatypes.py:16-23)
ADMM_PREFIX = "admm"
MULTIPLIER_PREFIX = "admm_lambda"
LOCAL_PREFIX = "admm_coupling"
MEAN_PREFIX = "admm_coupling_mean"
EXCHANGE_MULTIPLIER_PREFIX = "admm_exchange_lambda"
EXCHANGE_LOCAL_PREFIX = "admm_exchange"
EXCHANGE_MEAN_PREFIX = "admm_exchange_mean"


@dataclasses.dataclass
class ADMMVariableReference(VariableReference):
    """VariableReference plus coupling/exchange variable names
    (reference ``admm_datatypes.py:80-109``)."""

    couplings: list[str] = dataclasses.field(default_factory=list)
    exchange: list[str] = dataclasses.field(default_factory=list)

    def all_names(self) -> list[str]:
        return super().all_names() + [*self.couplings, *self.exchange]


@register_backend("jax_admm", "casadi_admm")
class ADMMBackend(JAXBackend):
    """Local augmented OCP for one ADMM participant."""

    def setup_optimization(self, var_ref: ADMMVariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        self.var_ref = var_ref
        self.time_step = float(time_step)
        self.N = int(prediction_horizon)
        self.model = load_model(self.config["model"])

        couplings = list(getattr(var_ref, "couplings", []))
        exchange = list(getattr(var_ref, "exchange", []))
        self.coupling_names = couplings
        self.exchange_names = exchange

        # split couplings into optimized inputs vs output expressions
        def classify(name):
            if name in self.model.input_names:
                return "input"
            if name in self.model.output_names:
                return "output"
            raise ValueError(
                f"coupling {name!r} is neither a model input nor output")

        self._coup_kinds = {n: classify(n) for n in (*couplings, *exchange)}
        input_coups = [n for n in (*couplings, *exchange)
                       if self._coup_kinds[n] == "input"]
        opt_controls = [*var_ref.controls, *input_coups]

        trans_kwargs = transcription_kwargs_from_config(
            self.config.get("discretization_options"))
        self.ocp = transcribe(self.model, opt_controls, N=self.N,
                              dt=self.time_step, **trans_kwargs)
        self.solver_options = attach_stage_partition(
            solver_options_from_config(self.config.get("solver")), self.ocp)
        # inexact warm iterations: ADMM iterations >= 1 re-solve an almost
        # unchanged problem from a full primal/dual/barrier warm start, so
        # a short interior-point budget suffices, and a feasible warm
        # solve whose barrier/dual residual is not yet all the way down is
        # a success (the outer loop needs the couplings to ~1e-2/1e-3).
        # Each rule applies only where neither "solver" nor "warm_solver"
        # sets the key
        warm_cfg = {**dict(self.config.get("solver", {}) or {}),
                    **dict(self.config.get("warm_solver", {}) or {})}
        warm = solver_options_from_config(warm_cfg)
        if "max_iter" not in warm_cfg:
            warm = warm._replace(
                max_iter=min(self.solver_options.max_iter, 8))
        if "compl_inf_tol" not in warm_cfg:
            warm = warm._replace(
                compl_inf_tol=max(warm.compl_inf_tol, 5e-3))
        if "dual_inf_tol" not in warm_cfg:
            warm = warm._replace(dual_inf_tol=max(warm.dual_inf_tol, 1.0))
        self.warm_solver_options = attach_stage_partition(warm, self.ocp)
        self._exo_names = list(self.ocp.exo_names)
        self._theta0 = self.ocp.default_params(device=self.device,
                                               dtype=self.dtype)
        # the module-facing var_ref keeps real controls; the internal
        # collection path needs the extended control list
        self._collect_ref = VariableReference(
            states=var_ref.states, controls=opt_controls,
            inputs=var_ref.inputs, parameters=var_ref.parameters,
            outputs=var_ref.outputs)
        self._build_admm_step_fn()
        self._reset_warm_start()
        if self.config.get("precompile"):
            self._precompile()

    def _resolve_qp_fast_path(self) -> None:
        """No-op override: the routing decision belongs to the AUGMENTED
        problem and is made in :meth:`_build_admm_step_fn`; certifying the
        base OCP would waste a setup pass on a problem never solved."""

    @property
    def coupling_grid(self) -> np.ndarray:
        """Grid the coupling trajectories live on (reference
        ``ADMMBackend.coupling_grid``, ``backend.py:223-231``)."""
        return np.arange(self.N) * self.time_step

    # -- the augmented step (device side) ---------------------------------------

    def _coupling_extractors(self):
        """Per coupling name, a function (w_flat, ocp_theta) -> (N,) on the
        control grid. An output coupling evaluates the model's output map
        at every control node at once: the node's differential state, the
        free states of its last collocation point, its full input vector
        (controls and exogenous inputs spliced in declaration order) and
        its time."""
        ocp = self.ocp
        model = self.model
        N = self.N
        _, splice, _ = _input_splicer(model, ocp.control_names)

        def make(name):
            if self._coup_kinds[name] == "input":
                col = ocp.control_names.index(name)

                def extract(w_flat, theta, col=col):
                    return ocp.unflatten(w_flat)["u"][:, col]
            else:
                out_idx = model.output_names.index(name)

                def extract(w_flat, theta, out_idx=out_idx):
                    w = ocp.unflatten(w_flat)
                    z = w["z"][:, -1, :] if ocp.method == "collocation" \
                        else w["z"]
                    u_full = splice(w["u"], theta.d_traj)      # (N, n_in)
                    nodes = torch.arange(N, dtype=w_flat.dtype,
                                         device=w_flat.device)
                    y = model.output(w["x"][:N].T, z.T, u_full.T, theta.p,
                                     theta.t0 + nodes * ocp.dt)  # (n_y, N)
                    return y[out_idx]
            return extract

        return {n: make(n) for n in (*self.coupling_names,
                                     *self.exchange_names)}

    def _augmented_theta(self, dtype, generator=None):
        """Augmented theta ``(ocp_theta, means, lams, ex_diffs, ex_lams,
        rho)`` at the model's defaults on the backend's device: zeros, or
        standard normal draws from ``generator`` (the routing probe samples
        them at random values: zeros would hide a nonlinear output map that
        only enters through the linear penalty terms)."""
        dev = self.device
        n_c, n_e = len(self.coupling_names), len(self.exchange_names)

        def traj(rows):
            if generator is None:
                return torch.zeros((rows, self.N), dtype=dtype, device=dev)
            return torch.randn((rows, self.N), generator=generator,
                               dtype=dtype).to(dev)

        return (self.ocp.default_params(device=dev, dtype=dtype),
                traj(n_c), traj(n_c), traj(n_e), traj(n_e),
                torch.tensor(1.0, dtype=dtype, device=dev))

    def _build_admm_step_fn(self) -> None:
        ocp = self.ocp
        extractors = self._coupling_extractors()
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
        #: the augmented problem every solve solves (the certifiers' input)
        self.nlp = nlp

        # QP fast-path routing for the AUGMENTED problem: input-kind
        # coupling penalties are quadratic in w, but output-kind couplings
        # pull the (possibly nonlinear) output map into the objective. The
        # certificate treats means, multipliers and rho as symbolic theta,
        # so it covers every ADMM iterate; the cross-check probe samples
        # them at random values
        from agentlib_mpc_torch.ops.qp import is_lq, resolve_qp_routing

        n_w = ocp.n_w

        def certifier():
            from agentlib_mpc_torch.lint.fx import certify_lq

            return certify_lq(nlp, self._augmented_theta(_ROUTING_DTYPE),
                              n_w)

        def probe():
            gen = torch.Generator().manual_seed(17)
            return is_lq(nlp, self._augmented_theta(_ROUTING_DTYPE, gen),
                         n_w)

        self.uses_qp_fast_path = resolve_qp_routing(
            str((self.config.get("solver") or {})
                .get("qp_fast_path", "auto")),
            probe, logger=self.logger, label="the augmented ADMM OCP",
            certifier=certifier)
        inner = _solve_qp_one if self.uses_qp_fast_path else solve_nlp

        # stage-sparse derivative plan for the AUGMENTED problem: one
        # certifier run, reused for the warm option set; a warm-ONLY
        # sparse/stage configuration gets its own pass
        from agentlib_mpc_torch.ops.solver import (
            attach_jacobian_plan,
            plan_worthwhile,
        )

        aug0 = self._augmented_theta(self.dtype)
        cold_wants = plan_worthwhile(self.solver_options,
                                     ocp.stage_partition, self.device)
        self.solver_options = attach_derivative_plan(
            self.solver_options, ocp, nlp=nlp, theta=aug0,
            logger=self.logger, label="the augmented ADMM OCP",
            device=self.device)
        plan = self.solver_options.stage_jacobian_plan
        if plan is not None:
            self.warm_solver_options = attach_jacobian_plan(
                self.warm_solver_options, plan)
        elif not cold_wants:
            self.warm_solver_options = attach_derivative_plan(
                self.warm_solver_options, ocp, nlp=nlp, theta=aug0,
                logger=self.logger, label="the augmented ADMM OCP",
                device=self.device)

        theta0 = self._theta0

        def make_step(opts):
            def step(x0, u_prev, d_traj, p, x_lb, x_ub, u_lb, u_ub,
                     means, lams, ex_diffs, ex_lams, rho,
                     w_guess, y_guess, z_guess, mu0, t0):
                theta = theta0._replace(
                    x0=x0, u_prev=u_prev, d_traj=d_traj, p=p, x_lb=x_lb,
                    x_ub=x_ub, u_lb=u_lb, u_ub=u_ub, t0=t0)
                lb, ub = ocp.bounds(theta)
                full_theta = (theta, means, lams, ex_diffs, ex_lams, rho)
                res = inner(nlp, w_guess, full_theta, lb, ub, opts,
                            y0=y_guess, z0=z_guess, mu0=mu0)
                traj = ocp.trajectories(res.w, theta)
                u0 = torch.clamp(traj["u"][0], theta.u_lb[0],
                                 theta.u_ub[0])
                coup_trajs = {n: extractors[n](res.w, theta)
                              for n in (*coup_names, *ex_names)}
                w_next = ocp.shift_guess(res.w, theta)
                return u0, traj, coup_trajs, w_next, res.y, res.z, res.stats

            return step

        self._step_admm = make_step(self.solver_options)
        self._step_admm_warm = make_step(self.warm_solver_options)

    # -- solve ----------------------------------------------------------------

    def _admm_params(self, now: float, variables: dict[str, Any]):
        """Means, multipliers, exchange deviations and multipliers on the
        coupling grid (host numpy, (n, N) each) and rho."""
        grid = self.coupling_grid

        def stack(prefix, names):
            if not names:
                return np.zeros((0, self.N))
            rows = []
            for n in names:
                v = variables.get(f"{prefix}_{n}")
                rows.append(sample(0.0 if v is None else v, grid,
                                   current=now))
            return np.stack(rows)

        means = stack(MEAN_PREFIX, self.coupling_names)
        lams = stack(MULTIPLIER_PREFIX, self.coupling_names)
        ex_diffs = stack(EXCHANGE_MEAN_PREFIX, self.exchange_names)
        ex_lams = stack(EXCHANGE_MULTIPLIER_PREFIX, self.exchange_names)
        rho = float(variables.get("penalty_factor", 10.0))
        return means, lams, ex_diffs, ex_lams, rho

    def solve(self, now: float, variables: dict[str, Any]) -> dict:
        saved_ref = self.var_ref
        self.var_ref = self._collect_ref
        try:
            host = self._collect(now, variables)
        finally:
            self.var_ref = saved_ref
        means, lams, ex_diffs, ex_lams, rho = self._admm_params(now,
                                                                variables)
        tensor = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                           device=self.device)
        args = [tensor(a) for a in (*host, means, lams, ex_diffs, ex_lams,
                                    rho)]
        # iterations >= 1 within a control step run the short warm budget
        warm = int(variables.get("admm_iteration", 0)) >= 1 \
            and not self._cold
        step_fn = self._step_admm_warm if warm else self._step_admm
        mu0 = self.solver_options.mu_init if self._cold else 1e-2
        t0 = torch.tensor(float(now), dtype=self.dtype, device=self.device)
        t_start = _time.perf_counter()
        with telemetry.span("backend.solve", backend=type(self).__name__,
                            instance=f"{id(self):x}", warm=str(warm)):
            u0, traj, coup_trajs, w_next, y_next, z_next, stats = step_fn(
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
                   for i, n in enumerate(self.ocp.control_names)
                   if n in saved_ref.controls},
            "traj": {k: v.detach().cpu().numpy() for k, v in traj.items()},
            "couplings": {n: v.detach().cpu().numpy()
                          for n, v in coup_trajs.items()},
            "stats": stats_row,
        }
