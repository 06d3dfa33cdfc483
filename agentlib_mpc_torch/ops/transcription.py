"""OCP → NLP transcription: direct collocation and multiple shooting.

Port of ``agentlib_mpc_tpu/ops/transcription.py`` (lines 52-464). The NLP
functions ``f``, ``g``, ``h`` take ONE flat decision vector and one
:class:`OCPParams`, like the JAX package; callers batch them with
``torch.func.vmap``. Where the JAX package vmaps over the stage axis, the
port evaluates the model once on all stages (and collocation points), as
trailing ``(N,)`` or ``(N, d)`` axes (see ``models/model.py``); multiple
shooting integrates all N intervals as one batch of N lanes
(``ops/integrators.py``).

Layout of the flat decision vector — the JAX package builds it with
``ravel_pytree``, which sorts the dict keys, so the order is:
    ``u``  (N, n_u)          piecewise-constant controls
    ``x``  (N+1, n_x)        differential states at interval boundaries
    ``xc`` (N, d, n_x)       interior collocation states [collocation only]
    ``z``  (N, d, n_z)       stage-wise free states (slacks/algebraics);
                             (N, n_z) for multiple shooting
For ``ZoneWithSupply`` at N=10, d=2 that is u 10, x 11, xc 20, z 20 → 61.

Every transcription carries its :class:`~agentlib_mpc_torch.ops.stagewise.
StagePartition` (``stage_partition``), which the solver's stage sweep
factors by.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from agentlib_mpc_torch.models.model import Model
from agentlib_mpc_torch.ops.collocation import collocation_matrices
from agentlib_mpc_torch.ops.integrators import integrate
from agentlib_mpc_torch.ops.solver import NLPFunctions
from agentlib_mpc_torch.ops.stagewise import (
    StagePartition,
    build_stage_partition,
)
from agentlib_mpc_torch.utils.device import resolve_device

# value used in place of +-inf bounds (interior-point needs finite boxes)
BIG = 1.0e6

#: key order of the flat decision vector (sorted, as ``ravel_pytree``);
#: multiple shooting has no ``xc``
LAYOUT_KEYS = ("u", "x", "xc", "z")


class OCPParams(NamedTuple):
    """Per-solve data for a transcribed OCP. All leaves are tensors so the
    whole tuple can be batched (``torch.func.vmap`` treats it as a pytree)."""

    x0: torch.Tensor        # (n_x,) current differential state
    u_prev: torch.Tensor    # (n_u,) last applied control (Δu penalty)
    d_traj: torch.Tensor    # (N, n_d) exogenous inputs per interval
    p: torch.Tensor         # (n_p,) model parameters
    x_lb: torch.Tensor      # (N+1, n_x) state bounds over the horizon
    x_ub: torch.Tensor
    u_lb: torch.Tensor      # (N, n_u) control bounds over the horizon
    u_ub: torch.Tensor
    z_lb: torch.Tensor      # (n_z,) free-state bounds
    z_ub: torch.Tensor
    t0: torch.Tensor        # () solve start time (for time-dependent costs)


@dataclasses.dataclass(frozen=True)
class TranscribedOCP:
    """A transcribed optimal control problem, ready for ``solve_nlp``."""

    model: Model
    control_names: tuple[str, ...]
    exo_names: tuple[str, ...]
    N: int
    dt: float
    method: str
    n_w: int
    n_g: int
    n_h: int
    nlp: NLPFunctions
    #: flat (..., n_w) → dict of (..., *shape) views, in LAYOUT_KEYS order
    #: (the keys the method has)
    unflatten: Callable[[torch.Tensor], dict]
    flatten: Callable[[dict], torch.Tensor]
    bounds: Callable[[OCPParams], tuple[torch.Tensor, torch.Tensor]]
    initial_guess: Callable[[OCPParams], torch.Tensor]
    shift_guess: Callable[[torch.Tensor, OCPParams], torch.Tensor]
    trajectories: Callable[[torch.Tensor, OCPParams], dict]
    default_params: Callable[..., OCPParams]
    #: stage metadata of the KKT system this transcription produces: its
    #: KKT matrix is block tridiagonal under this partition
    #: (``ops/stagewise.py``); ``solver.attach_stage_partition`` attaches it
    #: to ``SolverOptions.stage_partition``
    stage_partition: StagePartition | None = None


def _input_splicer(model: Model, control_names: Sequence[str]):
    """Return (exo_names, splice, splice_du): ``splice(u_ctrl, d_exo)``
    rebuilds the full model input vector (last axis) in declaration order,
    without in-place writes (safe under ``torch.func`` transforms)."""
    control_names = list(control_names)
    for c in control_names:
        if c not in model.input_names:
            raise ValueError(f"control {c!r} is not a model input")
    exo_names = [n for n in model.input_names if n not in control_names]
    n_u = len(control_names)
    # position of each model input in cat([u_ctrl, d_exo], -1)
    perm = [control_names.index(n) if n in control_names
            else n_u + exo_names.index(n) for n in model.input_names]

    def splice(u_ctrl, d_exo):
        src = torch.cat([u_ctrl, d_exo], dim=-1)
        return torch.stack([src[..., j] for j in perm], dim=-1)

    def splice_du(du_ctrl):
        zeros = du_ctrl.new_zeros(du_ctrl.shape[:-1] + (len(exo_names),))
        return splice(du_ctrl, zeros)

    return exo_names, splice, splice_du


def _finite(arr, default):
    return torch.where(torch.isfinite(arr), arr, torch.full_like(arr, default))


def transcribe(
    model: Model,
    control_names: Sequence[str],
    N: int,
    dt: float,
    method: str = "collocation",
    collocation_degree: int = 3,
    collocation_method: str = "radau",
    integrator: str = "rk4",
    integrator_substeps: int = 3,
    fix_initial_state: bool = True,
) -> TranscribedOCP:
    """Transcribe ``model`` over an N-interval horizon with step ``dt``.

    ``method="multiple_shooting"`` integrates each interval with
    ``integrator`` ("euler", "rk4", "implicit_midpoint", "trbdf2",
    "adaptive") in ``integrator_substeps`` steps. ``fix_initial_state=False``
    drops the ``x[0] = x0`` pin (the MHE configuration)."""
    if method not in ("collocation", "multiple_shooting"):
        raise ValueError(f"unknown transcription method {method!r}")
    exo_names, splice, splice_du = _input_splicer(model, control_names)
    n_x = model.n_diff
    n_z = model.n_free
    n_u = len(control_names)
    is_colloc = method == "collocation"
    d = collocation_degree if is_colloc else 1

    shapes = {"u": (N, n_u), "x": (N + 1, n_x)}
    if is_colloc:
        shapes.update(xc=(N, d, n_x), z=(N, d, n_z))
    else:
        shapes.update(z=(N, n_z))
    keys = tuple(k for k in LAYOUT_KEYS if k in shapes)
    sizes = {k: int(np.prod(shapes[k])) for k in keys}
    n_w = sum(sizes.values())

    def unflatten(w_flat):
        lead = w_flat.shape[:-1]
        out, off = {}, 0
        for k in keys:
            out[k] = w_flat[..., off:off + sizes[k]].reshape(lead + shapes[k])
            off += sizes[k]
        return out

    def flatten(w):
        lead = w["u"].shape[:-2]
        return torch.cat([w[k].reshape(lead + (sizes[k],)) for k in keys],
                         dim=-1)

    consts_np = {"nodes": np.arange(N, dtype=np.float64)}
    if is_colloc:
        taus, C_np, D_np, B_np = collocation_matrices(d, collocation_method)
        # time offsets (in intervals) of the collocation points and of the
        # cost quadrature points (boundary + collocation)
        consts_np.update(
            C=C_np[:, 1:], D=D_np, B=B_np,
            grid_coll=np.arange(N)[:, None] + taus[None, 1:],     # (N, d)
            grid_cost=np.arange(N)[:, None] + taus[None, :])      # (N, d+1)
    const_cache: dict = {}

    def consts(like):
        """Transcription constants as tensors, once per (dtype, device)."""
        key = (like.dtype, like.device)
        if key not in const_cache:
            const_cache[key] = {
                k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                for k, v in consts_np.items()}
        return const_cache[key]

    def _du_seq(u, u_prev):
        return u - torch.cat([u_prev[None, :], u[:-1]], dim=0)

    def _vars_first(a):
        """(N, [d,] n) → (n, N[, d]): variable axis leading for the model."""
        return a.movedim(-1, 0)

    def _inputs(u, theta):
        """(n_in, N) full model inputs per interval."""
        return splice(u, theta.d_traj).T

    def _inputs_coll(u, theta):
        """(n_in, N, 1): the interval's inputs at every collocation point."""
        return _inputs(u, theta).unsqueeze(-1)

    # ---- equality constraints ------------------------------------------------
    def g_fn(w_flat, theta: OCPParams):
        c = consts(w_flat)
        w = unflatten(w_flat)
        x, u, z = w["x"], w["u"], w["z"]
        parts = [x[0] - theta.x0] if fix_initial_state else []
        if is_colloc:
            xc = w["xc"]
            X = torch.cat([x[:-1, None, :], xc], dim=1)         # (N, d+1, n_x)
            t = theta.t0 + c["grid_coll"] * dt                  # (N, d)
            fs = model.ode(_vars_first(xc), _vars_first(z),
                           _inputs_coll(u, theta), theta.p,
                           t).movedim(0, -1)                    # (N, d, n_x)
            # defect at each collocation point k=1..d:
            # sum_j C[j,k] X_j = dt * f(X_k)
            xdot_poly = torch.einsum("jk,ijn->ikn", c["C"], X)  # (N, d, n_x)
            defects = xdot_poly - dt * fs
            conts = x[1:] - torch.einsum("j,ijn->in", c["D"], X)  # (N, n_x)
            parts.append(defects.reshape(-1))
            parts.append(conts.reshape(-1))
        else:
            # all N intervals as one batch of lanes
            u_in, z_in = _inputs(u, theta), _vars_first(z)

            def f(xx, t):
                return model.ode(_vars_first(xx), z_in, u_in, theta.p,
                                 t).movedim(0, -1)

            x_end = integrate(f, x[:-1], theta.t0 + c["nodes"] * dt, dt,
                              substeps=integrator_substeps,
                              method=integrator)                # (N, n_x)
            parts.append((x[1:] - x_end).reshape(-1))
        return torch.cat(parts) if parts else w_flat.new_zeros((0,))

    # ---- inequality constraints (h >= 0) ------------------------------------
    def h_fn(w_flat, theta: OCPParams):
        if model.n_constraints == 0:
            return w_flat.new_zeros((0,))
        c = consts(w_flat)
        w = unflatten(w_flat)
        if is_colloc:
            res = model.constraint_residuals(
                _vars_first(w["xc"]), _vars_first(w["z"]),
                _inputs_coll(w["u"], theta), theta.p,
                theta.t0 + c["grid_coll"] * dt)                 # (n_r, N, d)
        else:
            res = model.constraint_residuals(
                _vars_first(w["x"][:-1]), _vars_first(w["z"]),
                _inputs(w["u"], theta), theta.p,
                theta.t0 + c["nodes"] * dt)                     # (n_r, N)
        return res.movedim(0, -1).reshape(-1)

    # ---- objective -----------------------------------------------------------
    def f_fn(w_flat, theta: OCPParams):
        c = consts(w_flat)
        w = unflatten(w_flat)
        x, u, z = w["x"], w["u"], w["z"]
        du = splice_du(_du_seq(u, theta.u_prev)).T              # (n_in, N)
        if not is_colloc:
            q = model.stage_cost(_vars_first(x[:-1]), _vars_first(z),
                                 _inputs(u, theta), theta.p,
                                 theta.t0 + c["nodes"] * dt, du=du)  # (N,)
            return dt * q.sum()
        # j = 0 is the boundary point (weight B[0]); interior points use the
        # collocation states; the free state of point 0 is that of point 1
        XX = torch.cat([x[:-1, None, :], w["xc"]], dim=1)       # (N, d+1, n_x)
        ZZ = torch.cat([z[:, :1], z], dim=1)                    # (N, d+1, n_z)
        t = theta.t0 + c["grid_cost"] * dt
        q = model.stage_cost(_vars_first(XX), _vars_first(ZZ),
                             _inputs_coll(u, theta), theta.p, t,
                             du=du.unsqueeze(-1))               # (N, d+1)
        return (dt * (c["B"] * q).sum(-1)).sum()

    # static sizes (probe once with zeros, on the CPU in float64)
    theta0 = _default_params(model, control_names, exo_names, N, dt,
                             device=torch.device("cpu"), dtype=torch.float64)
    w0 = torch.zeros((n_w,), dtype=torch.float64)
    n_g = int(g_fn(w0, theta0).shape[0])
    n_h = int(h_fn(w0, theta0).shape[0])

    # stage metadata for the structured KKT factorization; the covered
    # index space must match the (n_w + n_g)-dim KKT system exactly, or the
    # layout above and build_stage_partition drifted apart
    stage_partition = build_stage_partition(
        N=N, n_x=n_x, n_u=n_u, n_z=n_z, d=d, method=method,
        fix_initial_state=fix_initial_state)
    assert stage_partition.n_total == n_w + n_g, \
        (stage_partition.n_total, n_w, n_g)

    # ---- bounds --------------------------------------------------------------
    def bounds_fn(theta: OCPParams):
        x_lb = _finite(theta.x_lb, -BIG)
        x_ub = _finite(theta.x_ub, BIG)
        u_lb = _finite(theta.u_lb, -BIG)
        u_ub = _finite(theta.u_ub, BIG)
        z_lb = _finite(theta.z_lb, -BIG)
        z_ub = _finite(theta.z_ub, BIG)
        lb = {"x": x_lb, "u": u_lb, "z": z_lb.expand(shapes["z"])}
        ub = {"x": x_ub, "u": u_ub, "z": z_ub.expand(shapes["z"])}
        if is_colloc:
            # interior states inherit the bounds of their interval's end point
            lb["xc"] = x_lb[1:, None, :].expand(N, d, n_x)
            ub["xc"] = x_ub[1:, None, :].expand(N, d, n_x)
        return flatten(lb), flatten(ub)

    # ---- initial guess / warm start -----------------------------------------
    def initial_guess_fn(theta: OCPParams):
        u_mid = torch.clamp(torch.zeros_like(theta.u_lb),
                            _finite(theta.u_lb, -BIG), _finite(theta.u_ub, BIG))
        u_guess = theta.u_prev.expand(N, n_u)
        u_guess = torch.where(torch.isfinite(u_guess), u_guess, u_mid)
        guess = {"x": theta.x0.expand(N + 1, n_x), "u": u_guess,
                 "z": theta.x0.new_zeros(shapes["z"])}
        if is_colloc:
            guess["xc"] = theta.x0.expand(N, d, n_x)
        return flatten(guess)

    def shift_guess_fn(w_flat, theta: OCPParams):
        """Shift the previous optimum one interval forward, repeating the
        last stage, and pin the new initial state."""
        w = unflatten(w_flat)
        out = {k: torch.cat([w[k][1:], w[k][-1:]], dim=0) for k in keys}
        out["x"] = torch.cat([theta.x0[None, :], w["x"][2:], w["x"][-1:]],
                             dim=0)
        return flatten(out)

    # ---- result extraction ---------------------------------------------------
    def trajectories_fn(w_flat, theta: OCPParams):
        w = unflatten(w_flat)
        x, u = w["x"], w["u"]
        z_stage = w["z"][:, -1, :] if is_colloc else w["z"]
        last = [min(i, N - 1) for i in range(N + 1)]
        u_full = splice(u[last], theta.d_traj[last])             # (N+1, n_in)
        steps = torch.arange(N + 1, dtype=w_flat.dtype, device=w_flat.device)
        y = model.output(x.T, z_stage[last].T, u_full.T, theta.p,
                         theta.t0 + steps * dt).T                # (N+1, n_y)
        return {
            "time_state": theta.t0 + steps * dt,
            "time_control": theta.t0 + steps[:-1] * dt,
            "x": x,
            "u": u,
            "z": z_stage,
            "y": y,
            "objective": f_fn(w_flat, theta),
        }

    def default_params(*, device=None, dtype: torch.dtype = torch.float32,
                       **kw) -> OCPParams:
        return _default_params(model, control_names, exo_names, N, dt,
                               device=resolve_device(device), dtype=dtype,
                               **kw)

    return TranscribedOCP(
        model=model,
        control_names=tuple(control_names),
        exo_names=tuple(exo_names),
        N=N,
        dt=dt,
        method=method,
        n_w=n_w,
        n_g=n_g,
        n_h=n_h,
        nlp=NLPFunctions(f=f_fn, g=g_fn, h=h_fn),
        unflatten=unflatten,
        flatten=flatten,
        bounds=bounds_fn,
        initial_guess=initial_guess_fn,
        shift_guess=shift_guess_fn,
        trajectories=trajectories_fn,
        default_params=default_params,
        stage_partition=stage_partition,
    )


def _default_params(model: Model, control_names, exo_names, N, dt, *,
                    device, dtype, **overrides) -> OCPParams:
    """OCPParams from model defaults; keyword overrides replace leaves."""
    byname = {v.name: v for v in
              (*model.inputs, *model.states, *model.parameters)}
    n_u = len(control_names)

    def vec(values, shape=None):
        t = torch.tensor([float(v) for v in values], dtype=dtype,
                         device=device)
        return t if shape is None else t.expand(shape).clone()

    diff = model.diff_state_names
    free = model.free_state_names
    theta = OCPParams(
        x0=vec(byname[n].value for n in diff),
        u_prev=vec(byname[n].value for n in control_names),
        d_traj=vec((byname[n].value for n in exo_names), (N, len(exo_names))),
        p=vec(v.value for v in model.parameters),
        x_lb=vec((byname[n].lb for n in diff), (N + 1, model.n_diff)),
        x_ub=vec((byname[n].ub for n in diff), (N + 1, model.n_diff)),
        u_lb=vec((byname[n].lb for n in control_names), (N, n_u)),
        u_ub=vec((byname[n].ub for n in control_names), (N, n_u)),
        z_lb=vec(byname[n].lb for n in free),
        z_ub=vec(byname[n].ub for n in free),
        t0=torch.zeros((), dtype=dtype, device=device))
    return theta._replace(**{
        k: torch.as_tensor(v, dtype=dtype, device=device)
        for k, v in overrides.items()})
