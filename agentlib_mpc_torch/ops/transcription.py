"""OCP → NLP transcription: direct collocation.

Port of the collocation path of ``agentlib_mpc_tpu/ops/transcription.py``
(lines 52-464). The NLP functions ``f``, ``g``, ``h`` take ONE flat decision
vector and one :class:`OCPParams`, like the JAX package; callers batch them
with ``torch.func.vmap``. Where the JAX package vmaps over the stage axis,
the port evaluates the model once on all stages and collocation points, as
trailing ``(N, d)`` axes (see ``models/model.py``).

Layout of the flat decision vector — the JAX package builds it with
``ravel_pytree``, which sorts the dict keys, so the order is:
    ``u``  (N, n_u)          piecewise-constant controls
    ``x``  (N+1, n_x)        differential states at interval boundaries
    ``xc`` (N, d, n_x)       interior collocation states
    ``z``  (N, d, n_z)       stage-wise free states (slacks/algebraics)
For ``ZoneWithSupply`` at N=10, d=2 that is u 10, x 11, xc 20, z 20 → 61.

``method="multiple_shooting"`` needs ``ops/integrators.py`` and raises
until that is ported; ``stage_partition`` stays ``None`` until the
stage-structured slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from agentlib_mpc_torch.models.model import Model
from agentlib_mpc_torch.ops.collocation import collocation_matrices
from agentlib_mpc_torch.ops.solver import NLPFunctions
from agentlib_mpc_torch.utils.device import resolve_device

# value used in place of +-inf bounds (interior-point needs finite boxes)
BIG = 1.0e6

#: key order of the flat decision vector (sorted, as ``ravel_pytree``)
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
    unflatten: Callable[[torch.Tensor], dict]
    flatten: Callable[[dict], torch.Tensor]
    bounds: Callable[[OCPParams], tuple[torch.Tensor, torch.Tensor]]
    initial_guess: Callable[[OCPParams], torch.Tensor]
    shift_guess: Callable[[torch.Tensor, OCPParams], torch.Tensor]
    trajectories: Callable[[torch.Tensor, OCPParams], dict]
    default_params: Callable[..., OCPParams]
    #: stage metadata for the structured KKT factorization — not ported in
    #: this slice (ROADMAP Queue 1, stage-structured path)
    stage_partition: None = None


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

    ``fix_initial_state=False`` drops the ``x[0] = x0`` pin (the MHE
    configuration)."""
    if method == "multiple_shooting":
        raise NotImplementedError(
            "multiple shooting needs ops/integrators.py, which the port has "
            "not ported yet (ROADMAP Queue 1: integrators and multiple "
            "shooting)")
    if method != "collocation":
        raise ValueError(f"unknown transcription method {method!r}")
    del integrator, integrator_substeps  # shooting only
    exo_names, splice, splice_du = _input_splicer(model, control_names)
    n_x = model.n_diff
    n_z = model.n_free
    n_u = len(control_names)
    d = collocation_degree

    shapes = {"u": (N, n_u), "x": (N + 1, n_x), "xc": (N, d, n_x),
              "z": (N, d, n_z)}
    sizes = {k: int(np.prod(shapes[k])) for k in LAYOUT_KEYS}
    n_w = sum(sizes.values())

    def unflatten(w_flat):
        lead = w_flat.shape[:-1]
        out, off = {}, 0
        for k in LAYOUT_KEYS:
            out[k] = w_flat[..., off:off + sizes[k]].reshape(lead + shapes[k])
            off += sizes[k]
        return out

    def flatten(w):
        lead = w["u"].shape[:-2]
        return torch.cat([w[k].reshape(lead + (sizes[k],))
                          for k in LAYOUT_KEYS], dim=-1)

    taus, C_np, D_np, B_np = collocation_matrices(d, collocation_method)
    # time offsets (in intervals) of the collocation points and of the
    # cost quadrature points (boundary + collocation)
    grid_coll = np.arange(N)[:, None] + taus[None, 1:]          # (N, d)
    grid_cost = np.arange(N)[:, None] + taus[None, :]           # (N, d+1)
    consts_np = {"C": C_np[:, 1:], "D": D_np, "B": B_np,
                 "grid_coll": grid_coll, "grid_cost": grid_cost}
    const_cache: dict = {}

    def consts(like):
        """Collocation constants as tensors, once per (dtype, device)."""
        key = (like.dtype, like.device)
        if key not in const_cache:
            const_cache[key] = {
                k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                for k, v in consts_np.items()}
        return const_cache[key]

    def _du_seq(u, u_prev):
        return u - torch.cat([u_prev[None, :], u[:-1]], dim=0)

    def _vars_first(a):
        """(N, d, n) → (n, N, d): variable axis leading for the model."""
        return a.permute(2, 0, 1)

    def _inputs(u, theta):
        """(n_in, N, 1) full model inputs per interval."""
        return splice(u, theta.d_traj).T.unsqueeze(-1)

    # ---- equality constraints ------------------------------------------------
    def g_fn(w_flat, theta: OCPParams):
        c = consts(w_flat)
        w = unflatten(w_flat)
        x, u, xc, z = w["x"], w["u"], w["xc"], w["z"]
        parts = [x[0] - theta.x0] if fix_initial_state else []
        X = torch.cat([x[:-1, None, :], xc], dim=1)             # (N, d+1, n_x)
        t = theta.t0 + c["grid_coll"] * dt                      # (N, d)
        fs = model.ode(_vars_first(xc), _vars_first(z), _inputs(u, theta),
                       theta.p, t).permute(1, 2, 0)             # (N, d, n_x)
        # defect at each collocation point k=1..d:
        # sum_j C[j,k] X_j = dt * f(X_k)
        xdot_poly = torch.einsum("jk,ijn->ikn", c["C"], X)      # (N, d, n_x)
        defects = xdot_poly - dt * fs
        conts = x[1:] - torch.einsum("j,ijn->in", c["D"], X)    # (N, n_x)
        parts.append(defects.reshape(-1))
        parts.append(conts.reshape(-1))
        return torch.cat(parts)

    # ---- inequality constraints (h >= 0) ------------------------------------
    def h_fn(w_flat, theta: OCPParams):
        if model.n_constraints == 0:
            return w_flat.new_zeros((0,))
        c = consts(w_flat)
        w = unflatten(w_flat)
        t = theta.t0 + c["grid_coll"] * dt
        res = model.constraint_residuals(
            _vars_first(w["xc"]), _vars_first(w["z"]),
            _inputs(w["u"], theta), theta.p, t)                 # (n_r, N, d)
        return res.permute(1, 2, 0).reshape(-1)

    # ---- objective -----------------------------------------------------------
    def f_fn(w_flat, theta: OCPParams):
        c = consts(w_flat)
        w = unflatten(w_flat)
        x, u, xc, z = w["x"], w["u"], w["xc"], w["z"]
        du = _du_seq(u, theta.u_prev)
        # j = 0 is the boundary point (weight B[0]); interior points use the
        # collocation states; the free state of point 0 is that of point 1
        XX = torch.cat([x[:-1, None, :], xc], dim=1)            # (N, d+1, n_x)
        ZZ = torch.cat([z[:, :1], z], dim=1)                    # (N, d+1, n_z)
        t = theta.t0 + c["grid_cost"] * dt
        q = model.stage_cost(_vars_first(XX), _vars_first(ZZ),
                             _inputs(u, theta), theta.p, t,
                             du=splice_du(du).T.unsqueeze(-1))  # (N, d+1)
        return (dt * (c["B"] * q).sum(-1)).sum()

    # static sizes (probe once with zeros, on the CPU in float64)
    theta0 = _default_params(model, control_names, exo_names, N, dt,
                             device=torch.device("cpu"), dtype=torch.float64)
    w0 = torch.zeros((n_w,), dtype=torch.float64)
    n_g = int(g_fn(w0, theta0).shape[0])
    n_h = int(h_fn(w0, theta0).shape[0])

    # ---- bounds --------------------------------------------------------------
    def bounds_fn(theta: OCPParams):
        x_lb = _finite(theta.x_lb, -BIG)
        x_ub = _finite(theta.x_ub, BIG)
        u_lb = _finite(theta.u_lb, -BIG)
        u_ub = _finite(theta.u_ub, BIG)
        z_lb = _finite(theta.z_lb, -BIG)
        z_ub = _finite(theta.z_ub, BIG)
        # interior states inherit the bounds of their interval's end point
        lb = {"x": x_lb, "u": u_lb,
              "xc": x_lb[1:, None, :].expand(N, d, n_x),
              "z": z_lb.expand(N, d, n_z)}
        ub = {"x": x_ub, "u": u_ub,
              "xc": x_ub[1:, None, :].expand(N, d, n_x),
              "z": z_ub.expand(N, d, n_z)}
        return flatten(lb), flatten(ub)

    # ---- initial guess / warm start -----------------------------------------
    def initial_guess_fn(theta: OCPParams):
        u_mid = torch.clamp(torch.zeros_like(theta.u_lb),
                            _finite(theta.u_lb, -BIG), _finite(theta.u_ub, BIG))
        u_guess = theta.u_prev.expand(N, n_u)
        u_guess = torch.where(torch.isfinite(u_guess), u_guess, u_mid)
        guess = {"x": theta.x0.expand(N + 1, n_x), "u": u_guess,
                 "xc": theta.x0.expand(N, d, n_x),
                 "z": theta.x0.new_zeros((N, d, n_z))}
        return flatten(guess)

    def shift_guess_fn(w_flat, theta: OCPParams):
        """Shift the previous optimum one interval forward, repeating the
        last stage, and pin the new initial state."""
        w = unflatten(w_flat)
        x = torch.cat([theta.x0[None, :], w["x"][2:], w["x"][-1:]], dim=0)
        out = {"x": x,
               "u": torch.cat([w["u"][1:], w["u"][-1:]], dim=0),
               "xc": torch.cat([w["xc"][1:], w["xc"][-1:]], dim=0),
               "z": torch.cat([w["z"][1:], w["z"][-1:]], dim=0)}
        return flatten(out)

    # ---- result extraction ---------------------------------------------------
    def trajectories_fn(w_flat, theta: OCPParams):
        w = unflatten(w_flat)
        x, u = w["x"], w["u"]
        z_stage = w["z"][:, -1, :]
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
