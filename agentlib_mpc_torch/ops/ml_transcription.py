"""NARX (ML-surrogate) OCP transcription: discrete shooting over the
unified predict step with a pre-horizon lag window.

Port of ``agentlib_mpc_tpu/ops/ml_transcription.py`` (the reference's
``optimization_backends/casadi_/casadi_ml.py``: pre-horizon grid of fixed
past states/controls :121-154, lag plumbing into the stage function
:235-341, ``MultipleShooting_ML`` :111-373). Each history variable becomes
one padded sequence — ``L−1`` fixed past values from `MLOCPParams.past`
followed by the horizon's decision/exogenous values — and every stage's
flat NARX input vector is a static gather out of it. Where the JAX package
``vmap``s the predict step, the constraint residuals, the stage cost and
the outputs over the stages, the port gathers all N windows at once and
evaluates each once on the whole (N, ...) batch.

Layout of the flat decision vector — the JAX package builds it with
``ravel_pytree``, which sorts the dict keys, so the order is:
    ``u``  (N, n_u)      controls
    ``x``  (N+1, n_dyn)  dynamic states (NARX states, then white-box)
    ``z``  (N, n_slack)  the remaining free states
A guess, a multiplier or a bound of either package therefore means the
same thing in the other.

The trained parameters ride the params tuple (``ml_params``), so a
retrained model re-solves with new weights and nothing else changes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from agentlib_mpc_torch.ml.predictors import cast_params
from agentlib_mpc_torch.models.ml_model import MLModel
from agentlib_mpc_torch.ops.solver import NLPFunctions
from agentlib_mpc_torch.utils.device import resolve_device

BIG = 1.0e6

#: key order of the flat decision vector (sorted, as ``ravel_pytree``)
LAYOUT_KEYS = ("u", "x", "z")


class MLOCPParams(NamedTuple):
    """Per-solve data of a NARX OCP. ``past[name]`` holds the L−1 values
    before t0 (index 0 = t0−dt, newest first); ``ml_params`` the predictor
    pytrees keyed like ``MLModel.ml_params``. Every leaf is a tensor, so
    ``torch.func.vmap`` batches the whole tuple."""

    x0: torch.Tensor              # (n_dyn,) current dynamic-state values
    u_prev: torch.Tensor          # (n_u,)
    past: dict[str, torch.Tensor]
    d_traj: torch.Tensor          # (N, n_d)
    p: torch.Tensor               # (n_p,)
    x_lb: torch.Tensor            # (N+1, n_dyn)
    x_ub: torch.Tensor
    u_lb: torch.Tensor            # (N, n_u)
    u_ub: torch.Tensor
    z_lb: torch.Tensor            # (n_slack,)
    z_ub: torch.Tensor
    t0: torch.Tensor
    ml_params: dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TranscribedMLOCP:
    """NARX OCP ready for ``solve_nlp`` (mirror of
    :class:`~agentlib_mpc_torch.ops.transcription.TranscribedOCP`)."""

    model: MLModel
    control_names: tuple[str, ...]
    exo_names: tuple[str, ...]
    dyn_names: tuple[str, ...]
    slack_names: tuple[str, ...]
    N: int
    dt: float
    method: str
    n_w: int
    n_g: int
    n_h: int
    nlp: NLPFunctions
    unflatten: Callable
    flatten: Callable
    bounds: Callable
    initial_guess: Callable
    shift_guess: Callable
    trajectories: Callable
    default_params: Callable
    #: no stage partition: the KKT system is solved dense
    stage_partition: Any = None

    @property
    def state_grid(self):
        return np.arange(self.N + 1) * self.dt

    @property
    def control_grid(self):
        return np.arange(self.N) * self.dt


def _finite(arr, default):
    return torch.where(torch.isfinite(arr), arr, torch.full_like(arr, default))


def transcribe_ml(model: MLModel, control_names: Sequence[str],
                  N: int, dt: float) -> TranscribedMLOCP:
    """Discrete multiple shooting over ``model.ml_step``."""
    control_names = list(control_names)
    for c in control_names:
        if c not in model.input_names:
            raise ValueError(f"control {c!r} is not a model input")
    if abs(float(model.dt) - float(dt)) > 1e-9:
        raise ValueError(
            f"NARX model dt={model.dt} must equal the MPC time step {dt} "
            f"(the reference re-samples instead of integrating, "
            f"casadi_ml.py:111-154)")
    exo_names = [n for n in model.input_names if n not in control_names]
    dyn_names = [*model.narx_state_names, *model.wb_state_names]
    slack_names = [n for n in model.free_state_names
                   if n not in model.narx_state_names]
    n_dyn = len(dyn_names)
    n_u = len(control_names)
    n_slack = len(slack_names)
    lags = {n: max(model.ml_lags.get(n, 1), 1) for n in model.history_names}

    shapes = {"u": (N, n_u), "x": (N + 1, n_dyn), "z": (N, n_slack)}
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

    # per history variable, the (N, L) gather of the stage windows out of
    # its padded sequence: seq index of v(k - i) is (k - i) + (L - 1)
    window_np = {n: np.arange(N)[:, None] + (L - 1) - np.arange(L)[None, :]
                 for n, L in lags.items()}
    idx_cache: dict = {}

    def windows_idx(device):
        """The window gathers as index tensors, once per device."""
        if device not in idx_cache:
            idx_cache[device] = {
                n: torch.as_tensor(v, device=device)
                for n, v in window_np.items()}
        return idx_cache[device]

    ctrl_pos = {n: control_names.index(n) for n in control_names}
    exo_pos = {n: exo_names.index(n) for n in exo_names}

    def _sequences(w: dict, theta: MLOCPParams) -> dict[str, torch.Tensor]:
        """Per history variable the padded time series
        [v(−L+1) … v(−1), v(0) … v(N−1)], oldest first."""
        x, u, z = w["x"], w["u"], w["z"]
        seqs = {}
        for name in model.history_names:
            if name in dyn_names:
                cur = x[:N, dyn_names.index(name)]
            elif name in control_names:
                cur = u[:, ctrl_pos[name]]
            elif name in exo_names:
                cur = theta.d_traj[:, exo_pos[name]]
            elif name in slack_names:
                cur = z[:, slack_names.index(name)]
            else:  # pragma: no cover - guarded in MLModel validation
                raise ValueError(f"history variable {name!r} unplaceable")
            if lags[name] > 1:
                cur = torch.cat([theta.past[name].flip(0), cur])
            seqs[name] = cur
        return seqs

    def _bind_vectors(w, theta, rows):
        """(x_diff, z_free, u_full), each (n, len(rows)) in the
        *declarative* model layout, at the state nodes ``rows``; a node's
        controls, disturbances and slacks are those of the interval
        min(k, N - 1)."""
        x, u, z = w["x"], w["u"], w["z"]
        xs = x[rows]                              # (K, n_dyn)
        kc = [min(k, N - 1) for k in rows]
        uk, zk, dk = u[kc], z[kc], theta.d_traj[kc]
        K = len(rows)
        x_diff = torch.stack([xs[:, dyn_names.index(n)]
                              for n in model.diff_state_names]) \
            if model.diff_state_names else x.new_zeros((0, K))
        z_free = torch.stack([
            xs[:, dyn_names.index(n)] if n in model.narx_state_names
            else zk[:, slack_names.index(n)]
            for n in model.free_state_names]) \
            if model.free_state_names else x.new_zeros((0, K))
        u_full = torch.stack([
            uk[:, ctrl_pos[n]] if n in ctrl_pos else dk[:, exo_pos[n]]
            for n in model.input_names]) \
            if model.input_names else x.new_zeros((0, K))
        return x_diff, z_free, u_full

    stage_rows = list(range(N))
    node_rows = list(range(1, N + 1))
    all_rows = list(range(N + 1))
    offsets: dict = {}

    def _times(theta, rows, like):
        """t0 + k dt at the nodes ``rows``; the offsets are built once per
        (rows, dtype, device)."""
        key = (rows[0], len(rows), like.dtype, like.device)
        if key not in offsets:
            offsets[key] = torch.as_tensor(
                [float(k) * dt for k in rows], dtype=like.dtype,
                device=like.device)
        return theta.t0 + offsets[key]

    # ---- equalities: initial pin + shooting defects -------------------------
    def g_fn(w_flat, theta: MLOCPParams):
        w = unflatten(w_flat)
        x = w["x"]
        seqs = _sequences(w, theta)
        idx = windows_idx(w_flat.device)
        hist = {n: seqs[n][idx[n]] for n in model.history_names}  # (N, L)
        nxt, _ = model.ml_step(hist, theta.p, ml_params=theta.ml_params,
                               t=_times(theta, stage_rows, w_flat))
        pred = torch.stack([nxt[n] for n in dyn_names], dim=-1) \
            if dyn_names else x.new_zeros((N, 0))
        defects = x[1:] - pred
        return torch.cat([x[0] - theta.x0, defects.reshape(-1)])

    # ---- inequalities -------------------------------------------------------
    def h_fn(w_flat, theta: MLOCPParams):
        if model.n_constraints == 0:
            return w_flat.new_zeros((0,))
        w = unflatten(w_flat)
        x_diff, z_free, u_full = _bind_vectors(w, theta, node_rows)
        res = model.constraint_residuals(x_diff, z_free, u_full, theta.p,
                                         _times(theta, node_rows, w_flat))
        return res.T.reshape(-1)                # node-major, as the vmap

    # ---- objective ----------------------------------------------------------
    def f_fn(w_flat, theta: MLOCPParams):
        w = unflatten(w_flat)
        u = w["u"]
        du = u - torch.cat([theta.u_prev[None, :], u[:-1]], dim=0)
        x_diff, z_free, u_full = _bind_vectors(w, theta, stage_rows)
        du_full = torch.stack([
            du[:, ctrl_pos[n]] if n in ctrl_pos else du.new_zeros((N,))
            for n in model.input_names]) \
            if model.input_names else du.new_zeros((0, N))
        q = model.stage_cost(x_diff, z_free, u_full, theta.p,
                             _times(theta, stage_rows, w_flat), du=du_full)
        return dt * torch.sum(q)

    cpu = torch.device("cpu")
    theta0 = _default_ml_params(model, control_names, exo_names, dyn_names,
                                slack_names, lags, N, device=cpu,
                                dtype=torch.float64)
    w0 = torch.zeros((n_w,), dtype=torch.float64)
    n_g = int(g_fn(w0, theta0).shape[0])
    n_h = int(h_fn(w0, theta0).shape[0])

    def bounds_fn(theta: MLOCPParams):
        lb = {"x": _finite(theta.x_lb, -BIG), "u": _finite(theta.u_lb, -BIG),
              "z": _finite(theta.z_lb, -BIG).expand(N, n_slack)}
        ub = {"x": _finite(theta.x_ub, BIG), "u": _finite(theta.u_ub, BIG),
              "z": _finite(theta.z_ub, BIG).expand(N, n_slack)}
        return flatten(lb), flatten(ub)

    def initial_guess_fn(theta: MLOCPParams):
        u_prev = torch.where(torch.isfinite(theta.u_prev), theta.u_prev,
                             torch.zeros_like(theta.u_prev))
        guess = {
            "x": theta.x0.expand(N + 1, n_dyn),
            "u": u_prev.expand(N, n_u),
            "z": theta.x0.new_zeros((N, n_slack)),
        }
        return flatten(guess)

    def shift_guess_fn(w_flat, theta: MLOCPParams):
        w = unflatten(w_flat)
        out = {k: torch.cat([w[k][1:], w[k][-1:]], dim=0)
               for k in LAYOUT_KEYS}
        out["x"] = torch.cat([theta.x0[None, :], w["x"][2:], w["x"][-1:]],
                             dim=0)
        return flatten(out)

    def trajectories_fn(w_flat, theta: MLOCPParams):
        w = unflatten(w_flat)
        x_diff, z_free, u_full = _bind_vectors(w, theta, all_rows)
        steps = _times(theta, all_rows, w_flat)
        y = model.output(x_diff, z_free, u_full, theta.p, steps).T
        return {
            "time_state": steps,
            "time_control": steps[:-1],
            "x": w["x"],
            "u": w["u"],
            "z": w["z"],
            "y": y,
            "objective": f_fn(w_flat, theta),
        }

    def default_params(*, device=None, dtype: torch.dtype = torch.float32,
                       **kw) -> MLOCPParams:
        return _default_ml_params(model, control_names, exo_names, dyn_names,
                                  slack_names, lags, N,
                                  device=resolve_device(device), dtype=dtype,
                                  **kw)

    return TranscribedMLOCP(
        model=model,
        control_names=tuple(control_names),
        exo_names=tuple(exo_names),
        dyn_names=tuple(dyn_names),
        slack_names=tuple(slack_names),
        N=N,
        dt=float(dt),
        method="narx_shooting",
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


def _default_ml_params(model: MLModel, control_names, exo_names, dyn_names,
                       slack_names, lags, N, *, device, dtype,
                       **overrides) -> MLOCPParams:
    """MLOCPParams from model defaults on ``device`` in ``dtype``; keyword
    overrides replace leaves (``past`` a dict, ``ml_params`` a pytree, the
    rest anything ``torch.as_tensor`` takes)."""
    byname = {v.name: v for v in
              (*model.inputs, *model.states, *model.parameters)}
    n_u = len(control_names)
    n_dyn = len(dyn_names)

    def vec(values, shape=None):
        t = torch.tensor([float(v) for v in values], dtype=dtype,
                         device=device)
        return t if shape is None else t.expand(shape).clone()

    past = {n: torch.full((lags[n] - 1,), float(byname[n].value),
                          dtype=dtype, device=device)
            for n in model.history_names}
    theta = MLOCPParams(
        x0=vec(byname[n].value for n in dyn_names),
        u_prev=vec(byname[n].value for n in control_names),
        past=past,
        d_traj=vec((byname[n].value for n in exo_names),
                   (N, len(exo_names))),
        p=vec(v.value for v in model.parameters),
        x_lb=vec((byname[n].lb for n in dyn_names), (N + 1, n_dyn)),
        x_ub=vec((byname[n].ub for n in dyn_names), (N + 1, n_dyn)),
        u_lb=vec((byname[n].lb for n in control_names), (N, n_u)),
        u_ub=vec((byname[n].ub for n in control_names), (N, n_u)),
        z_lb=vec(byname[n].lb for n in slack_names),
        z_ub=vec(byname[n].ub for n in slack_names),
        t0=torch.zeros((), dtype=dtype, device=device),
        ml_params=cast_params(model.ml_params, device, dtype))
    updates = {}
    for k, v in overrides.items():
        if k == "past":
            updates[k] = {n: torch.as_tensor(a, dtype=dtype, device=device)
                          for n, a in v.items()}
        elif k == "ml_params":
            updates[k] = cast_params(v, device, dtype)
        else:
            updates[k] = torch.as_tensor(v, dtype=dtype, device=device)
    return theta._replace(**updates)
