"""Declarative dynamic models as plain tensor functions.

Port of ``agentlib_mpc_tpu/models/model.py:40-329``: the same declarative
surface — variable lists as class attributes and a ``setup(v)`` method that
writes ODEs, output equations, constraints and the objective — with
``setup`` re-executed on every evaluation with the current values bound to
an attribute namespace.

Shapes. Each evaluation method takes ``x_diff`` (n_diff, ...), ``z_free``
(n_free, ...), ``u`` (n_inputs, ...) and ``p`` (n_params, ...): the
variable index is the LEADING axis, and whatever trailing axes the
arguments carry broadcast against each other. With 1-D arguments this is
the JAX package's per-point contract; the transcription passes every stage
and collocation point at once as trailing ``(N, d)`` axes (where the JAX
package vmaps over the stage axis). Results stack along axis 0.
"""

from __future__ import annotations

import functools
import math
from typing import Iterable, Sequence

import torch

from agentlib_mpc_torch.models.objective import _as_objective
from agentlib_mpc_torch.models.variables import Var
from agentlib_mpc_torch.utils.device import resolve_device


class ModelEquations:
    """Container the user's ``setup`` fills in.

    ``odes``: state name → dx/dt expression
    ``outputs``: output name → algebraic expression
    ``constraints``: list of (lb, expr, ub); bounds may be tensors
    ``objective``: `Objective` | scalar | None (stage cost integrand)
    """

    def __init__(self):
        self.odes: dict[str, torch.Tensor] = {}
        self.outputs: dict[str, torch.Tensor] = {}
        self.constraints: list[tuple] = []
        self.objective = None

    def ode(self, name: str, expr) -> None:
        self.odes[name] = expr

    def alg(self, name: str, expr) -> None:
        self.outputs[name] = expr

    def constraint(self, lb, expr, ub) -> None:
        self.constraints.append((lb, expr, ub))


class VarNS:
    """Attribute namespace binding variable names to current values: inside
    ``setup`` the user writes ``v.T_in - v.T`` and gets tensor arithmetic."""

    def __init__(self, values: dict[str, torch.Tensor],
                 du: dict[str, torch.Tensor] | None = None,
                 t: torch.Tensor | float = 0.0):
        object.__setattr__(self, "_values", values)
        object.__setattr__(self, "_du", du or {})
        object.__setattr__(self, "t", t)

    def __getattr__(self, name: str):
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError(
                f"model has no variable {name!r}; declared: "
                f"{sorted(object.__getattribute__(self, '_values'))}"
            ) from None

    def __setattr__(self, name, value):
        raise AttributeError("VarNS is read-only; write equations via ModelEquations")

    def __getitem__(self, name: str):
        return self._values[name]

    def du(self, name: str):
        """Control move u_k − u_{k−1} for change penalties (zero outside the
        optimizer — e.g. during plant simulation)."""
        return self._du.get(name, 0.0)


def _names(vars_: Iterable[Var]) -> list[str]:
    return [v.name for v in vars_]


def _like(*arrays) -> torch.Tensor:
    """First floating tensor among ``arrays`` (dtype/device source)."""
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a
    return torch.zeros((), dtype=torch.float64)


def _batch_shape(x_diff, z_free, u, p, t) -> torch.Size:
    """Broadcast of the trailing (non-variable) axes of the arguments and
    of the time grid ``t`` (which has no variable axis)."""
    shapes = [a.shape[1:] for a in (x_diff, z_free, u, p)
              if isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0]]
    if isinstance(t, torch.Tensor):
        shapes.append(t.shape)
    return torch.broadcast_shapes(*shapes) if shapes else torch.Size()


def _stack(exprs, like: torch.Tensor, batch: torch.Size) -> torch.Tensor:
    """Stack expressions (tensors or numbers) along a new axis 0 after
    broadcasting them to one shape."""
    if not exprs:
        return torch.zeros((0,) + tuple(batch), dtype=like.dtype,
                           device=like.device)
    ts = [e if isinstance(e, torch.Tensor)
          else torch.as_tensor(e, dtype=like.dtype, device=like.device)
          for e in exprs]
    return torch.stack(torch.broadcast_tensors(*ts))


class Model:
    """Base class for declarative models.

    Subclass and set the class attributes ``inputs``, ``states``,
    ``parameters``, ``outputs`` (lists of `Var`), then implement
    ``setup(self, v) -> ModelEquations``.
    """

    inputs: Sequence[Var] = ()
    states: Sequence[Var] = ()
    parameters: Sequence[Var] = ()
    outputs: Sequence[Var] = ()
    dt: float = 1.0  # native sampling time (ML models override; sim substep)

    def __init__(self, overrides: dict[str, float] | None = None, dt: float | None = None):
        # per-object copies so overrides don't leak across instances
        self.inputs = [Var.from_dict(v.as_dict()) if isinstance(v, Var) else Var.from_dict(v, "input")
                       for v in type(self).inputs]
        self.states = [Var.from_dict(v.as_dict()) if isinstance(v, Var) else Var.from_dict(v, "state")
                       for v in type(self).states]
        self.parameters = [Var.from_dict(v.as_dict()) if isinstance(v, Var) else Var.from_dict(v, "parameter")
                           for v in type(self).parameters]
        self.outputs = [Var.from_dict(v.as_dict()) if isinstance(v, Var) else Var.from_dict(v, "output")
                        for v in type(self).outputs]
        if dt is not None:
            self.dt = dt
        if overrides:
            self._apply_overrides(overrides)
        self._check_shadowing()
        self.input_names = _names(self.inputs)
        self.state_names = _names(self.states)
        self.parameter_names = _names(self.parameters)
        self.output_names = _names(self.outputs)
        self._probe()

    # -- declaration handling -------------------------------------------------

    def _apply_overrides(self, overrides: dict[str, float]) -> None:
        groups = (self.inputs, self.states, self.parameters, self.outputs)
        byname = {v.name: (g, i) for g in groups for i, v in enumerate(g)}
        for name, val in overrides.items():
            if name not in byname:
                raise KeyError(f"override for unknown variable {name!r}")
            g, i = byname[name]
            if isinstance(val, dict):
                g[i] = Var.from_dict({**g[i].as_dict(), **val}, g[i].role)
            else:
                g[i] = g[i].replace(value=float(val))

    def _check_shadowing(self) -> None:
        seen: set[str] = set()
        for v in (*self.inputs, *self.states, *self.parameters, *self.outputs):
            if v.name in seen:
                raise ValueError(f"duplicate variable name {v.name!r} across groups")
            seen.add(v.name)

    def _probe(self) -> None:
        """Run setup once on defaults to learn the equation structure:
        which states are differential vs. free, constraint count, term names."""
        ns = self._make_ns(
            {v.name: torch.tensor(float(v.value), dtype=torch.float64) for v in
             (*self.inputs, *self.states, *self.parameters, *self.outputs)})
        eq = self.setup(ns)
        unknown = set(eq.odes) - set(self.state_names)
        if unknown:
            raise ValueError(f"ODE assigned to undeclared states: {sorted(unknown)}")
        unknown = set(eq.outputs) - set(self.output_names)
        if unknown:
            raise ValueError(f"alg equation for undeclared outputs: {sorted(unknown)}")
        self.diff_state_names = [n for n in self.state_names if n in eq.odes]
        self.free_state_names = [n for n in self.state_names if n not in eq.odes]
        self.n_diff = len(self.diff_state_names)
        self.n_free = len(self.free_state_names)
        self.n_constraints = len(eq.constraints)
        obj = eq.objective
        self.objective_term_names = (
            list(_as_objective(obj).term_values().keys()) if obj is not None else [])

    def setup(self, v: VarNS) -> ModelEquations:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- evaluation -----------------------------------------------------------

    def _make_ns(self, values, du=None, t=0.0) -> VarNS:
        return VarNS(values, du=du, t=t)

    def _bind(self, x_diff, z_free, u, p, t, du=None) -> tuple[ModelEquations, VarNS]:
        like = _like(x_diff, z_free, u, p)
        values: dict[str, torch.Tensor] = {}
        for i, n in enumerate(self.diff_state_names):
            values[n] = x_diff[i]
        for i, n in enumerate(self.free_state_names):
            values[n] = z_free[i]
        for i, n in enumerate(self.input_names):
            values[n] = u[i]
        for i, n in enumerate(self.parameter_names):
            values[n] = p[i]
        # outputs start at placeholder defaults; extra setup passes rebind
        # them to their computed expressions so constraints and objectives
        # may reference outputs by name
        for v in self.outputs:
            values[v.name] = torch.as_tensor(float(v.value), dtype=like.dtype,
                                             device=like.device)
        du_map = None
        if du is not None:
            du_map = {n: du[i] for i, n in enumerate(self.input_names)}
        ns = self._make_ns(values, du=du_map, t=t)
        eq = self.setup(ns)
        # one extra pass per declared output resolves chains of
        # output-to-output references (A=f(x), B=g(A), C=h(B), ...)
        for _ in range(len(self.outputs)):
            if not eq.outputs:
                break
            values = dict(values)
            for name, expr in eq.outputs.items():
                values[name] = expr
            ns = self._make_ns(values, du=du_map, t=t)
            eq = self.setup(ns)
        return eq, ns

    def ode(self, x_diff, z_free, u, p, t=0.0):
        """dx/dt of the differential states → (n_diff, ...)."""
        eq, _ = self._bind(x_diff, z_free, u, p, t)
        return _stack([eq.odes[n] for n in self.diff_state_names],
                      _like(x_diff, z_free, u, p),
                      _batch_shape(x_diff, z_free, u, p, t))

    def output(self, x_diff, z_free, u, p, t=0.0):
        """(n_outputs, ...) algebraic outputs."""
        eq, _ = self._bind(x_diff, z_free, u, p, t)
        outs = [eq.outputs.get(v.name, float(v.value)) for v in self.outputs]
        return _stack(outs, _like(x_diff, z_free, u, p),
                      _batch_shape(x_diff, z_free, u, p, t))

    def constraint_residuals(self, x_diff, z_free, u, p, t=0.0):
        """All model constraints as one-sided residuals h ≥ 0.

        Each (lb, expr, ub) triple contributes ``expr − lb`` and/or
        ``ub − expr``; statically infinite bounds are dropped, bounds that
        are tensors are kept as nonlinear residuals. Every residual covers
        the whole batch of points, also one that depends on none of the
        arguments that vary across it (a constraint on the controls alone
        is evaluated at every collocation point, as the JAX package does).
        """
        eq, _ = self._bind(x_diff, z_free, u, p, t)
        res = []
        for lb, expr, ub in eq.constraints:
            if not (isinstance(lb, (int, float)) and math.isinf(lb)):
                res.append(expr - lb)
            if not (isinstance(ub, (int, float)) and math.isinf(ub)):
                res.append(ub - expr)
        batch = _batch_shape(x_diff, z_free, u, p, t)
        out = _stack(res, _like(x_diff, z_free, u, p), batch)
        return out.expand(out.shape[:1]
                          + torch.broadcast_shapes(out.shape[1:], batch))

    def _stage_eq(self, x_diff, z_free, u, p, t, du):
        if du is None:
            du = torch.zeros_like(u)
        return self._bind(x_diff, z_free, u, p, t, du=du)[0]

    def stage_cost(self, x_diff, z_free, u, p, t=0.0, du=None):
        """Objective integrand → (...) (a scalar for 1-D arguments)."""
        eq = self._stage_eq(x_diff, z_free, u, p, t, du)
        like = _like(x_diff, z_free, u, p)
        batch = _batch_shape(x_diff, z_free, u, p, t)
        val = 0.0 if eq.objective is None else _as_objective(eq.objective).value()
        return _stack([val], like, batch)[0]

    def stage_cost_terms(self, x_diff, z_free, u, p, t=0.0, du=None):
        """name → weighted per-term stage cost."""
        eq = self._stage_eq(x_diff, z_free, u, p, t, du)
        if eq.objective is None:
            return {}
        like = _like(x_diff, z_free, u, p)
        batch = _batch_shape(x_diff, z_free, u, p, t)
        return {k: _stack([v], like, batch)[0] for k, v in
                _as_objective(eq.objective).term_values().items()}

    # -- simulation -----------------------------------------------------------

    def simulate_step(self, x_diff, u, p, dt: float, substeps: int = 10,
                      method: str = "rk4"):
        """Integrate the ODE over one sample with fixed sub-steps (JAX
        package: ``Model.simulate_step``); ``method`` selects the stepper
        of ``ops/integrators.py`` ("euler", "rk4", "implicit_midpoint",
        "trbdf2", "adaptive"). Free (slack) states are held at zero.

        Batch-first, unlike the evaluation methods above: ``x_diff`` is
        (..., n_diff), ``u`` (..., n_inputs) and ``p`` (..., n_params), the
        variables on the LAST axis and the leading axes independent plants
        (1-D arguments are one plant, as in the JAX package). Runs on the
        device of ``x_diff``, in the floating dtype its arguments promote
        to. Returns ``(x_next (..., n_diff), outputs (..., n_outputs))``."""
        from agentlib_mpc_torch.ops.integrators import integrate

        args = [torch.as_tensor(a) for a in (x_diff, u, p)]
        dtype = functools.reduce(torch.promote_types,
                                 (a.dtype for a in args))
        if not dtype.is_floating_point:
            dtype = torch.get_default_dtype()
        device = args[0].device
        x, u, p = (a.to(device=device, dtype=dtype) for a in args)
        z = torch.zeros((self.n_free,), dtype=dtype, device=device)
        u_v, p_v = u.movedim(-1, 0), p.movedim(-1, 0)

        def f(xx, t):
            return self.ode(xx.movedim(-1, 0), z, u_v, p_v, t).movedim(0, -1)

        x_next = integrate(f, x, 0.0, dt, substeps=substeps, method=method)
        y = self.output(x_next.movedim(-1, 0), z, u_v, p_v, dt)
        return x_next, y.movedim(0, -1)

    # -- convenience ----------------------------------------------------------

    def default_vector(self, group: str, *, device=None,
                       dtype: torch.dtype = torch.float64) -> torch.Tensor:
        vars_ = {"inputs": self.inputs, "parameters": self.parameters,
                 "outputs": self.outputs}.get(group)
        if group == "diff_states":
            byname = {v.name: v for v in self.states}
            vars_ = [byname[n] for n in self.diff_state_names]
        elif group == "free_states":
            byname = {v.name: v for v in self.states}
            vars_ = [byname[n] for n in self.free_state_names]
        if vars_ is None:
            raise KeyError(group)
        return torch.tensor([float(v.value) for v in vars_], dtype=dtype,
                            device=resolve_device(device))

    def get_var(self, name: str) -> Var:
        for v in (*self.inputs, *self.states, *self.parameters, *self.outputs):
            if v.name == name:
                return v
        raise KeyError(name)

    def input_index(self, name: str) -> int:
        return self.input_names.index(name)
