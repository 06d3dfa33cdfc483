"""Typed model variables.

Copy of ``agentlib_mpc_tpu/models/variables.py`` (which imports no JAX);
the port keeps its own copy so that it never imports the JAX package.

Mirrors the declarative variable groups of the reference
(``agentlib_mpc/models/casadi_model.py:36-274``: CasadiInput, CasadiState,
CasadiParameter, CasadiOutput) but carries no symbolic payload — in the
TPU-native design a variable is pure metadata (name, default, bounds, unit);
its *value* only exists inside the model functions, as a tensor.

Semantics kept from the reference:
- "inputs" are every exogenous signal of a model — controls, disturbances and
  settings alike; which input is a control is decided by the *controller
  config*, not the model (reference: modules/mpc/mpc.py:31-107 splits the
  module's variables into controls/inputs groups against the model).
- a state with no ODE assigned is a stage-wise free (algebraic / slack)
  variable in the OCP (reference: CasadiState.ode unset →
  differentials/algebraics split in casadi_model.py:469-500).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

Role = Literal["state", "input", "parameter", "output"]


@dataclasses.dataclass(frozen=True)
class Var:
    """Metadata for one scalar model quantity."""

    name: str
    value: float = 0.0
    lb: float = -math.inf
    ub: float = math.inf
    unit: str = "-"
    description: str = ""
    role: Role = "input"
    #: variable type, for interop with reference-style JSON configs
    type: str = "float"

    def replace(self, **kw) -> "Var":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for key in ("lb", "ub"):
            if math.isinf(d[key]):
                d[key] = None
        return d

    @classmethod
    def from_dict(cls, d: dict, role: Role | None = None) -> "Var":
        d = dict(d)
        d.pop("alias", None)
        d.pop("source", None)
        d.pop("shared", None)
        if d.get("lb") is None:
            d["lb"] = -math.inf
        if d.get("ub") is None:
            d["ub"] = math.inf
        if role is not None:
            d["role"] = role
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        return cls(**d)


def state(name: str, value: float = 0.0, *, lb: float = -math.inf,
          ub: float = math.inf, unit: str = "-", description: str = "") -> Var:
    """A (differential or algebraic/slack) state."""
    return Var(name=name, value=value, lb=lb, ub=ub, unit=unit,
               description=description, role="state")


def control_input(name: str, value: float = 0.0, *, lb: float = -math.inf,
                  ub: float = math.inf, unit: str = "-",
                  description: str = "") -> Var:
    """An exogenous input (control, disturbance or setting — the controller
    config decides)."""
    return Var(name=name, value=value, lb=lb, ub=ub, unit=unit,
               description=description, role="input")


def parameter(name: str, value: float = 0.0, *, unit: str = "-",
              description: str = "") -> Var:
    return Var(name=name, value=value, unit=unit, description=description,
               role="parameter")


def output(name: str, value: float = 0.0, *, unit: str = "-",
           description: str = "") -> Var:
    return Var(name=name, value=value, unit=unit, description=description,
               role="output")
