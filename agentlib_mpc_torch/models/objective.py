"""Composable objective algebra on tensors.

Port of ``agentlib_mpc_tpu/models/objective.py``: the same term classes
(SubObjective, ChangePenaltyObjective, ConditionalObjective,
CombinedObjective) with ``jnp`` replaced by ``torch``. ``Model.setup`` is
re-run on every evaluation, so a term holds the *value* of its expression
at the current stage (a tensor, or a Python float for constants) plus its
name and weight. Values keep the dtype and device of the tensors they were
built from; constants stay Python numbers so they never force a dtype.
"""

from __future__ import annotations

from typing import Union

import torch

Scalar = Union[float, torch.Tensor]


class Objective:
    """Base class: supports ``+`` and ``*`` composition."""

    name: str = "objective"

    def value(self) -> Scalar:
        raise NotImplementedError

    def term_values(self) -> dict[str, Scalar]:
        """name → weighted term value at the current stage."""
        return {self.name: self.value()}

    def __add__(self, other):
        return CombinedObjective(self, _as_objective(other))

    def __radd__(self, other):
        if isinstance(other, (int, float)) and other == 0:  # sum([...])
            return self
        return CombinedObjective(_as_objective(other), self)

    def __mul__(self, factor):
        return _Scaled(self, factor)

    __rmul__ = __mul__


class _Wrapped(Objective):
    """A bare scalar expression used as an objective."""

    def __init__(self, expr: Scalar, name: str = "objective"):
        self.expr = expr
        self.name = name

    def value(self) -> Scalar:
        return self.expr


class _Scaled(Objective):
    def __init__(self, inner: Objective, factor: Scalar):
        self.inner = inner
        self.factor = factor
        self.name = inner.name

    def value(self) -> Scalar:
        return self.inner.value() * self.factor

    def term_values(self) -> dict[str, Scalar]:
        return {k: v * self.factor for k, v in self.inner.term_values().items()}


def _as_objective(x) -> Objective:
    if isinstance(x, Objective):
        return x
    return _Wrapped(x)


class SubObjective(Objective):
    """``weight * sum(expressions)``; ``weight`` may be a float or a
    parameter value from the namespace."""

    def __init__(self, expressions, weight: Scalar = 1.0, name: str = "sub_objective"):
        if not isinstance(expressions, (list, tuple)):
            expressions = [expressions]
        self.expressions = list(expressions)
        self.weight = weight
        self.name = name

    def value(self) -> Scalar:
        total = 0.0
        for e in self.expressions:
            total = total + e
        return self.weight * total


class ChangePenaltyObjective(Objective):
    """Penalty on control moves Δu; ``du`` comes from ``v.du("<control>")``
    which the transcription wires to u_k − u_{k−1}."""

    def __init__(self, du: Scalar, weight: Scalar = 1.0,
                 name: str = "change_penalty", quadratic: bool = True):
        self.du = du
        self.weight = weight
        self.name = name
        self.quadratic = quadratic

    def value(self) -> Scalar:
        du = self.du
        if self.quadratic:
            penalty = du * du
        else:
            penalty = du.abs() if isinstance(du, torch.Tensor) else abs(du)
        return self.weight * penalty


class ConditionalObjective(Objective):
    """Objective switched by a boolean condition (``torch.where``)."""

    def __init__(self, condition, if_true: Objective, if_false: Objective,
                 name: str = "conditional"):
        self.condition = condition
        self.if_true = _as_objective(if_true)
        self.if_false = _as_objective(if_false)
        self.name = name

    def value(self) -> Scalar:
        a, b = self.if_true.value(), self.if_false.value()
        if not isinstance(self.condition, torch.Tensor):
            return a if self.condition else b
        return torch.where(self.condition, a, b)


class CombinedObjective(Objective):
    """Sum of terms with optional normalization."""

    def __init__(self, *terms, normalization: Scalar = 1.0, name: str = "combined"):
        self.terms: list[Objective] = [_as_objective(t) for t in terms]
        self.normalization = normalization
        self.name = name

    def value(self) -> Scalar:
        total = 0.0
        for t in self.terms:
            total = total + t.value()
        return total / self.normalization

    def term_values(self) -> dict[str, Scalar]:
        out: dict[str, Scalar] = {}
        for i, t in enumerate(self.terms):
            for k, v in t.term_values().items():
                key = k if k not in out else f"{k}_{i}"
                out[key] = v / self.normalization
        return out

    def __add__(self, other):
        other = _as_objective(other)
        if isinstance(other, CombinedObjective) and \
                other.normalization == self.normalization:
            return CombinedObjective(*self.terms, *other.terms,
                                     normalization=self.normalization)
        return CombinedObjective(self, other)
