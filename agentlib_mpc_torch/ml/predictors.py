"""Tensor evaluation of serialized ML models.

Port of ``agentlib_mpc_tpu/ml/predictors.py``. Each trained model becomes a
pure function ``apply(params, x) -> y`` over tensors (the reference's
``models/casadi_predictor.py`` re-implements it symbolically in CasADi).
``apply`` uses no in-place operation and no host sync, so it runs under
``torch.func`` (``jacrev``/``hessian``/``vmap``), which the solver uses to
differentiate the NARX transcription; ``apply_batch(params, X)`` evaluates
a (..., n_in) batch at once, where the JAX package ``vmap``s ``apply``.

The params pytree is an explicit argument, as in the JAX package:
hot-swapping a retrained model replaces leaves of identical shape.
:func:`make_predictor` builds them as float64 tensors on the CPU (the
host copy); :func:`cast_params` moves a copy to the device and dtype a
solve runs in.

Two activations need care to match ``jax.nn``: ``jax.nn.gelu`` is the
tanh approximation by default (``torch.nn.functional.gelu`` is the exact
erf form), and ``torch.nn.functional.softplus`` turns linear above its
threshold, where ``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from agentlib_mpc_torch.ml.serialized import (
    ACTIVATIONS as _DECLARED,
    SerializedANN,
    SerializedGPR,
    SerializedGraphANN,
    SerializedKerasANN,
    SerializedLinReg,
    SerializedMLModel,
)

_ACT = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}

# one function table governs trainer + predictor; the declarative name list
# in serialized.py must match it exactly
assert set(_ACT) == set(_DECLARED), (
    "activation registries diverged: predictors._ACT vs "
    "serialized.ACTIVATIONS")


class Predictor(NamedTuple):
    """``apply(params, x: (n_in,)) → (n_out,)`` and ``apply_batch(params,
    X: (..., n_in)) → (..., n_out)``; ``params`` is a pytree of tensors
    whose leaves may be swapped (same shapes)."""

    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any
    n_inputs: int
    n_outputs: int
    input_columns: tuple[str, ...]
    output_names: tuple[str, ...]
    apply_batch: Callable[[Any, torch.Tensor], torch.Tensor]


def _host(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float64))


def cast_params(params, device=None, dtype: torch.dtype = torch.float64):
    """A copy of a params pytree with every floating tensor on ``device``
    in ``dtype`` (None keeps the device)."""
    def cast(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.to(device=device if device is not None else t.device,
                        dtype=dtype)
        return t

    return tree_map(cast, params)


def _ann_predictor(m: SerializedANN) -> Predictor:
    params = {"W": [_host(w) for w in m.weights],
              "b": [_host(b) for b in m.biases]}
    acts = tuple(m.activations)

    def apply_batch(p, X):
        h = X
        for W, b, a in zip(p["W"], p["b"], acts):
            h = _ACT[a](h @ W + b)
        return h.reshape(X.shape[:-1] + (-1,))

    def apply(p, x):
        return apply_batch(p, x.reshape(1, -1))[0]

    n_out = int(np.asarray(m.biases[-1]).size) if m.biases else 0
    return Predictor(apply, params, m.n_inputs, n_out,
                     tuple(m.input_columns), tuple(m.output_names),
                     apply_batch)


def _gpr_predictor(m: SerializedGPR) -> Predictor:
    x_train = np.asarray(m.x_train, dtype=float)
    d = x_train.shape[1] if x_train.ndim == 2 else 1
    ls = np.broadcast_to(np.asarray(m.length_scale, dtype=float), (d,))
    params = {
        "x_train": _host(x_train),
        "alpha": _host(m.alpha),
        "constant_value": _host(float(m.constant_value)),
        "length_scale": _host(ls),
        "mean": _host(m.mean if m.mean is not None else np.zeros(d)),
        "std": _host(m.std if m.std is not None else np.ones(d)),
        "scale": _host(float(m.scale)),
    }
    normalize = bool(m.normalize)

    def apply_batch(p, X):
        if normalize:
            X = (X - p["mean"]) / p["std"]
        # k(x, X) = cv * exp(-0.5 * sum_j ((x_j - X_ij)/l_j)^2); the White
        # term has zero cross-covariance, so the posterior mean is k @ alpha
        diff = (X[..., None, :] - p["x_train"]) / p["length_scale"]
        k = p["constant_value"] * torch.exp(
            -0.5 * torch.sum(diff * diff, dim=-1))
        return (k @ p["alpha"] * p["scale"]).reshape(X.shape[:-1] + (-1,))

    def apply(p, x):
        return apply_batch(p, x.reshape(1, -1))[0]

    return Predictor(apply, params, m.n_inputs, len(m.output),
                     tuple(m.input_columns), tuple(m.output_names),
                     apply_batch)


def _linreg_predictor(m: SerializedLinReg) -> Predictor:
    coef = np.atleast_2d(np.asarray(m.coef, dtype=float))  # (n_out, n_in)
    params = {"coef": _host(coef),
              "intercept": _host(np.atleast_1d(
                  np.asarray(m.intercept, dtype=float)))}

    def apply(p, x):
        return p["coef"] @ x + p["intercept"]

    def apply_batch(p, X):
        return X @ p["coef"].T + p["intercept"]

    return Predictor(apply, params, m.n_inputs, coef.shape[0],
                     tuple(m.input_columns), tuple(m.output_names),
                     apply_batch)


def _graph_predictor(m: SerializedGraphANN) -> Predictor:
    from agentlib_mpc_torch.ml.keras_graph import (
        build_graph_apply,
        spec_from_jsonable,
    )

    spec, params = spec_from_jsonable(m.graph)
    apply = build_graph_apply(spec)

    def apply_batch(p, X):
        flat = X.reshape(-1, X.shape[-1])
        out = torch.func.vmap(apply, in_dims=(None, 0))(p, flat)
        return out.reshape(X.shape[:-1] + out.shape[-1:])

    return Predictor(apply, params, m.n_inputs, len(m.output),
                     tuple(m.input_columns), tuple(m.output_names),
                     apply_batch)


def _keras_predictor(m: SerializedKerasANN) -> Predictor:
    # load the .keras artifact, convert once, evaluate as a graph
    return _graph_predictor(m.to_graph())


_MAKERS = {
    SerializedANN: _ann_predictor,
    SerializedGPR: _gpr_predictor,
    SerializedLinReg: _linreg_predictor,
    SerializedGraphANN: _graph_predictor,
    SerializedKerasANN: _keras_predictor,
}


def make_predictor(m: SerializedMLModel) -> Predictor:
    """Build the tensor evaluator for a serialized model (registry
    mirroring the reference's ``casadi_predictor.py:742-747``); its params
    are float64 CPU tensors (:func:`cast_params` moves them)."""
    for cls, maker in _MAKERS.items():
        if isinstance(m, cls):
            return maker(m)
    raise TypeError(f"no predictor for {type(m).__name__}")
