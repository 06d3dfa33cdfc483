"""Serialized ML-model exchange format (JSON).

Port of ``agentlib_mpc_tpu/ml/serialized.py``, a copy: the JAX package's
module needs no JAX, but importing it imports the JAX package. Documents
are byte-compatible, so a JSON written by either package loads in the
other and a trainer of one feeds a controller of the other.

Every model records its prediction step ``dt``, input `Feature`s with lag
depth, and `OutputFeature`s with absolute/difference output type and a
recursive flag (the reference's ``models/serialized_ml_model.py`` and
``data_structures/ml_model_datatypes.py:14-135``). Parameters are plain
lists; the predictor layer (:mod:`agentlib_mpc_torch.ml.predictors`)
turns them into tensors.

The learned warm-start document (``SerializedWarmstart``) comes with
``ml/warmstart.py`` (ROADMAP Queue 1 item 5); a document of that type
raises ``KeyError`` here as an unknown type.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, ClassVar, Optional, Type, Union

import numpy as np

ACTIVATIONS = ("linear", "relu", "tanh", "sigmoid", "softplus", "elu",
               "gelu")


@dataclasses.dataclass
class Feature:
    """One model input quantity with NARX lag depth: ``lag = L`` means the
    values at t, t−dt, …, t−(L−1)dt all enter the input vector."""

    name: str
    lag: int = 1

    def as_dict(self) -> dict:
        return {"name": self.name, "lag": self.lag}


@dataclasses.dataclass
class OutputFeature(Feature):
    """Model output. ``output_type``: "absolute" → forward pass yields the
    feature's next-step value; "difference" → yields the increment to add to
    the current value. ``recursive``: the output is also an input (state
    evolution); non-recursive outputs are algebraic and must be absolute
    (reference validator, ``ml_model_datatypes.py:40-53``)."""

    output_type: str = "absolute"
    recursive: bool = True

    def __post_init__(self):
        if self.output_type not in ("absolute", "difference"):
            raise ValueError(
                f"output_type must be 'absolute' or 'difference', got "
                f"{self.output_type!r}")
        if not self.recursive and self.output_type == "difference":
            raise ValueError(
                f"output feature {self.name!r} is non-recursive, so its "
                f"output_type must be 'absolute'")

    def as_dict(self) -> dict:
        return {**super().as_dict(), "output_type": self.output_type,
                "recursive": self.recursive}


def name_with_lag(name: str, lag: int) -> str:
    return name if lag == 0 else f"{name}_{lag}"


def column_order(inputs: dict[str, Feature],
                 outputs: dict[str, OutputFeature]) -> list[str]:
    """Flat input-vector layout: every input feature with lags 0..L−1, then
    every *recursive* output likewise (reference
    ``ml_model_datatypes.py:118-132``)."""
    ordered: list[str] = []
    for name, feat in inputs.items():
        ordered.extend(name_with_lag(name, i) for i in range(feat.lag))
    for name, feat in outputs.items():
        if feat.recursive:
            ordered.extend(name_with_lag(name, i) for i in range(feat.lag))
    return ordered


_REGISTRY: dict[str, Type["SerializedMLModel"]] = {}


def _as_feature(d, cls):
    if isinstance(d, cls):
        return d
    d = dict(d)
    d.pop("init", None)
    return cls(**d)


@dataclasses.dataclass
class SerializedMLModel:
    """Base exchange document. Subclasses add a ``parameters`` payload."""

    model_type: ClassVar[str] = "base"

    dt: float = 1.0
    inputs: dict[str, Feature] = dataclasses.field(default_factory=dict)
    output: dict[str, OutputFeature] = dataclasses.field(default_factory=dict)
    trainer_config: Optional[dict] = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _REGISTRY[cls.model_type] = cls

    def __post_init__(self):
        self.inputs = {k: _as_feature(v, Feature)
                       for k, v in self.inputs.items()}
        self.output = {k: _as_feature(v, OutputFeature)
                       for k, v in self.output.items()}
        for k, f in (*self.inputs.items(), *self.output.items()):
            f.name = f.name or k

    # -- layout ---------------------------------------------------------------

    @property
    def input_columns(self) -> list[str]:
        return column_order(self.inputs, self.output)

    @property
    def n_inputs(self) -> int:
        return len(self.input_columns)

    @property
    def output_names(self) -> list[str]:
        return list(self.output)

    def lags_per_variable(self) -> dict[str, int]:
        """name → lag depth of every variable entering the input vector."""
        lags = {n: f.lag for n, f in self.inputs.items()}
        for n, f in self.output.items():
            if f.recursive:
                lags[n] = max(f.lag, lags.get(n, 0))
        return lags

    # -- (de)serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "model_type": self.model_type,
            "dt": self.dt,
            "inputs": {k: v.as_dict() for k, v in self.inputs.items()},
            "output": {k: v.as_dict() for k, v in self.output.items()},
            "trainer_config": self.trainer_config,
            "parameters": self._parameters_dict(),
        }

    def _parameters_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "SerializedMLModel":
        d = dict(d)
        model_type = d.pop("model_type")
        sub = _REGISTRY.get(model_type)
        if sub is None:
            raise KeyError(f"unknown serialized model type {model_type!r}; "
                           f"known: {sorted(_REGISTRY)}")
        params = d.pop("parameters", {})
        return sub(**{**d, **params})

    @classmethod
    def from_json(cls, s: str) -> "SerializedMLModel":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: Union[str, Path]) -> "SerializedMLModel":
        return cls.from_json(Path(path).read_text())


def load_serialized_model(
        source: Union[str, Path, dict, SerializedMLModel]
) -> SerializedMLModel:
    """Polymorphic loader: instance, dict, JSON string or file path
    (reference ``load_serialized_model``, ``serialized_ml_model.py:145-152``)."""
    if isinstance(source, SerializedMLModel):
        return source
    if isinstance(source, dict):
        return SerializedMLModel.from_dict(source)
    text = str(source)
    if text.lstrip().startswith("{"):
        return SerializedMLModel.from_json(text)
    return SerializedMLModel.load(source)


@dataclasses.dataclass
class SerializedANN(SerializedMLModel):
    """Feed-forward network: per-layer weights (in-dim × out-dim), biases
    and activation names (reference ``SerializedANN``,
    ``serialized_ml_model.py:155-228`` — keras structure+weights JSON)."""

    model_type: ClassVar[str] = "ANN"

    weights: list = dataclasses.field(default_factory=list)
    biases: list = dataclasses.field(default_factory=list)
    activations: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        super().__post_init__()
        if not (len(self.weights) == len(self.biases)
                == len(self.activations)):
            raise ValueError("weights/biases/activations length mismatch")
        for a in self.activations:
            if a not in ACTIVATIONS:
                raise ValueError(f"unknown activation {a!r}; known: "
                                 f"{ACTIVATIONS}")

    def _parameters_dict(self) -> dict:
        return {
            "weights": [np.asarray(w).tolist() for w in self.weights],
            "biases": [np.asarray(b).tolist() for b in self.biases],
            "activations": list(self.activations),
        }

    @classmethod
    def from_torch(cls, module, dt, inputs, output,
                   trainer_config=None) -> "SerializedANN":
        """Convert a torch ``nn.Sequential`` of Linear + activation layers."""
        import torch.nn as nn

        act_map = {nn.ReLU: "relu", nn.Tanh: "tanh", nn.Sigmoid: "sigmoid",
                   nn.Softplus: "softplus", nn.ELU: "elu", nn.GELU: "gelu",
                   nn.Identity: "linear"}
        weights, biases, acts = [], [], []
        pending_act = None
        for layer in module:
            if isinstance(layer, nn.Linear):
                if weights:
                    acts.append(pending_act or "linear")
                pending_act = None
                weights.append(
                    layer.weight.detach().numpy().T.tolist())  # (in, out)
                biases.append(layer.bias.detach().numpy().tolist())
            else:
                for t, name in act_map.items():
                    if isinstance(layer, t):
                        pending_act = name
                        break
                else:
                    raise ValueError(f"unsupported torch layer {layer}")
        if weights:
            acts.append(pending_act or "linear")
        return cls(dt=dt, inputs=inputs, output=output,
                   trainer_config=trainer_config,
                   weights=weights, biases=biases, activations=acts)


@dataclasses.dataclass
class SerializedGPR(SerializedMLModel):
    """Exact GPR with the reference's kernel family — ConstantKernel × RBF
    + White — plus input normalization and output scaling
    (``SerializedGPR``/``CustomGPR``, ``serialized_ml_model.py:231-540``).
    Prediction needs only ``x_train`` and the precomputed dual coefficients
    ``alpha`` (White contributes nothing to cross-covariance)."""

    model_type: ClassVar[str] = "GPR"

    x_train: list = dataclasses.field(default_factory=list)
    alpha: list = dataclasses.field(default_factory=list)
    constant_value: float = 1.0
    length_scale: Any = 1.0
    noise_level: float = 1.0
    normalize: bool = False
    mean: Optional[list] = None
    std: Optional[list] = None
    scale: float = 1.0

    def _parameters_dict(self) -> dict:
        return {
            "x_train": np.asarray(self.x_train).tolist(),
            "alpha": np.asarray(self.alpha).tolist(),
            "constant_value": float(self.constant_value),
            "length_scale": (np.asarray(self.length_scale).tolist()
                             if np.ndim(self.length_scale) else
                             float(self.length_scale)),
            "noise_level": float(self.noise_level),
            "normalize": bool(self.normalize),
            "mean": None if self.mean is None
            else np.asarray(self.mean).tolist(),
            "std": None if self.std is None
            else np.asarray(self.std).tolist(),
            "scale": float(self.scale),
        }

    @classmethod
    def from_sklearn(cls, gpr, dt, inputs, output, normalize=False,
                     mean=None, std=None, scale=1.0,
                     trainer_config=None) -> "SerializedGPR":
        """Convert a fitted sklearn GPR with kernel C(·)×RBF(·) + White(·)
        (the reference's trainer kernel, ``ml_model_trainer.py:673-735``)."""
        k = gpr.kernel_
        return cls(
            dt=dt, inputs=inputs, output=output,
            trainer_config=trainer_config,
            x_train=gpr.X_train_.tolist(),
            alpha=np.asarray(gpr.alpha_).reshape(-1).tolist(),
            constant_value=float(k.k1.k1.constant_value),
            length_scale=(np.asarray(k.k1.k2.length_scale).tolist()
                          if np.ndim(k.k1.k2.length_scale) else
                          float(k.k1.k2.length_scale)),
            noise_level=float(k.k2.noise_level),
            normalize=normalize,
            mean=None if mean is None else np.asarray(mean).tolist(),
            std=None if std is None else np.asarray(std).tolist(),
            scale=scale,
        )


@dataclasses.dataclass
class SerializedLinReg(SerializedMLModel):
    """Affine model (reference ``SerializedLinReg``,
    ``serialized_ml_model.py:566-659``)."""

    model_type: ClassVar[str] = "LinReg"

    coef: list = dataclasses.field(default_factory=list)
    intercept: Any = 0.0

    def _parameters_dict(self) -> dict:
        return {
            "coef": np.asarray(self.coef).tolist(),
            "intercept": (np.asarray(self.intercept).tolist()
                          if np.ndim(self.intercept) else
                          float(self.intercept)),
        }

    @classmethod
    def from_sklearn(cls, linreg, dt, inputs, output,
                     trainer_config=None) -> "SerializedLinReg":
        return cls(dt=dt, inputs=inputs, output=output,
                   trainer_config=trainer_config,
                   coef=np.asarray(linreg.coef_).tolist(),
                   intercept=(np.asarray(linreg.intercept_).tolist()
                              if np.ndim(linreg.intercept_) else
                              float(linreg.intercept_)))


@dataclasses.dataclass
class SerializedGraphANN(SerializedMLModel):
    """Self-contained layer-graph ANN: topology + weights in the document.

    The counterpart of the reference's Keras coverage
    (``casadi_predictor.py:197-719``): any supported Keras ``Sequential`` /
    ``Functional`` model converts once (``ml/keras_graph.from_keras``) into
    a JSON graph spec + weight lists, after which neither keras nor
    tensorflow is needed anywhere — the document alone rebuilds the tensor
    evaluator (`ml/keras_graph.build_graph_apply`).
    """

    model_type: ClassVar[str] = "GraphANN"

    graph: dict = dataclasses.field(default_factory=dict)

    def _parameters_dict(self) -> dict:
        return {"graph": self.graph}

    @classmethod
    def from_keras(cls, model, dt, inputs, output,
                   trainer_config=None) -> "SerializedGraphANN":
        """Convert a live Keras model into the self-contained document."""
        from agentlib_mpc_torch.ml.keras_graph import (
            from_keras,
            spec_to_jsonable,
        )

        spec, params = from_keras(model)
        return cls(dt=dt, inputs=inputs, output=output,
                   trainer_config=trainer_config,
                   graph=spec_to_jsonable(spec, params))


@dataclasses.dataclass
class SerializedKerasANN(SerializedMLModel):
    """Path-referencing Keras artifact (reference ``SerializedKerasANN``,
    ``serialized_ml_model.py:662-709``): stores the ``.keras`` file path;
    loading requires keras and converts to the layer-graph evaluator."""

    model_type: ClassVar[str] = "KerasANN"

    model_path: str = ""

    def _parameters_dict(self) -> dict:
        return {"model_path": str(self.model_path)}

    @classmethod
    def serialize(cls, model, dt, inputs, output, model_path,
                  trainer_config=None) -> "SerializedKerasANN":
        """Save `model` to ``model_path`` (.keras) and reference it."""
        path = Path(model_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        model.save(path)
        return cls(dt=dt, inputs=inputs, output=output,
                   trainer_config=trainer_config, model_path=str(path))

    def deserialize(self):
        """Load the referenced Keras model (requires keras installed)."""
        import keras

        return keras.saving.load_model(self.model_path)

    def to_graph(self) -> SerializedGraphANN:
        """Load + convert into the self-contained graph document."""
        return SerializedGraphANN.from_keras(
            self.deserialize(), dt=self.dt, inputs=self.inputs,
            output=self.output, trainer_config=self.trainer_config)
