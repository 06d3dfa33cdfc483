"""Keras ANN interop: layer-graph IR, tensor evaluation and converter.

Port of ``agentlib_mpc_tpu/ml/keras_graph.py``. A trained Keras model (the
reference's ``agentlib_mpc/models/casadi_predictor.py``: layer classes
:197-536, Sequential chain :599-616, Functional-API DAG walk :618-719) is
converted **once** into

* a JSON-able *graph spec* — a topologically-ordered list of nodes
  (layer type + static config + input edges), and
* a *params* pytree of float64 weight tensors keyed by node name,

which :func:`build_graph_apply` turns into one pure function
``apply(params, x) -> y`` over tensors: no in-place operation, so it runs
under ``torch.func`` (the NARX transcription differentiates through it).
Documents are the JAX package's, byte for byte.

Supported layer types (the reference's 17, ``casadi_predictor.py:197-215``):
dense (with the activation set incl. exponential/gaussian), flatten,
batch_normalization, normalization, cropping1d, concatenate, reshape,
input_slice, constant, add, subtract, multiply, divide, power, average,
rescaling, rbf. Nested Functional / Sequential submodels are inlined
recursively (the reference wraps them, :536-556). :func:`from_keras`
imports nothing of keras itself and runs on the host only; keras is
needed only where a live model is converted.

Internal array convention: like the reference's CasADi layers, every value
is a 2-D ``(rows, features)`` tensor without the batch dimension
(``Layer.update_dimensions``, :239-252); the public ``apply`` takes the
flat input vector and returns the flat output.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils._pytree import tree_map

# activations the reference evaluates symbolically
# (``casadi_predictor.py:254-296``): the shared trainer/predictor table
# plus the two keras-only names it supports on top
from agentlib_mpc_torch.ml.predictors import _ACT as _BASE_ACT

GRAPH_ACTIVATIONS = {
    **_BASE_ACT,
    "exponential": torch.exp,
    "gaussian": lambda x: torch.exp(-(x ** 2)),
}


def _act(name) -> Callable:
    if callable(name):
        return name
    if isinstance(name, dict):
        # keras custom-activation config dicts (reference :283-296):
        # concave(f)(x) = -f(-x); saturated(relu) = clip to [-1, 1]
        reg = name.get("registered_name", "")
        inner = name.get("config", {}).get("activation", "linear")
        if reg.endswith("ConcaveActivation"):
            base = _act(inner)
            return lambda x: -base(-x)
        if reg.endswith("SaturatedActivation"):
            if inner == "relu":
                return lambda x: torch.clamp(x, -1.0, 1.0)
            if inner == "softplus":
                e = float(np.e)
                return lambda x: torch.where(
                    x >= 0,
                    torch.log((1 + e) / (1 + torch.exp(1 - x))),
                    torch.log((1 + torch.exp(1 + x)) / (1 + e)))
        raise ValueError(f"unsupported custom activation {name!r}")
    try:
        return GRAPH_ACTIVATIONS[str(name)]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


# --------------------------------------------------------------------------
# node forward functions: (params_of_node, [inputs]) -> output (2-D arrays)
# --------------------------------------------------------------------------

def _f_dense(cfg, p, xs):
    act = _act(cfg.get("activation", "linear"))
    return act(xs[0] @ p["kernel"] + p["bias"][None, :])


def _f_flatten(cfg, p, xs):
    return xs[0].reshape(1, -1)       # row-major == horzcat of rows


def _f_batch_normalization(cfg, p, xs):
    eps = float(cfg.get("epsilon", 1e-3))
    return ((xs[0] - p["mean"][None, :])
            / torch.sqrt(p["var"][None, :] + eps)
            * p["gamma"][None, :] + p["beta"][None, :])


def _f_normalization(cfg, p, xs):
    return (xs[0] - p["mean"]) / torch.sqrt(p["var"])


def _f_cropping1d(cfg, p, xs):
    lo, hi = cfg.get("cropping", (1, 1))
    x = xs[0]
    return x[int(lo): x.shape[0] - int(hi), :]


def _f_concatenate(cfg, p, xs):
    axis = int(cfg.get("axis", -1))
    # reference semantics (:410-418): feature axis → horzcat, time → vertcat
    return torch.cat(xs, dim=1 if axis in (-1, 2) else 0)


def _f_reshape(cfg, p, xs):
    r, c = cfg["target_shape"]
    return xs[0].reshape(int(r), int(c))   # keras C-order (NOT CasADi's F)


def _f_input_slice(cfg, p, xs):
    idx = [int(i) for i in cfg["feature_indices"]]
    return xs[0][:, idx]


def _f_constant(cfg, p, xs):
    return p["constant"]


def _f_add(cfg, p, xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _f_subtract(cfg, p, xs):
    return xs[0] - xs[1]


def _f_multiply(cfg, p, xs):
    out = xs[0]
    for x in xs[1:]:
        out = out * x
    return out


def _f_divide(cfg, p, xs):
    return xs[0] / xs[1]


def _f_power(cfg, p, xs):
    return xs[0] ** xs[1]


def _f_average(cfg, p, xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out / len(xs)


def _f_rescaling(cfg, p, xs):
    # scale/offset may be scalars or per-feature arrays (keras broadcasts)
    x = xs[0]
    scale = torch.as_tensor(cfg.get("scale", 1.0), dtype=x.dtype,
                            device=x.device)
    offset = torch.as_tensor(cfg.get("offset", 0.0), dtype=x.dtype,
                             device=x.device)
    return x * scale + offset


def _f_rbf(cfg, p, xs):
    # phi_j = exp(-gamma_j ||x - c_j||^2), gamma = exp(log_gamma)
    # (reference RBF layer, ``casadi_predictor.py:517-532``)
    diff = xs[0] - p["centers"]                     # (units, d)
    dist_sq = torch.sum(diff * diff, dim=1)         # (units,)
    gamma = torch.exp(p["log_gamma"]).reshape(-1)
    return torch.exp(-gamma * dist_sq)[None, :]     # (1, units)


NODE_FORWARDS = {
    "dense": _f_dense,
    "flatten": _f_flatten,
    "batch_normalization": _f_batch_normalization,
    "normalization": _f_normalization,
    "cropping1d": _f_cropping1d,
    "concatenate": _f_concatenate,
    "reshape": _f_reshape,
    "input_slice": _f_input_slice,
    "constant": _f_constant,
    "add": _f_add,
    "subtract": _f_subtract,
    "multiply": _f_multiply,
    "divide": _f_divide,
    "power": _f_power,
    "average": _f_average,
    "rescaling": _f_rescaling,
    "rbf": _f_rbf,
}


# --------------------------------------------------------------------------
# graph spec evaluation
# --------------------------------------------------------------------------

def build_graph_apply(spec: dict) -> Callable[[Any, torch.Tensor],
                                               torch.Tensor]:
    """Compile a graph spec into ``apply(params, x)``.

    Spec schema::

        {"input": {"name": str, "shape": [rows, features]},
         "nodes": [{"name": str, "type": str, "config": {...},
                    "inputs": [str, ...]}, ...],   # topological order
         "output": str}

    ``params`` maps node name → dict of weight arrays. ``x`` is the flat
    input vector; the output is flattened back to 1-D.
    """
    in_name = spec["input"]["name"]
    in_shape = tuple(int(s) for s in spec["input"]["shape"])
    nodes = spec["nodes"]
    known = {in_name}
    for node in nodes:
        if node["type"] not in NODE_FORWARDS:
            raise ValueError(
                f"unsupported layer type {node['type']!r} "
                f"(node {node['name']!r}); supported: "
                f"{sorted(NODE_FORWARDS)}")
        for src in node["inputs"]:
            if src not in known:
                raise ValueError(
                    f"node {node['name']!r} consumes {src!r} before its "
                    f"definition — spec must be topologically ordered")
        known.add(node["name"])
    if spec["output"] not in known:
        raise ValueError(f"output node {spec['output']!r} not in graph")

    def apply(params, x):
        values = {in_name: torch.reshape(x, in_shape)}
        for node in nodes:
            fwd = NODE_FORWARDS[node["type"]]
            xs = [values[src] for src in node["inputs"]]
            values[node["name"]] = fwd(node.get("config", {}),
                                       params.get(node["name"], {}), xs)
        return torch.reshape(values[spec["output"]], (-1,))

    return apply


# --------------------------------------------------------------------------
# Keras → (spec, params) converter
# --------------------------------------------------------------------------

_KERAS_CLASS_MAP = {
    "Dense": "dense",
    "Flatten": "flatten",
    "BatchNormalization": "batch_normalization",
    "Normalization": "normalization",
    "Cropping1D": "cropping1d",
    "Concatenate": "concatenate",
    "Reshape": "reshape",
    "Add": "add",
    "Subtract": "subtract",
    "Multiply": "multiply",
    "TrueDivide": "divide",
    "Divide": "divide",
    "Power": "power",
    "Average": "average",
    "Rescaling": "rescaling",
}


def _classify_layer(layer) -> str:
    """Keras layer → node type: exact class match, then duck-typing for the
    custom physXAI layers (rbf / input_slice / constant, reference
    :497-532). No name-substring matching — the reference's substring rule
    (:603-608) silently misclassifies e.g. GlobalAveragePooling as the
    'average' merge; unsupported layers must raise instead."""
    cls = type(layer).__name__
    if cls in _KERAS_CLASS_MAP:
        return _KERAS_CLASS_MAP[cls]
    if hasattr(layer, "centers") and hasattr(layer, "log_gamma"):
        return "rbf"
    if hasattr(layer, "feature_indices"):
        return "input_slice"
    if hasattr(layer, "constant"):
        return "constant"
    name = layer.get_config().get("name", "")
    raise NotImplementedError(
        f"Keras layer {cls!r} (name={name!r}) is not supported; "
        f"supported types: {sorted(set(_KERAS_CLASS_MAP))} + "
        f"rbf/input_slice/constant (by attributes)")


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _extract(layer, node_type: str, cfg_out: dict, params_out: dict):
    """Pull static config + weights out of one keras layer."""
    cfg = layer.get_config()
    if node_type == "dense":
        w = layer.get_weights()
        params_out["kernel"] = _np(w[0])
        params_out["bias"] = (_np(w[1]) if len(w) > 1
                              else np.zeros(w[0].shape[1]))
        cfg_out["activation"] = cfg.get("activation", "linear")
    elif node_type == "batch_normalization":
        w = layer.get_weights()
        params_out["gamma"], params_out["beta"] = _np(w[0]), _np(w[1])
        params_out["mean"], params_out["var"] = _np(w[2]), _np(w[3])
        cfg_out["epsilon"] = float(cfg.get("epsilon", 1e-3))
    elif node_type == "normalization":
        mean, var = _np(layer.mean), _np(layer.variance)
        if mean.ndim == 3:      # (reference :382-390)
            mean, var = mean[-1], var[-1]
        params_out["mean"], params_out["var"] = mean, var
    elif node_type == "cropping1d":
        crop = layer.cropping
        cfg_out["cropping"] = [int(crop[0]), int(crop[1])] \
            if not np.isscalar(crop) else [int(crop), int(crop)]
    elif node_type == "concatenate":
        cfg_out["axis"] = int(layer.axis)
    elif node_type == "reshape":
        shape = tuple(int(s) for s in layer.target_shape)
        if len(shape) == 1:
            shape = (1, shape[0])
        cfg_out["target_shape"] = list(shape)
    elif node_type == "rescaling":
        # keep per-feature arrays intact (JSON-able nested lists)
        cfg_out["scale"] = np.asarray(layer.scale, dtype=float).tolist()
        cfg_out["offset"] = np.asarray(layer.offset, dtype=float).tolist()
    elif node_type == "rbf":
        params_out["centers"] = _np(layer.centers)
        params_out["log_gamma"] = _np(layer.log_gamma)
    elif node_type == "input_slice":
        cfg_out["feature_indices"] = [
            int(i) for i in np.asarray(layer.feature_indices).reshape(-1)]
    elif node_type == "constant":
        params_out["constant"] = _np(layer.constant)
    # pure-arithmetic merge layers carry no state


def _iter_history(tensor):
    """(producing layer, node_index, tensor_index) of a keras tensor."""
    h = tensor._keras_history
    return h.operation, h.node_index, h.tensor_index


def from_keras(model) -> tuple[dict, dict]:
    """Convert a Keras ``Sequential`` or ``Functional`` model (single input,
    single output — the reference's supported envelope, :579-587) into
    ``(spec, params)`` for :func:`build_graph_apply`.

    Nested Functional/Sequential submodels are inlined with name prefixes
    (the reference wraps them in ``FunctionalWrapper``/``SequentialWrapper``,
    :536-556)."""
    spec_nodes: list[dict] = []
    params: dict[str, dict] = {}
    used_names: set[str] = {"input"}

    def add_layer(layer, input_names: list[str], prefix: str) -> str:
        cls = type(layer).__name__
        if cls in ("Functional", "Sequential") or hasattr(layer, "layers"):
            return inline_submodel(layer, input_names, prefix)
        node_type = _classify_layer(layer)
        name = prefix + layer.name
        # weight-sharing: a layer called at several graph nodes yields one
        # spec node per CALL — unique names keep the calls' outputs apart
        # (weights are duplicated per call; acceptable for inference)
        k = 1
        while name in used_names:
            k += 1
            name = f"{prefix}{layer.name}__call{k}"
        used_names.add(name)
        cfg: dict = {}
        p: dict = {}
        _extract(layer, node_type, cfg, p)
        spec_nodes.append({"name": name, "type": node_type,
                           "config": cfg, "inputs": list(input_names)})
        if p:
            params[name] = p
        return name

    def inline_submodel(model_, input_names: list[str], prefix: str) -> str:
        sub_prefix = prefix + model_.name + "/"
        if _is_sequential(model_):
            cur = input_names
            last = input_names[0]
            for layer in model_.layers:
                if type(layer).__name__ == "InputLayer":
                    continue
                last = add_layer(layer, cur, sub_prefix)
                cur = [last]
            return last
        return walk_functional(model_, input_names, sub_prefix)

    def _is_sequential(m) -> bool:
        return type(m).__name__ == "Sequential" or not hasattr(m, "inputs")

    def walk_functional(model_, outer_inputs: list[str], prefix: str) -> str:
        if len(model_.inputs) != len(outer_inputs):
            raise NotImplementedError(
                f"model {model_.name!r} has {len(model_.inputs)} inputs; "
                f"{len(outer_inputs)} were wired")
        produced: dict[tuple, str] = {}
        for t, outer in zip(model_.inputs, outer_inputs):
            op, ni, ti = _iter_history(t)
            produced[(op.name, ni, ti)] = outer

        def resolve(tensor) -> str:
            op, ni, ti = _iter_history(tensor)
            key = (op.name, ni, ti)
            if key in produced:
                return produced[key]
            # evaluate the producing layer at this call node
            node = op._inbound_nodes[ni]
            srcs = [resolve(t) for t in node.input_tensors]
            out_name = add_layer(op, srcs, prefix)
            # register all output tensors of this call (single-output
            # layers: tensor_index 0)
            produced[(op.name, ni, 0)] = out_name
            return produced[key]

        outs = model_.outputs
        if len(outs) != 1:
            raise NotImplementedError(
                "only single-output Keras models are supported "
                "(reference envelope, casadi_predictor.py:676)")
        return resolve(outs[0])

    # top level
    if _is_sequential(model):
        in_shape = model.layers[0].input.shape \
            if model.layers else (None, 1)
        in_feat = tuple(int(s) for s in in_shape[1:]) or (1,)
        input_name = "input"
        cur = [input_name]
        last = input_name
        for layer in model.layers:
            if type(layer).__name__ == "InputLayer":
                continue
            last = add_layer(layer, cur, "")
            cur = [last]
        out_name = last
    else:
        if len(model.inputs) != 1:
            raise NotImplementedError(
                "only single-input Keras models are supported "
                "(reference envelope, casadi_predictor.py:579-587)")
        shape = model.inputs[0].shape
        in_feat = tuple(int(s) for s in shape[1:] if s is not None) or (1,)
        input_name = "input"
        out_name = walk_functional(model, [input_name], "")

    rows, feats = (1, in_feat[0]) if len(in_feat) == 1 else in_feat[:2]
    spec = {
        "input": {"name": input_name, "shape": [int(rows), int(feats)]},
        "nodes": spec_nodes,
        "output": out_name,
    }
    # validate + return tensor params
    build_graph_apply(spec)
    return spec, tree_map(torch.as_tensor, params)


def spec_to_jsonable(spec: dict, params: dict) -> dict:
    """Self-contained JSON document (spec + weights as nested lists)."""
    return {
        "spec": spec,
        "params": {node: {k: np.asarray(v).tolist() for k, v in d.items()}
                   for node, d in params.items()},
    }


def spec_from_jsonable(doc: dict) -> tuple[dict, dict]:
    params = {
        node: {k: torch.as_tensor(np.asarray(v, dtype=np.float64))
               for k, v in d.items()}
        for node, d in doc["params"].items()}
    return doc["spec"], params
