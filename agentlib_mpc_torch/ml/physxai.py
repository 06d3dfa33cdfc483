"""physXAI bridge: convert physXAI training artifacts to the exchange format.

Port of ``agentlib_mpc_tpu/ml/physxai.py``, a copy. Counterpart of the
reference's physXAI plugin
(``machine_learning_plugins/physXAI/``: config translation
``model_config_creation.py:26-150``, model generation
``model_generation.py:45-120``): physXAI preprocessing configs name
features as ``<name>_lag<k>`` and outputs as ``Change(<name>)`` for
difference targets; artifacts are joblib-dumped sklearn estimators or
layer-weight dumps. This module parses those conventions into
`Feature`/`OutputFeature` metadata and wraps the artifacts as serialized
models. The physXAI package itself is optional — running its training
scripts (`generate_physxai_models`) needs it installed, while converting
existing artifacts does not.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Union

import numpy as np

from agentlib_mpc_torch.ml.serialized import (
    Feature,
    OutputFeature,
    SerializedANN,
    SerializedLinReg,
    SerializedMLModel,
)

#: physXAI naming conventions (reference ``model_config_creation.py:8-9``)
OUTPUT_TYPE_PATTERN = r"Change\((.*)\)"
LAG_PATTERN = r"_lag(\d+)$"


def parse_physxai_features(
        preprocessing: dict) -> tuple[float, dict, dict]:
    """(dt, inputs, output) from a physXAI preprocessing dict (reference
    ``physXAI_2_agentlib_json``, ``model_config_creation.py:26-150``)."""
    dt = float(preprocessing["time_step"])
    shift = preprocessing.get("shift", 1)
    if shift != 1:
        raise ValueError(
            f"physXAI shift must be 1 for MPC use, got {shift}")
    outputs = preprocessing.get("output")
    if not isinstance(outputs, list) or len(outputs) != 1:
        raise ValueError("physXAI output must be a list with one element")

    output_str = outputs[0]
    output_type = "absolute"
    m = re.match(OUTPUT_TYPE_PATTERN, output_str)
    out_name = output_str
    if m:
        output_type = "difference"
        out_name = m.group(1).strip()

    # group "<name>_lag<k>" features; lag depth = 1 + max k, and the lag
    # indices must be consecutive (the reference validates likewise)
    lags: dict[str, list[int]] = {}
    order: list[str] = []
    for input_str in preprocessing["inputs"]:
        lag = 0
        base = input_str
        lm = re.search(LAG_PATTERN, input_str)
        if lm:
            lag = int(lm.group(1))
            base = input_str[:lm.start()]
        if base not in lags:
            lags[base] = []
            order.append(base)
        lags[base].append(lag)
    for base, ks in lags.items():
        if sorted(ks) != list(range(len(ks))):
            raise ValueError(
                f"physXAI lags for {base!r} are not consecutive from 0: "
                f"{sorted(ks)}")

    recursive = out_name in lags
    inputs = {base: Feature(name=base, lag=len(ks))
              for base, ks in lags.items() if base != out_name}
    output = {out_name: OutputFeature(
        name=out_name, lag=len(lags.get(out_name, [0])),
        output_type=output_type, recursive=recursive)}
    if not recursive and output_type == "difference":
        raise ValueError(
            f"physXAI output {out_name!r} is a Change() target but does "
            f"not appear among the inputs — unsupported combination")
    return dt, inputs, output


def convert_physxai_model(
        preprocessing: dict,
        artifact,
        model_type: str = "LinReg",
        trainer_config: Optional[dict] = None) -> SerializedMLModel:
    """Wrap a physXAI artifact as a serialized model.

    artifact: a fitted sklearn LinearRegression (or a joblib path to one)
    for ``model_type="LinReg"``; a ``{"weights": [...], "biases": [...],
    "activations": [...]}`` layer dump (or a path to a joblib of one) for
    ``model_type="ANN"``.
    """
    dt, inputs, output = parse_physxai_features(preprocessing)
    if isinstance(artifact, (str, Path)):
        import joblib

        artifact = joblib.load(artifact)
    meta = {"source": "physXAI", **(trainer_config or {})}
    if model_type == "LinReg":
        return SerializedLinReg.from_sklearn(
            artifact, dt=dt, inputs=inputs, output=output,
            trainer_config=meta)
    if model_type == "ANN":
        return SerializedANN(
            dt=dt, inputs=inputs, output=output, trainer_config=meta,
            weights=[np.asarray(w).tolist() for w in artifact["weights"]],
            biases=[np.asarray(b).tolist() for b in artifact["biases"]],
            activations=list(artifact["activations"]))
    raise ValueError(f"unsupported physXAI model_type {model_type!r}")


def generate_physxai_models(scripts: Union[list, dict], scripts_path: str,
                            training_data_path: str, run_id: str,
                            save_path: str = "models",
                            time_step: int = 900) -> list[str]:
    """Run physXAI training scripts (requires the physXAI package — the
    reference gates identically, ``model_generation.py:9-13``)."""
    try:
        from physXAI import models  # noqa: F401 - registers model types
    except ImportError as exc:
        raise ImportError(
            "generate_physxai_models needs the physXAI package "
            "(git+https://github.com/RWTH-EBC/physXAI.git); converting "
            "existing artifacts with convert_physxai_model does not"
        ) from exc
    import importlib.util
    import os

    entries = scripts.items() if isinstance(scripts, dict) \
        else [(None, s) for s in scripts]
    out = []
    for _name, script in entries:
        if not script.endswith(".py"):
            script += ".py"
        script_path = os.path.join(scripts_path, script)
        spec = importlib.util.spec_from_file_location(
            "physxai_train", script_path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(
                f"physXAI training script not found: {script_path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        # always return what train_model produced (artifact paths/names);
        # dict keys are only labels for the caller's bookkeeping
        out.append(module.train_model(
            base_path=os.path.abspath(save_path), folder_name=run_id,
            training_data_path=os.path.abspath(training_data_path),
            time_step=time_step))
    return out
