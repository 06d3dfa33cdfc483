"""Model loading from agent configs.

Port of ``agentlib_mpc_tpu/backends/backend.py:34-46, 82-139``
(``load_custom_class``, ``load_model``, ``load_model_for_backend``). The
``OptimizationBackend`` base class, its registry and ``create_backend``
wait for the backends slice (ROADMAP Queue 1 item 2); ML model configs
wait for the ML slice (item 3).
"""

from __future__ import annotations

import importlib.util

from agentlib_mpc_torch.models.model import Model


def load_custom_class(file: str, class_name: str):
    """Load a class from a file path (the reference's ``custom_injection``
    hook)."""
    spec = importlib.util.spec_from_file_location(
        f"_custom_{class_name}", file)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {class_name!r} from {file!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, class_name)


def load_model(model_cfg: dict | Model, dt: float | None = None) -> Model:
    """Instantiate the model named by a config dict.

    Accepts: a Model instance; ``{"class": ModelClass, ...}``;
    ``{"class": "<zoo name>"}`` (a built-in model of
    :mod:`agentlib_mpc_torch.models.zoo` by name); or the custom injection
    ``{"type": {"file": ..., "class_name": ...}}``. Any
    "states"/"inputs"/"parameters"/"outputs" lists of ``{"name",
    "value"}`` entries set initial/default values.
    """
    if isinstance(model_cfg, Model):
        return model_cfg
    model_cfg = dict(model_cfg)
    cls = model_cfg.get("class")
    if isinstance(cls, str):
        from agentlib_mpc_torch.models import zoo

        candidate = getattr(zoo, cls, None)
        if not (isinstance(candidate, type) and candidate is not Model
                and issubclass(candidate, Model)):
            raise KeyError(
                f"model class {cls!r} is not a built-in zoo model; "
                f"for custom models use {{'type': {{'file', "
                f"'class_name'}}}} injection")
        cls = candidate
    if cls is None:
        type_key = model_cfg.get("type")
        if isinstance(type_key, dict):
            cls = load_custom_class(type_key["file"], type_key["class_name"])
        else:
            raise KeyError(
                "model config needs 'class' or {'type': {'file', "
                "'class_name'}}")
    overrides: dict[str, float] = {}
    for group in ("states", "inputs", "parameters", "outputs"):
        for entry in model_cfg.get(group, []):
            if "value" in entry:
                overrides[entry["name"]] = entry["value"]
    return cls(overrides=overrides or None, dt=dt)


def load_model_for_backend(model_cfg: dict | Model,
                           dt: float | None = None) -> Model:
    """Model loading for a module's backend: a config with
    ``ml_model_sources`` names learned surrogates, which the ML slice
    brings; every other config goes to :func:`load_model`."""
    if isinstance(model_cfg, dict) and model_cfg.get("ml_model_sources"):
        raise NotImplementedError(
            "ML model configs (ml_model_sources) need the ML slice, which "
            "is not ported yet (ROADMAP Queue 1 item 3)")
    return load_model(model_cfg, dt=dt)
