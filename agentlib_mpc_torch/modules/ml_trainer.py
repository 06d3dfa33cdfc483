"""ML model trainer modules: collect data → retrain → broadcast.

Port of ``agentlib_mpc_tpu/modules/ml_trainer.py``, the reference's trainer
modules
(``modules/ml_model_training/ml_model_trainer.py``: broker-callback data
collection :334-351, periodic retrain loop :283-288, retrain→serialize→
save→broadcast :305-332, memory/age eviction :353-374; trainer registry
:770-774). The numeric pipeline lives in
:mod:`agentlib_mpc_torch.ml.training`; this module wires it to the runtime:
every update of a declared input/output variable is recorded with its
timestamp, and every ``retrain_delay`` the history is resampled, lagged,
split, fitted and published as a serialized model document on the
``ml_model_variable`` channel, where MLSimulator / MLBackend consumers
hot-swap it (§3.5 loop). The ANN trainer trains on the agent's device in
its dtype; the GPR, LinReg and Keras trainers fit on the host.

Config (reference ``MLModelTrainerConfig``, :42-235):
    inputs / outputs: recorded variables (outputs are the prediction
        targets; every variable may carry ``lag`` in its entry)
    step_size: resample dt == the surrogate's prediction step
    retrain_delay: seconds between retrains
    output_types: {name: "absolute" | "difference"}
    non_recursive_outputs: [names] (algebraic targets)
    train_share / validation_share / test_share: must sum to 1
    ml_model_variable: broadcast channel name (default "MLModel")
    save_directory: optional JSON dump location
    max_data_points / max_data_age: eviction policy
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from agentlib_mpc_torch.ml.serialized import (
    Feature,
    OutputFeature,
    SerializedMLModel,
)
from agentlib_mpc_torch.ml.training import (
    ANNTrainerCore,
    create_lagged_features,
    fit_ann,
    fit_gpr,
    fit_linreg,
    resample,
    train_val_test_split,
)
from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.variables import AgentVariable

logger = logging.getLogger(__name__)


class MLModelTrainer(BaseModule):
    """Abstract trainer; subclasses implement ``fit``."""

    variable_groups = ("inputs", "outputs")
    shared_groups = ()
    model_type = "base"

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.step_size = float(config.get("step_size",
                                          config.get("time_step", 60.0)))
        self.retrain_delay = float(config.get("retrain_delay", 3600.0))
        self.train_share = float(config.get("train_share", 0.7))
        self.validation_share = float(config.get("validation_share", 0.15))
        self.test_share = float(config.get("test_share", 0.15))
        if abs(self.train_share + self.validation_share + self.test_share
               - 1.0) > 1e-9:
            raise ValueError(
                "train/validation/test shares must sum to 1 (reference "
                "validator, ml_model_trainer.py:132-150)")
        self.ml_model_variable = config.get("ml_model_variable", "MLModel")
        self.save_directory = config.get("save_directory")
        self.max_data_points = int(config.get("max_data_points", 100_000))
        self.max_data_age = config.get("max_data_age")  # seconds | None
        self.output_types = dict(config.get("output_types", {}))
        self.non_recursive = set(config.get("non_recursive_outputs", []))
        self._retrains = 0

        def lag_of(group, name):
            for entry in config.get(group, []):
                if isinstance(entry, dict) and entry.get("name") == name:
                    return int(entry.get("lag", 1))
            return 1

        self.input_features = {
            n: Feature(name=n, lag=lag_of("inputs", n))
            for n in self._groups["inputs"]}
        self.output_features = {
            n: OutputFeature(
                name=n, lag=lag_of("outputs", n),
                output_type=self.output_types.get(n, "difference"
                                                  if n not in
                                                  self.non_recursive
                                                  else "absolute"),
                recursive=n not in self.non_recursive)
            for n in self._groups["outputs"]}
        #: name → [(time, value)] raw samples
        self.time_series: dict[str, list] = {
            n: [] for n in (*self._groups["inputs"],
                            *self._groups["outputs"])}

    # -- data collection ------------------------------------------------------

    def register_callbacks(self) -> None:
        for name in self.time_series:
            var = self.vars[name]
            self.agent.data_broker.register_callback(
                var.alias, var.source, self._make_record_callback(name))

    def _make_record_callback(self, name: str):
        def _cb(incoming: AgentVariable):
            local = self.vars[name]
            local.value = incoming.value
            local.timestamp = incoming.timestamp
            try:
                self.time_series[name].append(
                    (float(incoming.timestamp), float(incoming.value)))
            except (TypeError, ValueError):
                pass
        return _cb

    def _update_time_series_data(self) -> None:
        """Eviction by count and age (reference
        ``_update_time_series_data``, ``ml_model_trainer.py:353-374``)."""
        now = float(self.env.now)
        for name, rows in self.time_series.items():
            if self.max_data_age is not None:
                cutoff = now - float(self.max_data_age)
                rows[:] = [r for r in rows if r[0] >= cutoff]
            if len(rows) > self.max_data_points:
                del rows[:len(rows) - self.max_data_points]

    def history_frame(self):
        import pandas as pd

        frames = {}
        for name, rows in self.time_series.items():
            if rows:
                s = pd.Series({t: v for t, v in rows}).sort_index()
                frames[name] = s[~s.index.duplicated(keep="last")]
        if not frames:
            return None
        # ZOH fill across columns updating at different times (broker
        # semantics: a value holds until the next publish)
        return pd.DataFrame(frames).sort_index().ffill().bfill()

    # -- retraining loop ------------------------------------------------------

    def process(self):
        while True:
            yield self.retrain_delay
            try:
                self.retrain_model()
            except ValueError as exc:
                self.logger.warning("retrain skipped: %s", exc)

    def retrain_model(self) -> Optional[SerializedMLModel]:
        """resample → lag features → split → fit → serialize → broadcast
        (reference ``retrain_model``, ``ml_model_trainer.py:305-332``)."""
        self._update_time_series_data()
        df = self.history_frame()
        if df is None or len(df) < 3:
            raise ValueError("not enough data to train")
        df = resample(df.dropna(),
                      self.step_size,
                      method=self.config.get("interpolation_method",
                                             "previous"))
        X, y = create_lagged_features(df, self.input_features,
                                      self.output_features)
        if len(X) < 3:
            raise ValueError("not enough samples after lag shifting")
        data = train_val_test_split(
            X, y, (self.train_share, self.validation_share, self.test_share),
            seed=self._retrains)
        serialized = self.fit(data)
        self._retrains += 1
        if self.save_directory:
            directory = Path(self.save_directory)
            directory.mkdir(parents=True, exist_ok=True)
            name = "_".join(self.output_features) or "model"
            serialized.save(directory /
                            f"{name}_{self._retrains:04d}.json")
        out = AgentVariable(name=self.ml_model_variable,
                            value=serialized.to_dict(), shared=True)
        self.send(out)
        return serialized

    def fit(self, data) -> SerializedMLModel:  # pragma: no cover - abstract
        raise NotImplementedError

    def results(self):
        import pandas as pd

        rows = [{"time": t, "variable": n, "value": v}
                for n, series in self.time_series.items()
                for t, v in series]
        if not rows:
            return None
        return pd.DataFrame(rows).set_index("time")


@register_module("ann_trainer")
class ANNTrainer(MLModelTrainer):
    """MLP trainer on ``torch.optim`` (reference ``ANNTrainer``,
    ``ml_model_trainer.py:617-667``), on the agent's device in its
    dtype."""

    model_type = "ANN"

    def fit(self, data):
        cfg = self.config
        core = ANNTrainerCore(
            hidden=tuple(cfg.get("layers", (32, 32))),
            activation=cfg.get("activation", "tanh"),
            epochs=int(cfg.get("epochs", 400)),
            learning_rate=float(cfg.get("learning_rate", 1e-2)),
            batch_size=int(cfg.get("batch_size", 64)),
            early_stopping_patience=int(
                cfg.get("early_stopping_patience", 50)),
            seed=self._retrains, device=self.device, dtype=self.dtype)
        return fit_ann(
            data.training_inputs, data.training_outputs,
            data.validation_inputs, data.validation_outputs,
            dt=self.step_size, inputs=self.input_features,
            output=self.output_features, trainer=core,
            trainer_config={"module_id": self.id, "type": "ann_trainer"})


@register_module("gpr_trainer")
class GPRTrainer(MLModelTrainer):
    """Exact GPR trainer (reference ``GPRTrainer``,
    ``ml_model_trainer.py:673-735``)."""

    model_type = "GPR"

    def fit(self, data):
        return fit_gpr(
            data.training_inputs, data.training_outputs,
            dt=self.step_size, inputs=self.input_features,
            output=self.output_features,
            normalize=bool(self.config.get("normalize", True)),
            n_restarts_optimizer=int(
                self.config.get("n_restarts_optimizer", 0)),
            trainer_config={"module_id": self.id, "type": "gpr_trainer"})


@register_module("linreg_trainer")
class LinRegTrainer(MLModelTrainer):
    """Least-squares trainer (reference ``LinRegTrainer``,
    ``ml_model_trainer.py:744-767``)."""

    model_type = "LinReg"

    def fit(self, data):
        return fit_linreg(
            data.training_inputs, data.training_outputs,
            dt=self.step_size, inputs=self.input_features,
            output=self.output_features,
            trainer_config={"module_id": self.id, "type": "linreg_trainer"})


@register_module("keras_ann_trainer")
class KerasANNTrainer(MLModelTrainer):
    """Keras-backed ANN trainer (the reference's actual trainer stack,
    ``ml_model_trainer.py:617-667``): trains a Keras Sequential MLP and
    broadcasts a self-contained GraphANN document (keras needed at
    training time only; prediction is tensor code via ``ml/keras_graph``)."""

    model_type = "GraphANN"

    def fit(self, data):
        from agentlib_mpc_torch.ml.training import fit_keras_ann

        cfg = self.config
        return fit_keras_ann(
            data.training_inputs, data.training_outputs,
            data.validation_inputs, data.validation_outputs,
            dt=self.step_size, inputs=self.input_features,
            output=self.output_features,
            layers=tuple(cfg.get("layers", (32, 32))),
            activation=cfg.get("activation", "tanh"),
            epochs=int(cfg.get("epochs", 200)),
            learning_rate=float(cfg.get("learning_rate", 1e-2)),
            batch_size=int(cfg.get("batch_size", 64)),
            early_stopping_patience=int(
                cfg.get("early_stopping_patience", 30)),
            trainer_config={"module_id": self.id,
                            "type": "keras_ann_trainer"})
