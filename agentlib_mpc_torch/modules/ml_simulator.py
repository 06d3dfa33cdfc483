"""ML-model simulator: drives a hybrid NARX model, hot-swaps surrogates.

Port of ``agentlib_mpc_tpu/modules/ml_simulator.py`` (the reference's
``MLModelSimulator``, ``modules/ml_model_simulator.py:51-71``: an agentlib
Simulator subclass whose ``_update_ml_model_callback`` receives serialized
models over the broker and rebuilds the CasADi predict function while
keeping past values). The history windows carry the NARX state across
steps, on the agent's device in its dtype; a received model document
becomes new predictor parameters. Like the JAX package (which compiles
its step there), the module takes one throwaway step at construction and
after every swap, so a real-time schedule does not slip at the first
sample.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from agentlib_mpc_torch.backends.ml_backend import load_ml_model
from agentlib_mpc_torch.ml.predictors import cast_params
from agentlib_mpc_torch.ml.serialized import load_serialized_model
from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source

logger = logging.getLogger(__name__)


@register_module("ml_simulator")
class MLSimulator(BaseModule):
    """Plant stand-in for learned dynamics."""

    variable_groups = ("inputs", "outputs", "states", "parameters")
    shared_groups = ("outputs", "states")

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.t_sample = float(config.get("t_sample", 1.0))
        self.model = load_ml_model(config["model"], dt=self.t_sample)
        self.ml_model_variable = config.get("ml_model_variable", "MLModel")
        init = {}
        for var in self.variables_in_group("states"):
            if var.value is not None:
                init[var.name] = float(var.value)
        self.hist = self.model.init_history(init, device=self.device,
                                            dtype=self.dtype)
        self._rows: list[dict] = []
        self._build_step()

    def _build_step(self) -> None:
        model = self.model
        self._ml_params = cast_params(model.ml_params, self.device,
                                      self.dtype)

        def sim_step(hist, p, ml_params):
            nxt, outs = model.ml_step(hist, p, ml_params=ml_params)
            hist_next = model.advance_history(hist, dict(nxt))
            return hist_next, nxt, outs

        self._sim_step = sim_step
        # one throwaway step now (the JAX package compiles here): the first
        # eager step pays torch's lazy set-up
        sim_step(self.hist, self._param_vector(), self._ml_params)

    def _param_vector(self, p=None) -> torch.Tensor:
        if p is None:
            p = self.model.default_vector("parameters", device="cpu")
        return torch.as_tensor(np.asarray(p, dtype=float), dtype=self.dtype,
                               device=self.device)

    def register_callbacks(self) -> None:
        super().register_callbacks()
        self.agent.data_broker.register_callback(
            self.ml_model_variable, Source(), self._update_ml_model_callback)

    def _update_ml_model_callback(self, incoming: AgentVariable) -> None:
        """Hot-swap a retrained surrogate (reference
        ``_update_ml_model_callback``, ``ml_model_simulator.py:51-71``)."""
        try:
            serialized = load_serialized_model(incoming.value)
            self.model.update_ml_models(serialized)
            self._build_step()
            self.logger.info("hot-swapped ML model for %s at t=%s",
                             list(serialized.output), self.env.now)
        except (ValueError, KeyError, TypeError) as exc:
            self.logger.error("rejected ML model update: %s", exc)

    def process(self):
        while True:
            updates = self._current_inputs()
            yield self.t_sample
            self.do_step(updates)

    def _current_inputs(self) -> dict:
        updates = {}
        for name in self.model.input_names:
            if name in self.vars and self.vars[name].value is not None:
                updates[name] = float(self.vars[name].value)
        return updates

    def do_step(self, updates: dict | None = None) -> None:
        model = self.model
        if updates is None:
            updates = self._current_inputs()
        hist = dict(self.hist)
        for n, v in updates.items():
            if n in hist:
                win = hist[n]
                hist[n] = torch.cat([torch.full_like(win[:1], v), win[1:]])
        p = model.default_vector("parameters", device="cpu").numpy()
        for i, name in enumerate(model.parameter_names):
            if name in self.vars and self.vars[name].value is not None:
                p[i] = float(self.vars[name].value)
        hist_next, nxt, outs = self._sim_step(hist, self._param_vector(p),
                                              self._ml_params)
        self.hist = hist_next
        names = [*nxt, *outs]
        # the plant's new values back to the host: one transfer per sample
        host = torch.stack([(nxt[n] if n in nxt else outs[n]).reshape(())
                            for n in names]).cpu().numpy().astype(float) \
            if names else np.zeros(0)
        row = {"time": float(self.env.now)}
        for n, v in updates.items():
            row[n] = v
        for n, val in zip(names, host):
            row[n] = float(val)
            if n in self.vars:
                self.set(n, float(val))
        self._rows.append(row)

    def results(self):
        import pandas as pd

        if not self._rows:
            return None
        return pd.DataFrame(self._rows).set_index("time")

    def cleanup_results(self) -> None:
        self._rows.clear()
