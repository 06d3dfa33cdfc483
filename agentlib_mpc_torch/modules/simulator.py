"""Simulator module: the plant stand-in.

Port of ``agentlib_mpc_tpu/modules/simulator.py``; the port keeps its own copy
and imports nothing of the JAX package.

Replaces agentlib's Simulator module as used by every reference example
(``examples/one_room_mpc/physical/simple_mpc.py:190-212``): owns a model
instance, integrates it every ``t_sample`` with the latest input values
from the broker, publishes outputs, and records a results table.

The integrator is a fixed-step scheme (rk4 default, implicit_midpoint for
stiff plants) — the CVODES replacement — run by
:meth:`~agentlib_mpc_torch.models.model.Model.simulate_step` on the agent's
device in its dtype, where the JAX package jit-compiles the same step.
Both run it once at construction, so a real-time schedule does not slip at
the first sample (the JAX package compiles there; the port pays torch's
lazy set-up). The plant state comes back to the host once per sample, as
in the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from agentlib_mpc_torch.backends.backend import load_model
from agentlib_mpc_torch.runtime.module import BaseModule, register_module

logger = logging.getLogger(__name__)


@register_module("simulator")
class Simulator(BaseModule):
    variable_groups = ("inputs", "outputs", "states", "parameters")
    shared_groups = ("outputs",)

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.t_sample = float(config.get("t_sample", 1.0))
        self.integrator = config.get("integrator", "rk4")
        self.substeps = int(config.get("substeps", 5))
        self.model = load_model(config["model"])
        self._x = np.array([self.model.get_var(n).value
                            for n in self.model.diff_state_names])
        # state overrides from the module's own states group
        for var in self.variables_in_group("states"):
            if var.name in self.model.diff_state_names and var.value is not None:
                self._x[self.model.diff_state_names.index(var.name)] = var.value
        self._rows: list[dict] = []
        self._build_step()

    def _build_step(self) -> None:
        model = self.model
        method = self.integrator
        substeps = self.substeps
        t_sample = self.t_sample
        dev, dtype = self.device, self.dtype

        def sim_step(x, u_full, p):
            return model.simulate_step(
                torch.as_tensor(x, dtype=dtype, device=dev),
                torch.as_tensor(u_full, dtype=dtype, device=dev),
                torch.as_tensor(p, dtype=dtype, device=dev),
                dt=t_sample, substeps=substeps, method=method)

        self._sim_step = sim_step
        # one throwaway step now, as the JAX package compiles its step
        # here: the first eager step pays torch's lazy set-up (about a
        # second on a CPU), and in real-time mode that pause would let the
        # schedule slip behind wall time
        sim_step(self._x, model.default_vector("inputs", device="cpu"),
                 model.default_vector("parameters", device="cpu"))

    def process(self):
        while True:
            # snapshot inputs at t (zero-order hold), integrate across the
            # sample, publish at t+dt — the time the state is valid — so
            # measurement timestamps don't depend on agent ordering
            u_full = self._current_inputs()
            yield self.t_sample
            self.do_step(u_full)

    def _current_inputs(self) -> np.ndarray:
        model = self.model
        u_full = model.default_vector("inputs", device="cpu").numpy()
        for i, name in enumerate(model.input_names):
            if name in self.vars and self.vars[name].value is not None:
                u_full[i] = float(self.vars[name].value)
        return u_full

    def do_step(self, u_full: np.ndarray | None = None) -> None:
        model = self.model
        if u_full is None:
            u_full = self._current_inputs()
        p = model.default_vector("parameters", device="cpu").numpy()
        for i, name in enumerate(model.parameter_names):
            if name in self.vars and self.vars[name].value is not None:
                p[i] = float(self.vars[name].value)
        x_next, y = self._sim_step(self._x, u_full, p)
        # the plant state and outputs back to the host: one transfer per
        # sample
        host = torch.cat([x_next, y]).cpu().numpy().astype(float)
        self._x, y = host[:x_next.shape[0]], host[x_next.shape[0]:]
        row = {"time": float(self.env.now)}
        for i, name in enumerate(model.diff_state_names):
            row[name] = float(self._x[i])
        for i, name in enumerate(model.input_names):
            row[name] = float(u_full[i])
        for i, name in enumerate(model.output_names):
            row[name] = float(y[i])
            if name in self.vars:
                self.set(name, float(y[i]))
        self._rows.append(row)

    def results(self):
        import pandas as pd

        if not self._rows:
            return None
        return pd.DataFrame(self._rows).set_index("time")

    def cleanup_results(self) -> None:
        self._rows.clear()
