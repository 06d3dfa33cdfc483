"""Hybrid NARX model: ML surrogates + optional white-box dynamics.

Port of ``agentlib_mpc_tpu/models/ml_model.py`` (the reference's
``models/casadi_ml_model.py``: config validation :61-149, lag bookkeeping
:261-280, recursive/non-recursive output placement :401-465, unified
predict function :496-577, hot-swap :205-231). A subclass declares
variables like any :class:`~agentlib_mpc_torch.models.model.Model` and may
write white-box ODEs in ``setup``; serialized ML models then provide the
discrete-time dynamics of the remaining states (recursive outputs) and
algebraic relations (non-recursive outputs).

The unified step is a pure function of a *history* dict ``hist[name] →
(..., L) tensor, newest first on the last axis``, the parameter vector and
the ML parameter pytrees. With ``(L,)`` windows it is the JAX package's
per-point step; leading axes evaluate many points at once (the NARX
transcription passes all N stages in one call where the JAX package
``vmap``s over them). It uses no in-place operation, so ``torch.func``
differentiates through it. :attr:`MLModel.ml_params` holds the float64
host copy of the weights; a solve casts them to its device and dtype.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Union

import torch
from torch.profiler import record_function

from agentlib_mpc_torch.ml.predictors import Predictor, make_predictor
from agentlib_mpc_torch.ml.serialized import (
    SerializedMLModel,
    load_serialized_model,
)
from agentlib_mpc_torch.models.model import Model, ModelEquations


class MLModel(Model):
    """Model whose state evolution is (partly) learned.

    Class attribute / constructor arg ``ml_model_sources``: list of
    serialized models (instances, dicts, JSON strings or file paths).
    """

    ml_model_sources: Sequence[Union[str, dict, SerializedMLModel]] = ()

    def __init__(self, overrides: dict | None = None, dt: float | None = None,
                 ml_models: Optional[Iterable] = None):
        super().__init__(overrides=overrides, dt=dt)
        sources = list(ml_models if ml_models is not None
                       else type(self).ml_model_sources)
        self.serialized: dict[str, SerializedMLModel] = {}
        self.predictors: dict[str, Predictor] = {}
        self.ml_params: dict[str, Any] = {}
        self._model_of_output: dict[str, str] = {}
        self.register_ml_models(*[load_serialized_model(s) for s in sources])

    # default: pure black-box model (no white-box equations)
    def setup(self, v):
        return ModelEquations()

    # -- registration / validation (casadi_ml_model.py:61-149,374-399) -------

    def register_ml_models(self, *serialized: SerializedMLModel) -> None:
        known = {v.name for v in
                 (*self.inputs, *self.states, *self.parameters,
                  *self.outputs)}
        seen_outputs: dict[str, str] = {}
        for m in serialized:
            key = "|".join(m.output)
            if not m.output:
                raise ValueError("serialized model declares no output")
            if abs(float(m.dt) - float(self.dt)) > 1e-9:
                raise ValueError(
                    f"serialized model for {key!r} has dt={m.dt}, model "
                    f"dt={self.dt}; all must match (reference "
                    f"casadi_ml_model.py:104-121)")
            for out_name, feat in m.output.items():
                if out_name in seen_outputs:
                    raise ValueError(
                        f"output {out_name!r} provided by two ML models")
                seen_outputs[out_name] = key
                if feat.recursive:
                    if out_name not in self.state_names:
                        raise ValueError(
                            f"recursive ML output {out_name!r} must be a "
                            f"declared state")
                else:
                    if out_name not in self.output_names:
                        raise ValueError(
                            f"non-recursive ML output {out_name!r} must be "
                            f"a declared output")
            for feat_name in m.lags_per_variable():
                if feat_name not in known:
                    raise ValueError(
                        f"ML feature {feat_name!r} is not a declared model "
                        f"variable")
            predictor = make_predictor(m)
            if predictor.n_outputs != len(m.output):
                raise ValueError(
                    f"serialized model for {key!r} declares "
                    f"{len(m.output)} outputs but its parameters produce "
                    f"{predictor.n_outputs}")
            self.serialized[key] = m
            self.predictors[key] = predictor
            self.ml_params[key] = predictor.params
            for out_name in m.output:
                self._model_of_output[out_name] = key
        self._rebuild_lag_tables()

    def update_ml_models(self, *serialized: SerializedMLModel) -> None:
        """Hot-swap retrained models at runtime (reference
        ``update_ml_models``, ``casadi_ml_model.py:205-231``). A model with
        new input columns rebuilds the lag tables."""
        for m in serialized:
            key = "|".join(m.output)
            if key not in self.serialized:
                self.register_ml_models(m)
                continue
            pred = make_predictor(m)
            if pred.n_outputs != len(m.output):
                raise ValueError(
                    f"serialized model for {key!r} declares "
                    f"{len(m.output)} outputs but its parameters produce "
                    f"{pred.n_outputs}")
            self.serialized[key] = m
            old = self.predictors[key]
            self.predictors[key] = pred
            self.ml_params[key] = pred.params
            if old.input_columns != pred.input_columns:
                self._rebuild_lag_tables()

    def _rebuild_lag_tables(self) -> None:
        lags: dict[str, int] = {}
        for m in self.serialized.values():
            for name, lag in m.lags_per_variable().items():
                lags[name] = max(lag, lags.get(name, 0))
        self.ml_lags = lags
        #: states whose evolution is learned (recursive outputs)
        self.narx_state_names = [
            n for n in self.state_names
            if any(n in m.output and m.output[n].recursive
                   for m in self.serialized.values())]
        #: algebraic ML outputs
        self.ml_output_names = [
            n for n in self.output_names
            if any(n in m.output and not m.output[n].recursive
                   for m in self.serialized.values())]
        #: white-box differential states keep their ODEs
        self.wb_state_names = [n for n in self.diff_state_names
                               if n not in self.narx_state_names]
        #: every variable that needs a history window (length ≥ 1)
        self.history_names = sorted(
            set(self.ml_lags)
            | set(self.input_names)
            | set(self.narx_state_names)
            | set(self.wb_state_names))

    def get_lags_per_variable(self) -> dict[str, int]:
        """name → history depth the controller must record (reference
        ``casadi_ml.py:388-397``)."""
        return {n: l for n, l in self.ml_lags.items() if l > 1}

    @property
    def max_lag(self) -> int:
        return max(self.ml_lags.values(), default=1)

    # -- history --------------------------------------------------------------

    def init_history(self, values: dict[str, float] | None = None, *,
                     device=None, dtype: torch.dtype = torch.float64
                     ) -> dict:
        """hist[name] = (L,) tensor, newest first, filled with the current
        (or declared default) value, on ``device`` (None: the card)."""
        from agentlib_mpc_torch.utils.device import resolve_device

        dev = resolve_device(device)
        values = values or {}
        hist = {}
        for n in self.history_names:
            L = max(self.ml_lags.get(n, 1), 1)
            v = float(values.get(n, self.get_var(n).value))
            hist[n] = torch.full((L,), v, dtype=dtype, device=dev)
        return hist

    @staticmethod
    def advance_history(hist: dict, updates: dict[str, Any]) -> dict:
        """Shift every window one step and write the new current values."""
        out = {}
        for n, win in hist.items():
            new = updates.get(n, win[..., 0])
            new = torch.as_tensor(new, dtype=win.dtype,
                                  device=win.device).reshape(
                win.shape[:-1] + (1,))
            out[n] = torch.cat([new, win[..., :-1]], dim=-1)
        return out

    # -- unified discrete step (casadi_ml_model.py:496-577) -------------------

    def _flat_input(self, key: str, hist: dict) -> torch.Tensor:
        """The model's flat input vectors (..., n_in) from history windows,
        in ``column_order``."""
        m = self.serialized[key]
        cols = []
        for name, feat in m.inputs.items():
            cols.extend(hist[name][..., i] for i in range(feat.lag))
        for name, feat in m.output.items():
            if feat.recursive:
                cols.extend(hist[name][..., i] for i in range(feat.lag))
        return torch.stack(cols, dim=-1)

    def _current(self, names, hist, like, batch) -> torch.Tensor:
        """(len(names), *batch): the current value of each variable, from
        its window where it has one, else its declared value."""
        rows = [hist[n][..., 0] if n in hist
                else torch.full(batch, float(self.get_var(n).value),
                                dtype=like.dtype, device=like.device)
                for n in names]
        if not rows:
            return like.new_zeros((0,) + tuple(batch))
        return torch.stack(torch.broadcast_tensors(*rows))

    def ml_step(self, hist: dict, p: torch.Tensor,
                ml_params: dict[str, Any] | None = None,
                t: float | torch.Tensor = 0.0) -> tuple[dict, dict]:
        """One dt step of the unified dynamics.

        Returns (next_states, outputs): next_states maps every
        differential-state name to its value after dt (ML states via
        surrogate, white-box states via RK4 on their ODEs with all other
        quantities held); outputs maps non-recursive ML outputs and
        declarative algebraic outputs to current values. Every value has
        the windows' leading shape.
        """
        if ml_params is None:
            ml_params = self.ml_params
        like = next(iter(hist.values()))
        batch = like.shape[:-1]
        preds: dict[str, torch.Tensor] = {}
        for key, predictor in self.predictors.items():
            # the surrogate's share of a solve's derivative passes
            # (forward and forward-mode work; reverse sweeps run outside)
            with record_function("ml.predict"):
                out = predictor.apply_batch(ml_params[key],
                                            self._flat_input(key, hist))
            m = self.serialized[key]
            for j, out_name in enumerate(m.output):
                feat = m.output[out_name]
                val = out[..., j]
                if feat.recursive and feat.output_type == "difference":
                    val = hist[out_name][..., 0] + val
                preds[out_name] = val

        next_states: dict[str, torch.Tensor] = {}
        for n in self.narx_state_names:
            next_states[n] = preds[n]

        u = self._current(self.input_names, hist, like, batch)
        z = self._current(self.free_state_names, hist, like, batch)
        if self.wb_state_names:
            # white-box ODE states advance by RK4 with ML states, inputs
            # and algebraic outputs held at their current values (the
            # reference fuses an integrator with the black-box passes the
            # same way, casadi_ml_model.py:496-577)
            from agentlib_mpc_torch.ops.integrators import integrate

            wb_idx = [self.diff_state_names.index(n)
                      for n in self.wb_state_names]

            def f(x_wb, tt):
                rows = [hist[n][..., 0] if n in self.narx_state_names
                        else x_wb[..., self.wb_state_names.index(n)]
                        for n in self.diff_state_names]
                dx = self.ode(torch.stack(rows), z, u, p, tt)
                return torch.stack([dx[i] for i in wb_idx], dim=-1)

            x_wb0 = torch.stack([hist[n][..., 0]
                                 for n in self.wb_state_names], dim=-1)
            x_wb1 = integrate(f, x_wb0, t, float(self.dt), substeps=4,
                              method="rk4")
            for i, n in enumerate(self.wb_state_names):
                next_states[n] = x_wb1[..., i]

        outputs: dict[str, torch.Tensor] = {}
        for n in self.ml_output_names:
            outputs[n] = preds[n]
        # declarative algebraic outputs at the current point
        if set(self.output_names) - set(self.ml_output_names):
            x_full = self._current(self.diff_state_names, hist, like, batch)
            y = self.output(x_full, z, u, p, t)
            for i, n in enumerate(self.output_names):
                if n not in self.ml_output_names:
                    outputs[n] = y[i]
        return next_states, outputs

    def simulate_ml_step(self, hist: dict, p, inputs: dict[str, float],
                         ml_params=None, t=0.0) -> tuple[dict, dict, dict]:
        """Convenience closed-loop driver: apply `inputs`, take one step,
        advance the history. Returns (hist_next, next_states, outputs)."""
        hist = dict(hist)
        for n, v in inputs.items():
            win = hist[n]
            hist[n] = torch.cat([torch.full_like(win[..., :1], float(v)),
                                 win[..., 1:]], dim=-1)
        like = next(iter(hist.values()))
        next_states, outputs = self.ml_step(
            hist, torch.as_tensor(p, dtype=like.dtype, device=like.device),
            ml_params=ml_params, t=t)
        hist_next = self.advance_history(hist, dict(next_states))
        return hist_next, next_states, outputs
