"""Data source: replay a table onto the broker on a sample grid.

Port of ``agentlib_mpc_tpu/modules/data_source.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's ``DataSource``
(``modules/data_source.py``: config :15-75, replay loop :170-182,
interpolated lookup :134-168): a CSV file / DataFrame / dict of columns is
normalized to a numeric seconds index and each configured output column is
published every ``t_sample`` with linear or zero-order-hold interpolation,
with an optional ``data_offset`` shifting the table's time axis.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.utils.sampling import interpolate_to_previous

logger = logging.getLogger(__name__)


@register_module("data_source")
class DataSource(BaseModule):
    """Config keys: ``data`` (csv path | DataFrame | {col: {t: v}}),
    ``t_sample``, ``data_offset`` (seconds added to lookup time),
    ``interpolation_method`` ("linear" | "previous"), ``outputs`` (the
    columns to publish; empty = all columns)."""

    variable_groups = ("outputs",)
    shared_groups = ("outputs",)

    def __init__(self, config: dict, agent):
        super().__init__(config, agent)
        self.t_sample = float(config.get("t_sample", 1.0))
        self.data_offset = float(config.get("data_offset", 0.0))
        self.method = config.get("interpolation_method", "linear")
        if self.method not in ("linear", "previous"):
            raise ValueError(
                f"interpolation_method must be 'linear' or 'previous', got "
                f"{self.method!r}")
        self.data = self._load_table(config["data"])
        cols = self._groups.get("outputs") or list(self.data)
        missing = [c for c in cols if c not in self.data]
        if missing:
            raise ValueError(f"data source columns not in table: {missing}")
        self.columns = cols
        # columns that were not declared as outputs are still published
        # under their own name (reference publishes every column)
        from agentlib_mpc_torch.runtime.variables import AgentVariable

        for c in cols:
            if c not in self.vars:
                var = AgentVariable(name=c, shared=True)
                self._declare(var, "outputs")
                self._groups["outputs"].append(c)

    @staticmethod
    def _normalize_index(index) -> np.ndarray:
        """datetime → seconds since start; numeric stays (reference
        datetime normalization, ``data_source.py:96-132``)."""
        import pandas as pd

        idx = pd.Index(index)
        if isinstance(idx, pd.DatetimeIndex):
            return (idx - idx[0]).total_seconds().to_numpy()
        return idx.to_numpy(dtype=float)

    def _load_table(self, data) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        import pandas as pd

        if isinstance(data, (str, Path)):
            from agentlib_mpc_torch.utils.try_format import (
                is_try_file,
                read_try_file,
            )

            if is_try_file(data):
                # German TRY weather dataset (the reference's TRYPredictor
                # input format, ``modules/InputPrediction/try_predictor.py``)
                df = read_try_file(data)
            else:
                df = pd.read_csv(data, index_col=0)
                try:
                    df.index = pd.to_datetime(df.index)
                except (ValueError, TypeError):
                    pass
        elif isinstance(data, pd.DataFrame):
            df = data
        elif isinstance(data, dict):
            df = pd.DataFrame(data)
        else:
            raise TypeError(f"unsupported data source type {type(data)}")
        if df.empty:
            raise ValueError("data source table is empty")
        times = self._normalize_index(df.index)
        order = np.argsort(times)
        return {
            str(c): (times[order],
                     df[c].to_numpy(dtype=float)[order])
            for c in df.columns}

    def get_data_at_time(self, t: float) -> dict[str, float]:
        t = t + self.data_offset
        out = {}
        for c in self.columns:
            times, vals = self.data[c]
            if self.method == "previous":
                out[c] = float(interpolate_to_previous([t], times, vals)[0])
            else:
                out[c] = float(np.interp(t, times, vals))
        return out

    def process(self):
        while True:
            for name, value in self.get_data_at_time(
                    float(self.env.now)).items():
                self.set(name, value)
            yield self.t_sample
