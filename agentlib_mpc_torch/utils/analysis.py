"""Results persistence, loading and slicing.

Port of ``agentlib_mpc_tpu/utils/analysis.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's ``utils/analysis.py`` (load_mpc :21-25,
load_sim :41-46, mpc_at_time_step :108-163, admm_at_time_step :166-241,
iteration counts :244-255, index conversion :49-76). The on-disk layout is
the reference's: MPC results are MultiIndex (time, grid) CSVs with
two-level columns, ADMM results (time, iteration, grid), simulator and
stats tables flat time-indexed CSVs — so analyses written against the
reference port mechanically.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from agentlib_mpc_torch.utils.time_utils import TIME_CONVERSION


# -- saving -------------------------------------------------------------------

def save_mpc(df, path) -> None:
    df.to_csv(path)


def save_results(results: dict, directory: Union[str, Path]) -> dict:
    """Write a LocalMAS ``get_results()`` tree to ``directory`` as
    ``<agent>_<module>[ _<part>].csv``. Returns {key: path}."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    written = {}
    for agent_id, modules in results.items():
        if not isinstance(modules, dict):
            continue
        for module_id, res in modules.items():
            parts = res.items() if isinstance(res, dict) else [("", res)]
            for part, df in parts:
                if df is None or not hasattr(df, "to_csv"):
                    continue
                name = f"{agent_id}_{module_id}" + (f"_{part}" if part
                                                    else "")
                path = directory / f"{name}.csv"
                df.to_csv(path)
                written[name] = path
    return written


# -- loading ------------------------------------------------------------------

def load_mpc(path) -> "pd.DataFrame":
    """(time, grid)-indexed MPC results with ('variable', name) columns
    (reference ``load_mpc``, ``analysis.py:21-25``)."""
    import pandas as pd

    return pd.read_csv(path, index_col=[0, 1], header=[0, 1])


def load_admm(path) -> "pd.DataFrame":
    """(time, iteration, grid)-indexed ADMM results with the two-level
    ('variable', name) column header (reference ``load_admm`` delegates
    to ``load_mpc`` with ``header=[0, 1]``, ``utils/analysis.py:17-25``;
    layout from ``casadi_/admm.py:364-424``)."""
    import pandas as pd

    return pd.read_csv(path, index_col=[0, 1, 2], header=[0, 1])


def load_sim(path, causality=None) -> "pd.DataFrame":
    """Flat time-indexed simulator results (reference ``load_sim``,
    ``analysis.py:41-46``)."""
    import pandas as pd

    return pd.read_csv(path, index_col=0)


def load_mpc_stats(path) -> "pd.DataFrame":
    import pandas as pd

    return pd.read_csv(path, index_col=0)


# -- index handling -----------------------------------------------------------

def convert_index(df, to_unit: str = "hours", from_unit: str = "seconds",
                  level: Union[int, str] = 0):
    """Convert one level of a (Multi)Index between time units (reference
    ``convert_multi_index``/``convert_index``, ``analysis.py:49-76``)."""
    import pandas as pd

    factor = TIME_CONVERSION[from_unit] / TIME_CONVERSION[to_unit]
    if isinstance(df.index, pd.MultiIndex):
        values = [np.asarray(df.index.get_level_values(i), dtype=float)
                  for i in range(df.index.nlevels)]
        pos = level if isinstance(level, int) \
            else df.index.names.index(level)
        values[pos] = values[pos] * factor
        df = df.copy()
        df.index = pd.MultiIndex.from_arrays(values, names=df.index.names)
        return df
    df = df.copy()
    df.index = np.asarray(df.index, dtype=float) * factor
    return df


# -- slicing ------------------------------------------------------------------

def _nearest_time(times: np.ndarray, time_step: Optional[float]):
    times = np.unique(np.asarray(times, dtype=float))
    if time_step is None:
        return times[-1]
    idx = int(np.argmin(np.abs(times - float(time_step))))
    return times[idx]


def mpc_at_time_step(data, time_step: Optional[float] = None,
                     variable: Optional[str] = None,
                     index_offset: bool = True):
    """One solve's predicted trajectory, grid offsets made absolute
    (reference ``mpc_at_time_step``, ``analysis.py:108-163``): pass the
    closed-loop time of the solve (nearest match; None = last)."""
    t = _nearest_time(data.index.get_level_values(0), time_step)
    sl = data.loc[t]
    if index_offset:
        sl = sl.copy()
        sl.index = np.asarray(sl.index, dtype=float) + float(t)
    if variable is not None:
        cols = sl.columns
        if hasattr(cols, "nlevels") and cols.nlevels == 2:
            return sl[("variable", variable)]
        return sl[variable]
    return sl


def admm_at_time_step(data, time_step: Optional[float] = None,
                      variable: Optional[str] = None,
                      iteration: Optional[float] = None,
                      index_offset: bool = True):
    """Slice ADMM results at a control step; ``iteration=None`` → all
    iterations of that step (reference ``admm_at_time_step``,
    ``analysis.py:166-241``)."""
    t = _nearest_time(data.index.get_level_values(0), time_step)
    sl = data.loc[t]
    if iteration is not None:
        iters = np.unique(np.asarray(
            sl.index.get_level_values(0), dtype=float))
        it = iters[int(np.argmin(np.abs(iters - float(iteration))))]
        sl = sl.loc[it]
        if index_offset:
            sl = sl.copy()
            sl.index = np.asarray(sl.index, dtype=float) + float(t)
    if variable is not None:
        cols = sl.columns
        if hasattr(cols, "nlevels") and cols.nlevels == 2:
            return sl[("variable", variable)]
        return sl[variable]
    return sl


def get_number_of_iterations(data) -> dict:
    """time → ADMM iteration count (reference ``analysis.py:244-255``)."""
    out = {}
    for t in np.unique(np.asarray(data.index.get_level_values(0),
                                  dtype=float)):
        out[t] = len(np.unique(np.asarray(
            data.loc[t].index.get_level_values(0), dtype=float)))
    return out


def first_vals_at_trajectory_index(data):
    """First value of each solve's trajectory — the closed-loop signal
    (reference ``analysis.py:263-278``)."""
    import pandas as pd

    times = np.unique(np.asarray(data.index.get_level_values(0),
                                 dtype=float))
    return pd.Series({t: data.loc[t].iloc[0] for t in times})


def last_vals_at_trajectory_index(data):
    import pandas as pd

    times = np.unique(np.asarray(data.index.get_level_values(0),
                                 dtype=float))
    return pd.Series({t: data.loc[t].iloc[-1] for t in times})
