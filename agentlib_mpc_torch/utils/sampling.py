"""Trajectory sampling: interpolate live variable values onto OCP grids.

Port of ``agentlib_mpc_tpu/utils/sampling.py``; the port keeps its own copy
and imports nothing of the JAX package.

Re-implements the semantics of the reference's ``utils/sampling.py``
(``sample`` :45-164, ``interpolate_to_previous`` :183-202; enum
``data_structures/interpolation.py:6-24``): a variable arriving over the
broker may be a scalar (hold constant), a list (already on the grid), or a
(times, values) trajectory to interpolate at the solve's current time with
linear or previous-value (zero-order hold) interpolation, extrapolating
edges with the boundary value.

Host-side numpy: this runs in the control loop *before* device dispatch and
produces the fixed-shape arrays the solve consumes.
"""

from __future__ import annotations

from enum import Enum
from typing import Sequence

import numpy as np


class InterpolationMethods(str, Enum):
    linear = "linear"
    previous = "previous"
    mean_over_interval = "mean_over_interval"


def sample(
    value,
    grid: Sequence[float],
    current: float = 0.0,
    method: InterpolationMethods = InterpolationMethods.linear,
) -> np.ndarray:
    """Sample `value` onto `current + grid`.

    value: scalar | sequence of len(grid) | (times, values) pair |
           dict {time: value} | pandas Series.
    """
    grid = np.asarray(grid, dtype=float)
    # pandas Series → (times, values) without importing pandas here
    if hasattr(value, "index") and hasattr(value, "values"):
        value = (np.asarray(value.index, dtype=float),
                 np.asarray(value.values, dtype=float))
    if isinstance(value, dict):
        # keys may be strings (JSON round-trip of a pandas Series): sort
        # numerically, not lexicographically
        keys = sorted(value, key=float)
        value = (np.array([float(k) for k in keys]),
                 np.array([value[k] for k in keys], dtype=float))
    if np.isscalar(value) or (isinstance(value, np.ndarray) and value.ndim == 0):
        return np.full(grid.shape, float(value))
    if isinstance(value, (list, np.ndarray)):
        arr = np.asarray(value, dtype=float)
        if arr.shape == grid.shape:
            return arr
        if arr.size == 1:
            return np.full(grid.shape, float(arr.reshape(())))
        raise ValueError(
            f"list value of length {arr.size} does not match grid of "
            f"length {grid.size}; pass a (times, values) pair to interpolate")
    times, vals = value
    times = np.asarray(times, dtype=float)
    vals = np.asarray(vals, dtype=float)
    target = current + grid
    if method == InterpolationMethods.previous:
        return interpolate_to_previous(target, times, vals)
    if method == InterpolationMethods.mean_over_interval:
        out = np.empty(target.shape)
        for i, t0 in enumerate(target):
            t1 = target[i + 1] if i + 1 < len(target) else t0
            mask = (times >= t0) & (times < t1) if t1 > t0 else np.array([])
            if np.any(mask):
                out[i] = float(np.mean(vals[mask]))
            else:
                out[i] = float(np.interp(t0, times, vals))
        return out
    # linear with edge extrapolation by boundary value (np.interp semantics)
    return np.interp(target, times, vals)


def shift_time_series(arr: np.ndarray, horizon: int) -> np.ndarray:
    """Shift a trajectory one control interval forward, repeating the tail —
    the between-steps warm start both ADMM modes use (reference
    ``shift_values_by_one``, ``admm_datatypes.py:275-282``; tensor twin:
    ``ops/admm.shift_one``). ``arr`` has ``k·horizon`` samples."""
    arr = np.asarray(arr)
    k = max(len(arr) // max(horizon, 1), 1)
    return np.concatenate([arr[k:], arr[-k:]])


def interpolate_to_previous(target, times, vals) -> np.ndarray:
    """Zero-order hold (reference ``interpolate_to_previous``,
    ``utils/sampling.py:183-202``)."""
    idx = np.searchsorted(times, np.asarray(target, dtype=float), side="right") - 1
    idx = np.clip(idx, 0, len(vals) - 1)
    return np.asarray(vals, dtype=float)[idx]
