"""Results-frame builders (reference CSV layouts).

The port's own copy of ``agentlib_mpc_tpu/utils/results.py`` (numpy, and
pandas imported where a frame is built): the reference's MultiIndex result
layouts, used by the fused fleet (``parallel/config_bridge.py``).
"""

from __future__ import annotations

import numpy as np


def trajectory_layout(model, control_names,
                      ocp=None) -> dict[str, list[str]]:
    """Column names of an OCP's result trajectories — the single
    definition of the layout contract (keys "x"/"u"/"y"/"z"). Pass the transcribed ``ocp`` when available: NARX OCPs
    order "x" by their dyn_names (learned + white-box states) and keep
    only slack states in "z"."""
    if ocp is not None and hasattr(ocp, "dyn_names"):
        return {
            "x": list(ocp.dyn_names),
            "u": list(ocp.control_names),
            "y": list(model.output_names),
            "z": list(ocp.slack_names),
        }
    return {
        "x": list(model.diff_state_names),
        "u": list(control_names),
        "y": list(model.output_names),
        "z": list(model.free_state_names),
    }


def admm_iteration_frame(time, iterations, grid, columns):
    """One (time, iteration, grid) MultiIndex block of ADMM coupling
    trajectories — the reference's iteration-buffered layout
    (``casadi_/admm.py:364-424``).

    ``columns``: name → array reshaping to ``len(iterations) * len(grid)``
    (either ``(n_it, G)`` or flat).
    """
    import pandas as pd

    df = pd.DataFrame({("variable", name): np.asarray(arr).reshape(-1)
                       for name, arr in columns.items()})
    df.index = pd.MultiIndex.from_product(
        [[time], list(iterations), np.asarray(grid, dtype=float)],
        names=["time", "iteration", "grid"])
    return df


def concat_admm_frames(frames):
    """Concatenate :func:`admm_iteration_frame` blocks into one results
    frame with normalized two-level columns."""
    import pandas as pd

    if not frames:
        return None
    out = pd.concat(frames)
    out.columns = pd.MultiIndex.from_tuples(out.columns)
    return out


def mpc_trajectory_frame(rows, layout):
    """(time, grid-offset) MultiIndex DataFrame with ('variable', name)
    columns from recorded per-step trajectories.

    ``rows``: iterable of ``{"time": float, "traj": {key: array}}`` where
    ``traj`` has the `TranscribedOCP.trajectories` keys (time_state, x,
    u, y, z). ``layout``: {"x": [names], "u": [...], "y": [...],
    "z": [...]} — the :func:`trajectory_layout` shape.
    Control-grid quantities (one row shorter than the state grid) are
    NaN-padded at the terminal node, as the reference does.
    """
    import pandas as pd

    rows = list(rows)
    if not rows:
        return None
    frames = []
    for row in rows:
        traj = row["traj"]
        grid = np.asarray(traj["time_state"]) - row["time"]
        n_nodes = len(grid)
        data = {}
        for key in ("x", "u", "y", "z"):
            for i, n in enumerate(layout[key]):
                col = np.asarray(traj[key])[:, i]
                if col.shape[0] < n_nodes:  # control-grid quantities
                    col = np.append(col, [np.nan] * (n_nodes -
                                                     col.shape[0]))
                data[("variable", n)] = col
        df = pd.DataFrame(data)
        df.index = pd.MultiIndex.from_product(
            [[row["time"]], grid], names=["time", "grid"])
        frames.append(df)
    out = pd.concat(frames)
    out.columns = pd.MultiIndex.from_tuples(out.columns)
    return out
