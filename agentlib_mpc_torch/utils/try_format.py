"""German Test-Reference-Year (TRY) weather file parsing.

Port of ``agentlib_mpc_tpu/utils/try_format.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's TRY support: its ``TRYPredictor`` subclasses
agentlib's TRYSensor and publishes eleven weather quantities parsed from
DWD TRY datasets (``modules/InputPrediction/try_predictor.py:7-90``; the
reference ships ``examples/three_zone_datadriven_admm/TRY2015_Aachen_Jahr.dat``).

File layout (DWD TRY 2015): a free-text header terminated by a ``***``
line, then hourly rows of whitespace-separated columns

    RW HW MM DD HH  t  p  WR WG N  x  RF B  D  A  E  IL

This parser maps them to the reference's published variable names, converts
air temperature to Kelvin (the reference publishes ``T_oda`` in K), and
indexes rows in seconds from the file start (hourly grid) so the result
plugs straight into :class:`~agentlib_mpc_torch.modules.data_source.DataSource`
/ :class:`~agentlib_mpc_torch.modules.input_prediction.InputPredictor`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

#: data-row columns of a TRY 2015 file, in file order
_RAW_COLUMNS = ("RW", "HW", "MM", "DD", "HH", "t", "p", "WR", "WG", "N",
                "x", "RF", "B", "D", "A", "E", "IL")

#: raw column → published quantity name (reference predictor's variables,
#: ``try_predictor.py:13-68``); RW/HW/date columns and the quality bit are
#: metadata, not measurements
TRY_QUANTITIES = {
    "t": "T_oda",                 # air temperature 2 m [K] (converted)
    "p": "pressure",              # air pressure [hPa]
    "WR": "wind_direction",       # [deg] {0..360; 999}
    "WG": "wind_speed",           # [m/s]
    "N": "coverage",              # cloud coverage [eighth] {0..8; 9}
    "x": "absolute_humidity",     # mixing ratio [g/kg]
    "RF": "relative_humidity",    # [%] {1..100}
    "B": "beam_direct",           # direct solar beam, horizontal [W/m2]
    "D": "beam_diffuse",          # diffuse solar beam, horizontal [W/m2]
    "A": "beam_atm",              # atmospheric counter-radiation [W/m2]
    "E": "beam_terr",             # terrestrial radiation [W/m2]
}

_HEADER_END = "***"
_HOUR = 3600.0


def read_try_file(path: str | Path):
    """Parse a TRY ``.dat`` file → DataFrame of the eleven published
    quantities on an hourly seconds index (0, 3600, 7200, ...).

    Air temperature is converted °C → K under the reference's ``T_oda``
    name; all other columns keep the file's units.
    """
    import pandas as pd

    lines = Path(path).read_text().splitlines()
    data_start = None
    for i, line in enumerate(lines):
        if line.strip().startswith(_HEADER_END):
            data_start = i + 1
            break
    if data_start is None:
        raise ValueError(
            f"{path}: not a TRY file (no '{_HEADER_END}' header terminator)")

    rows = []
    for line in lines[data_start:]:
        parts = line.split()
        if len(parts) != len(_RAW_COLUMNS):
            if parts:  # tolerate blank lines, reject malformed data
                raise ValueError(
                    f"{path}: malformed TRY data row (expected "
                    f"{len(_RAW_COLUMNS)} columns, got {len(parts)}): "
                    f"{line!r}")
            continue
        rows.append([float(p) for p in parts])
    if not rows:
        raise ValueError(f"{path}: TRY file contains no data rows")

    raw = np.asarray(rows)
    out = {}
    for col, name in TRY_QUANTITIES.items():
        vals = raw[:, _RAW_COLUMNS.index(col)]
        if col == "t":
            vals = vals + 273.15
        out[name] = vals
    index = np.arange(len(rows)) * _HOUR
    return pd.DataFrame(out, index=index)


def try_forecast_ensemble(df, column: str, t0: float, horizon_steps: int,
                          n_scenarios: int, seed: int = 0,
                          spread: "float | None" = None,
                          dt: float = _HOUR) -> np.ndarray:
    """Batched forecast ensemble from a parsed TRY table: ``(S,
    horizon_steps)`` trajectories of ``column`` starting at ``t0`` (seconds
    on the table's index) on a ``dt`` grid. Row 0 is the nominal
    interpolated series, rows 1.. seeded random-walk perturbations from
    :func:`~agentlib_mpc_torch.resilience.chaos.disturbance_model` (the
    JAX package's draws bit for bit). ``spread`` is the per-step walk
    sigma; None defaults to 5% of the window's peak-to-peak range.

    The rows plug into
    :func:`agentlib_mpc_torch.scenario.generate.scenario_thetas` as one
    exogenous channel's per-scenario ``d_traj`` column."""
    from agentlib_mpc_torch.resilience.chaos import disturbance_model

    if column not in df.columns:
        raise KeyError(
            f"column {column!r} not in the TRY table "
            f"({sorted(df.columns)})")
    grid = float(t0) + np.arange(int(horizon_steps)) * float(dt)
    base = np.interp(grid, np.asarray(df.index, dtype=float),
                     np.asarray(df[column], dtype=float))
    sigma = float(spread) if spread is not None else \
        0.05 * float(np.ptp(base)) if base.size else 0.0
    draws = disturbance_model(
        seed=seed + int(t0), horizon=base.shape[0],
        n_scenarios=int(n_scenarios), scale=sigma, kind="walk")
    return base[None, :] + draws[:, :, 0]


def is_try_file(path) -> bool:
    """Cheap sniff: TRY files are ``.dat`` with a ``***`` header separator
    in their first ~60 lines."""
    p = Path(path)
    if p.suffix.lower() != ".dat":
        return False
    try:
        with open(p, "r", errors="replace") as fh:
            for _ in range(60):
                line = fh.readline()
                if not line:
                    return False
                if line.strip().startswith(_HEADER_END):
                    return True
    except OSError:
        return False
    return False
