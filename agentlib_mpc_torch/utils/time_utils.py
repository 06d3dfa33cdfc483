"""Time-unit conversion helpers.

Port of ``agentlib_mpc_tpu/utils/time_utils.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's ``agentlib_mpc/utils/__init__.py``
(``TIME_CONVERSION`` table and ``is_time_in_intervals``) used by the MPC
deactivation modules and the analysis index conversion.
"""

from __future__ import annotations

from typing import Iterable, Tuple

TIME_CONVERSION = {
    "seconds": 1.0,
    "minutes": 60.0,
    "hours": 3600.0,
    "days": 86400.0,
    "weeks": 7 * 86400.0,
}


def convert_time(value: float, from_unit: str = "seconds",
                 to_unit: str = "seconds") -> float:
    return value * TIME_CONVERSION[from_unit] / TIME_CONVERSION[to_unit]


def is_time_in_intervals(time: float,
                         intervals: Iterable[Tuple[float, float]]) -> bool:
    """True if ``time`` lies in any closed [start, end] interval."""
    return any(start <= time <= end for start, end in intervals)
