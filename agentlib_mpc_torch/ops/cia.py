"""Combinatorial integer approximation (CIA) of relaxed binary schedules.

Port of ``agentlib_mpc_tpu/ops/cia.py`` (the reference's pycombina bridge,
``optimization_backends/casadi_/minlp_cia.py:124-150``): after a relaxed
NLP solve produces fractional binary controls ``b_rel ∈ [0,1]^(N×nb)``,
find a true binary schedule ``B`` minimizing the accumulated-deviation
objective

    η = max_{t,i} | Σ_{τ≤t} (b_rel[τ,i] − B[τ,i]) · dt[τ] |

subject to per-control switch limits and optionally a SOS1 (one-hot per
step) constraint — the schedule the second, binary-fixed NLP solve then
tracks. Host-side by design (tiny, sequential, branchy), between two
device solves.

:func:`solve_cia` runs the branch-and-bound of ``csrc/cia.cpp`` (built by
:mod:`agentlib_mpc_torch.native`) and nothing else: a failed build raises.
:func:`_solve_python` is its plain version (the same depth-first search
and greedy child order), which the tests hold it against; no caller
falls back to it. ``solve_cia.native_calls`` counts the library's runs.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import numpy as np

from agentlib_mpc_torch import native

_MAX_NB = 16


def sum_up_rounding(b_rel: np.ndarray, dt: np.ndarray,
                    sos1: bool = False) -> np.ndarray:
    """Classic sum-up rounding (Sager 2009): greedy one-pass schedule.
    Used as a fast approximation and as the B&B's conceptual first leaf."""
    b_rel = np.asarray(b_rel, dtype=float)
    N, nb = b_rel.shape
    out = np.zeros((N, nb))
    dev = np.zeros(nb)
    for t in range(N):
        dev += b_rel[t] * dt[t]
        if sos1 and nb > 1:
            i = int(np.argmax(dev))
            out[t, i] = 1.0
            dev[i] -= dt[t]
        else:
            on = dev >= 0.5 * dt[t]
            out[t, on] = 1.0
            dev[on] -= dt[t]
    return out


def cia_objective(b_rel: np.ndarray, b_bin: np.ndarray,
                  dt: np.ndarray) -> float:
    acc = np.cumsum((np.asarray(b_rel) - np.asarray(b_bin))
                    * np.asarray(dt)[:, None], axis=0)
    return float(np.max(np.abs(acc))) if acc.size else 0.0


def _solve_python(b_rel, dt, max_switches, sos1, max_nodes):
    """Plain version of csrc/cia.cpp (same DFS + greedy ordering)."""
    N, nb = b_rel.shape
    if sos1 and nb > 1:
        choices = [tuple(1 if j == i else 0 for j in range(nb))
                   for i in range(nb)]
    else:
        choices = list(itertools.product((0, 1), repeat=nb))
    best = {"obj": math.inf, "B": np.zeros((N, nb))}
    current = np.zeros((N, nb))
    nodes = [0]

    def dfs(t, dev, switches, last, partial):
        if partial >= best["obj"]:
            return
        if t == N:
            best["obj"] = partial
            best["B"] = current.copy()
            return
        nodes[0] += 1
        if nodes[0] > max_nodes:
            return
        scored = []
        for choice in choices:
            nd = dev + (b_rel[t] - choice) * dt[t]
            scored.append((float(np.max(np.abs(nd))), choice, nd))
        scored.sort(key=lambda s: s[0])
        for d, choice, nd in scored:
            child = max(partial, d)
            if child >= best["obj"]:
                break
            sw = [switches[i] + (last[i] is not None and choice[i] != last[i])
                  for i in range(nb)]
            if max_switches is not None and any(
                    sw[i] > max_switches[i] for i in range(nb)):
                continue
            current[t] = choice
            dfs(t + 1, nd, sw, list(choice), child)
            if nodes[0] > max_nodes:
                return

    dfs(0, np.zeros(nb), [0] * nb, [None] * nb, 0.0)
    return best["B"], best["obj"]


def _prepare(b_rel, dt, max_switches):
    """Validated, contiguous float64 ``b_rel`` (clipped to [0, 1]) and
    per-interval ``dt``."""
    b_rel = np.ascontiguousarray(np.clip(np.asarray(b_rel, dtype=float),
                                         0.0, 1.0))
    if b_rel.ndim != 2:
        raise ValueError("b_rel must be (N, nb)")
    N, nb = b_rel.shape
    if nb > _MAX_NB:
        raise ValueError(f"at most {_MAX_NB} binary controls supported")
    dt_arr = np.ascontiguousarray(
        np.broadcast_to(np.asarray(dt, dtype=float), (N,)))
    if max_switches is not None and len(max_switches) != nb:
        raise ValueError(
            f"max_switches has {len(max_switches)} entries for {nb} binary "
            f"controls")
    return b_rel, dt_arr


def solve_cia(
    b_rel: np.ndarray,
    dt: float | np.ndarray,
    max_switches: list[int] | None = None,
    sos1: bool = False,
    max_nodes: int = 2_000_000,
) -> tuple[np.ndarray, float]:
    """Solve the CIA problem in ``csrc/cia.cpp``. Returns (B, η); η is
    ``inf`` (and B zeros) when the node budget ends before the first leaf.

    b_rel: (N, nb) relaxed binaries; dt: scalar or (N,) interval lengths;
    max_switches: per-control change budget (None = unbounded);
    sos1: require exactly one active control per step (nb ≥ 2).
    """
    b_rel, dt_arr = _prepare(b_rel, dt, max_switches)
    N, nb = b_rel.shape
    fn = native.load("cia").cia_solve
    fn.restype = ctypes.c_int
    b_out = np.zeros((N, nb))
    obj = ctypes.c_double(0.0)
    ms = (np.ascontiguousarray(np.asarray(max_switches, dtype=np.int32))
          if max_switches is not None else None)
    dbl = ctypes.POINTER(ctypes.c_double)
    status = fn(
        b_rel.ctypes.data_as(dbl), ctypes.c_int(N), ctypes.c_int(nb),
        dt_arr.ctypes.data_as(dbl),
        ms.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        if ms is not None else None,
        ctypes.c_int(1 if sos1 else 0),
        b_out.ctypes.data_as(dbl), ctypes.byref(obj),
        ctypes.c_longlong(max_nodes))
    solve_cia.native_calls += 1
    if status < 0:
        raise ValueError(f"cia_solve rejected its arguments (N={N}, nb={nb})")
    if obj.value >= 1e299:
        return b_out, math.inf
    return b_out, float(obj.value)


solve_cia.native_calls = 0
