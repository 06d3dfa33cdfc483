"""Lagrange-polynomial collocation matrices.

Copy of ``agentlib_mpc_tpu/ops/collocation.py`` (numpy only).

Same math as the reference's direct collocation setup
(``agentlib_mpc/optimization_backends/casadi_/basic.py:344-392``, which calls
``casadi.collocation_points``): for a degree-d scheme on the unit interval,
build the derivative matrix C, the end-point continuity vector D and the
quadrature weight vector B of the Lagrange basis through the collocation
points. Everything here is *static* numpy executed once at transcription
time; the transcription turns the results into tensors once per
dtype and device.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def collocation_points(degree: int, method: str = "radau") -> tuple[float, ...]:
    """Collocation points on (0, 1], excluding the left endpoint 0.

    ``legendre``: Gauss-Legendre points (roots of the shifted Legendre
    polynomial P_d). ``radau``: right Radau points (roots of
    P_d + P_{d-1} shifted, endpoint 1 included) — the stiffly-accurate
    default, matching CasADi's convention.
    """
    if degree < 1:
        raise ValueError("collocation degree must be >= 1")
    if method == "legendre":
        # roots of Legendre P_d on [-1, 1] → shift to [0, 1]
        roots = np.polynomial.legendre.legroots(
            [0.0] * degree + [1.0])
        pts = (roots + 1.0) / 2.0
    elif method == "radau":
        # right Radau (Radau IIA): the d roots of P_d(x) − P_{d-1}(x) on
        # [-1, 1], which include the right endpoint x = +1
        # (check: d=2 → roots {−1/3, 1} → taus {1/3, 1})
        coeffs = np.zeros(degree + 1)
        coeffs[degree] = 1.0
        coeffs[degree - 1] = -1.0
        roots = np.polynomial.legendre.legroots(coeffs)
        pts = np.sort((roots + 1.0) / 2.0)
        assert np.isclose(pts[-1], 1.0), "right Radau must include tau=1"
    else:
        raise ValueError(f"unknown collocation method {method!r}")
    return tuple(float(p) for p in np.sort(pts))


@functools.lru_cache(maxsize=None)
def collocation_matrices(degree: int, method: str = "radau"):
    """(taus, C, D, B) for degree-d collocation.

    ``taus``: (d+1,) grid including 0.
    ``C[j, k]``: d/dτ of Lagrange basis ℓ_j at τ_k (j = 0..d, k = 1..d).
    ``D[j]``: ℓ_j(1) — continuity to the next interval boundary.
    ``B[j]``: ∫₀¹ ℓ_j dτ — quadrature weights for the cost integral.
    """
    taus = np.array([0.0] + list(collocation_points(degree, method)))
    d = degree
    C = np.zeros((d + 1, d + 1))
    D = np.zeros(d + 1)
    B = np.zeros(d + 1)
    for j in range(d + 1):
        # Lagrange basis ℓ_j through taus
        poly = np.poly1d([1.0])
        for r in range(d + 1):
            if r != j:
                poly *= np.poly1d([1.0, -taus[r]]) / (taus[j] - taus[r])
        D[j] = poly(1.0)
        dpoly = np.polyder(poly)
        for k in range(d + 1):
            C[j, k] = dpoly(taus[k])
        ipoly = np.polyint(poly)
        B[j] = ipoly(1.0)
    return taus, C, D, B
