"""The chaos harness's seeded disturbance source.

Port of ``_rng`` and ``disturbance_model`` of
``agentlib_mpc_tpu/resilience/chaos.py`` (lines 132-176): the one seeded
stream that scenario generation (:mod:`agentlib_mpc_torch.scenario.
generate`, the forecast-ensemble hooks) and the chaos injectors share.
Both are numpy and ``random.Random("chaos:<seed>:<scope>")``, copied
line for line, so their draws equal the JAX package's bit for bit.

The rest of the chaos harness (the broker, solver and ADMM injectors, the
serving-plane and mesh fault models, :class:`ChaosController`) comes with
ROADMAP Queue 1 item 5 (multi-GPU, serving and resilience).
"""

from __future__ import annotations

import random

import numpy as np

__all__ = ["disturbance_model"]


def _rng(seed: int, scope: str) -> random.Random:
    """One independent, reproducible stream per injection point."""
    return random.Random(f"chaos:{seed}:{scope}")


def disturbance_model(seed: int, horizon: int, n_scenarios: int, *,
                      n_channels: int = 1, scale: float = 1.0,
                      kind: str = "gaussian",
                      nominal_first: bool = True) -> np.ndarray:
    """Seeded disturbance draws, shape ``(n_scenarios, horizon,
    n_channels)``: equal arguments reproduce the same draws, here and in
    the JAX package.

    * ``kind="gaussian"``: i.i.d. N(0, scale²) per step;
    * ``kind="walk"``: a zero-start random walk with N(0, scale²)
      increments (forecast error that grows with lookahead).

    ``nominal_first`` keeps scenario 0 all-zero: the nominal branch a
    forecast ensemble perturbs around."""
    if n_scenarios < 1:
        raise ValueError("n_scenarios must be >= 1")
    if kind not in ("gaussian", "walk"):
        raise ValueError(f"unknown disturbance kind {kind!r}")
    # the numpy stream comes from the chaos string-stream convention; the
    # kind stays out of the scope, so "walk" is the running sum of the
    # very increments "gaussian" returns
    scope = f"disturbance:{horizon}:{n_scenarios}:{n_channels}"
    root = _rng(seed, scope).getrandbits(64)
    gen = np.random.default_rng(root)
    draws = gen.normal(0.0, float(scale),
                       size=(n_scenarios, int(horizon), int(n_channels)))
    if kind == "walk":
        draws = np.cumsum(draws, axis=1)
    if nominal_first:
        draws[0] = 0.0
    return draws
