"""Resilience: guarded actuation and the degradation ladder.

Port of the part of ``agentlib_mpc_tpu/resilience/`` the module path runs:
:mod:`.guard` (per-solve health checks and the shift-and-replay → hold →
FallbackPID cascade driven from
:class:`~agentlib_mpc_torch.modules.mpc.BaseMPC`), and of the chaos
harness only its seeded disturbance source (:func:`chaos.
disturbance_model`, which scenario generation shares); the injectors come
with ROADMAP Queue 1 item 5.
"""

from agentlib_mpc_torch.resilience.guard import (
    LEVEL_FALLBACK,
    LEVEL_HOLD,
    LEVEL_MPC,
    LEVEL_REPLAY,
    ActuationGuard,
    DegradationPolicy,
    GuardDecision,
    check_result,
)

__all__ = [
    "ActuationGuard", "DegradationPolicy", "GuardDecision", "check_result",
    "LEVEL_MPC", "LEVEL_REPLAY", "LEVEL_HOLD", "LEVEL_FALLBACK",
]
