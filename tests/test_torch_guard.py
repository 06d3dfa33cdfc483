"""The actuation guard through both packages: the cases of
``tests/test_resilience.py`` (check_result, the degradation ladder, the
budget cap, the exported level gauge, MINLP-shaped plans, the checkpoint
snapshot) run on the same scripted solve results through the JAX
package's guard and the port's, with the same decisions, levels and flag
flips, and the JAX test's expectations hold for the port."""

import importlib

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401

PACKAGES = ("agentlib_mpc_tpu", "agentlib_mpc_torch")
BOUNDS = {"mDot": (0.0, 0.05)}


def guard_mod(pkg):
    return importlib.import_module(f"{pkg}.resilience.guard")


def _result(u0=0.02, success=True, n=5):
    traj = {"u": np.full((n, 1), float(u0))}
    return {"u0": {"mDot": u0}, "traj": traj, "stats": {"success": success}}


def _plan():
    return {"u0": {"mDot": 0.01},
            "traj": {"u": np.arange(5, dtype=float).reshape(5, 1) / 100},
            "stats": {"success": True}}


def _guard(g, **kw):
    policy = g.DegradationPolicy(**{"replay_steps": 2, "hold_steps": 1,
                                    "recovery_steps": 2, **kw})
    return g.ActuationGuard(policy, agent="a", module="m")


def _log(guard, decisions):
    """Decision, level and flag flips per assessment."""
    return [(d.action, d.controls, d.healthy, d.reasons,
             d.entered_fallback, d.reengaged, level)
            for d, level in decisions]


def _assess_all(guard, results, bounds=BOUNDS):
    out = []
    for r in results:
        d = guard.assess(r, bounds)
        out.append((d, guard.level))
    return _log(guard, out)


def case_check_result(g):
    return [g.check_result(_result(), BOUNDS),
            g.check_result(_result(success=False), BOUNDS),
            g.check_result(_result(u0=float("nan")), BOUNDS),
            g.check_result(_result(u0=0.2), BOUNDS),
            g.check_result(_result(u0=0.2), bounds=None)]


def case_precheck(g):
    guard = g.ActuationGuard(g.DegradationPolicy(recovery_steps=1),
                             agent="a", module="m")
    d = guard.assess(_result(), BOUNDS,
                     precheck=(False, ("surrogate_off_manifold",)))
    return _log(guard, [(d, guard.level)])


def case_ladder(g):
    bad, ok = _result(success=False), _result()
    return _assess_all(_guard(g), [_plan(), bad, bad, bad, bad, bad, ok, ok])


def case_streak_reset(g):
    bad = _result(success=False)
    return _assess_all(_guard(g), [_result(), bad, _result(), bad])


def case_no_plan(g):
    return _assess_all(_guard(g), [_result(success=False)])


def case_budget_cap(g):
    guard = g.ActuationGuard(g.DegradationPolicy(
        replay_steps=3, hold_steps=3, fallback_after=1, recovery_steps=1),
        agent="a", module="m")
    bad = _result(success=False)
    return _assess_all(guard, [_result(), bad, bad])


def case_minlp_plan(g):
    guard = g.ActuationGuard(g.DegradationPolicy(replay_steps=2,
                                                 hold_steps=1),
                             agent="a", module="m")
    guard.plan_columns = ["mDot"]
    guard.binary_plan_columns = ["valve"]
    result = {"u0": {"mDot": 0.0, "valve": 1.0},
              "traj": {"u": np.arange(4, dtype=float).reshape(4, 1) / 100},
              "binary_schedule": np.array([[1.0], [1.0], [0.0], [0.0]]),
              "stats": {"success": True}}
    bounds = {"mDot": (0.0, 0.05), "valve": (0.0, 1.0)}
    bad = {"u0": {"mDot": float("nan"), "valve": float("nan")},
           "traj": {}, "stats": {"success": False}}
    return _assess_all(guard, [result, bad, bad], bounds)


def case_snapshot_restore(g):
    guard = _guard(g)
    bad = _result(success=False)
    _assess_all(guard, [_plan(), bad])
    snap = guard.snapshot()
    fresh = _guard(g)
    fresh.restore(snap)
    return [snap, _assess_all(fresh, [bad, bad, bad])]


def case_external_override_hold(g):
    guard = _guard(g)
    before = guard.external_override_hold()
    _assess_all(guard, [_plan()])
    return [before, guard.external_override_hold()]


def case_level_gauge(g):
    pkg = g.__name__.split(".")[0]
    telemetry = importlib.import_module(f"{pkg}.telemetry")
    telemetry.configure(enabled=True)
    guard = g.ActuationGuard(g.DegradationPolicy(), agent="gauge",
                             module=pkg)
    guard.assess(_result(success=False), BOUNDS)
    return [telemetry.metrics().get("mpc_degradation_level",
                                    agent="gauge", module=pkg)]


def case_unknown_policy_key(g):
    with pytest.raises(ValueError, match="unknown resilience option") as e:
        g.DegradationPolicy.from_config({"replays": 3})
    return [str(e.value)]


CASES = {name.removeprefix("case_"): fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_guards_decide_alike(case):
    ref, port = (CASES[case](guard_mod(pkg)) for pkg in PACKAGES)
    assert repr(port) == repr(ref)


def test_port_ladder_keeps_the_reference_expectations():
    """The expectations of test_resilience.py's ladder, on the port."""
    g = guard_mod("agentlib_mpc_torch")
    log = case_ladder(g)
    assert [row[0] for row in log] == [
        "actuate", "replay", "replay", "hold", "fallback", "fallback",
        "fallback", "actuate"]
    assert log[1][1] == {"mDot": 0.01} and log[2][1] == {"mDot": 0.02}
    assert log[3][1] == {"mDot": 0.02}
    assert log[4][4] and not log[5][4]          # entered fallback once
    assert not log[6][5] and log[7][5]          # hysteresis, then re-engage
    assert [row[6] for row in log] == [g.LEVEL_MPC, g.LEVEL_REPLAY,
                                       g.LEVEL_REPLAY, g.LEVEL_HOLD,
                                       g.LEVEL_FALLBACK, g.LEVEL_FALLBACK,
                                       g.LEVEL_FALLBACK, g.LEVEL_MPC]
    ok, reasons = case_check_result(g)[2]
    assert not ok and reasons == ("nonfinite_control",
                                  "nonfinite_trajectory")
    assert case_level_gauge(g) == [float(g.LEVEL_FALLBACK)]
