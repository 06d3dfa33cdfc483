"""The chaos harness: its seeded streams and the serving-plane fault model.

Port of parts of ``agentlib_mpc_tpu/resilience/chaos.py``:

* ``_rng`` and :func:`disturbance_model` (JAX ``:132-176``): the one
  seeded stream that scenario generation (:mod:`agentlib_mpc_torch.
  scenario.generate`) and the chaos injectors share. Both are numpy and
  ``random.Random("chaos:<seed>:<scope>")``, copied line for line, so
  their draws equal the JAX package's bit for bit;
* :func:`churn_schedule` (JAX ``:1090``), the serving benchmark's seeded
  tenant churn, equal to the JAX package's event for event;
* the serving-plane fault model (JAX ``:363-727``): NaN storms, overload
  deadline squeezes, stalled rounds and failed engine builds installed on
  a :class:`~agentlib_mpc_torch.serving.plane.ServingPlane` by
  :func:`install_serving_chaos`, and :func:`corrupt_checkpoint` (JAX
  ``:728``), the torn checkpoint the restore path must refuse. Every
  injection is recorded on the :class:`ChaosController` and journaled as
  a ``chaos.injected`` event.

The port's round synchronizes on the host inside ``engine.step``, so a
stall (:class:`ServeStallRule`) hangs a round's LAUNCH, the call the
port's watchdog bounds, where the JAX package hangs its readback. The
broker, solver and ADMM injectors, the mesh fault model and the learned
warm-start poisoning rule come with ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from typing import Optional

import numpy as np

from agentlib_mpc_torch import telemetry

logger = logging.getLogger(__name__)

__all__ = ["ChaosBuildError", "ChaosConfig", "ChaosController",
           "ServeBuildFailRule", "ServeChaosConfig", "ServeNaNStormRule",
           "ServeOverloadRule", "ServeStallRule", "churn_schedule",
           "corrupt_checkpoint", "disturbance_model",
           "install_serving_chaos"]


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


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """The seed the injectors draw from (the JAX package's broker, solver
    and ADMM rule lists come with ROADMAP Queue 1 item 5)."""

    seed: int = 0


class ChaosController:
    """Owns the installed injectors: event log, counters, uninstall."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self.events: list[tuple[str, str]] = []   # (kind, where)
        self._restores: list = []                 # () -> None, LIFO

    def note(self, kind: str, where: str) -> None:
        self.events.append((kind, where))
        if telemetry.enabled():
            telemetry.counter(
                "chaos_injections_total",
                "faults injected by the chaos harness").inc(kind=kind)
        # every injection records itself here: injected fault, observed
        # symptom and recovery join up in the journal
        telemetry.journal_event("chaos.injected", rule=kind,
                                target=where, seed=self.config.seed)
        logger.debug("chaos: %s at %s", kind, where)

    def count(self, kind: str) -> int:
        return sum(1 for k, _ in self.events if k == kind)

    def uninstall(self) -> None:
        """Restore every wrapped seam (idempotent)."""
        while self._restores:
            self._restores.pop()()


# -- serving-plane chaos (the --chaos-serve fault model) ----------------------


class ChaosBuildError(RuntimeError):
    """Raised by a chaos-failed engine build (the injected analogue of an
    out-of-memory or CUDA failure at tenant join)."""


class _RoundWindow:
    """A rule active on served rounds ``[start_round, start_round +
    n_rounds)`` (open-ended when ``n_rounds`` is None) for one tenant or
    every one (``"*"``)."""

    def matches(self, tenant_id: str) -> bool:
        return self.tenant in ("*", tenant_id)

    def triggered(self, round_: int) -> bool:
        if round_ < self.start_round:
            return False
        return self.n_rounds is None or \
            round_ < self.start_round + self.n_rounds


@dataclasses.dataclass(frozen=True)
class ServeNaNStormRule(_RoundWindow):
    """Persistently poison one tenant's submissions: every matching
    ``submit`` inside the window carries an all-NaN parameter tree (the
    bad-sensor-feed tenant the health ladder must evict; the plane
    rejects it at the door, ``mode="theta"``). ``mode="result"`` poisons
    the *decoded* result instead (NaN ``u0`` and ``success=False``) to
    drive the guard-verdict path."""

    tenant: str = "*"
    start_round: int = 0
    n_rounds: Optional[int] = None   # None = open-ended
    mode: str = "theta"              # theta | result


@dataclasses.dataclass(frozen=True)
class ServeOverloadRule(_RoundWindow):
    """Overload storm: every matching submission inside the window is
    forced to a tight ``deadline_s``; requests whose round takes longer
    expire at the drain (``shed_deadline``). One ``chaos.injected`` note
    per storm round."""

    tenant: str = "*"
    start_round: int = 0
    n_rounds: Optional[int] = None   # None = open-ended
    deadline_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class ServeStallRule:
    """Hang one round for ``duration_s``: the card-that-never-answers
    signature the dispatch watchdog must survive. ``call`` indexes the
    dispatcher's round launches (the call that blocks in the port)."""

    call: int = 0
    duration_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class ServeBuildFailRule:
    """Fail the Nth (and the following ``n_builds - 1``) engine
    build(s) with :class:`ChaosBuildError`."""

    build: int = 0
    n_builds: int = 1

    def triggered(self, idx: int) -> bool:
        return self.build <= idx < self.build + self.n_builds


@dataclasses.dataclass(frozen=True)
class ServeChaosConfig:
    seed: int = 0
    nan_storm: tuple = ()
    stall: tuple = ()
    build_fail: tuple = ()
    overload: tuple = ()

    @classmethod
    def from_dict(cls, cfg: dict) -> "ServeChaosConfig":
        known = {"seed", "nan_storm", "stall", "build_fail", "overload"}
        if cfg.get("warmstart_poison"):
            raise NotImplementedError(
                "warmstart_poison (learned warm starts, ml/warmstart.py) "
                "is not ported yet (ROADMAP Queue 1 item 5)")
        unknown = set(cfg) - known - {"warmstart_poison"}
        if unknown:
            raise ValueError(
                f"unknown serve-chaos option(s) {sorted(unknown)}; "
                f"known: {sorted(known | {'warmstart_poison'})}")

        def rules(name, rule_cls):
            return tuple(r if isinstance(r, rule_cls) else rule_cls(**r)
                         for r in cfg.get(name, ()))

        return cls(
            seed=int(cfg.get("seed", 0)),
            nan_storm=rules("nan_storm", ServeNaNStormRule),
            stall=rules("stall", ServeStallRule),
            build_fail=rules("build_fail", ServeBuildFailRule),
            overload=rules("overload", ServeOverloadRule),
        )


def _nan_tree(tree):
    from torch.utils._pytree import tree_map

    return tree_map(
        lambda leaf: np.full_like(np.asarray(leaf, dtype=float), np.nan),
        tree)


class _SlowLaunch:
    """Slot-plane proxy whose round launch hangs first. The sleep runs
    where the watchdog bounds the launch (its worker thread), so a long
    stall costs one leaked daemon thread like a card that never answers;
    a launch the watchdog gave up on meanwhile never runs."""

    def __init__(self, slot_plane, duration_s: float, abandoned):
        self._plane = slot_plane
        self._duration_s = float(duration_s)
        self._abandoned = abandoned

    def launch_round(self):
        import time as _time

        _time.sleep(self._duration_s)
        if self._abandoned.is_set():
            return None
        return self._plane.launch_round()


def install_serving_chaos(plane, config: "ServeChaosConfig | dict",
                          seed: "int | None" = None) -> ChaosController:
    """Install the serving-scope injectors on a
    :class:`~agentlib_mpc_torch.serving.plane.ServingPlane`. Three seams:
    ``submit`` (NaN storms and overload deadline squeezes, windowed by
    served round), the dispatcher's round launch (stalls) and decode
    (result-mode poison), and the compile cache's builder (engine-build
    failures: the :class:`ChaosBuildError` propagates out of ``join``,
    never out of ``serve_round``). ``uninstall()`` on the returned
    :class:`ChaosController` restores every seam."""
    if not isinstance(config, ServeChaosConfig):
        config = ServeChaosConfig.from_dict(config)
    if seed is not None:
        config = dataclasses.replace(config, seed=int(seed))
    controller = ChaosController(ChaosConfig(seed=config.seed))
    counters = {"launch": 0, "build": 0, "round": 0}

    if config.nan_storm or config.overload:
        orig_submit = plane.submit
        orig_serve = plane.serve_round
        overload_noted: set = set()

        def serve_round(*a, **kw):
            out = orig_serve(*a, **kw)
            counters["round"] += 1
            return out

        def submit(tenant_id, theta=None, **kw):
            r = counters["round"]
            rule = next((x for x in config.nan_storm
                         if x.matches(tenant_id) and x.triggered(r)
                         and x.mode == "theta"), None)
            if rule is not None:
                controller.note("serve_nan_theta",
                                f"{tenant_id}:round{r}")
                base = theta if theta is not None \
                    else plane._specs[tenant_id].theta
                theta = _nan_tree(base)
            o_rule = next((x for x in config.overload
                           if x.matches(tenant_id) and x.triggered(r)),
                          None)
            if o_rule is not None:
                if r not in overload_noted:
                    # one injection record per storm ROUND
                    overload_noted.add(r)
                    controller.note("serve_overload", f"round{r}")
                kw["deadline_s"] = o_rule.deadline_s
            return orig_submit(tenant_id, theta, **kw)

        plane.submit = submit
        plane.serve_round = serve_round
        controller._restores.append(
            lambda: (setattr(plane, "submit", orig_submit),
                     setattr(plane, "serve_round", orig_serve)))

    dispatcher = plane.dispatcher
    if config.stall:
        orig_job = dispatcher._launch_job

        def launch_job(slot_plane, abandoned):
            idx = counters["launch"]
            counters["launch"] += 1
            stall = next((x for x in config.stall if x.call == idx), None)
            if stall is not None:
                controller.note("serve_stall", f"call{idx}")
                slot_plane = _SlowLaunch(slot_plane, stall.duration_s,
                                         abandoned)
            return orig_job(slot_plane, abandoned)

        dispatcher._launch_job = launch_job
        controller._restores.append(
            lambda d=dispatcher, o=orig_job: setattr(d, "_launch_job", o))

    result_storms = tuple(r for r in config.nan_storm
                          if r.mode == "result")
    if result_storms:
        orig_mat = dispatcher._materialize

        def materialize(slot_plane, handle, label=""):
            out = orig_mat(slot_plane, handle, label)
            if isinstance(out, dict):
                r = counters["round"]
                for tenant_id, res in out.items():
                    rule = next(
                        (x for x in result_storms
                         if x.matches(tenant_id) and x.triggered(r)),
                        None)
                    if rule is None:
                        continue
                    controller.note("serve_nan_result",
                                    f"{tenant_id}:round{r}")
                    res = dict(res)
                    stats = dict(res.get("stats") or {})
                    stats["success"] = False
                    stats["chaos"] = "nan"
                    res["stats"] = stats
                    res["u0"] = {n: float("nan")
                                 for n in res.get("u0", {})}
                    out[tenant_id] = res
            return out

        dispatcher._materialize = materialize
        controller._restores.append(
            lambda d=dispatcher, o=orig_mat: setattr(d, "_materialize", o))

    if config.build_fail:
        cache = plane.cache
        orig_gob = cache.get_or_build

        def get_or_build(key, builder, label=""):
            def chaotic_builder():
                idx = counters["build"]
                counters["build"] += 1
                rule = next((x for x in config.build_fail
                             if x.triggered(idx)), None)
                if rule is not None:
                    controller.note("serve_build_fail",
                                    f"build{idx}:{label}")
                    raise ChaosBuildError(
                        f"chaos: engine build {idx} for bucket "
                        f"{label or '?'} failed")
                return builder()
            return orig_gob(key, chaotic_builder, label)

        cache.get_or_build = get_or_build
        controller._restores.append(
            lambda c=cache, o=orig_gob: setattr(c, "get_or_build", o))

    return controller


def corrupt_checkpoint(path: str, mode: str = "truncate") -> list:
    """Damage a checkpoint directory: the crash-during-save / bit-rot
    fault the restore path must REJECT loudly instead of splicing garbage
    into live engines. ``truncate`` halves every data file (the
    ``torch.save`` payloads of the port's checkpoints); ``drop-manifest``
    removes the completeness marker (``manifest.json`` of a plane
    checkpoint, else the tree file of a ``save_pytree`` checkpoint).
    Returns the damaged paths."""
    import os

    if mode == "drop-manifest":
        for marker in ("manifest.json", "tree.pt"):
            victim = os.path.join(path, marker)
            if os.path.isfile(victim):
                os.remove(victim)
                return [victim]
        raise FileNotFoundError(
            f"no completeness marker under {path}")
    if mode != "truncate":
        raise ValueError(f"unknown corruption mode {mode!r}")
    victims = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if not f.endswith(".pt"):
                continue
            full = os.path.join(root, f)
            size = os.path.getsize(full)
            if size > 1:
                with open(full, "r+b") as fh:
                    fh.truncate(size // 2)
                victims.append(full)
    if not victims:
        raise FileNotFoundError(f"nothing to corrupt under {path}")
    logger.warning("chaos: truncated %d data files under %s",
                   len(victims), path)
    return victims


# -- serving-plane tenant churn (the --serve benchmark's load model) ----------

def churn_schedule(seed: int, n_tenants: int, rounds: int,
                   p_leave: float = 0.15, p_join: float = 0.3,
                   min_active: int = 1) -> list:
    """Deterministic tenant join/leave events for the serving benchmark.

    Returns ``rounds`` lists of ``("join", tid)`` / ``("leave", tid)``
    events over a population of ``n_tenants`` tenant ids (``"t000"``...).
    Same seed, same schedule, here and in the JAX package. Round 0 joins
    an initial cohort; later rounds flip membership with per-tenant
    probabilities ``p_join`` (for departed tenants: every such join after
    the first is a REJOIN, the compile-cache-hit path) and ``p_leave``
    (for active ones, floored at ``min_active`` so the plane always has
    traffic)."""
    rng = _rng(seed, "serve-churn")
    ids = [f"t{i:03d}" for i in range(n_tenants)]
    active: set = set()
    schedule = []
    for r in range(rounds):
        events = []
        if r == 0:
            cohort = ids[:max(min_active, (n_tenants + 1) // 2)]
            events += [("join", t) for t in cohort]
            active.update(cohort)
        else:
            for t in ids:
                if t in active:
                    if (len(active) > min_active
                            and rng.random() < p_leave):
                        events.append(("leave", t))
                        active.discard(t)
                elif rng.random() < p_join:
                    events.append(("join", t))
                    active.add(t)
        schedule.append(events)
    return schedule
