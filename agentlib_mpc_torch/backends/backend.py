"""Backend base class, variable reference, registry, and model loading.

Port of ``agentlib_mpc_tpu/backends/backend.py``: a backend is constructed
from the module's ``optimization_backend`` config dict, is handed a
:class:`VariableReference` describing which module variables play which
OCP role, builds the problem once (``setup_optimization``), and then serves
repeated ``solve(now, variables)`` calls. Every backend runs on an explicit
``device`` (None: the card) in an explicit ``dtype``; the owning module
passes its agent's. Its warm state stays on that device; what it returns
to the module (``u0``, trajectories, the stats row) is host numbers.

A config naming a backend type of a later slice of the port would raise
``NotImplementedError`` naming its ROADMAP item
(:data:`DEFERRED_BACKEND_TYPES`, empty since the ML slice);
:meth:`OptimizationBackend.problem_fingerprint` waits for item 5.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import logging
from typing import Any, Optional, Type

import torch

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.models.model import Model
from agentlib_mpc_torch.ops.solver import (
    init_point_source_name,
    jac_path_name,
    kkt_path_name,
)
from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# the shared solver metric families (declared once in telemetry)
_SOLVER_METRICS = telemetry.solver_metrics()

backend_types: dict[str, Type["OptimizationBackend"]] = {}

#: backend types of the JAX package whose slice of the port has not come
#: yet, with the ROADMAP Queue 1 item that brings each
DEFERRED_BACKEND_TYPES: dict[str, str] = {}


def load_custom_class(file: str, class_name: str):
    """Load a class from a file path (the reference's ``custom_injection``
    hook)."""
    spec = importlib.util.spec_from_file_location(
        f"_custom_{class_name}", file)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {class_name!r} from {file!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, class_name)


def register_backend(*names: str):
    def deco(cls):
        for n in names:
            backend_types[n] = cls
        return cls
    return deco


def create_backend(config: dict, device=None,
                   dtype: torch.dtype = torch.float32
                   ) -> "OptimizationBackend":
    """Build the backend a config names, on ``device`` (None: the card)
    in ``dtype``."""
    type_key = config.get("type", "jax")
    if isinstance(type_key, dict):
        cls = load_custom_class(type_key["file"], type_key["class_name"])
    else:
        if type_key in DEFERRED_BACKEND_TYPES and \
                type_key not in backend_types:
            raise NotImplementedError(
                f"backend type {type_key!r} is not ported yet: it comes "
                f"with ROADMAP Queue 1 item "
                f"{DEFERRED_BACKEND_TYPES[type_key]}")
        if type_key not in backend_types:
            raise KeyError(f"unknown backend type {type_key!r}; known: "
                           f"{sorted(backend_types)}")
        cls = backend_types[type_key]
    return cls(config, device=device, dtype=dtype)


@dataclasses.dataclass
class VariableReference:
    """Names of the module variables in each OCP role (reference
    ``data_structures/mpc_datamodels.py`` VariableReference)."""

    states: list[str] = dataclasses.field(default_factory=list)
    controls: list[str] = dataclasses.field(default_factory=list)
    inputs: list[str] = dataclasses.field(default_factory=list)
    parameters: list[str] = dataclasses.field(default_factory=list)
    outputs: list[str] = dataclasses.field(default_factory=list)
    binary_controls: list[str] = dataclasses.field(default_factory=list)

    def all_names(self) -> list[str]:
        return [*self.states, *self.controls, *self.inputs,
                *self.parameters, *self.outputs, *self.binary_controls]


def load_model(model_cfg: dict | Model, dt: float | None = None) -> Model:
    """Instantiate the model named by a config dict.

    Accepts: a Model instance; ``{"class": ModelClass, ...}``;
    ``{"class": "<zoo name>"}`` (a built-in model of
    :mod:`agentlib_mpc_torch.models.zoo` by name); or the custom injection
    ``{"type": {"file": ..., "class_name": ...}}``. Any
    "states"/"inputs"/"parameters"/"outputs" lists of ``{"name",
    "value"}`` entries set initial/default values.
    """
    if isinstance(model_cfg, Model):
        return model_cfg
    model_cfg = dict(model_cfg)
    cls = model_cfg.get("class")
    if isinstance(cls, str):
        from agentlib_mpc_torch.models import zoo

        candidate = getattr(zoo, cls, None)
        if not (isinstance(candidate, type) and candidate is not Model
                and issubclass(candidate, Model)):
            raise KeyError(
                f"model class {cls!r} is not a built-in zoo model; "
                f"for custom models use {{'type': {{'file', "
                f"'class_name'}}}} injection")
        cls = candidate
    if cls is None:
        type_key = model_cfg.get("type")
        if isinstance(type_key, dict):
            cls = load_custom_class(type_key["file"], type_key["class_name"])
        else:
            raise KeyError(
                "model config needs 'class' or {'type': {'file', "
                "'class_name'}}")
    overrides: dict[str, float] = {}
    for group in ("states", "inputs", "parameters", "outputs"):
        for entry in model_cfg.get(group, []):
            if "value" in entry:
                overrides[entry["name"]] = entry["value"]
    return cls(overrides=overrides or None, dt=dt)


def load_model_for_backend(model_cfg: dict | Model,
                           dt: float | None = None) -> Model:
    """Backend-aware model loading for the owning *module*: ML model
    configs carry ``ml_model_sources`` that plain :func:`load_model` would
    silently drop (the surrogates would never register and the NARX
    transcription would see no learned states). Dispatches to the ML
    loader when the config asks for it."""
    if isinstance(model_cfg, dict) and model_cfg.get("ml_model_sources"):
        from agentlib_mpc_torch.backends.ml_backend import load_ml_model

        return load_ml_model(model_cfg, dt=dt)
    return load_model(model_cfg, dt=dt)


class OptimizationBackend:
    """Abstract backend. Subclasses implement setup_optimization/solve."""

    def __init__(self, config: dict, device=None,
                 dtype: torch.dtype = torch.float32):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.dtype = dtype
        #: warm starts reset because a solve's iterate was non-finite
        self.warm_start_resets = 0
        self.var_ref: Optional[VariableReference] = None
        self.model: Optional[Model] = None
        self._stats_history: list[dict] = []
        self.logger = logger

    @property
    def stats_history(self) -> list[dict]:
        """Back-compat view of the per-solve stats rows.

        Telemetry is the first-class record now (``solver_*`` metric
        families in :mod:`agentlib_mpc_torch.telemetry`); this property keeps
        the pre-telemetry contract — a mutable list of per-solve dicts with
        the historical key schema (time, iterations, success, kkt_error,
        objective, constraint_violation, solve_wall_time) — for the module
        results writers and existing user code. ``append``/``clear`` on the
        returned list behave exactly as before.
        """
        return self._stats_history

    @staticmethod
    def solver_stats_row(stats, now, wall: float, **extra) -> dict:
        """One solve's ``stats_history`` row from a ``SolverStats`` — the
        single place the key schema lives (time, iterations, success,
        kkt_error, objective, constraint_violation, solve_wall_time,
        kkt_path, jac_path, init_point_source), so the five backends
        cannot drift. ``extra`` appends or overrides (e.g. the MINLP
        two-phase iteration sum)."""
        return {
            "time": float(now),
            "iterations": int(stats.iterations),
            "success": bool(stats.success),
            "kkt_error": float(stats.kkt_error),
            "objective": float(stats.objective),
            "constraint_violation": float(stats.constraint_violation),
            "solve_wall_time": wall,
            "kkt_path": kkt_path_name(getattr(stats, "kkt_path", -1)),
            "jac_path": jac_path_name(getattr(stats, "jac_path", -1)),
            # initial-point provenance (ISSUE 19): legacy/unlabeled
            # stats read as the plain start they are
            "init_point_source": init_point_source_name(
                getattr(stats, "init_point_source", -1)) or "plain",
            **extra,
        }

    def _record_solve(self, stats_row: dict) -> None:
        """Record one solve: stats row (back-compat history), telemetry
        metrics, and — on failure — ONE warning carrying the full stats row
        (iterations / objective / constraint violation included, not just
        the kkt error) plus a ``solver_failures_total{backend=...}``
        increment. All five backends route their ``solve()`` through here.
        """
        if getattr(self, "_suppress_record", False):
            # throwaway solves (precompile warm-up) must not pollute the
            # solver_* families: a 10+ s compile-inclusive sample would
            # dominate solver_solve_seconds and read as a runtime solve.
            # The backend.solve span still records — compile attribution
            # is exactly what a precompile solve is for.
            return
        self._stats_history.append(stats_row)
        backend = type(self).__name__
        m = _SOLVER_METRICS
        if telemetry.enabled():
            m["solves"].inc(backend=backend)
            if "iterations" in stats_row:
                m["iterations"].observe(float(stats_row["iterations"]),
                                        backend=backend)
            if "solve_wall_time" in stats_row:
                m["solve_seconds"].observe(
                    float(stats_row["solve_wall_time"]), backend=backend)
            if "kkt_error" in stats_row:
                m["kkt_error"].set(float(stats_row["kkt_error"]),
                                   backend=backend)
        if not stats_row.get("success", True):
            if telemetry.enabled():
                m["failures"].inc(backend=backend)
            self.logger.warning(
                "%s solve at t=%s did not converge; stats: %s",
                backend, stats_row.get("time"), stats_row)

    def register_logger(self, lg: logging.Logger) -> None:
        """Reference contract: the owning module injects its logger
        (``optimization_backends/backend.py:102-104``)."""
        self.logger = lg

    def health_check(self, result: dict) -> tuple[bool, tuple[str, ...]]:
        """Backend-specific validity hook for one ``solve`` result,
        merged into the actuation guard's assessment (``BaseMPC.do_step``
        passes it as ``ActuationGuard.assess(..., precheck=...)``).

        The generic checks — solver success, finite ``u0``/trajectories,
        control bounds — already run in
        :func:`agentlib_mpc_torch.resilience.guard.check_result`; the base
        hook therefore reports healthy and subclasses override to ADD
        checks only they can make (e.g. a surrogate's trust region, an
        integer schedule's feasibility). Returns ``(healthy, reasons)``;
        every reason becomes a ``mpc_unhealthy_solves_total{reason=...}``
        label."""
        return True, ()

    def problem_fingerprint(self):
        """Structural fingerprint of the transcribed problem this backend
        solves: the admission key of the serving plane
        (``agentlib_mpc_torch/serving/``); an agent process asks its
        backend for it and hands it to
        :meth:`~agentlib_mpc_torch.serving.plane.ServingPlane.join`
        bucketing. Available once ``setup_optimization`` has transcribed
        the OCP (the backends set ``self.ocp``); raises otherwise.
        Memoized per OCP object by the serving layer."""
        ocp = getattr(self, "ocp", None)
        if ocp is None:
            raise RuntimeError(
                "problem_fingerprint() needs a transcribed OCP — call "
                "setup_optimization first (or this backend type does "
                "not expose one)")
        from agentlib_mpc_torch.serving.fingerprint import (
            tenant_fingerprint,
        )

        return tenant_fingerprint(ocp)

    # -- durable warm-start state (beyond reference: its warm starts die
    #    with the process, ``casadi_utils.py:94-101``) ------------------------

    def warm_state(self) -> dict:
        """Snapshot of the warm-start memory every backend keeps (primal
        ``w``, duals ``y``/``z`` as tensors on the backend's device, cold
        flag). Save with
        :func:`agentlib_mpc_torch.utils.checkpoint.save_pytree`; a
        restarted controller restores it via :meth:`set_warm_state` and
        its first solve runs warm instead of paying cold-start
        iterations under a real-time deadline."""
        self._require_warm_state()
        return {"w": self._w_guess, "y": self._y_guess,
                "z": self._z_guess, "cold": bool(self._cold)}

    def _require_warm_state(self) -> None:
        """Distinguish the two no-warm-state conditions: lifecycle error
        (setup_optimization not called yet) vs a backend that genuinely
        keeps no warm-start memory."""
        if hasattr(self, "_w_guess"):
            return
        if self.var_ref is None:
            raise RuntimeError(
                f"{type(self).__name__}: call setup_optimization before "
                f"using warm_state/set_warm_state")
        raise NotImplementedError(
            f"{type(self).__name__} keeps no warm-start state")

    def _carry_warm_start(self, w_next, y_next, z_next, now=None) -> None:
        """Adopt a solve's final iterate as the next warm start — unless
        it is non-finite: carrying a NaN-diverged iterate would make
        EVERY subsequent solve non-finite, so the actuation guard's
        probe mode could never observe a recovery (and a restart would
        re-checkpoint the poison). Resets to the cold start instead,
        like the fused engine's quarantine. One host sync."""
        if bool(torch.isfinite(w_next).all()
                & torch.isfinite(y_next).all()
                & torch.isfinite(z_next).all()):
            self._w_guess, self._y_guess, self._z_guess = \
                w_next, y_next, z_next
            self._cold = False
        else:
            self.logger.warning(
                "solve at t=%s produced non-finite iterates; resetting "
                "warm start", now)
            self.warm_start_resets += 1
            self._reset_warm_start()

    def set_warm_state(self, tree: dict) -> None:
        """Restore a :meth:`warm_state` snapshot (same problem shapes)."""
        self._require_warm_state()
        for key, current in (("w", self._w_guess), ("y", self._y_guess),
                             ("z", self._z_guess)):
            new = tree[key]
            if current.shape != new.shape or current.dtype != new.dtype \
                    or current.device != new.device:
                raise ValueError(
                    f"warm state {key!r} is {tuple(new.shape)}/{new.dtype}/"
                    f"{new.device}, this backend's problem needs "
                    f"{tuple(current.shape)}/{current.dtype}/"
                    f"{current.device} — restore into a "
                    f"backend built from the same config")
        self._w_guess = tree["w"]
        self._y_guess = tree["y"]
        self._z_guess = tree["z"]
        self._cold = bool(tree["cold"])

    def setup_optimization(self, var_ref: VariableReference,
                           time_step: float, prediction_horizon: int) -> None:
        raise NotImplementedError

    def solve(self, now: float, variables: dict[str, Any]) -> dict:
        """variables: name → current value (scalar or trajectory).
        Returns a result dict with at least 'u0' (first controls, by name),
        'traj' (full trajectories), 'stats'."""
        raise NotImplementedError

    def trajectory_layout(self) -> dict[str, list[str]]:
        """Column names of the trajectories this backend's ``solve`` returns
        in ``result["traj"]`` — the contract the module's results writer
        iterates (reference result-format bookkeeping,
        ``discretization.py:398-484``). Keys: "x" (node states), "u"
        (optimized inputs incl. merged couplings), "y" (outputs), "z"
        (algebraic/slack states)."""
        from agentlib_mpc_torch.utils.results import trajectory_layout

        ocp = getattr(self, "ocp", None)
        u = list(ocp.control_names) if ocp is not None \
            else list(self.var_ref.controls)
        return trajectory_layout(self.model, u)

    def get_lags_per_variable(self) -> dict[str, int]:
        """name → number of past samples the backend needs (NARX models;
        reference ``casadi_ml.py:388-397``). Default: none."""
        return {}
