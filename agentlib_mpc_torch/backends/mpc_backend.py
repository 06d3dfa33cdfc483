"""Config translators shared by the backends.

Port of ``agentlib_mpc_tpu/backends/mpc_backend.py:37-108``: reference-style
``discretization_options`` to ``transcribe`` keywords, a solver config to
:class:`SolverOptions`, and the two derived attachments (stage partition,
certified stage-sparse derivative plan). ``JAXBackend`` and the scenario
helpers wait for the backends slice (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

from agentlib_mpc_torch.ops.solver import SolverOptions


def transcription_kwargs_from_config(disc: dict) -> dict:
    """Translate reference-style ``discretization_options`` into
    ``transcribe`` keyword arguments."""
    disc = dict(disc or {})
    if disc.get("method", "collocation") == "multiple_shooting":
        return dict(
            method="multiple_shooting",
            integrator=disc.get("integrator", "rk4"),
            integrator_substeps=int(disc.get("integrator_substeps", 3)),
        )
    return dict(
        method="collocation",
        collocation_degree=int(disc.get("collocation_order", 3)),
        collocation_method=disc.get("collocation_method", "radau"),
    )


def solver_options_from_config(cfg: dict) -> SolverOptions:
    """Translate a reference-style solver config into SolverOptions.
    Unknown keys (e.g. the reference's ipopt-specific options) are ignored
    so existing configs keep working."""
    cfg = dict(cfg or {})
    cfg.pop("name", None)  # reference: solver name (ipopt/fatrop/...)
    cfg.pop("options", None)
    # derived, not config-expressible: attached from the transcribed OCP
    cfg.pop("stage_partition", None)
    cfg.pop("stage_jacobian_plan", None)
    known = SolverOptions._fields
    return SolverOptions(**{k: v for k, v in cfg.items() if k in known})


def attach_stage_partition(options: SolverOptions, ocp) -> SolverOptions:
    """Wire a transcribed OCP's stage partition into solver options, so
    ``kkt_method="auto"`` can route long horizons to the stage sweep."""
    from agentlib_mpc_torch.ops.solver import attach_stage_partition as attach

    return attach(options, getattr(ocp, "stage_partition", None))


def attach_derivative_plan(options: SolverOptions, ocp, nlp=None,
                           theta=None, logger=None,
                           label: "str | None" = None,
                           device=None) -> SolverOptions:
    """Wire the certified stage-sparse derivative plan into solver
    options (``stagejac.attach_plan_if_worthwhile``). Pass ``nlp``/
    ``theta`` for an augmented problem; by default the OCP's own ``nlp``
    is certified at its default parameters on ``device`` (None: the
    card)."""
    from agentlib_mpc_torch.ops import stagejac

    return stagejac.attach_plan_if_worthwhile(
        options, getattr(ocp, "stage_partition", None),
        ocp.nlp if nlp is None else nlp,
        ocp.default_params(device=device) if theta is None else theta,
        ocp.n_w, log=logger, label=label or "the transcribed OCP",
        device=device)
