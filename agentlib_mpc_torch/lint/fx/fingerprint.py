"""Structural fingerprints: the aten graph as a compile-cache key.

Port of ``agentlib_mpc_tpu/lint/jaxpr/fingerprint.py``. The serving plane
(``agentlib_mpc_torch/serving/``) admits a changing tenant population
onto built fused engines. Reusing an engine for a new tenant is sound
exactly when the tenant's problem computes the same graph with only
parameter values differing; this module turns that question into a key:

* **Identity**: SHA-256 digests of the aten graphs of ``f``/``g``/``h``
  that :func:`~agentlib_mpc_torch.lint.fx.interp.trace_nlp_function`
  records at the problem's shapes. ``make_fx`` keeps the tensors a
  function bakes in as ``_tensor_constant*`` attributes whose values are
  not in the graph's code, so their bytes, dtype and shape are hashed
  too: two models that differ only in a baked constant digest apart even
  where every certificate agrees. Two separate transcriptions of one
  model record the same graph and digest equal. The port's digests are
  not the JAX package's (another graph language); the bucket decisions
  they lead to are the same.
* **Proved structure facts**: the LQ verdict (:func:`.lq.certify_lq`) and
  the stage-structure proof (:func:`.structure.certify_stage_structure`),
  which decide how an engine routes the problem (QP fast path,
  stage-sparse derivatives); two problems that would route differently
  never share a cache entry.

The graphs are traced on the CPU in float64, the certifiers' template
convention (``parallel.fused_admm._TEMPLATE_DTYPE``): the fingerprint is
a property of the problem's structure, not of where a tenant runs.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

__all__ = ["StructuralFingerprint", "graph_digest", "structural_fingerprint"]

#: dtype and device of the fingerprint's traces
_TRACE_DTYPE = torch.float64
_TRACE_DEVICE = "cpu"


def _attr(gm, target: str):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def graph_digest(fn, w_template: torch.Tensor, theta) -> str:
    """SHA-256 (truncated to 16 hex chars) of ``fn(w, theta)``'s aten
    graph at the example arguments' shapes and dtypes, with the bytes,
    dtype and shape of every tensor the graph bakes in. Parameter
    (argument) values do not enter."""
    from agentlib_mpc_torch.lint.fx.interp import trace_nlp_function

    gm, _tensors = trace_nlp_function(fn, w_template, theta)
    h = hashlib.sha256(gm.code.encode())
    for node in gm.graph.nodes:
        if node.op != "get_attr":
            continue
        const = _attr(gm, node.target)
        h.update(str(node.target).encode())
        if isinstance(const, torch.Tensor):
            const = const.detach().to("cpu").contiguous()
            h.update(f"{const.dtype}{tuple(const.shape)}".encode())
            h.update(const.view(-1).view(torch.uint8).numpy().tobytes()
                     if const.numel() else b"")
        else:
            h.update(repr(const).encode())
    return h.hexdigest()[:16]


class StructuralFingerprint(NamedTuple):
    """Hashable identity and proved structure facts of one NLP.

    Equal fingerprints mean identical recorded graphs (up to parameter
    values), identical shapes and trace dtype, and identical certified
    routing facts: the conditions for reusing a built engine across
    tenants."""

    #: graph digests of (f, g, h), the load-bearing identity
    f_digest: str
    g_digest: str
    h_digest: str
    #: (n_w, m_e, m_h): the shape bucket
    n_w: int
    m_e: int
    m_h: int
    #: dtype of the decision vector the graphs were recorded at
    dtype: str
    #: LQ certificate status ("lq" / "not_lq" / "unknown")
    lq_status: str
    #: stage-structure proof outcome (None: no partition supplied)
    stage_ok: "bool | None" = None
    #: per-h-row base stages of a proved certificate (else None), the
    #: defining key of the stage-sparse derivative plan
    h_row_stages: "tuple | None" = None

    @property
    def digest(self) -> str:
        """One stable short hex digest over every field: the string the
        serving cache counts hits and misses by."""
        return hashlib.sha256(repr(self).encode()).hexdigest()[:16]

    def describe(self) -> str:
        stage = ("banded" if self.stage_ok
                 else "unproved" if self.stage_ok is not None else "n/a")
        return (f"{self.digest} (n_w={self.n_w}, m_e={self.m_e}, "
                f"m_h={self.m_h}, {self.dtype}, lq={self.lq_status}, "
                f"stage={stage})")


def structural_fingerprint(nlp, theta, n_w: int,
                           partition=None) -> StructuralFingerprint:
    """Fingerprint one NLP: graph digests and certified structure facts.

    ``nlp`` is an :class:`~agentlib_mpc_torch.ops.solver.NLPFunctions`
    triple of ``(w, theta)`` functions; ``theta`` an example parameter
    pytree (values irrelevant, shapes matter; it is moved to the CPU in
    float64 for the traces); ``partition`` the OCP's
    :class:`~agentlib_mpc_torch.ops.stagewise.StagePartition` when one
    exists (the stage proof is skipped without it).

    Certifier failures degrade, never raise: an interpreter error maps to
    ``lq_status="unknown"`` / ``stage_ok=None``, still a valid (more
    conservative) key: two problems whose structure could not be proved
    share an entry only if their graphs digest equal anyway."""
    from torch.utils._pytree import tree_map

    from agentlib_mpc_torch.lint.fx import (
        certify_lq,
        certify_stage_structure,
    )

    theta = tree_map(
        lambda t: (t.to(device=_TRACE_DEVICE, dtype=_TRACE_DTYPE)
                   if isinstance(t, torch.Tensor) and t.is_floating_point()
                   else t), theta)
    w0 = torch.zeros((n_w,), dtype=_TRACE_DTYPE, device=_TRACE_DEVICE)
    f_d = graph_digest(nlp.f, w0, theta)
    g_d = graph_digest(nlp.g, w0, theta)
    h_d = graph_digest(nlp.h, w0, theta)
    with torch.no_grad():
        m_e = int(nlp.g(w0, theta).shape[0])
        m_h = int(nlp.h(w0, theta).shape[0])

    try:
        lq_status = certify_lq(nlp, theta, n_w).status
    except Exception:  # noqa: BLE001 — a certifier bug must not block joins
        lq_status = "unknown"
    stage_ok: "bool | None" = None
    h_row_stages: "tuple | None" = None
    if partition is not None:
        try:
            cert = certify_stage_structure(nlp, theta, n_w, partition)
            stage_ok = bool(cert.ok)
            if cert.ok and cert.h_row_stages is not None:
                h_row_stages = tuple(int(s) for s in cert.h_row_stages)
        except Exception:  # noqa: BLE001
            stage_ok = None
    return StructuralFingerprint(
        f_digest=f_d, g_digest=g_d, h_digest=h_d,
        n_w=int(n_w), m_e=m_e, m_h=m_h,
        dtype=str(w0.dtype).removeprefix("torch."),
        lq_status=lq_status, stage_ok=stage_ok,
        h_row_stages=h_row_stages)
