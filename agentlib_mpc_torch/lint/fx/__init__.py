"""Semantic proofs over aten graphs: the port's certifiers.

Port of the two routing certifiers of ``agentlib_mpc_tpu/lint/jaxpr``:

* :func:`certify_lq` (:mod:`.lq`) — a polynomial-degree lattice proving
  LQ structure *for all theta*; the authority of the QP fast path
  (``ops/qp.py:resolve_qp_routing``).
* :func:`certify_stage_structure` (:mod:`.structure`) — stage dependence
  plus Hessian interactions checked against the partition's
  block-tridiagonal band; the only source of a
  :class:`~agentlib_mpc_torch.ops.stagejac.StageJacobianPlan`.

Both are domains over one abstract interpreter (:mod:`.interp`) that walks
the aten graph ``make_fx`` records in fake mode. :mod:`.fingerprint`
digests the same graphs, with both certificates, into the serving plane's
compile-cache key (:func:`structural_fingerprint`).
"""

from agentlib_mpc_torch.lint.fx.interp import (
    AVal,
    Domain,
    TraceError,
    run_nlp_function,
)
from agentlib_mpc_torch.lint.fx.fingerprint import (
    StructuralFingerprint,
    graph_digest,
    structural_fingerprint,
)
from agentlib_mpc_torch.lint.fx.lq import (
    NONPOLY,
    DegreeDomain,
    LQCertificate,
    certify_lq,
)
from agentlib_mpc_torch.lint.fx.structure import (
    DependenceDomain,
    StructureCertificate,
    certify_stage_structure,
)

__all__ = ["AVal", "DegreeDomain", "DependenceDomain", "Domain",
           "LQCertificate", "NONPOLY", "StructuralFingerprint",
           "StructureCertificate", "TraceError", "certify_lq",
           "certify_stage_structure", "graph_digest", "run_nlp_function",
           "structural_fingerprint"]
