"""The port's certifiers over aten graphs against the JAX package's.

``agentlib_mpc_torch/lint/fx`` (``certify_lq``, ``certify_stage_structure``
over the graph ``make_fx`` records in fake mode) on the adversarial corpus
of ``tests/test_jaxpr_certifier.py:45-335`` rewritten with torch functions,
on the JAX package's example menu (``lint/jaxpr/examples.EXAMPLE_OCPS``,
whose pinned ``expected_lq`` is the JAX package's verdict) and on the two
fleets' augmented ADMM problems: the verdicts and degrees, the stage
verdicts and ``h_row_stages`` must equal the JAX package's, run on the
same inputs. Also every routing rule of ``ops/qp.py:resolve_qp_routing``
and the sampled probe ``is_lq`` against the JAX package's.

The JAX certifiers run through a shim (:func:`jax_certifier`): newer jax
moved ``Literal`` out of ``jax.core`` and renamed the ``pjit`` primitive
``jit``; the shim adds the old spellings for this module only and changes
nothing where the old ones exist.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.lint.jaxpr.examples import EXAMPLE_OCPS, _ENTRY_SPECS
from agentlib_mpc_tpu.ops import qp as jqp
from agentlib_mpc_tpu.ops.solver import NLPFunctions as JNLP
from agentlib_mpc_torch.lint.fx import (
    LQCertificate,
    certify_lq,
    certify_stage_structure,
)
from agentlib_mpc_torch.models import zoo as tzoo
from agentlib_mpc_torch.ops.qp import is_lq, resolve_qp_routing
from agentlib_mpc_torch.ops.solver import NLPFunctions
from agentlib_mpc_torch.ops.stagewise import stage_of_index
from agentlib_mpc_torch.ops.transcription import transcribe

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
_N = 3  # primal dimension of the handcrafted corpus


@pytest.fixture(scope="module")
def jax_certifier():
    """The JAX package's ``lint.jaxpr`` module, runnable on the installed
    jax (see the module docstring)."""
    import jax.core
    from jax._src import core as jcore

    from agentlib_mpc_tpu.lint import jaxpr as jlint
    from agentlib_mpc_tpu.lint.jaxpr import interp as jinterp

    mp = pytest.MonkeyPatch()
    if not hasattr(jax.core, "Literal"):
        mp.setattr(jax.core, "Literal", jcore.Literal, raising=False)
    eqn = jinterp._Interpreter.eqn

    def eqn_with_jit(self, e, args):
        if e.primitive.name == "jit" and "jaxpr" in e.params:
            return self.run(e.params["jaxpr"], args)
        return eqn(self, e, args)

    mp.setattr(jinterp._Interpreter, "eqn", eqn_with_jit)
    yield jlint
    mp.undo()


def _tnlp(f=None, g=None, h=None):
    return NLPFunctions(f=f or (lambda w, th: w.sum() * 0.0),
                        g=g or (lambda w, th: w[:0] * 0.0),
                        h=h or (lambda w, th: w[:0] * 0.0))


def _jnlp(f=None, g=None, h=None):
    return JNLP(f=f or (lambda w, th: jnp.sum(w) * 0.0),
                g=g or (lambda w, th: jnp.zeros((0,))),
                h=h or (lambda w, th: jnp.zeros((0,))))


# the adversarial corpus, once per framework: (torch nlp, jax nlp, theta)
CORPUS = {
    # the VERDICT hazard: theta=0 picks the quadratic branch, so the probe
    # certifies, while any theta > 0 activates sin(w)
    "theta_gated_nonlinearity": (
        lambda: _tnlp(f=lambda w, th: torch.where(
            th > 0.0, torch.sin(w).sum(), (w * w).sum())),
        lambda: _jnlp(f=lambda w, th: jnp.where(
            th > 0.0, jnp.sum(jnp.sin(w)), jnp.sum(w * w))),
        0.0),
    "theta_gated_both_lq": (
        lambda: _tnlp(f=lambda w, th: torch.where(
            th > 0.0, (w * w).sum(), 2.0 * (w * w).sum() + w.sum())),
        lambda: _jnlp(f=lambda w, th: jnp.where(
            th > 0.0, jnp.sum(w * w), 2.0 * jnp.sum(w * w) + jnp.sum(w))),
        0.0),
    "proper_lq_program": (
        lambda: _tnlp(f=lambda w, th: 0.5 * (w @ w) + th @ w,
                      g=lambda w, th: torch.stack([w[0] + 2.0 * w[1]
                                                   - th[0]]),
                      h=lambda w, th: w - 1.0),
        lambda: _jnlp(f=lambda w, th: 0.5 * jnp.dot(w, w) + jnp.dot(th, w),
                      g=lambda w, th: jnp.asarray([w[0] + 2.0 * w[1]
                                                   - th[0]]),
                      h=lambda w, th: w - 1.0),
        np.zeros(_N)),
    "cubic_objective": (
        lambda: _tnlp(f=lambda w, th: (w ** 3).sum()),
        lambda: _jnlp(f=lambda w, th: jnp.sum(w ** 3)),
        0.0),
    "quadratic_constraint": (
        lambda: _tnlp(g=lambda w, th: torch.stack([w @ w - 1.0])),
        lambda: _jnlp(g=lambda w, th: jnp.asarray([jnp.dot(w, w) - 1.0])),
        0.0),
    "theta_nonlinearity_stays_lq": (
        lambda: _tnlp(f=lambda w, th: torch.exp(th) * (w * w).sum()
                      + torch.sin(th)),
        lambda: _jnlp(f=lambda w, th: jnp.exp(th) * jnp.sum(w * w)
                      + jnp.sin(th)),
        0.3),
    "square_is_degree_two": (
        lambda: _tnlp(f=lambda w, th: torch.square(w).sum()),
        lambda: _jnlp(f=lambda w, th: jnp.sum(jnp.square(w))),
        0.0),
    "loop_accumulated_quadratic": (
        lambda: _tnlp(f=lambda w, th: sum((wi * wi for wi in w),
                                          0.0 * w[0])),
        lambda: _jnlp(f=lambda w, th: jax.lax.scan(
            lambda c, wi: (c + wi * wi, None), 0.0 * w[0], w)[0]),
        0.0),
}


def _certs(jlint, key):
    t_fn, j_fn, theta = CORPUS[key]
    th = np.asarray(theta, dtype=np.float64)
    tc = certify_lq(t_fn(), torch.as_tensor(th), _N)
    jc = jlint.certify_lq(j_fn(), jnp.asarray(th), _N)
    return tc, jc


def _degrees(c):
    return (c.status, c.objective_degree, c.eq_degree, c.ineq_degree)


@pytest.mark.parametrize("key", sorted(CORPUS))
def test_corpus_verdicts_and_degrees_match_jax(jax_certifier, key):
    tc, jc = _certs(jax_certifier, key)
    assert _degrees(tc) == _degrees(jc), (tc.describe(), jc.describe())


@pytest.mark.parametrize("key,status,degrees", [
    ("theta_gated_nonlinearity", "not_lq", None),
    ("theta_gated_both_lq", "lq", (2, 0, 0)),
    ("proper_lq_program", "lq", (2, 1, 1)),
    ("cubic_objective", "not_lq", (3, 0, 0)),
    ("quadratic_constraint", "not_lq", None),
    ("theta_nonlinearity_stays_lq", "lq", None),
    ("square_is_degree_two", "lq", (2, 0, 0)),
    ("loop_accumulated_quadratic", "lq", (2, 0, 0)),
])
def test_corpus_verdicts_pinned(key, status, degrees):
    """The JAX package's own pins (tests/test_jaxpr_certifier.py), held
    without running the JAX certifier."""
    t_fn, _, theta = CORPUS[key]
    cert = certify_lq(t_fn(), torch.as_tensor(np.asarray(theta, float)), _N)
    assert cert.status == status
    assert cert.proved_lq == (status == "lq")
    if degrees is not None:
        assert (cert.objective_degree, cert.eq_degree,
                cert.ineq_degree) == degrees


def test_probe_falsely_certifies_the_gated_case_like_jax():
    """Precondition of the VERDICT case: the sampled probe sees only the
    default-theta branch — in both frameworks."""
    t_fn, j_fn, _ = CORPUS["theta_gated_nonlinearity"]
    assert is_lq(t_fn(), torch.tensor(0.0, dtype=F64), _N)
    assert jqp.is_lq(j_fn(), jnp.asarray(0.0), _N)


@pytest.mark.parametrize("case", ["item", "data_branch", "unregistered_op"])
def test_opaque_functions_are_unknown(case):
    """What the graph cannot show (``.item()``, a Python branch on data,
    an op outside the registry on ``w``) gives "unknown", never "lq" — the
    JAX package's pure_callback row."""
    f = {
        "item": lambda w, th: (w * w).sum() * w.sum().item(),
        "data_branch": lambda w, th: (w * w * w).sum()
        if bool(w[0] > 0) else w.sum(),
        "unregistered_op": lambda w, th: torch.sort(w).values[0] * w.sum(),
    }[case]
    cert = certify_lq(_tnlp(f=f), torch.tensor(0.0, dtype=F64), _N)
    assert cert.status == "unknown"
    assert cert.opaque


def test_untainted_unregistered_op_keeps_precision():
    """An op outside the registry fed only theta cannot carry w
    dependence (an aten op is a pure function of its inputs)."""
    f = lambda w, th: torch.sort(th).values.sum() * (w * w).sum()
    cert = certify_lq(_tnlp(f=f), torch.arange(3.0, dtype=F64), _N)
    assert cert.status == "lq"


def test_detach_is_stop_gradient():
    """``detach`` cuts the AD path the solvers extract through."""
    f = lambda w, th: (w * w).sum() + torch.sin(w).detach().sum()
    assert certify_lq(_tnlp(f=f), torch.tensor(0.0, dtype=F64),
                      _N).status == "lq"


# --------------------------------------------------------------------------
# the routing seam: certificate is the authority, probe demoted
# --------------------------------------------------------------------------

def _cert(status):
    return LQCertificate(status=status, objective_degree=2, eq_degree=1,
                         ineq_degree=1)


def test_routing_certified_lq_runs_probe_once_as_cross_check():
    probed = []

    def probe():
        probed.append(1)
        return True
    assert resolve_qp_routing("auto", probe,
                              certifier=lambda: _cert("lq")) is True
    assert probed == [1]


def test_routing_refuted_skips_probe():
    probed = []

    def probe():
        probed.append(1)
        return True
    assert resolve_qp_routing("auto", probe,
                              certifier=lambda: _cert("not_lq")) is False
    assert probed == []


def test_routing_probe_disagreement_blocks(caplog):
    with caplog.at_level(logging.WARNING):
        routed = resolve_qp_routing(
            "auto", lambda: False, certifier=lambda: _cert("lq"),
            logger=logging.getLogger("test.qp"), label="the corpus")
    assert routed is False
    assert "DISAGREE" in caplog.text


def test_routing_unknown_falls_back_to_probe_loudly(caplog):
    with caplog.at_level(logging.WARNING):
        routed = resolve_qp_routing(
            "auto", lambda: True, certifier=lambda: _cert("unknown"),
            logger=logging.getLogger("test.qp"), label="the corpus")
    assert routed is True
    assert "inconclusive" in caplog.text


def test_routing_raising_certifier_falls_back_to_probe_loudly(caplog):
    def certifier():
        raise RuntimeError("interpreter exploded")
    with caplog.at_level(logging.WARNING):
        routed = resolve_qp_routing("auto", lambda: True,
                                    certifier=certifier,
                                    logger=logging.getLogger("test.qp"))
    assert routed is True
    assert "falling back to the sampled probe" in caplog.text


def test_routing_on_off_run_neither():
    boom = lambda: (_ for _ in ()).throw(AssertionError("ran"))
    assert resolve_qp_routing("on", boom, certifier=boom) is True
    assert resolve_qp_routing("off", boom, certifier=boom) is False
    with pytest.raises(ValueError, match="qp_fast_path"):
        resolve_qp_routing("maybe", boom)


@pytest.mark.parametrize("status,probe,expected", [
    ("lq", True, True), ("lq", False, False), ("not_lq", True, False),
    ("unknown", True, True), ("unknown", False, False), (None, True, True),
    (None, False, False)])
def test_routing_rules_match_jax(status, probe, expected):
    cert_t = None if status is None else (lambda: _cert(status))
    cert_j = None if status is None else (
        lambda: jqp_cert(status))
    got = resolve_qp_routing("auto", lambda: probe, certifier=cert_t)
    ref = jqp.resolve_qp_routing("auto", lambda: probe, certifier=cert_j)
    assert got == ref == expected


def jqp_cert(status):
    from agentlib_mpc_tpu.lint.jaxpr.lq import LQCertificate as JCert

    return JCert(status=status, objective_degree=2, eq_degree=1,
                 ineq_degree=1)


def test_end_to_end_verdict_case_not_routed():
    """The probe alone would route the theta-gated entry to the QP fast
    path; with the certifier attached, auto-routing refuses."""
    t_fn, _, _ = CORPUS["theta_gated_nonlinearity"]
    nlp, theta = t_fn(), torch.tensor(0.0, dtype=F64)
    probe = lambda: is_lq(nlp, theta, _N)
    assert resolve_qp_routing("auto", probe) is True
    assert resolve_qp_routing(
        "auto", probe, certifier=lambda: certify_lq(nlp, theta, _N)) is False


# --------------------------------------------------------------------------
# the example menu and the fleets' augmented problems
# --------------------------------------------------------------------------

def _menu_pair(name):
    from agentlib_mpc_tpu.lint.jaxpr.examples import build_example

    model_cls, controls, kw = _ENTRY_SPECS[name]
    tocp = transcribe(getattr(tzoo, model_cls)(), controls, N=4, dt=300.0,
                      **kw)
    return tocp, build_example(name)


@pytest.mark.parametrize("name", [ex.name for ex in EXAMPLE_OCPS])
def test_menu_certificates_match_jax(jax_certifier, name):
    expected = next(ex.expected_lq for ex in EXAMPLE_OCPS if ex.name == name)
    tocp, jocp = _menu_pair(name)
    th = tocp.default_params(device="cpu", dtype=F64)
    jth = jocp.default_params()
    tc = certify_lq(tocp.nlp, th, tocp.n_w)
    jc = jax_certifier.certify_lq(jocp.nlp, jth, jocp.n_w)
    assert tc.status == expected
    assert _degrees(tc) == _degrees(jc), (tc.describe(), jc.describe())
    ts = certify_stage_structure(tocp.nlp, th, tocp.n_w,
                                 tocp.stage_partition)
    js = jax_certifier.certify_stage_structure(jocp.nlp, jth, jocp.n_w,
                                               jocp.stage_partition)
    assert ts.ok and js.ok, (ts.describe(), js.describe())
    assert ts.h_row_stages == js.h_row_stages
    # the same rows from the dense Jacobian's sparsity at a random point
    w = torch.as_tensor(np.random.default_rng(0).normal(size=tocp.n_w))
    Jh = torch.func.jacrev(lambda ww: tocp.nlp.h(ww, th))(w)
    stage_of = stage_of_index(tocp.stage_partition)[:tocp.n_w]
    first = [int(stage_of[np.nonzero(row)[0]].min()) if row.any() else 0
             for row in Jh.numpy() != 0]
    assert list(ts.h_row_stages) == first


@pytest.mark.parametrize("model,expected", [("linear", "lq"),
                                            ("zone", "not_lq")])
def test_fleet_augmented_problems(jax_certifier, model, expected):
    """What chip_smoke prints: the linear fleet's augmented problem proves
    lq, the zone fleet's refutes — as the JAX package says of the same
    augmented problem built from bench.py's OCPs."""
    import bench
    from agentlib_mpc_torch.parallel import admm_step

    ocp = admm_step.MODELS[model][0]()
    N = ocp.N
    theta = admm_step.augmented_theta(ocp, model, "cpu", F64)
    nlp = admm_step.augmented_nlp(ocp)
    jocp = bench._MODELS[model][0]()
    _, _, zbar0, rho0 = bench._MODELS[model]
    jtheta = (jocp.default_params(), jnp.full((N, 1), zbar0),
              jnp.zeros((N, 1)), jnp.asarray(rho0))
    jnlp = JNLP(
        f=lambda w, t: jocp.nlp.f(w, t[0]) + 0.5 * t[3] * jnp.sum(
            (jocp.unflatten(w)["u"] - t[1] + t[2]) ** 2),
        g=lambda w, t: jocp.nlp.g(w, t[0]), h=lambda w, t: jocp.nlp.h(w, t[0]))
    tc = certify_lq(nlp, theta, ocp.n_w)
    jc = jax_certifier.certify_lq(jnlp, jtheta, jocp.n_w)
    assert tc.status == expected
    assert _degrees(tc) == _degrees(jc)
    probe = lambda: is_lq(nlp, theta, ocp.n_w)
    assert resolve_qp_routing("auto", probe, certifier=lambda: tc) is \
        (expected == "lq")


# --------------------------------------------------------------------------
# stage-structure refusals (the JAX package's TestStageStructure)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def colloc_d1():
    ocp = transcribe(tzoo.LinearRCZone(), ["Q"], N=4, dt=300.0,
                     method="collocation", collocation_degree=1)
    return ocp, ocp.default_params(device="cpu", dtype=F64)


def test_mispermuted_partition_rejected(colloc_d1):
    ocp, th = colloc_d1
    p = ocp.stage_partition
    perm = list(p.perm)
    a, b = 0, 3 * p.block
    perm[a], perm[b] = perm[b], perm[a]
    cert = certify_stage_structure(ocp.nlp, th, ocp.n_w,
                                   p._replace(perm=tuple(perm)))
    assert not cert.ok and cert.violations


def test_out_of_band_coupling_rejected(colloc_d1):
    ocp, th = colloc_d1
    nlp = NLPFunctions(f=ocp.nlp.f,
                       g=lambda w, t: torch.stack([w[0] * w[ocp.n_w - 1]]),
                       h=ocp.nlp.h)
    cert = certify_stage_structure(nlp, th, ocp.n_w, ocp.stage_partition)
    assert not cert.ok
    assert any("Hessian interaction" in v or "g[0]" in v
               for v in cert.violations)


def test_partition_nw_mismatch_raises(colloc_d1):
    ocp, th = colloc_d1
    for bad_nw in (2, ocp.n_w + 1):
        small = ocp.stage_partition._replace(n_w=bad_nw)
        with pytest.raises(ValueError, match="partition covers"):
            certify_stage_structure(ocp.nlp, th, ocp.n_w, small)


@pytest.mark.parametrize("case", ["item", "data_branch"])
def test_opaque_function_is_not_banded(colloc_d1, case):
    """``.item()`` records as an opaque scalar that smears to every stage
    it saw; a Python branch on data cannot be recorded at all."""
    ocp, th = colloc_d1
    f = {"item": lambda w, t: w.sum() * w.sum().item(),
         "data_branch": lambda w, t: w.sum() if bool(w[0] > 0)
         else w[0]}[case]
    nlp = NLPFunctions(f=f, g=ocp.nlp.g, h=ocp.nlp.h)
    cert = certify_stage_structure(nlp, th, ocp.n_w, ocp.stage_partition)
    assert not cert.ok and cert.opaque
    if case == "data_branch":
        assert cert.opaque == ("interpreter-error",)
        assert cert.h_row_stages is None


def test_certifying_first_leaves_lazy_caches_real():
    """The transcription fills its constant cache per (dtype, device) on
    first use. Certifying before any real call in that dtype (what
    build_step does on the card in f32) must leave real tensors there,
    not the trace's fake ones."""
    from torch._subclasses.fake_tensor import FakeTensor

    ocp = transcribe(tzoo.LinearRCZone(), ["Q"], N=3, dt=300.0,
                     method="collocation", collocation_degree=2)
    th = ocp.default_params(device="cpu", dtype=torch.float32)
    assert certify_lq(ocp.nlp, th, ocp.n_w).status == "lq"
    w = torch.zeros(ocp.n_w, dtype=torch.float32)
    for fn in ocp.nlp:
        out = fn(w, th)
        assert not isinstance(out, FakeTensor)
        assert bool(torch.isfinite(out).all())
