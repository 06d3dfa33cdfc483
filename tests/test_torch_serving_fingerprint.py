"""The port's structural fingerprint and bucket key against the JAX
package's, on the CPU.

``agentlib_mpc_torch/lint/fx/fingerprint.py`` and ``serving/
fingerprint.py`` against ``agentlib_mpc_tpu/lint/jaxpr/fingerprint.py``
and ``serving/fingerprint.py`` (the JAX certifiers through the shim of
``tests/test_torch_certify.py``): the bucket decisions are equal on the
same pairs (two transcriptions of one model, one model at another ``dt``,
a baked number, other solver options, a single-scenario tree against
flat, a fan of 2 against flat), a baked tensor separates the port's
digests, and the fingerprints' ``n_w``, ``m_e``, ``m_h``, ``lq_status``,
``stage_ok`` and ``h_row_stages`` equal the JAX package's on the tracker
and on ``LinearRCZone`` (N=4, degree-2 collocation). The digests
themselves differ between the packages (aten graphs against jaxprs).
"""

import jax.numpy as jnp
import pytest
import torch

from agentlib_mpc_tpu.lint.retrace_budget import tracker_ocp as jtracker_ocp
from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
from agentlib_mpc_tpu.serving import TenantSpec as JSpec
from agentlib_mpc_torch.ops.solver import SolverOptions
from agentlib_mpc_torch.reference_configs import tracker_ocp
from agentlib_mpc_torch.serving import TenantSpec, bucket_key

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


@pytest.fixture(scope="module")
def ocp():
    return tracker_ocp()


@pytest.fixture(scope="module")
def jocp():
    return jtracker_ocp()


def make_spec(ocp, tid, a, **kw):
    kw.setdefault("couplings", {"shared_u": "u"})
    kw.setdefault("solver_options", SolverOptions(max_iter=30))
    return TenantSpec(tenant_id=tid, ocp=ocp,
                      theta=ocp.default_params(
                          device="cpu", dtype=F64,
                          p=torch.tensor([float(a)], dtype=F64)), **kw)


@pytest.fixture(scope="module")
def jax_certifier():
    """The JAX package's ``lint.jaxpr``, runnable on the installed jax
    (``tests/test_torch_certify.py``'s shim: newer jax moved ``Literal``
    out of ``jax.core`` and renamed the ``pjit`` primitive ``jit``)."""
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


def _zone_pair(dt):
    from agentlib_mpc_torch.models import zoo as tzoo
    from agentlib_mpc_torch.ops.transcription import transcribe
    from agentlib_mpc_tpu.models import zoo as jzoo
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtranscribe

    kw = dict(N=4, dt=dt, method="collocation", collocation_degree=2)
    return (transcribe(tzoo.LinearRCZone(), ["Q"], **kw),
            jtranscribe(jzoo.LinearRCZone(), ["Q"], **kw))


def _fingerprints(jlint, t_ocp, j_ocp):
    from agentlib_mpc_torch.lint.fx import structural_fingerprint

    fp_t = structural_fingerprint(
        t_ocp.nlp, t_ocp.default_params(device="cpu", dtype=F64),
        t_ocp.n_w, t_ocp.stage_partition)
    fp_j = jlint.structural_fingerprint(
        j_ocp.nlp, j_ocp.default_params(), j_ocp.n_w,
        j_ocp.stage_partition)
    return fp_t, fp_j


FIELDS = ("n_w", "m_e", "m_h", "lq_status", "stage_ok", "h_row_stages")


@pytest.fixture(scope="module")
def zone_fps(jax_certifier):
    """(port, JAX) fingerprints of two transcriptions of LinearRCZone at
    dt 300 s and one at 600 s, computed once for this file."""
    return {name: _fingerprints(jax_certifier, *_zone_pair(dt))
            for name, dt in (("300", 300.0), ("300b", 300.0),
                             ("600", 600.0))}


def test_fingerprint_fields_equal_the_jax_package(jax_certifier,
                                                  zone_fps):
    for fp_t, fp_j in (_fingerprints(jax_certifier, tracker_ocp(),
                                     jtracker_ocp()), zone_fps["300"]):
        assert {f: getattr(fp_t, f) for f in FIELDS} == \
            {f: getattr(fp_j, f) for f in FIELDS}
        assert fp_t.dtype == "float64" and fp_t.lq_status == "lq"


@pytest.mark.parametrize("other,equal", [("300b", True), ("600", False)])
def test_fingerprint_decisions_equal_the_jax_package(zone_fps, other,
                                                     equal):
    """Equal, or not, in both packages: two transcriptions of one model;
    one model at another dt (a number baked into the graph)."""
    (ta, ja), (tb, jb) = zone_fps["300"], zone_fps[other]
    assert (ta == tb) is equal and (ja == jb) is equal
    assert (ta.digest == tb.digest) is equal


def test_baked_constants_separate_digests():
    """A number the objective bakes in separates the digests in both
    packages (a literal in the jaxpr and in the aten graph's code). A
    baked TENSOR (``_tensor_constant*`` in the aten graph, outside its
    code) separates the port's digests too; the JAX package's jaxpr on
    jax 0.9 names an array constant without its value, so there two such
    objectives digest equal (ROADMAP Queue 3)."""
    from agentlib_mpc_tpu.lint.jaxpr import jaxpr_digest
    from agentlib_mpc_torch.lint.fx import graph_digest

    def fn(c):
        return lambda w, th: ((w[:2] - c) ** 2).sum() * th[0]

    w_t, th_t = torch.zeros(3, dtype=F64), torch.ones(1, dtype=F64)
    w_j, th_j = jnp.zeros(3), jnp.ones(1)
    consts = (2.0, 2.0, 2.5)
    t = [graph_digest(fn(c), w_t, th_t) for c in consts]
    j = [jaxpr_digest(fn(c), w_j, th_j) for c in consts]
    assert t[0] == t[1] != t[2]
    assert j[0] == j[1] != j[2]
    tensors = ([1.0, 2.0], [1.0, 2.0], [1.0, 2.5])
    t = [graph_digest(fn(torch.tensor(c, dtype=F64)), w_t, th_t)
         for c in tensors]
    assert t[0] == t[1] != t[2]


def test_bucket_key_decisions_equal_the_jax_package(ocp, jocp):
    """Theta never enters the key; solver options do; a single-scenario
    tree is the flat bucket."""
    from agentlib_mpc_torch.scenario import fan_tree, single_scenario
    from agentlib_mpc_tpu.scenario import fan_tree as jfan_tree
    from agentlib_mpc_tpu.scenario import single_scenario as jsingle
    from agentlib_mpc_tpu.serving import bucket_key as jbucket_key

    def jspec(tid, a, **kw):
        kw.setdefault("couplings", {"shared_u": "u"})
        kw.setdefault("solver_options", JSO(max_iter=30))
        return JSpec(tenant_id=tid, ocp=jocp,
                     theta=jocp.default_params(p=jnp.array([a])), **kw)

    pairs = [
        (dict(), dict(), True),
        (dict(), dict(solver_options=(SolverOptions(max_iter=50),
                                      JSO(max_iter=50))), False),
        (dict(), dict(tree=(single_scenario(), jsingle())), True),
        (dict(), dict(tree=(fan_tree(2, robust_horizon=1),
                            jfan_tree(2, robust_horizon=1))), False),
    ]
    for kw_a, kw_b, equal in pairs:
        keys = []
        for side in (0, 1):
            kws = []
            for kw in (kw_a, kw_b):
                kw = dict(kw)
                tree = kw.pop("tree", None)
                if "solver_options" in kw:
                    kw["solver_options"] = kw["solver_options"][side]
                if tree is not None:
                    kw["scenario_tree"] = tree[side]
                kws.append(kw)
            if side == 0:
                keys.append([bucket_key(make_spec(ocp, "x", 1.0, **kws[0])),
                             bucket_key(make_spec(ocp, "y", 2.0, **kws[1]))])
            else:
                keys.append([jbucket_key(jspec("x", 1.0, **kws[0])),
                             jbucket_key(jspec("y", 2.0, **kws[1]))])
        (ta, tb), (ja, jb) = keys
        assert (ta == tb) is equal and (ja == jb) is equal
