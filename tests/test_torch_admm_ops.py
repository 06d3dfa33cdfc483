"""The port's ADMM operators and the fused fleet's helpers against the JAX
package, on the CPU in float64.

Every function of ``agentlib_mpc_torch/ops/admm.py`` runs on the same
seeded numpy inputs as its counterpart in ``agentlib_mpc_tpu/ops/admm.py``,
with and without ``active`` masks, and must agree to 1e-12 (the same
arithmetic in float64; only the order of a few sums can differ). Also:
``bucket_agents``, ``pad_group_to_devices``, ``routed_groups``,
``stack_params`` against the JAX package's; every ``ValueError`` and
``NotImplementedError`` of the ``FusedADMM`` constructor and of
``step``; the config translators and model loading of ``backends/``
against the JAX package's; the port's checkpoint format (atomic
replace, crash-recovery siblings, refusal of a mismatched restore); and
the ``utils/convert.py`` carriers of the fused state.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.backends import backend as jbackend
from agentlib_mpc_tpu.backends import mpc_backend as jmpc
from agentlib_mpc_tpu.ops import admm as jadmm
from agentlib_mpc_tpu.parallel import fused_admm as jfa
from agentlib_mpc_torch.backends import backend as tbackend
from agentlib_mpc_torch.backends import mpc_backend as tmpc
from agentlib_mpc_torch.models import zoo as tzoo
from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.objective import SubObjective
from agentlib_mpc_torch.models.variables import control_input, parameter
from agentlib_mpc_torch.ops import admm as tadmm
from agentlib_mpc_torch.ops.solver import SolverOptions
from agentlib_mpc_torch.ops.transcription import transcribe
from agentlib_mpc_torch.parallel import fused_admm as tfa
from agentlib_mpc_torch.utils import checkpoint as ckpt
from agentlib_mpc_torch.utils.convert import (
    fused_state_from_numpy,
    iteration_stats_from_numpy,
    theta_batches_from_numpy,
    to_numpy,
)

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
#: float64, same arithmetic; only summation order may differ
TOL = 1e-12


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(port, ref, tol=TOL):
    ref = np.asarray(ref, dtype=float)
    np.testing.assert_allclose(np.asarray(port, dtype=float), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(initial=0.0),
                                              1.0))


def residuals_close(port, ref):
    for a, b in zip(port, ref):
        close(a, b)


def masks(n):
    rng = np.random.default_rng(n)
    m = rng.random(n) > 0.4
    m[0] = True
    return [None, m]


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("shape", [(5, 4), (3, 2, 4)], ids=["T", "KxT"])
def test_consensus_update_matches_jax(rng, masked, shape):
    x = rng.normal(size=shape)
    zbar = rng.normal(size=shape[1:])
    lam = rng.normal(size=shape)
    active = masks(shape[0])[masked]
    jnew, jres = jadmm.consensus_update(
        jnp.asarray(x), jadmm.ConsensusState(jnp.asarray(zbar),
                                             jnp.asarray(lam),
                                             jnp.asarray(2.5)),
        active=None if active is None else jnp.asarray(active))
    tnew, tres = tadmm.consensus_update(
        t(x), tadmm.ConsensusState(t(zbar), t(lam), t(2.5)),
        active=None if active is None else torch.as_tensor(active))
    close(tnew.zbar, jnew.zbar)
    close(tnew.lam, jnew.lam)
    residuals_close(tres, jres)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_exchange_update_matches_jax(rng, masked):
    x = rng.normal(size=(6, 5))
    mean, diff, lam = (rng.normal(size=5), rng.normal(size=(6, 5)),
                       rng.normal(size=5))
    active = masks(6)[masked]
    jnew, jres = jadmm.exchange_update(
        jnp.asarray(x), jadmm.ExchangeState(jnp.asarray(mean),
                                            jnp.asarray(diff),
                                            jnp.asarray(lam),
                                            jnp.asarray(1.5)),
        active=None if active is None else jnp.asarray(active))
    tnew, tres = tadmm.exchange_update(
        t(x), tadmm.ExchangeState(t(mean), t(diff), t(lam), t(1.5)),
        active=None if active is None else torch.as_tensor(active))
    for name in ("mean", "diff", "lam", "rho"):
        close(getattr(tnew, name), getattr(jnew, name))
    residuals_close(tres, jres)
    if masked:
        # masked-out agents keep their diff
        off = ~np.asarray(active)
        np.testing.assert_array_equal(tnew.diff.numpy()[off], diff[off])


def _residuals(rng):
    return [tuple(abs(rng.normal(size=4))) + (4.0 + k, 8.0 + k)
            for k in range(3)]


def test_combine_residuals_matches_jax(rng):
    rows = _residuals(rng)
    j = jadmm.combine_residuals(*(jadmm.AdmmResiduals(
        *(jnp.asarray(v) for v in r)) for r in rows))
    tt = tadmm.combine_residuals(*(tadmm.AdmmResiduals(
        *(t(v) for v in r)) for r in rows))
    residuals_close(tt, j)


@pytest.mark.parametrize("relative", [True, False])
def test_converged_matches_jax(rng, relative):
    for scale in (1e-5, 1e-3, 1e-1, 10.0):
        r = tuple(scale * abs(rng.normal(size=2))) + \
            tuple(abs(rng.normal(size=2))) + (40.0, 40.0)
        j = jadmm.converged(jadmm.AdmmResiduals(*(jnp.asarray(v) for v in r)),
                            use_relative=relative)
        tt = tadmm.converged(tadmm.AdmmResiduals(*(t(v) for v in r)),
                             use_relative=relative)
        assert bool(tt) == bool(j)


@pytest.mark.parametrize("threshold", [-1.0, 1.0, 2.0, 10.0])
def test_vary_penalty_matches_jax(threshold):
    for primal, dual in ((1.0, 0.01), (0.01, 1.0), (1.0, 1.0)):
        r = (primal, dual, 1.0, 1.0, 4.0, 4.0)
        j = jadmm.vary_penalty(jnp.asarray(3.0), jadmm.AdmmResiduals(
            *(jnp.asarray(v) for v in r)), threshold=threshold, factor=2.0)
        tt = tadmm.vary_penalty(t(3.0), tadmm.AdmmResiduals(
            *(t(v) for v in r)), threshold=threshold, factor=2.0)
        close(tt, j)


@pytest.mark.parametrize("shape,horizon", [((7,), 7), ((3, 12), 6),
                                            ((2, 2, 5), 5)])
def test_shift_one_matches_jax(rng, shape, horizon):
    x = rng.normal(size=shape)
    close(tadmm.shift_one(t(x), horizon), jadmm.shift_one(jnp.asarray(x),
                                                          horizon))


@pytest.mark.parametrize("kind", ["consensus", "exchange"])
def test_penalties_match_jax(rng, kind):
    x, target, lam = (rng.normal(size=6) for _ in range(3))
    jf = getattr(jadmm, f"{kind}_penalty")
    tf = getattr(tadmm, f"{kind}_penalty")
    close(tf(t(x), t(target), t(lam), t(0.7)),
          jf(jnp.asarray(x), jnp.asarray(target), jnp.asarray(lam),
             jnp.asarray(0.7)))


# ---- fused-engine helpers ---------------------------------------------------

class Tracker(Model):
    inputs = [control_input("u", 0.0, lb=-5.0, ub=5.0)]
    parameters = [parameter("a", 1.0)]

    def setup(self, v):
        eq = ModelEquations()
        eq.objective = SubObjective((v.u - v.a) ** 2, name="track")
        return eq


@pytest.fixture(scope="module")
def tracker_ocp():
    return transcribe(Tracker(), ["u"], N=3, dt=300.0,
                      method="multiple_shooting")


@pytest.fixture(scope="module")
def jtracker():
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
    from conftest import make_tracker_model

    return jtr(make_tracker_model(lb=-5.0, ub=5.0)(), ["u"], N=3, dt=300.0,
               method="multiple_shooting")


def theta(ocp, a):
    return ocp.default_params(device="cpu", dtype=F64,
                              p=torch.tensor([a], dtype=F64))


SOLVER = SolverOptions(tol=1e-8, max_iter=20)


def engine(ocp, n=2, **kw):
    group = tfa.AgentGroup(name="g", ocp=ocp, n_agents=n,
                           couplings={"c": "u"}, solver_options=SOLVER)
    return tfa.FusedADMM([group], tfa.FusedADMMOptions(max_iterations=3),
                         device="cpu", **kw)


def test_stack_params_matches_jax(tracker_ocp, jtracker):
    port = tfa.stack_params([theta(tracker_ocp, a) for a in (1.0, 2.0)])
    ref = jfa.stack_params([jtracker.default_params(p=jnp.array([a]))
                            for a in (1.0, 2.0)])
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_bucket_agents_matches_jax(tracker_ocp, jtracker):
    from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
    from conftest import make_tracker_model

    other = transcribe(Tracker(), ["u"], N=3, dt=300.0,
                       method="multiple_shooting")
    jother = jtr(make_tracker_model()(), ["u"], N=3, dt=300.0,
                 method="multiple_shooting")
    layout = [("a", 0, {"c": "u"}, {}, 1.0), ("b", 0, {"c": "u"}, {}, 2.0),
              ("c", 1, {"c": "u"}, {}, 3.0), ("d", 0, {}, {"e": "u"}, 4.0),
              ("e", 0, {"c": "u"}, {}, 5.0)]

    def specs(ocps, so, th):
        return [{"name": n, "ocp": ocps[o], "couplings": c, "exchanges": e,
                 "theta": th(ocps[o], a), "solver_options": so}
                for n, o, c, e, a in layout]

    tg, tth, tmap = tfa.bucket_agents(specs((tracker_ocp, other), SOLVER,
                                            theta))
    jg, jth, jmap = jfa.bucket_agents(specs(
        (jtracker, jother), JSO(tol=1e-8, max_iter=20),
        lambda o, a: o.default_params(p=jnp.array([a]))))
    assert tmap == jmap == [[0, 1, 4], [2], [3]]
    assert [(g.name, g.n_agents, g.couplings, g.exchanges) for g in tg] == \
        [(g.name, g.n_agents, g.couplings, g.exchanges) for g in jg]
    for a, b in zip(tth, jth):
        np.testing.assert_array_equal(a.p.numpy(), np.asarray(b.p))


@pytest.mark.parametrize("n,devices", [(3, 4), (4, 4), (5, 2), (1, 8)])
def test_pad_group_to_devices_matches_jax(tracker_ocp, jtracker, n, devices):
    from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO

    targets = [float(a) for a in range(n)]
    tgroup = tfa.AgentGroup(name="g", ocp=tracker_ocp, n_agents=n,
                            couplings={"c": "u"}, solver_options=SOLVER)
    jgroup = jfa.AgentGroup(name="g", ocp=jtracker, n_agents=n,
                            couplings={"c": "u"}, solver_options=JSO())
    tp, tth, tmask = tfa.pad_group_to_devices(
        tgroup, tfa.stack_params([theta(tracker_ocp, a) for a in targets]),
        devices)
    jp, jth, jmask = jfa.pad_group_to_devices(
        jgroup, jfa.stack_params([jtracker.default_params(p=jnp.array([a]))
                                  for a in targets]), devices)
    assert tp.n_agents == jp.n_agents
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for name in jth._fields:
        np.testing.assert_array_equal(getattr(tth, name).numpy(),
                                      np.asarray(getattr(jth, name)))


def test_routed_groups_force_the_resolved_routing(tracker_ocp):
    eng = engine(tracker_ocp)
    assert eng.group_uses_qp == (True,)
    (g,) = eng.routed_groups()
    assert g.qp_fast_path == "on"
    again = tfa.FusedADMM([dataclasses.replace(g, qp_fast_path="off")],
                          eng.options, device="cpu")
    assert again.routed_groups()[0].qp_fast_path == "off"


def test_participant_offsets(tracker_ocp):
    groups = [tfa.AgentGroup(name=n, ocp=tracker_ocp, n_agents=k,
                             couplings={"c": "u"}, solver_options=SOLVER)
              for n, k in (("a", 2), ("b", 3))]
    groups.append(tfa.AgentGroup(name="x", ocp=tracker_ocp, n_agents=1,
                                 exchanges={"e": "u"}, solver_options=SOLVER))
    eng = tfa.FusedADMM(groups, tfa.FusedADMMOptions(),
                        device="cpu")
    assert eng.participant_offset("c", "consensus", 1) == 2
    assert eng._participant_count("c", "consensus") == 5
    assert eng.participant_offset("e", "exchange", 2) == 0
    with pytest.raises(KeyError):
        eng.participant_offset("c", "consensus", 2)


def test_pad_state_rows_repeats_the_last_lane(tracker_ocp):
    eng = engine(tracker_ocp)
    ths = tfa.stack_params([theta(tracker_ocp, a) for a in (1.0, 2.0)])
    state = eng.init_state([ths])
    padded, (pth,) = eng.pad_state_rows({0: 2}, state, [ths])
    assert padded.w[0].shape[0] == 4 and pth.p.shape[0] == 4
    assert torch.equal(padded.w[0][3], state.w[0][1])
    assert torch.equal(padded.lam["c"][0][2], state.lam["c"][0][1])
    none, (only,) = eng.pad_state_rows({0: 1}, None, [ths])
    assert none is None and only.p.shape[0] == 3


# ---- constructor and step validation ----------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    ({"active": [torch.ones(3, dtype=torch.bool)]}, "shape"),
    ({"active": []}, "masks for 1 groups"),
    ({"collective_certify": "maybe"}, "collective_certify"),
    ({"memory_certify": "x"}, "memory_certify"),
    ({"dispatch_certify": "x"}, "dispatch_certify"),
    ({"precision_certify": "x"}, "precision_certify"),
    ({"watchdog_timeout_s": 1.0, "donate_state": True}, "donate_state"),
], ids=["mask-shape", "mask-count", "collective", "memory", "dispatch",
        "precision", "watchdog-donate"])
def test_constructor_value_errors(tracker_ocp, kwargs, match):
    with pytest.raises(ValueError, match=match):
        engine(tracker_ocp, **kwargs)


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": object()}, "item 5"),
    ({"watchdog_timeout_s": 1.0}, "item 5"),
    ({"warmstart": object()}, "item 5"),
    ({"collective_certify": "require"}, "item 7"),
    ({"memory_certify": "require"}, "item 7"),
    ({"dispatch_certify": "require"}, "item 7"),
    ({"precision_certify": "require"}, "item 7"),
], ids=["mesh", "watchdog", "warmstart", "collective", "memory",
        "dispatch", "precision"])
def test_unported_features_raise(tracker_ocp, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        engine(tracker_ocp, **kwargs)


@pytest.mark.parametrize("opts,error", [
    ({"fusion": "require"}, NotImplementedError),
    ({"precision": "mixed"}, NotImplementedError),
    ({"precision": "require"}, NotImplementedError),
    ({"precision": "fast"}, ValueError),
])
def test_group_solver_options_that_need_certifiers(tracker_ocp, opts, error):
    group = tfa.AgentGroup(name="g", ocp=tracker_ocp, n_agents=1,
                           couplings={"c": "u"},
                           solver_options=SOLVER._replace(**opts))
    with pytest.raises(error):
        tfa.FusedADMM([group], device="cpu")


def test_structural_value_errors(tracker_ocp):
    short = transcribe(Tracker(), ["u"], N=2, dt=300.0,
                       method="multiple_shooting")
    mk = lambda name, ocp, **kw: tfa.AgentGroup(
        name=name, ocp=ocp, n_agents=1, solver_options=SOLVER, **kw)
    with pytest.raises(ValueError, match="one horizon"):
        tfa.FusedADMM([mk("a", tracker_ocp, couplings={"c": "u"}),
                       mk("b", short, couplings={"c": "u"})],
                      device="cpu")
    with pytest.raises(ValueError, match="both consensus"):
        tfa.FusedADMM([mk("a", tracker_ocp, couplings={"c": "u"}),
                       mk("b", tracker_ocp, exchanges={"c": "u"})],
                      device="cpu")
    with pytest.raises(ValueError, match="qp_fast_path"):
        tfa.FusedADMM([mk("a", tracker_ocp, couplings={"c": "u"},
                          qp_fast_path="maybe")], device="cpu")
    eng = tfa.FusedADMM(
        [mk("a", tracker_ocp, couplings={"c": "u"}),
         mk("b", tracker_ocp, exchanges={"e": "u"})],
        tfa.FusedADMMOptions(rho={"c": 1.0}), device="cpu")
    ths = [tfa.stack_params([theta(tracker_ocp, 1.0)])] * 2
    with pytest.raises(ValueError, match="misses aliases"):
        eng.init_state(ths)


def test_step_validates_active_overrides(tracker_ocp):
    eng = engine(tracker_ocp)
    ths = tfa.stack_params([theta(tracker_ocp, a) for a in (1.0, 2.0)])
    state = eng.init_state([ths])
    with pytest.raises(ValueError, match="masks for 1 groups"):
        eng.step(state, [ths], active=[])
    with pytest.raises(ValueError, match="shape"):
        eng.step(state, [ths], active=[torch.ones(5, dtype=torch.bool)])


def test_engine_defaults_to_the_card(tracker_ocp, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    group = tfa.AgentGroup(name="g", ocp=tracker_ocp, n_agents=1,
                           couplings={"c": "u"}, solver_options=SOLVER)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.FusedADMM([group])


# ---- backends: translators and model loading ---------------------------------

@pytest.mark.parametrize("disc", [
    None, {}, {"collocation_order": 2, "collocation_method": "legendre"},
    {"method": "multiple_shooting"},
    {"method": "multiple_shooting", "integrator": "euler",
     "integrator_substeps": 5}])
def test_transcription_kwargs_match_jax(disc):
    assert tmpc.transcription_kwargs_from_config(disc) == \
        jmpc.transcription_kwargs_from_config(disc)


@pytest.mark.parametrize("cfg", [
    None, {"max_iter": 30}, {"name": "ipopt", "options": {"x": 1},
                             "tol": 1e-5, "unknown_key": 3},
    {"kkt_method": "lu", "corrector": True, "stage_partition": "x"}])
def test_solver_options_from_config_match_jax(cfg):
    port = tmpc.solver_options_from_config(cfg)
    ref = jmpc.solver_options_from_config(cfg)
    for name in port._fields:
        if name in ref._fields:
            assert getattr(port, name) == getattr(ref, name), name


def test_attach_stage_partition_and_plan():
    ocp = transcribe(tzoo.ZoneWithSupply(), ["mDot"], N=3, dt=300.0,
                     method="collocation", collocation_degree=2)
    opts = tmpc.attach_stage_partition(SolverOptions(), ocp)
    assert opts.stage_partition == ocp.stage_partition
    assert tmpc.attach_stage_partition(
        SolverOptions(kkt_method="lu"), ocp).stage_partition is None
    # N=3 is far below the sparse crossover: no certifier, no plan
    assert tmpc.attach_derivative_plan(opts, ocp, device="cpu") is opts
    forced = tmpc.attach_derivative_plan(
        opts._replace(jacobian="sparse"), ocp, device="cpu")
    assert forced.stage_jacobian_plan is not None


@pytest.mark.parametrize("cfg", [
    {"class": "CooledRoom"},
    {"class": "CooledRoom", "parameters": [{"name": "s_T", "value": 0.5}],
     "states": [{"name": "T", "value": 299.0}]}])
def test_load_model_matches_jax(cfg):
    port = tbackend.load_model(cfg, dt=300.0)
    ref = jbackend.load_model(cfg, dt=300.0)
    assert type(port).__name__ == type(ref).__name__
    for v in ref.parameters + ref.states:
        assert port.get_var(v.name).value == v.value, v.name


def test_load_model_errors_and_injection(tmp_path):
    with pytest.raises(KeyError, match="zoo"):
        tbackend.load_model({"class": "NoSuchModel"})
    with pytest.raises(KeyError, match="class"):
        tbackend.load_model({})
    # an ML config loads through the ML loader, which wants an MLModel
    with pytest.raises(TypeError, match="MLModel"):
        tbackend.load_model_for_backend({"class": "CooledRoom",
                                         "ml_model_sources": ["m.json"]})
    model = tzoo.Cooler()
    assert tbackend.load_model_for_backend(model) is model
    src = tmp_path / "custom.py"
    src.write_text(
        "from agentlib_mpc_torch.models.zoo import Cooler\n"
        "class MyCooler(Cooler):\n    pass\n")
    loaded = tbackend.load_model(
        {"type": {"file": str(src), "class_name": "MyCooler"},
         "parameters": [{"name": "r_mDot", "value": 3.0}]})
    assert type(loaded).__name__ == "MyCooler"
    assert loaded.get_var("r_mDot").value == 3.0


# ---- checkpoints ---------------------------------------------------------------

def _state(tracker_ocp, n=2):
    eng = engine(tracker_ocp, n=n)
    ths = tfa.stack_params([theta(tracker_ocp, float(a)) for a in range(n)])
    return eng.init_state([ths])


def test_checkpoint_round_trip(tracker_ocp, tmp_path):
    state = _state(tracker_ocp)
    state = state._replace(w=(state.w[0] + 0.25,))
    tree = {"state": state, "time": 600.0, "theta": [torch.arange(3.0)]}
    path = ckpt.save_pytree(str(tmp_path / "c"), tree)
    assert ckpt.has_checkpoint(path)
    back = ckpt.load_pytree(path, tree)
    assert isinstance(back["state"], tfa.FusedState)
    assert back["time"] == 600.0
    for a, b in zip(torch.utils._pytree.tree_leaves(tree),
                    torch.utils._pytree.tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    # a second save replaces the first and leaves no sibling behind
    ckpt.save_pytree(path, {**tree, "time": 900.0})
    assert ckpt.load_pytree(path, tree)["time"] == 900.0
    assert not [p for p in os.listdir(tmp_path) if p != "c"]


def test_checkpoint_refuses_a_mismatched_restore(tracker_ocp, tmp_path):
    path = ckpt.save_pytree(str(tmp_path / "c"),
                            {"state": _state(tracker_ocp, 3)})
    with pytest.raises(ValueError, match="not compatible"):
        ckpt.load_pytree(path, {"state": _state(tracker_ocp, 4)})
    with pytest.raises(ValueError, match="not compatible"):
        ckpt.load_pytree(path, {"other": _state(tracker_ocp, 3)})


def test_checkpoint_crash_recovery(tracker_ocp, tmp_path):
    tree = {"x": torch.ones(2)}
    path = str(tmp_path / "c")
    assert not ckpt.has_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        ckpt.load_pytree(path, tree)
    ckpt.save_pytree(path, tree)
    # a save killed between its two renames leaves only the .old sibling
    os.rename(path, f"{path}.old-123")
    assert ckpt.has_checkpoint(path)
    assert torch.equal(ckpt.load_pytree(path, tree)["x"], torch.ones(2))
    # a half-written .tmp sibling is not a checkpoint
    os.makedirs(f"{path}.tmp-9")
    assert torch.equal(ckpt.load_pytree(path, tree)["x"], torch.ones(2))
    os.rename(f"{path}.old-123", f"{path}.old-1")
    os.remove(os.path.join(f"{path}.old-1", "tree.pt"))
    assert not ckpt.has_checkpoint(path)
    with pytest.raises(RuntimeError, match="every crash-recovery"):
        ckpt.load_pytree(path, tree)


# ---- carriers ------------------------------------------------------------------

def test_fused_state_round_trips_through_numpy(tracker_ocp):
    state = _state(tracker_ocp)
    back = fused_state_from_numpy(to_numpy(state), "cpu", F64)
    assert isinstance(back, tfa.FusedState)
    for a, b in zip(torch.utils._pytree.tree_leaves(state),
                    torch.utils._pytree.tree_leaves(back)):
        assert torch.equal(a, b)
    # a mapping of the fields works as well, and f32 casts floats only
    f32 = fused_state_from_numpy(to_numpy(state)._asdict(), "cpu",
                                 torch.float32)
    assert f32.w[0].dtype == torch.float32


def test_iteration_stats_and_thetas_from_numpy():
    stats = {"iterations": np.int64(3), "primal_residuals": np.ones(4),
             "dual_residuals": np.ones(4), "penalty": {"c": np.ones(4)},
             "converged": np.bool_(True), "local_solves_ok": np.bool_(False),
             "coupling_locals": None, "exchange_locals": None,
             "quarantined": np.zeros(4, np.int32),
             "lane_quarantined": (np.zeros(2, np.int32),)}
    port = iteration_stats_from_numpy(stats, "cpu", torch.float32)
    assert port.iterations.dtype == torch.int64
    assert port.converged.dtype == torch.bool
    assert port.quarantined.dtype == torch.int32
    assert port.penalty["c"].dtype == torch.float32
    assert port.coupling_locals is None
    ocp = transcribe(Tracker(), ["u"], N=3, dt=300.0,
                     method="multiple_shooting")
    ths = tfa.stack_params([theta(ocp, a) for a in (1.0, 2.0)])
    (back,) = theta_batches_from_numpy([to_numpy(ths)], "cpu", F64)
    for a, b in zip(ths, back):
        assert torch.equal(a, b)


def test_jax_state_carries_into_the_port():
    """A JAX FusedState and IterationStats, mapped to numpy, come in with
    every leaf equal."""
    from agentlib_mpc_tpu.ops.solver import SolverOptions as JSO
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtr
    from conftest import make_tracker_model

    ocp = jtr(make_tracker_model()(), ["u"], N=3, dt=300.0,
              method="multiple_shooting")
    group = jfa.AgentGroup(name="g", ocp=ocp, n_agents=2,
                           couplings={"c": "u"}, exchanges={},
                           solver_options=JSO(tol=1e-8, max_iter=20))
    eng = jfa.FusedADMM([group], jfa.FusedADMMOptions(max_iterations=2))
    ths = jfa.stack_params([ocp.default_params(p=jnp.array([a]))
                            for a in (1.0, 3.0)])
    state = eng.init_state([ths])
    jstate = jax.tree.map(np.asarray, state)
    port = fused_state_from_numpy(jstate, "cpu", F64)
    np.testing.assert_array_equal(port.w[0].numpy(), jstate.w[0])
    np.testing.assert_array_equal(port.z[0].numpy(), jstate.z[0])
    assert float(port.rho["c"]) == float(jstate.rho["c"])
    back = to_numpy(port)
    rebuilt = jfa.FusedState(**back._asdict())
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, b)
