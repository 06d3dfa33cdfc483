"""The port's training stack against the JAX package: the data pipeline,
the torch ANN trainer against the optax one, the host fitters, the Keras
converter and the physXAI bridge.

``ANNTrainerCore`` draws its initialisation and its per-epoch permutations
from the same numpy generator as the JAX trainer, and Adam's update is the
same formula in torch and optax, so on the same data and seed the trained
weights agree to rounding in float64 (1e-8 stated) and early stopping
ends at the same epoch (counted as the generator's permutations). LinReg
and GPR documents are the JAX package's, JSON for JSON.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from agentlib_mpc_tpu.ml import keras_graph as jgraph
from agentlib_mpc_tpu.ml import physxai as jphys
from agentlib_mpc_tpu.ml import training as jtrain
from agentlib_mpc_torch.ml import keras_graph as tgraph
from agentlib_mpc_torch.ml import physxai as tphys
from agentlib_mpc_torch.ml import serialized as tser
from agentlib_mpc_torch.ml import training as ttrain

from _torch_threads import one_torch_thread  # noqa: F401

WEIGHT_TOL = 1e-8
GRAPH_TOL = 1e-10


def _regression(seed=1, n=200, n_val=40):
    rng = np.random.default_rng(seed)

    def f(X):
        return np.sin(X[:, :1]) + 0.1 * X[:, 1:2] * X[:, 2:3]

    X, Xv = rng.normal(size=(n, 3)), rng.normal(size=(n_val, 3))
    return X, f(X), Xv, f(Xv)


def _plain_features(*names):
    """Features as plain dicts, which both packages' documents take."""
    return ({n: {"name": n, "lag": 1} for n in names},
            {"o": {"name": "o", "output_type": "absolute",
                   "recursive": False}})


def _assert_same_net(got, ref, tol=WEIGHT_TOL):
    assert got[2] == list(ref[2])
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("activation", ["tanh", "relu", "softplus"])
def test_ann_trainer_matches_the_jax_trainer(activation):
    X, y, Xv, yv = _regression()
    kw = dict(hidden=(8, 8), activation=activation, epochs=5,
              batch_size=32, learning_rate=1e-2, seed=3)
    ref = jtrain.ANNTrainerCore(**kw).fit(X, y, Xv, yv)
    got = ttrain.ANNTrainerCore(**kw, device="cpu",
                                dtype=torch.float64).fit(X, y, Xv, yv)
    _assert_same_net(got, ref)


def test_ann_trainer_stops_early_at_the_jax_trainers_epoch(monkeypatch):
    """A case that stops: both trainers draw the same number of
    permutations (one per epoch run) and end on the same weights."""
    X, y, Xv, yv = _regression(seed=2)
    draws = []
    make_rng = np.random.default_rng

    class CountingGenerator:
        def __init__(self, seed):
            self._rng = make_rng(seed)
            draws.append(0)

        def uniform(self, *a, **k):
            return self._rng.uniform(*a, **k)

        def permutation(self, n):
            draws[-1] += 1
            return self._rng.permutation(n)

    monkeypatch.setattr(np.random, "default_rng", CountingGenerator)
    kw = dict(hidden=(8,), epochs=200, batch_size=50, learning_rate=0.1,
              early_stopping_patience=3, seed=4)
    ref = jtrain.ANNTrainerCore(**kw).fit(X, y, Xv, yv)
    got = ttrain.ANNTrainerCore(**kw, device="cpu").fit(X, y, Xv, yv)
    assert draws[0] == draws[1] < 200, draws
    _assert_same_net(got, ref)


def test_fit_ann_documents_match():
    X, y, Xv, yv = _regression(seed=5)
    inputs, output = _plain_features("a", "b", "c")
    kw = dict(hidden=(6,), epochs=3, seed=1)
    ref = jtrain.fit_ann(X, y, Xv, yv, dt=60.0, inputs=inputs,
                         output=output, trainer=jtrain.ANNTrainerCore(**kw))
    got = ttrain.fit_ann(X, y, Xv, yv, dt=60.0, inputs=inputs, output=output,
                         trainer=ttrain.ANNTrainerCore(**kw, device="cpu"))
    a, b = got.to_dict(), ref.to_dict()
    assert {k: v for k, v in a.items() if k != "parameters"} == \
        {k: v for k, v in b.items() if k != "parameters"}
    _assert_same_net([a["parameters"]["weights"], a["parameters"]["biases"],
                      a["parameters"]["activations"]],
                     [b["parameters"]["weights"], b["parameters"]["biases"],
                      b["parameters"]["activations"]])


def test_data_pipeline_matches():
    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(0.0, 6000.0, 80))
    df = pd.DataFrame({"Q": rng.uniform(0, 500, 80),
                       "T": 295.0 + rng.normal(size=80)}, index=t)
    inputs = {"Q": tser.Feature(name="Q", lag=2)}
    output = {"T": tser.OutputFeature(name="T", lag=3,
                                      output_type="difference")}
    for method in ("linear", "previous"):
        a = ttrain.resample(df, 60.0, method=method)
        b = jtrain.resample(df, 60.0, method=method)
        pd.testing.assert_frame_equal(a, b)
    X, y = ttrain.create_lagged_features(a, inputs, output)
    Xj, yj = jtrain.create_lagged_features(b, inputs, output)
    pd.testing.assert_frame_equal(X, Xj)
    pd.testing.assert_frame_equal(y, yj)
    s, sj = (mod.train_val_test_split(X, y, (0.6, 0.2, 0.2), seed=3)
             for mod in (ttrain, jtrain))
    for field in ("training_inputs", "validation_outputs", "test_inputs"):
        pd.testing.assert_frame_equal(getattr(s, field), getattr(sj, field))
    with pytest.raises(ValueError, match="sum to 1"):
        ttrain.train_val_test_split(X, y, (0.5, 0.2, 0.2))


def test_fit_linreg_document_equals_the_jax_packages():
    X, y, _, _ = _regression(seed=7)
    inputs, output = _plain_features("a", "b", "c")
    a = ttrain.fit_linreg(X, y, dt=60.0, inputs=inputs, output=output)
    b = jtrain.fit_linreg(X, y, dt=60.0, inputs=inputs, output=output)
    assert a.to_json() == b.to_json()


def test_fit_gpr_document_equals_the_jax_packages():
    rng = np.random.default_rng(8)
    X = rng.uniform(-1.5, 1.5, size=(30, 2))
    y = np.sin(X[:, 0]) + 0.1 * X[:, 1]
    inputs, output = _plain_features("a", "b")
    a = ttrain.fit_gpr(X, y, dt=60.0, inputs=inputs, output=output)
    b = jtrain.fit_gpr(X, y, dt=60.0, inputs=inputs, output=output)
    assert a.to_json() == b.to_json()


def test_warmstart_training_waits_for_its_slice():
    with pytest.raises(NotImplementedError, match="item 5"):
        ttrain.fit_warmstart({"theta": np.zeros((2, 1)),
                              "w": np.zeros((2, 1))}, "fp")
    with pytest.raises(NotImplementedError, match="item 5"):
        ttrain.load_warmstart_dataset({})


def test_keras_model_through_both_converters():
    """One Keras Functional model (a dense branch, a batch-normalized
    branch, a merge) through both packages' ``from_keras`` and
    ``build_graph_apply``: the same spec and parameters, and the same
    outputs within 1e-10."""
    keras = pytest.importorskip("keras")
    inp = keras.Input(shape=(3,))
    a = keras.layers.Dense(5, activation="tanh")(inp)
    b = keras.layers.BatchNormalization()(keras.layers.Dense(5)(inp))
    merged = keras.layers.Add()([a, b])
    out = keras.layers.Dense(2, activation="softplus")(
        keras.layers.Rescaling(0.5, offset=0.1)(merged))
    model = keras.Model(inp, out)
    rng = np.random.default_rng(9)
    for layer in model.layers:
        weights = layer.get_weights()
        if weights:
            layer.set_weights([rng.normal(size=w.shape).astype(w.dtype)
                               if k < 2 else np.abs(rng.normal(
                                   size=w.shape)).astype(w.dtype) + 0.5
                               for k, w in enumerate(weights)])
    spec, params = tgraph.from_keras(model)
    jspec, jparams = jgraph.from_keras(model)
    assert spec == jspec
    doc = tgraph.spec_to_jsonable(spec, params)
    assert doc == jgraph.spec_to_jsonable(jspec, jparams)
    apply, japply = tgraph.build_graph_apply(spec), \
        jgraph.build_graph_apply(jspec)
    for x in rng.normal(size=(5, 3)):
        got = apply(params, torch.as_tensor(x)).numpy()
        ref = np.asarray(japply(jparams, jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, rtol=GRAPH_TOL, atol=GRAPH_TOL)
    y_keras = np.asarray(model.predict(rng.normal(size=(1, 3)).astype(
        np.float32), verbose=0))
    assert y_keras.shape == (1, 2)


def _preprocessing():
    return {"time_step": 900, "shift": 1,
            "inputs": ["T_amb", "Q", "Q_lag1", "T", "T_lag1"],
            "output": ["Change(T)"]}


@pytest.mark.parametrize("cfg", [
    _preprocessing(),
    {**_preprocessing(), "output": ["y"], "inputs": ["T_amb", "Q"]}],
    ids=["difference", "absolute"])
def test_physxai_parsing_matches(cfg):
    dt, inputs, output = tphys.parse_physxai_features(cfg)
    jdt, jinputs, joutput = jphys.parse_physxai_features(cfg)
    assert dt == jdt
    assert {k: v.as_dict() for k, v in inputs.items()} == \
        {k: v.as_dict() for k, v in jinputs.items()}
    assert {k: v.as_dict() for k, v in output.items()} == \
        {k: v.as_dict() for k, v in joutput.items()}
    with pytest.raises(ValueError, match="shift"):
        tphys.parse_physxai_features({**cfg, "shift": 2})


def test_physxai_ann_artifact_converts_alike():
    rng = np.random.default_rng(10)
    artifact = {"weights": [rng.normal(size=(5, 4)), rng.normal(size=(4, 1))],
                "biases": [rng.normal(size=4), rng.normal(size=1)],
                "activations": ["tanh", "linear"]}
    a = tphys.convert_physxai_model(_preprocessing(), artifact, "ANN")
    b = jphys.convert_physxai_model(_preprocessing(), artifact, "ANN")
    assert a.to_json() == b.to_json()


def test_importing_the_ml_package_loads_no_keras_or_sklearn():
    code = ("import sys, agentlib_mpc_torch.ml, "
            "agentlib_mpc_torch.ml.training, agentlib_mpc_torch.ml.physxai, "
            "agentlib_mpc_torch.ml.keras_graph, "
            "agentlib_mpc_torch.ml.data_reduction, "
            "agentlib_mpc_torch.modules.ml_trainer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('keras', 'sklearn', 'tensorflow', 'jax'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
