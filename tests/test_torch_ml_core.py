"""The port's ML core against the JAX package: exchange documents,
predictors and their Jacobians, the Nyström reducer, and the
standardization the ANN trainer folds into its weights.

Every case builds one document from seeded numpy data and evaluates it in
both packages in float64 (``tests/conftest.py`` turns JAX's x64 on): ANN
(every activation, at pre-activations on both sides of softplus'
threshold 20), GPR (normalized and not), LinReg and layer-graph
documents (every node type and both custom activations) within 1e-12,
their Jacobians (``torch.func.jacrev`` against ``jax.jacrev``) within
1e-10. The standardization cases are ``tests/test_ml_standardization.py``'s
(the fourth there pins the JAX precision certifier, which the port has not
ported), held for the port's trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.ml import predictors as jpred
from agentlib_mpc_tpu.ml import serialized as jser
from agentlib_mpc_tpu.ml.data_reduction import NystroemReducer as JNystroem
from agentlib_mpc_torch.ml import predictors as tpred
from agentlib_mpc_torch.ml import serialized as tser
from agentlib_mpc_torch.ml.data_reduction import NystroemReducer
from agentlib_mpc_torch.ml.training import ANNTrainerCore

from _torch_threads import one_torch_thread  # noqa: F401

VALUE_TOL = 1e-12
JAC_TOL = 1e-10


def _features(n_in, lag=1):
    inputs = {f"u{i}": jser.Feature(name=f"u{i}", lag=lag)
              for i in range(n_in)}
    output = {"y": jser.OutputFeature(name="y", output_type="absolute",
                                      recursive=False)}
    return inputs, output


def _ann_doc(activation, seed=0):
    """4 inputs, hidden (6, 5), one output; the first layer passes the
    inputs through unscaled, so inputs of ±25 and ±19.5 put
    pre-activations on both sides of 20."""
    rng = np.random.default_rng(seed)
    W1 = np.concatenate([np.eye(4), rng.normal(size=(4, 2))], axis=1)
    inputs, output = _features(4)
    return jser.SerializedANN(
        dt=60.0, inputs=inputs, output=output,
        weights=[W1, rng.normal(size=(6, 5)), rng.normal(size=(5, 1))],
        biases=[rng.normal(size=6) * 0.1, rng.normal(size=5),
                rng.normal(size=1)],
        activations=[activation, activation, "linear"]).to_json()


def _gpr_doc(normalize, seed=1):
    rng = np.random.default_rng(seed)
    inputs, output = _features(3)
    return jser.SerializedGPR(
        dt=60.0, inputs=inputs, output=output,
        x_train=rng.normal(size=(25, 3)), alpha=rng.normal(size=25),
        constant_value=1.7, length_scale=[0.8, 1.3, 2.1],
        noise_level=1e-3, normalize=normalize,
        mean=rng.normal(size=3).tolist() if normalize else None,
        std=(0.5 + rng.uniform(size=3)).tolist() if normalize else None,
        scale=3.5).to_json()


def _linreg_doc(seed=2):
    rng = np.random.default_rng(seed)
    inputs = {"u": jser.Feature(name="u", lag=2)}
    output = {"x": jser.OutputFeature(name="x", lag=2,
                                      output_type="difference",
                                      recursive=True),
              "z": jser.OutputFeature(name="z", output_type="absolute",
                                      recursive=False)}
    return jser.SerializedLinReg(
        dt=60.0, inputs=inputs, output=output,
        coef=rng.normal(size=(2, 4)), intercept=rng.normal(size=2)
    ).to_json()


def _dense(name, src, n_in, n_out, rng, activation="linear"):
    node = {"name": name, "type": "dense",
            "config": {"activation": activation}, "inputs": [src]}
    return node, {"kernel": rng.normal(size=(n_in, n_out)),
                  "bias": rng.normal(size=n_out)}


def _graph_docs():
    """Two layer graphs covering every node type and both custom
    activations: a feature graph over a (1, 4) input, and a sequence graph
    over a (3, 2) input."""
    rng = np.random.default_rng(3)
    concave = {"registered_name": "physXAI>ConcaveActivation",
               "config": {"activation": "softplus"}}
    saturated = {"registered_name": "physXAI>SaturatedActivation",
                 "config": {"activation": "softplus"}}
    clipped = {"registered_name": "SaturatedActivation",
               "config": {"activation": "relu"}}
    nodes, params = [], {}

    def add(node, p=None):
        nodes.append(node)
        if p:
            params[node["name"]] = p

    add({"name": "norm", "type": "normalization", "config": {},
         "inputs": ["input"]},
        {"mean": rng.normal(size=4), "var": 0.5 + rng.uniform(size=4)})
    add({"name": "bn", "type": "batch_normalization",
         "config": {"epsilon": 1e-3}, "inputs": ["norm"]},
        {"gamma": rng.normal(size=4), "beta": rng.normal(size=4),
         "mean": rng.normal(size=4), "var": 0.5 + rng.uniform(size=4)})
    add(*_dense("d1", "bn", 4, 5, rng, concave))
    add({"name": "sl", "type": "input_slice",
         "config": {"feature_indices": [0, 2]}, "inputs": ["input"]})
    add({"name": "rbf", "type": "rbf", "config": {}, "inputs": ["sl"]},
        {"centers": rng.normal(size=(3, 2)),
         "log_gamma": rng.normal(size=3) * 0.3})
    add({"name": "cat", "type": "concatenate", "config": {"axis": -1},
         "inputs": ["d1", "rbf"]})
    add({"name": "resc", "type": "rescaling",
         "config": {"scale": (0.5 + rng.uniform(size=8)).tolist(),
                    "offset": 0.1}, "inputs": ["cat"]})
    add(*_dense("d2", "resc", 8, 3, rng, saturated))
    add(*_dense("d3", "resc", 8, 3, rng, clipped))
    add(*_dense("d4", "resc", 8, 3, rng, "gelu"))
    add({"name": "const", "type": "constant", "config": {},
         "inputs": ["input"]}, {"constant": 1.5 + rng.uniform(size=(1, 3))})
    add({"name": "sum", "type": "add", "config": {},
         "inputs": ["d2", "d3", "const"]})
    add({"name": "diff", "type": "subtract", "config": {},
         "inputs": ["sum", "d4"]})
    add({"name": "prod", "type": "multiply", "config": {},
         "inputs": ["diff", "const"]})
    add({"name": "quot", "type": "divide", "config": {},
         "inputs": ["prod", "const"]})
    add({"name": "pow", "type": "power", "config": {},
         "inputs": ["const", "d3"]})
    add({"name": "avg", "type": "average", "config": {},
         "inputs": ["quot", "pow", "d2"]})
    add(*_dense("out", "avg", 3, 2, rng, "exponential"))
    add(*_dense("out2", "out", 2, 2, rng, "gaussian"))
    feature = {"input": {"name": "input", "shape": [1, 4]},
               "nodes": nodes, "output": "out2"}
    feature_params = params

    nodes, params = [], {}
    add(*_dense("seq", "input", 2, 4, rng, "elu"))
    add({"name": "crop", "type": "cropping1d", "config": {"cropping": [1, 0]},
         "inputs": ["seq"]})
    add({"name": "flat", "type": "flatten", "config": {},
         "inputs": ["crop"]})
    add({"name": "shape", "type": "reshape",
         "config": {"target_shape": [2, 4]}, "inputs": ["flat"]})
    add({"name": "join", "type": "concatenate", "config": {"axis": 1},
         "inputs": ["shape", "crop"]})
    add({"name": "flat2", "type": "flatten", "config": {},
         "inputs": ["join"]})
    add(*_dense("head", "flat2", 16, 2, rng, "sigmoid"))
    sequence = {"input": {"name": "input", "shape": [3, 2]},
                "nodes": nodes, "output": "head"}
    docs = {}
    for key, spec, p, n_in in (("feature", feature, feature_params, 4),
                               ("sequence", sequence, params, 6)):
        inputs, _ = _features(n_in)
        output = {f"y{i}": jser.OutputFeature(
            name=f"y{i}", output_type="absolute", recursive=False)
            for i in range(2)}
        docs[key] = jser.SerializedGraphANN(
            dt=60.0, inputs=inputs, output=output,
            graph={"spec": spec, "params": {
                node: {k: np.asarray(v).tolist() for k, v in d.items()}
                for node, d in p.items()}}).to_json()
    return docs


GRAPHS = _graph_docs()
DOCS = {
    **{f"ann_{a}": _ann_doc(a) for a in jser.ACTIVATIONS},
    "gpr_normalized": _gpr_doc(True),
    "gpr_plain": _gpr_doc(False),
    "linreg": _linreg_doc(),
    **{f"graph_{k}": v for k, v in GRAPHS.items()},
}


def _inputs(n_in, seed=4):
    """Seeded inputs; the ANN's first four also at ±25 and ±19.5."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(12, n_in)) * 3.0
    if n_in == 4:
        X[:4] = [[25.0, -25.0, 19.5, -19.5], [-25.0, 25.0, -19.5, 19.5],
                 [20.5, 0.3, -20.5, 1.0], [0.0, 21.0, -0.7, -21.0]]
    return X


def _pair(doc):
    jm = jser.load_serialized_model(doc)
    tm = tser.load_serialized_model(doc)
    return jpred.make_predictor(jm), tpred.make_predictor(tm)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_documents_round_trip_between_the_packages(name):
    """A document written by either package loads in the other and
    writes the same JSON back."""
    doc = DOCS[name]
    port = tser.load_serialized_model(doc)
    assert type(port).__name__ == type(jser.load_serialized_model(doc)
                                       ).__name__
    assert port.to_json() == doc
    assert jser.load_serialized_model(port.to_json()).to_json() == doc
    assert port.input_columns == jser.load_serialized_model(
        doc).input_columns


@pytest.mark.parametrize("name", sorted(DOCS))
def test_predictor_matches_jax(name):
    jp, tp = _pair(DOCS[name])
    assert (tp.n_inputs, tp.n_outputs, tp.input_columns, tp.output_names) \
        == (jp.n_inputs, jp.n_outputs, jp.input_columns, jp.output_names)
    X = _inputs(jp.n_inputs)
    ref = np.asarray(jax.jit(jax.vmap(jp.apply, (None, 0)))(
        jp.params, jnp.asarray(X)))
    Xt = torch.as_tensor(X)
    each = torch.stack([tp.apply(tp.params, x) for x in Xt]).numpy()
    batch = tp.apply_batch(tp.params, Xt).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(each, ref, rtol=VALUE_TOL, atol=VALUE_TOL)
    np.testing.assert_allclose(batch, ref, rtol=VALUE_TOL, atol=VALUE_TOL)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_predictor_jacobian_matches_jax(name):
    jp, tp = _pair(DOCS[name])
    jac = jax.jit(jax.jacrev(jp.apply, argnums=1))
    for x in _inputs(jp.n_inputs)[:6]:
        ref = np.asarray(jac(jp.params, jnp.asarray(x)))
        got = torch.func.jacrev(tp.apply, argnums=1)(
            tp.params, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=JAC_TOL, atol=JAC_TOL)


def test_activation_table_matches_the_declared_names():
    assert set(tpred._ACT) == set(tser.ACTIVATIONS) == set(jser.ACTIVATIONS)


def test_softplus_and_gelu_follow_jax_nn():
    """The two activations whose torch defaults differ from jax.nn:
    softplus above its linear threshold, gelu's tanh approximation."""
    x = np.array([-30.0, -20.5, -1.3, 0.0, 1.3, 19.5, 20.5, 25.0, 40.0])
    for name, fn in (("softplus", jax.nn.softplus), ("gelu", jax.nn.gelu)):
        ref = np.asarray(fn(jnp.asarray(x)))
        got = tpred._ACT[name](torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=VALUE_TOL, atol=VALUE_TOL)


def test_params_cast_to_the_solve_dtype():
    _, tp = _pair(DOCS["ann_tanh"])
    cast = tpred.cast_params(tp.params, "cpu", torch.float32)
    assert all(t.dtype == torch.float32 for t in cast["W"] + cast["b"])
    assert all(t.dtype == torch.float64 for t in tp.params["W"])


def test_warmstart_documents_wait_for_their_slice():
    with pytest.raises(KeyError, match="Warmstart"):
        tser.SerializedMLModel.from_dict({"model_type": "Warmstart"})


@pytest.mark.parametrize("m, n", [(8, 40), (50, 20)])
def test_nystroem_reducer_matches_jax(m, n):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(n, 3))
    y = np.sin(X[:, 0])
    Xj, yj = JNystroem(n_components=m, seed=1).reduce(X, y)
    Xt, yt = NystroemReducer(n_components=m, seed=1).reduce(X, y)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    assert len(Xt) == min(m, n)


# -- standardization folded into the trained weights --------------------------

SCALES = (1e-12, 1e-6, 1.0, 1e6, 1e12)


def _fit_tiny(X, y):
    return ANNTrainerCore(hidden=(4,), epochs=2, seed=0, device="cpu").fit(
        X, y)


def _forward(weights, biases, acts, x, dtype):
    t = torch.float64 if dtype == np.float64 else torch.float32
    h = torch.as_tensor(np.asarray(x, dtype=dtype))
    for W, b, a in zip(weights, biases, acts):
        h = tpred._ACT[a](h @ torch.as_tensor(np.asarray(W, dtype=dtype))
                          + torch.as_tensor(np.asarray(b, dtype=dtype)))
    assert h.dtype == t
    return h.numpy()


def test_f32_error_bounded_across_column_scales():
    """The folded net evaluated in f32 on raw features agrees with its own
    f64 evaluation to f32-class relative error at every column scale."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-1.0, 1.0, size=(40, len(SCALES)))
    X = base * np.asarray(SCALES)
    weights, biases, acts = _fit_tiny(X, base.sum(axis=1))
    for x in X[:10]:
        y64 = _forward(weights, biases, acts, x, np.float64)
        y32 = _forward(weights, biases, acts, x, np.float32)
        assert np.all(np.isfinite(y32))
        rel = np.max(np.abs(y64 - y32)) / (1.0 + np.max(np.abs(y64)))
        assert rel < 1e-4, f"f32 round-trip error {rel:.2e}"


def test_folded_first_layer_consumes_raw_features():
    rng = np.random.default_rng(1)
    X = rng.uniform(280.0, 300.0, size=(30, 2))
    weights, biases, acts = _fit_tiny(X, X @ np.array([0.1, -0.2]))
    out = _forward(weights, biases, acts, X[0], np.float64)
    out32 = _forward(weights, biases, acts, X[0], np.float32)
    np.testing.assert_allclose(out32, out, rtol=1e-4, atol=1e-4)


def test_near_constant_column_keeps_weights_bounded():
    rng = np.random.default_rng(2)
    X = np.column_stack([np.full(40, 5.0),
                         5.0 + 1e-9 * rng.standard_normal(40),
                         rng.uniform(-1.0, 1.0, 40)])
    weights, biases, acts = _fit_tiny(X, X[:, 2])
    assert np.max(np.abs(weights[0])) < 1e3
    assert np.max(np.abs(biases[0])) < 1e3


def test_folded_weights_match_the_jax_trainer():
    """The same fold in both packages: the tiny nets of the cases above
    agree with the JAX trainer's to rounding."""
    from agentlib_mpc_tpu.ml.training import ANNTrainerCore as JTrainer

    rng = np.random.default_rng(1)
    X = rng.uniform(280.0, 300.0, size=(30, 2))
    y = X @ np.array([0.1, -0.2])
    ref = JTrainer(hidden=(4,), epochs=2, seed=0).fit(X, y)
    got = _fit_tiny(X, y)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10,
                                   atol=1e-10)
    assert got[2] == ref[2]
