"""ML surrogates: serialized exchange format, tensor predictors, training.

Port of ``agentlib_mpc_tpu/ml/``: trained ANN/GPR/linear-regression and
Keras-graph surrogates are serialized to the JAX package's JSON exchange
format, evaluated as pure tensor functions (so they sit inside the NARX
transcription, which the solver differentiates with ``torch.func``), and
trained with ``torch.optim`` (ANN), sklearn (GPR) or least squares
(LinReg). keras and sklearn are imported only where a model is converted
or fitted with them. The learned warm start (``ml/warmstart.py``) comes
with ROADMAP Queue 1 item 5.
"""

from agentlib_mpc_torch.ml.serialized import (
    Feature,
    OutputFeature,
    SerializedANN,
    SerializedGPR,
    SerializedGraphANN,
    SerializedKerasANN,
    SerializedLinReg,
    SerializedMLModel,
    column_order,
    load_serialized_model,
)
from agentlib_mpc_torch.ml.predictors import make_predictor
