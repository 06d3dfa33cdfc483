"""Optimization backends: transcribe + solve OCPs for the modules.

Port of ``agentlib_mpc_tpu/backends/``: the registry (string type → class),
the base class, model loading, the config translators, the central-MPC
:class:`JAXBackend`, the MHE backend and the MINLP backends (rounding,
CIA, branch-and-bound) and the ADMM backend (``jax_admm``/
``casadi_admm``) and the ML backends (``jax_ml``/``casadi_ml``/
``casadi_nn`` and ``jax_admm_ml``/``casadi_admm_ml``). Importing this
package registers the ported types.
"""

from agentlib_mpc_torch.backends.backend import (
    DEFERRED_BACKEND_TYPES,
    OptimizationBackend,
    VariableReference,
    backend_types,
    create_backend,
    load_model,
    register_backend,
)
from agentlib_mpc_torch.backends.mpc_backend import JAXBackend
from agentlib_mpc_torch.backends.admm_backend import ADMMBackend
from agentlib_mpc_torch.backends.mhe_backend import MHEBackend
from agentlib_mpc_torch.backends.minlp_backend import (
    BranchAndBoundBackend,
    CIABackend,
    MINLPBackend,
)
from agentlib_mpc_torch.backends.ml_backend import MLADMMBackend, MLBackend
