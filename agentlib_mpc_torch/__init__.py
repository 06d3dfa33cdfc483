"""agentlib_mpc_torch — the PyTorch/CUDA port of ``agentlib_mpc_tpu``.

The port mirrors the JAX package's layout (``models/``, ``ops/``,
``parallel/``, ``backends/``, ``runtime/``, ``modules/``, ``resilience/``,
``telemetry/``, ``utils/``) and holds each module against its JAX
counterpart in the tests. It imports ``torch`` and numpy only, never
``jax`` and nothing of ``agentlib_mpc_tpu``.

It covers the 256-zone consensus-ADMM control step of ``bench.py`` for
the zone and the linear fleet: the model zoo, collocation and multiple
shooting with the integrators, the batch-first interior-point solver with
its dense, stage-sweep and stage-sparse paths, the Mehrotra QP fast path,
the certifiers that route both fast paths (``lint/fx``), the consensus
and exchange updates, the fleet engine ``FusedADMM`` with its config entry
point ``FusedFleet`` (``parallel/``), the module path (``LocalMAS`` with
the ``mpc`` module on the ``jax`` backend, moving-horizon estimation,
mixed-integer MPC with its CIA and branch-and-bound schedules, the
simulator, the PIDs and the actuation guard, over the JAX package's agent
configs), data-driven MPC with learned surrogates (``ml/``, the NARX
transcription, the ``jax_ml``/``jax_admm_ml`` backends, the ML simulator
and trainers), scenario-tree robust MPC on one device (``scenario/``: the
tree KKT solve, scenario generation, ``ScenarioFleet``), the two
hand-written Hopper kernels of ``ops/kkt.py`` (the
pivot-free LDLᵀ factor and solve, ``csrc/*.cu``) and the host C++ of the
CIA branch-and-bound (``csrc/cia.cpp``, built by ``native.py``).

Entry points run on the card unless the caller asks for the CPU
(``utils.device.resolve_device``).
"""

__version__ = "0.1.0"
