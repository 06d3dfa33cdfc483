"""Agent modules: control logic on top of the runtime and backends.

Port of ``agentlib_mpc_tpu/modules/``. Importing this package registers
the ported module types: ``mpc``/``mpc_basic``/``mpc_full``, ``simulator``,
``pid``/``fallback_pid``, ``mpc_on_off``/``skip_mpc_intervals``,
``data_source``, ``set_point_generator``,
``try_predictor``/``input_predictor``, ``mhe``, ``minlp_mpc``, the
decentralized ADMM modules ``admm_local``/``local_admm`` and ``admm``,
the coordinator-based ADMM modules ``admm_coordinator`` and
``admm_coordinated``, the ``ml_simulator`` and the trainers
``ann_trainer``, ``gpr_trainer``, ``linreg_trainer`` and
``keras_ann_trainer`` (``runtime.module.create_module`` imports it before
its first lookup).
"""

from agentlib_mpc_torch.modules.mpc import BaseMPC, MINLPMPC, MPC
from agentlib_mpc_torch.modules.admm import LocalADMM, RealtimeADMM
from agentlib_mpc_torch.modules.coordinator import (
    ADMMCoordinator,
    CoordinatedADMM,
)
from agentlib_mpc_torch.modules.estimation import MHE
from agentlib_mpc_torch.modules.simulator import Simulator
from agentlib_mpc_torch.modules.data_source import DataSource
from agentlib_mpc_torch.modules.setpoint_generator import SetPointGenerator
from agentlib_mpc_torch.modules.deactivate_mpc import (
    MPCOnOff,
    SkipMPCInIntervals,
    SkippableMixin,
)
from agentlib_mpc_torch.modules.pid import PID, FallbackPID
from agentlib_mpc_torch.modules.input_prediction import InputPredictor
from agentlib_mpc_torch.modules.ml_simulator import MLSimulator
from agentlib_mpc_torch.modules.ml_trainer import (
    ANNTrainer,
    GPRTrainer,
    KerasANNTrainer,
    LinRegTrainer,
    MLModelTrainer,
)
