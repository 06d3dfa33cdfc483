from agentlib_mpc_torch.models.variables import (
    Var,
    state,
    control_input,
    parameter,
    output,
)
from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.objective import (
    Objective,
    SubObjective,
    ChangePenaltyObjective,
    ConditionalObjective,
    CombinedObjective,
)
