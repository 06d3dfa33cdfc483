from agentlib_mpc_torch.ops.collocation import collocation_matrices
from agentlib_mpc_torch.ops.solver import NLPFunctions, SolverOptions, solve_nlp
from agentlib_mpc_torch.ops.transcription import (
    OCPParams,
    TranscribedOCP,
    transcribe,
)
