"""Scenario-tree robust MPC: disturbance scenarios as one more batch axis.

Port of ``agentlib_mpc_tpu/scenario/`` on one device:

* :mod:`.tree`: static :class:`ScenarioTree` metadata (branch points,
  non-anticipativity node groups), the :class:`TreePartition` extension of
  the stage partition, and the tree-structured KKT solve (scenario stage
  sweeps plus a non-anticipativity Schur complement, every factor and
  solve on the LDLᵀ kernels);
* :mod:`.generate`: scenario batches from the chaos harness's seeded
  disturbance sampler;
* :mod:`.fleet`: :class:`ScenarioFleet`, the robust round over (agents ×
  scenarios) as one batched solve of n_agents·S lanes per ADMM iteration,
  with consensus per scenario and the non-anticipativity projection.

The exports are the JAX package's. Its mesh forms (``mesh=``, the
collective watchdog, ``shard_args``) and learned warm starts wait for
ROADMAP Queue 1 item 5, its certificates for item 7.
"""

from agentlib_mpc_torch.scenario.fleet import (
    ScenarioFleet,
    ScenarioFleetOptions,
    ScenarioState,
    ScenarioStats,
    solve_nlp_scenarios,
)
from agentlib_mpc_torch.scenario.generate import (
    ensemble_thetas,
    scenario_thetas,
)
from agentlib_mpc_torch.scenario.tree import (
    ScenarioTree,
    TreePartition,
    TreeStructureCertificate,
    branching_tree,
    build_tree_partition,
    certify_tree_structure,
    factor_kkt_tree,
    fan_tree,
    resolve_kkt_tree,
    single_scenario,
    solve_kkt_tree,
    synthetic_tree_kkt,
    tree_method_available,
    tree_partition_for_ocp,
)

__all__ = [
    "ScenarioFleet",
    "ScenarioFleetOptions",
    "ScenarioState",
    "ScenarioStats",
    "ScenarioTree",
    "TreePartition",
    "TreeStructureCertificate",
    "branching_tree",
    "build_tree_partition",
    "certify_tree_structure",
    "ensemble_thetas",
    "factor_kkt_tree",
    "fan_tree",
    "resolve_kkt_tree",
    "scenario_thetas",
    "single_scenario",
    "solve_kkt_tree",
    "solve_nlp_scenarios",
    "synthetic_tree_kkt",
    "tree_method_available",
    "tree_partition_for_ocp",
]
