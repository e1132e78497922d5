from racinglmpc_tpu_torch.parallel.mesh import (  # noqa: F401
    SCENARIO_AXIS,
    ScenarioMesh,
    all_ranks,
    cross_scenario_metrics,
    gather_scenario_tree,
    gather_tensor,
    init_multi_host,
    make_mesh,
    shard_scenario_tree,
)
