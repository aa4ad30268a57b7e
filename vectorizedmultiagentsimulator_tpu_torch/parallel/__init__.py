from vectorizedmultiagentsimulator_tpu_torch.parallel.rollout import rollout
from vectorizedmultiagentsimulator_tpu_torch.parallel.sharding import (
    EnvMesh,
    make_mesh,
    rank_seed,
    shard_environment,
    shard_state,
)
from vectorizedmultiagentsimulator_tpu_torch.parallel.distributed import (
    init_distributed,
    run_workers,
)

__all__ = ["EnvMesh", "init_distributed", "make_mesh", "rank_seed",
           "rollout", "run_workers", "shard_environment", "shard_state"]
