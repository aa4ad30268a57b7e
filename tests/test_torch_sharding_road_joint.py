"""The env-batch split held to the JAX package's shards (see
``tests/test_torch_sharding.py``): road_traffic (4 vehicles, map '1') and joint_passage, the two
longest JAX compiles."""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sharding import JAX_GROUPS, jax_shard_parity  # noqa: E402


@pytest.mark.parametrize("scenario", JAX_GROUPS["test_torch_sharding_road_joint"])
def test_shards_match_jax_shards(scenario, monkeypatch):
    jax_shard_parity(scenario, monkeypatch)
