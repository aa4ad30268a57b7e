"""The env-batch split held to the JAX package's shards (see
``tests/test_torch_sharding.py``): discovery, sampling and football (its red AI's planner samples
fixed on both sides)."""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sharding import JAX_GROUPS, jax_shard_parity  # noqa: E402


@pytest.mark.parametrize("scenario", JAX_GROUPS["test_torch_sharding_jax"])
def test_shards_match_jax_shards(scenario, monkeypatch):
    jax_shard_parity(scenario, monkeypatch)
