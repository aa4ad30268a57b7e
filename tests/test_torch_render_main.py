"""The port's frames held to the JAX package's pixel for pixel from one
injected state (``test_torch_render.check_frame``), for the main scenarios with an ``extra_render``: road_traffic, navigation,
discovery, multi_give_way and the passage and joint scenarios."""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_render import FRAMES_MAIN, check_frame  # noqa: E402


@pytest.mark.parametrize("name", sorted(FRAMES_MAIN))
def test_frame_equals_the_jax_frame(name):
    check_frame(name, FRAMES_MAIN[name])
