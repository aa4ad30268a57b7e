"""The port's frames held to the JAX package's pixel for pixel from one
injected state (``test_torch_render.check_frame``), for the trajectory, wind_flocking and debug scenarios with an
``extra_render``."""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_render import FRAMES_DEBUG, check_frame  # noqa: E402


@pytest.mark.parametrize("name", sorted(FRAMES_DEBUG))
def test_frame_equals_the_jax_frame(name):
    check_frame(name, FRAMES_DEBUG[name])
