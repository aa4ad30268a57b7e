"""road_traffic's gradient through the port's step against ``jax.grad``
(see ``tests/test_torch_grad.py``): 4 vehicles on map '1', the JAX
package's ``test_grad_road_traffic_beyond_reference`` case, 3 steps from
the JAX env's injected reset state."""
import os
import sys

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_grad import grad_matches_jax  # noqa: E402


def test_grad_matches_jax_road_traffic():
    grad_matches_jax("road_traffic")
