"""``test_torch_functional_jax.py``'s checks on navigation (its LIDARs
through the ray cast's plain version and its backward): ``step_fn``
against the JAX ``env.step_fn`` at the live parity's tolerance, and the
gradient of the 3-step loss with respect to the initial ``pos`` against
``jax.grad``, within 1e-4 of its largest entry.  A file of its own: one
JAX env build a file."""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_functional_jax import functional_matches_jax  # noqa: E402


@pytest.mark.parametrize("scenario", ["navigation"])
def test_step_fn_and_state_gradient_match_jax(scenario):
    functional_matches_jax(scenario)
