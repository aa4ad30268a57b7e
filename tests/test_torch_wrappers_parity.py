"""The port's wrappers held to the JAX package's wrappers from one
injected state with the same numpy actions
(``test_torch_wrappers.check_parity``) on transport and navigation, the
scenes ``chip_smoke.py`` wraps on the card."""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_wrappers import check_parity  # noqa: E402

PARITY_MAIN = [
    ("gymnasium_vec", "transport", True, False),
    ("gym", "transport", True, False),
    ("rllib", "navigation", True, True),
]


@pytest.mark.parametrize("kind,scenario,continuous,dict_space", PARITY_MAIN)
def test_wrapper_outputs_equal_the_jax_wrappers(kind, scenario, continuous,
                                                dict_space):
    if kind.startswith("gymnasium"):
        pytest.importorskip("gymnasium")
    check_parity(kind, scenario, continuous, dict_space)
