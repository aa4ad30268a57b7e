"""The port's closest-point geometry against the recorded reference
outputs in ``golden/geometry.npz``, at the tolerances of
``test_golden_geometry.py``."""
import os

import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

from vectorizedmultiagentsimulator_tpu_torch.ops import geometry as geo

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "geometry.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _rot(g, k):
    return _t(g[k])[..., 0]


CASES = {
    "closest_point_line": (
        lambda g: (geo.closest_point_line(
            _t(g["pos1"]), _rot(g, "rot1"), _t(g["l1"]), _t(g["point"])
        ),),
        ("cpl",), 1e-5,
    ),
    "closest_points_line_line": (
        lambda g: geo.closest_points_line_line(
            _t(g["pos1"]), _rot(g, "rot1"), _t(g["l1"]),
            _t(g["pos2"]), _rot(g, "rot2"), _t(g["l2"]),
        ),
        ("cpll_a", "cpll_b"), 1e-5,
    ),
    "closest_point_box": (
        lambda g: (geo.closest_point_box(
            _t(g["pos1"]), _rot(g, "rot1"), _t(g["w1"]), _t(g["l1"]),
            _t(g["point"]),
        ),),
        ("cpb",), 1e-5,
    ),
    "closest_point_box_xy": (
        lambda g: (torch.stack(geo.closest_point_box_xy(
            _t(g["pos1"]), _rot(g, "rot1"), _t(g["w1"]), _t(g["l1"]),
            _t(g["point"]),
        ), dim=-1),),
        ("cpb",), 1e-5,
    ),
    "closest_line_box": (
        lambda g: geo.closest_line_box(
            _t(g["pos1"]), _rot(g, "rot1"), _t(g["w1"]), _t(g["l1"]),
            _t(g["pos2"]), _rot(g, "rot2"), _t(g["l2"]),
        ),
        ("clb_a", "clb_b"), 1e-5,
    ),
    "closest_box_box": (
        lambda g: geo.closest_box_box(
            _t(g["pos1"]), _rot(g, "rot1"), _t(g["w1"]), _t(g["l1"]),
            _t(g["pos2"]), _rot(g, "rot2"), _t(g["w2"]), _t(g["l2"]),
        ),
        ("cbb_a", "cbb_b"), 1e-4,
    ),
    "inner_point_box": (
        lambda g: geo.inner_point_box(
            _t(g["point"]), _t(g["pos2"]), _t(g["pos1"])
        ),
        ("ipb", "ipb_d"), 1e-5,
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_golden(g, name):
    fn, keys, atol = CASES[name]
    outs = fn(g)
    assert len(outs) == len(keys)
    for out, key in zip(outs, keys):
        np.testing.assert_allclose(
            out.numpy(), g[key], atol=atol, err_msg=f"{name}: {key}"
        )


def test_geometry_scalar_sizes_match_tensor_sizes(g):
    """Python-float sizes (scenario queries) give the per-row tensor
    sizes' results."""
    pos, rot, pt = _t(g["pos1"]), _rot(g, "rot1"), _t(g["point"])
    a = geo.closest_point_box(pos, rot, 0.3, 0.2, pt)
    b = geo.closest_point_box(
        pos, rot, torch.full((256,), 0.3), torch.full((256,), 0.2), pt
    )
    torch.testing.assert_close(a, b, rtol=0, atol=0)
