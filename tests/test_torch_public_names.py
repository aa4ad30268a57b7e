"""The port's public names against the JAX package's: the scenario lists,
``Wrapper``, ``render_interactively`` and the utilities ``override``,
``Observer``, ``Observable.unsubscribe``, ``TorchUtils.recursive_clone``,
``recursive_require_grad_`` and ``select_by_index`` (held to
``JaxUtils.select_by_index`` on random inputs)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorizedmultiagentsimulator_tpu as vmt
import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu.utils import JaxUtils
from vectorizedmultiagentsimulator_tpu_torch import utils
from vectorizedmultiagentsimulator_tpu_torch.scenarios import names
from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils


@pytest.mark.parametrize("attr", ["scenarios", "debug_scenarios",
                                  "mpe_scenarios"])
def test_scenario_lists_match_jax(attr):
    assert getattr(vmt_torch, attr) == getattr(vmt, attr)


def test_public_names_match_jax():
    assert vmt_torch.__all__ == vmt.__all__
    assert sorted(vmt_torch.scenarios + vmt_torch.debug_scenarios
                  + vmt_torch.mpe_scenarios) == names()
    assert ([w.name for w in vmt_torch.Wrapper]
            == [w.name for w in vmt.Wrapper])
    assert (inspect.signature(vmt_torch.render_interactively)
            == inspect.signature(vmt.render_interactively))
    for name in ("override", "Observer", "Observable", "Color",
                 "env_index_to_mask", "ScenarioUtils"):
        assert hasattr(utils, name), name


@pytest.mark.parametrize("shape", [(7, 1), (7, 4), (7, 4, 3), (7, 4, 2, 5)])
def test_select_by_index_matches_jax(shape):
    rng = np.random.RandomState(len(shape))
    stacked = rng.randn(*shape).astype(np.float32)
    # indices in range, and out of it (-1 and K select 0 in both)
    idx = rng.randint(-1, shape[1] + 1, size=(shape[0],)).astype(np.int32)
    got = TorchUtils.select_by_index(torch.as_tensor(stacked),
                                     torch.as_tensor(idx))
    ref = JaxUtils.select_by_index(jnp.asarray(stacked), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_override():
    class Base:
        def f(self):
            return 1

    class Sub(Base):
        @utils.override(Base)
        def f(self):
            return 2

    assert Sub().f() == 2
    with pytest.raises(NameError):
        class Bad(Base):
            @utils.override(Base)
            def g(self):
                return 3


def test_observer_subscribe_and_unsubscribe():
    seen = []

    class Watch(utils.Observer):
        def notify(self, observable, *args, **kwargs):
            seen.append(args)

    source, watch = utils.Observable(), Watch()
    source.subscribe(watch)
    source.notify_observers(1)
    source.unsubscribe(watch)
    source.notify_observers(2)
    assert seen == [(1,)]
    with pytest.raises(NotImplementedError):
        utils.Observer().notify(source)


def test_recursive_clone_and_require_grad():
    x, y = torch.zeros(2), torch.ones(3, dtype=torch.long)
    tree = {"a": [x, (y, 5)], "b": "name"}
    copy = TorchUtils.recursive_clone(tree)
    assert isinstance(copy["a"][1], tuple) and copy["a"][1][1] == 5
    assert copy["b"] == "name"
    assert torch.equal(copy["a"][0], x) and copy["a"][0] is not x
    copy["a"][0] += 1
    assert torch.equal(x, torch.zeros(2))
    assert TorchUtils.recursive_require_grad_(copy) is copy
    assert copy["a"][0].requires_grad
    assert not copy["a"][1][0].requires_grad  # integer tensors take none
    assert not x.requires_grad
