"""``make_env`` entry point (reference ``vmas/make_env.py:14-101``)."""
from __future__ import annotations

from typing import Optional, Union

from vectorizedmultiagentsimulator_tpu_torch import scenarios
from vectorizedmultiagentsimulator_tpu_torch.environment import Environment, Wrapper
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario


def make_env(
    scenario: Union[str, BaseScenario],
    num_envs: int,
    device=None,
    continuous_actions: bool = True,
    wrapper: Optional[Union[Wrapper, str]] = None,
    max_steps: Optional[int] = None,
    seed: Optional[int] = None,
    dict_spaces: bool = False,
    multidiscrete_actions: bool = False,
    clamp_actions: bool = False,
    grad_enabled: bool = False,
    terminated_truncated: bool = False,
    wrapper_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Create an environment of ``num_envs`` parallel worlds on ``device``:
    the CUDA card by default (an error where there is none), or
    ``device="cpu"``; ``seed`` seeds the world's generator.  ``wrapper``
    (a ``Wrapper`` or its name: ``"gym"``, ``"gymnasium"``,
    ``"gymnasium_vec"``, ``"rllib"``) wraps the env, built with
    ``wrapper_kwargs``.  Remaining kwargs go to the scenario's
    ``make_world``."""
    if isinstance(scenario, str):
        scenario = scenarios.load(scenario).Scenario()
    env = Environment(
        scenario,
        num_envs=num_envs,
        device=device,
        continuous_actions=continuous_actions,
        max_steps=max_steps,
        seed=seed,
        dict_spaces=dict_spaces,
        multidiscrete_actions=multidiscrete_actions,
        clamp_actions=clamp_actions,
        grad_enabled=grad_enabled,
        terminated_truncated=terminated_truncated,
        **kwargs,
    )

    if wrapper is not None and isinstance(wrapper, str):
        wrapper = Wrapper[wrapper.upper()]
    if wrapper_kwargs is None:
        wrapper_kwargs = {}
    return wrapper.get_env(env, **wrapper_kwargs) if wrapper is not None else env
