"""Heuristic rollout driver (reference ``vmas/examples/run_heuristic.py``),
the PyTorch counterpart of the JAX package's ``examples/run_heuristic.py``.
Runs on the card unless ``device="cpu"`` is given."""
import time
from typing import Type

import torch

from vectorizedmultiagentsimulator_tpu_torch import make_env
from vectorizedmultiagentsimulator_tpu_torch.interactive import save_video
from vectorizedmultiagentsimulator_tpu_torch.models import (
    BaseHeuristicPolicy,
    RandomPolicy,
)


def run_heuristic(
    scenario_name: str,
    heuristic: Type[BaseHeuristicPolicy] = RandomPolicy,
    n_steps: int = 200,
    n_envs: int = 32,
    env_kwargs: dict = None,
    render: bool = False,
    save_render: bool = False,
    device: str = None,
):
    assert not (
        save_render and not render
    ), "To save the video you have to render it"
    if env_kwargs is None:
        env_kwargs = {}

    policy = heuristic(continuous_action=True)
    env = make_env(
        scenario=scenario_name,
        num_envs=n_envs,
        device=device,
        continuous_actions=True,
        wrapper=None,
        **env_kwargs,
    )

    frame_list = []
    init_time = time.time()
    obs = env.reset()
    # Summed on the device; read once at the end.
    total_reward = torch.zeros((), device=env.device)
    for _ in range(n_steps):
        actions = [
            policy.compute_action(obs[i], u_range=env.agents[i].u_range)
            for i in range(len(obs))
        ]
        obs, rews, dones, info = env.step(actions)
        rewards = torch.stack(rews, dim=1)
        total_reward = total_reward + torch.mean(rewards)
        if render:
            frame_list.append(
                env.render(mode="rgb_array", agent_index_focus=None)
            )
    total_reward = float(total_reward)

    total_time = time.time() - init_time
    if render and save_render:
        save_video(scenario_name, frame_list, fps=1 / env.scenario.world.dt)
    print(
        f"It took: {total_time}s for {n_steps} steps of {n_envs} parallel"
        f" environments\nThe average total reward was {total_reward}"
    )
    return total_reward


if __name__ == "__main__":
    from vectorizedmultiagentsimulator_tpu_torch.scenarios.transport import (
        HeuristicPolicy as TransportHeuristic,
    )

    run_heuristic(
        scenario_name="transport",
        heuristic=TransportHeuristic,
        n_envs=300,
        n_steps=200,
        render=False,
    )
