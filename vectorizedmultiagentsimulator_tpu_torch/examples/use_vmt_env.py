"""Generic rollout driver (reference ``vmas/examples/use_vmas_env.py``),
the PyTorch counterpart of the JAX package's ``examples/use_vmt_env.py``.
Runs on the card unless ``device="cpu"`` is given."""
import random
import time

import torch

from vectorizedmultiagentsimulator_tpu_torch import make_env
from vectorizedmultiagentsimulator_tpu_torch.interactive import save_video


def _get_deterministic_action(agent, continuous: bool, env):
    if continuous:
        action = -agent.action.u_range_tensor[None].expand(
            env.batch_dim, agent.action_size
        )
    else:
        action = torch.ones((env.batch_dim, 1), dtype=torch.int32,
                            device=env.device)
    return action


def use_vmt_env(
    render: bool = False,
    save_render: bool = False,
    num_envs: int = 32,
    n_steps: int = 100,
    random_action: bool = False,
    device: str = None,
    scenario_name: str = "waterfall",
    continuous_actions: bool = True,
    visualize_render: bool = True,
    dict_spaces: bool = True,
    **kwargs,
):
    """Run ``n_steps`` of ``num_envs`` parallel environments."""
    assert not (
        save_render and not render
    ), "To save the video you have to render it"

    env = make_env(
        scenario=scenario_name,
        num_envs=num_envs,
        device=device,
        continuous_actions=continuous_actions,
        dict_spaces=dict_spaces,
        wrapper=None,
        seed=None,
        **kwargs,
    )

    frame_list = []
    init_time = time.time()

    for step in range(1, n_steps + 1):
        # Actions can be a list (one per agent) or a dict keyed by name.
        dict_actions = random.choice([True, False])
        actions = {} if dict_actions else []
        for agent in env.agents:
            if not random_action:
                action = _get_deterministic_action(
                    agent, continuous_actions, env
                )
            else:
                action = env.get_random_action(agent)
            if dict_actions:
                actions.update({agent.name: action})
            else:
                actions.append(action)

        obs, rews, dones, info = env.step(actions)

        if render:
            frame = env.render(mode="rgb_array", agent_index_focus=None)
            if save_render:
                frame_list.append(frame)

    total_time = time.time() - init_time
    print(
        f"It took: {total_time}s for {n_steps} steps of {num_envs} parallel"
        f" environments for {scenario_name} scenario."
    )
    if render and save_render:
        save_video(scenario_name, frame_list, fps=1 / env.scenario.world.dt)
    return env


if __name__ == "__main__":
    use_vmt_env(
        scenario_name="waterfall",
        render=False,
        random_action=False,
        continuous_actions=False,
        n_agents=4,
    )
