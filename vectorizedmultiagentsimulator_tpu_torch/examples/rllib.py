"""RLlib PPO training example (reference ``vmas/examples/rllib.py``), the
PyTorch counterpart of the JAX package's ``examples/rllib.py``.

``ray`` is optional; this example is import-gated as there and documents
the wiring: the :class:`VectorEnvWrapper` plugs the environment into
RLlib's ``VectorEnv`` interface.  The envs run on the card unless the
config's ``device`` is ``"cpu"``.
"""
from __future__ import annotations

import importlib.util
from typing import Dict

from vectorizedmultiagentsimulator_tpu_torch import make_env

if importlib.util.find_spec("ray") is None:
    _HAS_RAY = False
else:
    _HAS_RAY = True
    import ray
    from ray import tune
    from ray.rllib.agents.ppo import PPOTrainer


scenario_name = "balance"
n_agents = 4
continuous_actions = True
max_steps = 200
num_vectorized_envs = 96
num_workers = 5
vmas_device = None  # the card; "cpu" for the CPU


def env_creator(config: Dict):
    env = make_env(
        scenario=config["scenario_name"],
        num_envs=config["num_envs"],
        device=config["device"],
        continuous_actions=config["continuous_actions"],
        max_steps=config["max_steps"],
        wrapper="rllib",
        **config.get("scenario_config", {}),
    )
    return env


def train():
    if not _HAS_RAY:
        raise ImportError(
            "RLlib is not installed. Please install it with"
            " `pip install ray[rllib]<=2.2`."
        )
    ray.init()
    tune.register_env("vmt_env", env_creator)
    tune.run(
        PPOTrainer,
        stop={"training_iteration": 5000},
        config={
            "seed": 0,
            "framework": "torch",
            "env": "vmt_env",
            "train_batch_size": 60000,
            "rollout_fragment_length": 125,
            "sgd_minibatch_size": 4096,
            "num_sgd_iter": 40,
            "num_gpus": 0,
            "num_workers": num_workers,
            "num_envs_per_worker": num_vectorized_envs,
            "lr": 5e-5,
            "gamma": 0.99,
            "use_gae": True,
            "use_critic": True,
            "batch_mode": "truncate_episodes",
            "env_config": {
                "device": vmas_device,
                "num_envs": num_vectorized_envs,
                "scenario_name": scenario_name,
                "continuous_actions": continuous_actions,
                "max_steps": max_steps,
                "scenario_config": {"n_agents": n_agents},
            },
        },
    )


if __name__ == "__main__":
    train()
