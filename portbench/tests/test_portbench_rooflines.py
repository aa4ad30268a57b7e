"""Each roofline's operations and bytes equal hand counts at a small
shape."""
from portbench.spec import load_cell, load_module


def count(kernel, workload, **traffic):
    cell = load_cell(workload)
    return load_module("rooflines", kernel).count(
        cell.config, dict(cell.traffic, **traffic))


def test_physics_transport():
    # 2 envs, 1 substep: 6 ss pairs x 29, 4 bs x 131, 6 entities x 25;
    # state: 6 entities x (pos, vel, rot, ang_vel) read and written, 4
    # agents' force and torque read; tables: 8 words an entity, 2 a pair
    got = count("physics_step", "transport.rollout", num_envs=2)
    assert got["ops"] == {"fp32": 2 * (6 * 29 + 4 * 131 + 6 * 25)}
    assert got["bytes"] == 4 * 2 * (2 * 6 * 6 + 4 * 3) + 4 * (8 * 6 + 2 * 10)


def test_physics_joint_passage():
    # 1 env, 10 substeps: 1 ss, 12 ls, 39 bs, 2 bl pairs, 23 entities, 3
    # joints (all rotating: no fixed-rotation torque)
    got = count("physics_step", "joint_passage.rollout", num_envs=1)
    per_substep = 29 + 12 * 42 + 39 * 131 + 2 * 470 + 23 * 25 + 3 * 102
    assert got["ops"] == {"fp32": 10 * per_substep}
    assert got["bytes"] == (4 * (2 * 23 * 6 + 2 * 3)
                            + 4 * (8 * 23 + 2 * 54 + 8 * 3))


PPO = dict(num_envs=64, ppo={"rollout_steps": 2, "epochs": 4,
                             "minibatches": 2, "hidden": 8,
                             "fused_block": 4})


def test_ppo_update():
    # obs 11 + 4 one-hot = 15 rows, 2 actions, hidden 8: 22 packed rows;
    # 2 x 4 x 64 = 512 samples, minibatches of 256 in 64 blocks of 4
    got = count("ppo_update", "transport.train", **PPO)
    n_params = 15 * 8 + 8 + 8 * 8 + 8 + 8 * 2 + 2 + 2 + 15 * 8 + 8 + 8 + 1
    assert n_params == 357
    assert got["bytes"] == 4 * (22 * 256 + 64 + 2 + 2 * 357 + 3)
    assert got["ops"] == {"bf16": 2 * (4 * 15 * 8 + 3 * 8 * 8) * 256,
                          "fp32": (2 * (3 * 8 * 2 + 2 * 8) + 15 * 8
                                   + 30 * 2) * 256}


def test_ppo_model():
    # a forward: 2 x (15x8 + 8x8 + 8x2 + 15x8 + 8x1) = 656 FLOP a sample,
    # over 512 samples and 4 x 64 last observations, then 3 forwards over
    # 512 samples in each of 4 epochs
    got = count("ppo_model", "transport.train", **PPO)
    assert got == {"bytes": 0,
                   "ops": {"bf16": 656 * (512 + 256) + 3 * 656 * 512 * 4}}
