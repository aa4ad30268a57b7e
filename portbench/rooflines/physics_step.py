"""Operations and bytes of one launch of the port's physics kernel
(``physics_step_kernel``, one world step of every env), counted from the
configuration's structure: the state read once and written once, and the
arithmetic of each pair class, entity and joint constraint a substep.

The arithmetic per pair class and substep (per joint constraint, and the
fixed-rotation torque of one that does not rotate) is the count the port's
``chip_smoke.py`` made from ``csrc/physics_step.cu`` (``PHYSICS_OPS``: each
sqrt, sin, cos, exp, log and division one operation), copied here so that
a change to the kernel does not move its yardstick.
"""

KERNEL = "physics_step_kernel"
OPS = {"ss": 29, "bs": 131, "ls": 42, "ll": 133, "bl": 470, "bb": 3300,
       "entity": 25, "joint": 102, "joint_fixed": 17}
# Static tables a launch reads, in 4-byte words: an entity's mass, moment,
# drag, radius, length, width, movable and rotatable flags; a pair's two
# indices; a joint's two indices, two anchor offsets, rest distance and
# rotate flag.
TABLE_WORDS = {"entity": 8, "pair": 2, "joint": 8}


def count(config: dict, traffic: dict) -> dict:
    B = traffic["num_envs"]
    N = len(config["entities"])
    A = len(config["agents"])
    pairs = config["pairs"]
    joints = config["joints"]
    per_env = sum(OPS[c] * len(p) for c, p in pairs.items())
    per_env += OPS["entity"] * N + OPS["joint"] * len(joints)
    per_env += OPS["joint_fixed"] * sum(not j["rotate"] for j in joints)
    ops = B * config["world"]["substeps"] * per_env
    # pos, vel (2 each), rot, ang_vel read and written; the agents' action
    # force (2) and torque read
    state = 4 * B * (2 * N * 6 + A * 3)
    tables = 4 * (TABLE_WORDS["entity"] * N
                  + TABLE_WORDS["pair"] * sum(len(p) for p in pairs.values())
                  + TABLE_WORDS["joint"] * len(joints))
    return {"bytes": state + tables, "ops": {"fp32": ops}}
