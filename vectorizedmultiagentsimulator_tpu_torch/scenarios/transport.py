"""Transport scenario (reference ``vmas/scenarios/transport.py``).

Agents push one or more heavy box packages (mass 50) onto a goal.
Exercises the box-sphere narrowphase, rejection-sampling spawns and the
shaping-reward buffer (``global_shaping``), a tensor in ``state.extras``.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.models import BaseHeuristicPolicy
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        self.n_packages = kwargs.pop("n_packages", 1)
        self.package_width = kwargs.pop("package_width", 0.15)
        self.package_length = kwargs.pop("package_length", 0.15)
        self.package_mass = kwargs.pop("package_mass", 50)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.shaping_factor = 100
        self.world_semidim = 1
        self.agent_radius = 0.03

        semidim = (
            self.world_semidim
            + 2 * self.agent_radius
            + max(self.package_length, self.package_width)
        )
        world = World(batch_dim, device, x_semidim=semidim, y_semidim=semidim)
        for i in range(n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    shape=Sphere(self.agent_radius),
                    u_multiplier=0.6,
                )
            )
        goal = Landmark(
            name="goal",
            collide=False,
            shape=Sphere(radius=0.15),
            color=Color.LIGHT_GREEN,
        )
        world.add_landmark(goal)
        self._packages = []
        for i in range(self.n_packages):
            package = Landmark(
                name=f"package {i}",
                collide=True,
                movable=True,
                mass=self.package_mass,
                shape=Box(length=self.package_length, width=self.package_width),
                color=Color.RED,
            )
            package.goal = goal
            self._packages.append(package)
            world.add_landmark(package)
        return world

    @property
    def packages(self):
        return self._packages

    def reset_world_at(self, env_index=None):
        ScenarioUtils.spawn_entities_randomly(
            self.world.agents,
            self.world,
            env_index,
            min_dist_between_entities=self.agent_radius * 2,
            x_bounds=(-self.world_semidim, self.world_semidim),
            y_bounds=(-self.world_semidim, self.world_semidim),
        )
        agent_occupied_positions = torch.stack(
            [agent.state.pos for agent in self.world.agents], dim=1
        )

        goal = self.world.landmarks[0]
        ScenarioUtils.spawn_entities_randomly(
            [goal] + self._packages,
            self.world,
            env_index,
            min_dist_between_entities=max(
                package.shape.circumscribed_radius() + goal.shape.radius + 0.01
                for package in self._packages
            ),
            x_bounds=(-self.world_semidim, self.world_semidim),
            y_bounds=(-self.world_semidim, self.world_semidim),
            occupied_positions=agent_occupied_positions,
        )

        for package in self._packages:
            on_goal = self.world.is_overlapping(package, package.goal)
            shaping = (
                torch.linalg.norm(
                    package.state.pos - package.goal.state.pos, dim=1
                )
                * self.shaping_factor
            )
            if env_index is None:
                package.on_goal = on_goal
                package.global_shaping = shaping
                package.dist_to_goal = torch.zeros_like(shaping)
            else:
                package.on_goal = TorchUtils.where_from_index(
                    env_index, on_goal, package.on_goal
                )
                package.global_shaping = TorchUtils.where_from_index(
                    env_index, shaping, package.global_shaping
                )
        if env_index is None:
            self.rew = torch.zeros(
                (self.world.batch_dim,), device=self.world.device
            )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            rew = torch.zeros((self.world.batch_dim,), device=self.world.device)
            for package in self._packages:
                dist_to_goal = torch.linalg.norm(
                    package.state.pos - package.goal.state.pos, dim=1
                )
                package.dist_to_goal = dist_to_goal
                package.on_goal = self.world.is_overlapping(
                    package, package.goal
                )
                package_shaping = dist_to_goal * self.shaping_factor
                rew = rew + torch.where(
                    package.on_goal,
                    torch.zeros_like(rew),
                    package.global_shaping - package_shaping,
                )
                package.global_shaping = package_shaping
            self.rew = rew
        return self.rew

    def observation(self, agent):
        package_obs = []
        for package in self._packages:
            package_obs.append(package.state.pos - package.goal.state.pos)
            package_obs.append(package.state.pos - agent.state.pos)
            package_obs.append(package.state.vel)
            package_obs.append(package.on_goal[:, None].to(torch.float32))
        return torch.cat(
            [agent.state.pos, agent.state.vel, *package_obs], dim=-1
        )

    def done(self):
        return torch.all(
            torch.stack([package.on_goal for package in self._packages], dim=1),
            dim=-1,
        )


class HeuristicPolicy(BaseHeuristicPolicy):
    """Hermite-spline dribbling policy (transport.py:194-348)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.lookahead = 0.0
        self.start_vel_dist_from_target_ratio = 0.5
        self.start_vel_behind_ratio = 0.5
        self.start_vel_mag = 1.0
        self.hit_vel_mag = 1.0
        self.package_radius = 0.15 / 2
        self.agent_radius = -0.02
        self.dribble_slowdown_dist = 0.0
        self.speed = 0.95

    def compute_action(self, observation, u_range: float):
        agent_pos = observation[:, :2]
        package_pos = observation[:, 6:8] + agent_pos
        goal_pos = -observation[:, 4:6] + package_pos
        control = self.dribble(agent_pos, package_pos, goal_pos)
        control = control * (self.speed * u_range)
        return torch.clamp(control, -u_range, u_range)

    def dribble(self, agent_pos, package_pos, goal_pos, agent_vel=None):
        package_disp = goal_pos - package_pos
        ball_dist = torch.linalg.norm(package_disp, dim=-1)
        direction = package_disp / torch.clamp_min(ball_dist, 1e-8)[:, None]
        hit_pos = package_pos - direction * (
            self.package_radius + self.agent_radius
        )
        hit_vel = direction * self.hit_vel_mag
        start_vel = self.get_start_vel(
            hit_pos, hit_vel, agent_pos, self.start_vel_mag * 2
        )
        if self.dribble_slowdown_dist > 0:
            slowdown = ball_dist <= self.dribble_slowdown_dist
            hit_vel = torch.where(
                slowdown[:, None],
                hit_vel * (ball_dist / self.dribble_slowdown_dist)[:, None],
                hit_vel,
            )
        return self.get_action(
            target_pos=hit_pos,
            target_vel=hit_vel,
            curr_pos=agent_pos,
            curr_vel=agent_vel,
            start_vel=start_vel,
        )

    @staticmethod
    def nPr(n, r):
        if r > n:
            return 0
        ans = 1
        for k in range(n, max(1, n - r), -1):
            ans = ans * k
        return ans

    def hermite(self, p0, p1, p0dot, p1dot, u=0.0, deriv=0):
        u = u.reshape(-1)
        U = torch.stack(
            [
                self.nPr(3, deriv) * (u ** max(0, 3 - deriv)),
                self.nPr(2, deriv) * (u ** max(0, 2 - deriv)),
                self.nPr(1, deriv) * (u ** max(0, 1 - deriv)),
                self.nPr(0, deriv) * (u**0),
            ],
            dim=1,
        ).to(torch.float32)
        A = torch.tensor(
            [
                [2.0, -2.0, 1.0, 1.0],
                [-3.0, 3.0, -2.0, -1.0],
                [0.0, 0.0, 1.0, 0.0],
                [1.0, 0.0, 0.0, 0.0],
            ],
            device=p0.device,
        )
        P = torch.stack([p0, p1, p0dot, p1dot], dim=1)
        ans = U[:, None, :] @ A[None, :, :] @ P
        return ans[:, 0]

    def get_start_vel(self, pos, vel, start_pos, start_vel_mag):
        goal_disp = pos - start_pos
        goal_dist = torch.linalg.norm(goal_disp, dim=-1)
        vel_mag = torch.linalg.norm(vel, dim=-1)
        vel_dir = torch.where(
            (vel_mag > 0)[:, None],
            vel / torch.clamp_min(vel_mag, 1e-8)[:, None],
            vel,
        )
        goal_dir = goal_disp / torch.clamp_min(goal_dist, 1e-8)[:, None]

        vel_dir_normal = torch.stack([-vel_dir[:, 1], vel_dir[:, 0]], dim=1)
        dot_prod = torch.sum(goal_dir * vel_dir_normal, dim=1)
        vel_dir_normal = torch.where(
            (dot_prod > 0)[:, None], -vel_dir_normal, vel_dir_normal
        )

        dist_behind_target = self.start_vel_dist_from_target_ratio * goal_dist
        point_dir = -vel_dir * self.start_vel_behind_ratio + vel_dir_normal * (
            1 - self.start_vel_behind_ratio
        )
        target_pos = pos + point_dir * dist_behind_target[:, None]
        target_disp = target_pos - start_pos
        target_dist = torch.linalg.norm(target_disp, dim=1)
        start_vel_aug_dir = torch.where(
            (target_dist > 0)[:, None],
            target_disp / torch.clamp_min(target_dist, 1e-8)[:, None],
            target_disp,
        )
        return start_vel_aug_dir * start_vel_mag

    def get_action(
        self,
        target_pos,
        target_vel=None,
        start_pos=None,
        start_vel=None,
        curr_pos=None,
        curr_vel=None,
    ):
        if curr_pos is None:
            curr_pos = torch.zeros_like(target_pos)
        if curr_vel is None:
            curr_vel = torch.zeros_like(target_pos)
        if start_pos is None:
            start_pos = curr_pos
        if target_vel is None:
            target_vel = torch.zeros_like(target_pos)
        if start_vel is None:
            start_vel = self.get_start_vel(
                target_pos, target_vel, start_pos, self.start_vel_mag * 2
            )
        u_start = torch.full(
            (curr_pos.shape[0],), self.lookahead, device=curr_pos.device
        )
        des_curr_pos = self.hermite(
            start_pos, target_pos, start_vel, target_vel, u=u_start, deriv=0
        )
        des_curr_vel = self.hermite(
            start_pos, target_pos, start_vel, target_vel, u=u_start, deriv=1
        )
        return 0.5 * (des_curr_pos - curr_pos) + 0.5 * (des_curr_vel - curr_vel)
