"""Shared locomotion task (Ant/Humanoid), batched (PyTorch port of the JAX
package's `tasks/shared/locomotion.py`).

Torque control forces = actions * joint_gears * power_scale; reset with
+-0.2 rad dof position / +-0.1 dof velocity noise clamped to limits;
observation layout:
  [torso_z(1), vel_loc(3), angvel_loc*angular_velocity_scale(3), yaw(1),
   roll(1), angle_to_target(1), up_proj(1), heading_proj(1),
   dof_pos_scaled(nd), dof_vel*dof_vel_scale(nd),
   sensor_force_torques*contact_force_scale(ns*6), actions(na)]
reward = progress + alive + up + heading - action/energy/limit costs, with
the death cost below the termination height; termination on height or
episode length. Potentials use the 60 Hz control dt with targets
[1000, 0, 0].
"""

from __future__ import annotations

import math

import torch

from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask


class LocomotionTask(RLTask):
    """Subclasses set: model, engine, joint_gears, motor_effort_ratio,
    num_obs/num_actions, and dof_at_limit_cost()."""

    joint_gears: torch.Tensor
    motor_effort_ratio: torch.Tensor

    def __init__(self, cfg: dict | None = None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        self.max_episode_length = env_cfg.get("episodeLength", 1000)
        self.dof_vel_scale = env_cfg.get("dofVelocityScale", 0.2)
        self.angular_velocity_scale = env_cfg.get("angularVelocityScale", 1.0)
        self.contact_force_scale = env_cfg.get("contactForceScale", 0.1)
        self.power_scale = env_cfg.get("powerScale", 1.0)
        self.heading_weight = env_cfg.get("headingWeight", 0.5)
        self.up_weight = env_cfg.get("upWeight", 0.1)
        self.actions_cost_scale = env_cfg.get("actionsCost", 0.005)
        self.energy_cost_scale = env_cfg.get("energyCost", 0.05)
        self.joints_at_limit_cost_scale = env_cfg.get("jointsAtLimitCost", 0.1)
        self.death_cost = env_cfg.get("deathCost", -2.0)
        self.termination_height = env_cfg.get("terminationHeight", 0.31)
        self.alive_reward_scale = env_cfg.get("alive_reward_scale", 0.5)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.clip_obs = env_cfg.get("clipObservations", math.inf)
        self.decimation = env_cfg.get("controlFrequencyInv", 2)
        # potentials always use 1/60 s
        self.dt = 1.0 / 60.0

    def _init_constants(self):
        """Device tensors the hooks use; call once model and engine exist."""
        dev = self.device
        self.targets = torch.tensor([1000.0, 0.0, 0.0], device=dev)
        self._inv_start_rot = rot.quat_conjugate(
            torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        )
        self._heading_vec = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self._up_vec = torch.tensor([0.0, 0.0, 1.0], device=dev)

    # ------------------------------------------------------------------
    def dof_at_limit_cost(self, obs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _potential(self, torso_position: torch.Tensor):
        """(potential, planar vector to the target) per env."""
        to_target = self.targets - torso_position
        to_target[..., 2] = 0.0
        return -torch.linalg.norm(to_target, dim=-1) / self.dt, to_target

    def sample_reset(self, n: int, generator: torch.Generator):
        m = self.model
        dev = self.device
        jq0 = m.jq0
        dof_noise = torch.rand((n, m.njd), generator=generator, device=dev)
        dof_noise = dof_noise * 0.4 - 0.2
        dof_pos = torch.minimum(
            torch.maximum(m.default_q[jq0:] + dof_noise, m.dof_limit_lower),
            m.dof_limit_upper,
        )
        dof_vel = torch.rand((n, m.njd), generator=generator, device=dev)
        dof_vel = dof_vel * 0.2 - 0.1
        q = m.default_q.expand(n, -1).clone()
        q[:, jq0:] = dof_pos
        qd = torch.zeros((n, m.nv), device=dev)
        qd[:, m.jd0:] = dof_vel
        pot, _ = self._potential(q[:, 0:3])
        carry = dict(
            potentials=pot,
            prev_potentials=pot.clone(),
            actions=torch.zeros((n, self.num_actions), device=dev),
        )
        return q, qd, carry

    def control(self, action: torch.Tensor, es: EnvState, generator=None):
        ctrl = self.engine.default_control(action.shape[0])
        ctrl.effort = action * self.joint_gears * self.power_scale
        return ctrl

    def observe(self, phys, carry, action):
        m = self.model
        torso_position = phys.q[:, 0:3]
        torso_rotation = phys.q[:, 3:7]
        velocity = phys.body_lvel[:, 0]
        ang_velocity = phys.body_avel[:, 0]
        dof_pos = phys.q[:, m.jq0:]
        dof_vel = phys.qd[:, m.jd0:]
        sensor_forces = phys.sensor_forces.reshape(phys.q.shape[0], -1)

        prev_potentials = carry["potentials"]
        potentials, to_target = self._potential(torso_position)

        torso_quat, up_proj, heading_proj, _, _ = rot.compute_heading_and_up(
            torso_rotation, self._inv_start_rot, to_target,
            self._heading_vec, self._up_vec, 2,
        )
        vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target = rot.compute_rot(
            torso_quat, velocity, ang_velocity, self.targets, torso_position
        )
        dof_pos_scaled = rot.unscale(
            dof_pos, m.dof_limit_lower, m.dof_limit_upper
        )
        obs = torch.cat(
            [
                torso_position[:, 2:3],
                vel_loc,
                angvel_loc * self.angular_velocity_scale,
                rot.normalize_angle(yaw)[:, None],
                rot.normalize_angle(roll)[:, None],
                rot.normalize_angle(angle_to_target)[:, None],
                up_proj[:, None],
                heading_proj[:, None],
                dof_pos_scaled,
                dof_vel * self.dof_vel_scale,
                sensor_forces * self.contact_force_scale,
                action,
            ],
            dim=-1,
        )
        carry = dict(
            carry,
            potentials=potentials,
            prev_potentials=prev_potentials,
            actions=action,
        )
        states = obs.new_zeros((obs.shape[0], 0))
        return obs, states, carry

    def reward_done(self, obs, action, phys, carry, progress):
        nd = self.model.njd
        heading_proj = obs[:, 11]
        up_proj = obs[:, 10]
        heading_reward = torch.where(
            heading_proj > 0.8,
            torch.full_like(heading_proj, self.heading_weight),
            self.heading_weight * heading_proj / 0.8,
        )
        up_reward = torch.where(
            up_proj > 0.93, torch.full_like(up_proj, self.up_weight),
            torch.zeros_like(up_proj),
        )
        actions_cost = torch.sum(action ** 2, dim=-1)
        electricity_cost = torch.sum(
            torch.abs(action * obs[:, 12 + nd: 12 + 2 * nd])
            * self.motor_effort_ratio,
            dim=-1,
        )
        progress_reward = carry["potentials"] - carry["prev_potentials"]
        total_reward = (
            progress_reward
            + self.alive_reward_scale
            + up_reward
            + heading_reward
            - self.actions_cost_scale * actions_cost
            - self.energy_cost_scale * electricity_cost
            - self.dof_at_limit_cost(obs)
        )
        fallen = obs[:, 0] < self.termination_height
        total_reward = torch.where(
            fallen, torch.full_like(total_reward, self.death_cost), total_reward
        )
        done = fallen | (progress >= self.max_episode_length - 1)
        return total_reward, done, carry, {}
