"""ANYmal flat-ground velocity-command task (PyTorch port of the JAX
package's `tasks/anymal.py`).

48-dim obs [base_lin_vel*2.0(3), base_ang_vel*0.25(3), projected_gravity(3),
commands_scaled(3), (dof_pos-default)*1.0(12), dof_vel*0.05(12),
actions(12)]; integrated position targets current_targets +=
actionScale*a*dt clamped to the joint limits; velocity-tracking reward with
exp(-err/0.25) kernels and joint-acc / action-rate / cosmetic penalties, all
scaled by dt = 1/60; fallen over when the base is below 0.51 m; commands
re-drawn at every reset. Config cfg/task/Anymal.yaml (dt 0.01,
controlFrequencyInv 2, commands x[-2,2] y[-1,1] yaw[-1,1], actionScale 13.5,
episodeLength_s 50).
"""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.envs.views import ArticulationView
from omniisaacgymenvs_torch.models.anymal import build_anymal
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device


def uniform(generator, shape, lo, hi, device):
    """Uniform draws in [lo, hi) of `shape` on `device`."""
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


class AnymalTask(RLTask):
    name = "Anymal"
    num_obs = 48
    num_states = 0
    num_actions = 12

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        learn = env_cfg.get("learn", {})
        control = env_cfg.get("control", {})
        ranges = env_cfg.get("randomCommandVelocityRanges", {})
        sim_cfg = cfg.get("sim", {})

        self.lin_vel_scale = learn.get("linearVelocityScale", 2.0)
        self.ang_vel_scale = learn.get("angularVelocityScale", 0.25)
        self.dof_pos_scale = learn.get("dofPositionScale", 1.0)
        self.dof_vel_scale = learn.get("dofVelocityScale", 0.05)
        self.action_scale = control.get("actionScale", 13.5)
        # reward scales are multiplied by dt = 1/60
        self.dt = 1.0 / 60.0
        self.rew_scales = {
            "lin_vel_xy": learn.get("linearVelocityXYRewardScale", 1.0) * self.dt,
            "ang_vel_z": learn.get("angularVelocityZRewardScale", 0.5) * self.dt,
            "lin_vel_z": learn.get("linearVelocityZRewardScale", -0.03) * self.dt,
            "joint_acc": learn.get("jointAccRewardScale", -0.0003) * self.dt,
            "action_rate": learn.get("actionRateRewardScale", -0.006) * self.dt,
            "cosmetic": learn.get("cosmeticRewardScale", -0.06) * self.dt,
        }
        self.command_x_range = ranges.get("linear_x", (-2.0, 2.0))
        self.command_y_range = ranges.get("linear_y", (-1.0, 1.0))
        self.command_yaw_range = ranges.get("yaw", (-1.0, 1.0))
        self.max_episode_length = int(
            learn.get("episodeLength_s", 50) / self.dt + 0.5
        )
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 2)

        dev = resolve_device(device)
        self.model = build_anymal(device=dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                sim_cfg, dt=0.01, substeps=2, gravity=(0.0, 0.0, -9.81),
            ),
        )
        self.default_dof_pos = self.model.default_q[self.model.jq0:]
        self._base_view = ArticulationView(self.model)
        self._gravity_dir = torch.tensor([0.0, 0.0, -1.0], device=dev)
        self._cmd_scale = torch.tensor(
            [self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale],
            device=dev,
        )

    # ------------------------------------------------------------------
    def initial_carry(self, n: int):
        z = lambda *s: torch.zeros((n,) + s, device=self.device)  # noqa: E731
        return dict(
            commands=z(3),
            current_targets=self.default_dof_pos.expand(n, -1).clone(),
            last_actions=z(12),
            last_dof_vel=z(12),
        )

    def sample_reset(self, n: int, generator: torch.Generator):
        m = self.model
        dev = self.device
        q = m.default_q.expand(n, -1).clone()
        qd = torch.zeros((n, m.nv), device=dev)
        qd[:, m.jd0:] = uniform(generator, (n, m.njd), -0.1, 0.1, dev)
        carry = self.initial_carry(n)
        carry["commands"] = torch.stack(
            [uniform(generator, (n,), *r, dev)
             for r in (self.command_x_range, self.command_y_range,
                       self.command_yaw_range)], dim=-1)
        return q, qd, carry

    def control(self, action, es: EnvState, generator=None):
        # integrated, clamped position targets
        targets = torch.minimum(
            torch.maximum(
                es.carry["current_targets"]
                + self.action_scale * action * self.dt,
                self.model.dof_limit_lower,
            ),
            self.model.dof_limit_upper,
        )
        es.carry["current_targets"] = targets
        ctrl = self.engine.default_control(action.shape[0])
        ctrl.pos_target = targets
        return ctrl

    def _base_frame(self, phys):
        """Base linear and angular velocity in the base frame."""
        quat = phys.q[:, 3:7]
        return (rot.quat_rotate_inverse(quat, phys.body_lvel[:, 0]),
                rot.quat_rotate_inverse(quat, phys.body_avel[:, 0]))

    def observe(self, phys, carry, action):
        m = self.model
        base_lin_vel, base_ang_vel = self._base_frame(phys)
        projected_gravity = rot.quat_rotate_inverse(phys.q[:, 3:7],
                                                    self._gravity_dir)
        dof_pos = phys.q[:, m.jq0:]
        dof_vel = phys.qd[:, m.jd0:]
        obs = torch.cat(
            [
                base_lin_vel * self.lin_vel_scale,
                base_ang_vel * self.ang_vel_scale,
                projected_gravity,
                carry["commands"] * self._cmd_scale,
                (dof_pos - self.default_dof_pos) * self.dof_pos_scale,
                dof_vel * self.dof_vel_scale,
                action,
            ],
            dim=-1,
        )
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        m = self.model
        rs = self.rew_scales
        base_lin_vel, base_ang_vel = self._base_frame(phys)
        dof_pos = phys.q[:, m.jq0:]
        dof_vel = phys.qd[:, m.jd0:]
        commands = carry["commands"]

        lin_vel_error = torch.sum(
            torch.square(commands[:, 0:2] - base_lin_vel[:, 0:2]), dim=-1)
        ang_vel_error = torch.square(commands[:, 2] - base_ang_vel[:, 2])
        rew_lin_vel_xy = torch.exp(-lin_vel_error / 0.25) * rs["lin_vel_xy"]
        rew_ang_vel_z = torch.exp(-ang_vel_error / 0.25) * rs["ang_vel_z"]
        rew_lin_vel_z = torch.square(base_lin_vel[:, 2]) * rs["lin_vel_z"]
        rew_joint_acc = torch.sum(
            torch.square(carry["last_dof_vel"] - dof_vel), dim=-1
        ) * rs["joint_acc"]
        rew_action_rate = torch.sum(
            torch.square(carry["last_actions"] - action), dim=-1
        ) * rs["action_rate"]
        rew_cosmetic = torch.sum(
            torch.abs(dof_pos[:, 0:4] - self.default_dof_pos[0:4]), dim=-1
        ) * rs["cosmetic"]
        total_reward = torch.clamp(
            rew_lin_vel_xy + rew_ang_vel_z + rew_joint_acc
            + rew_action_rate + rew_cosmetic + rew_lin_vel_z,
            min=0.0,
        )
        base_pos, _ = self._base_view.get_world_poses(phys)
        fallen_over = base_pos[:, 2] < 0.51
        total_reward = torch.where(
            fallen_over, torch.full_like(total_reward, -1.0), total_reward)
        done = fallen_over | (progress >= self.max_episode_length - 1)
        carry = dict(carry, last_actions=action, last_dof_vel=dof_vel)
        return total_reward, done, carry, {}
