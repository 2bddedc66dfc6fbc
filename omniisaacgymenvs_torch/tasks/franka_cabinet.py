"""FrankaCabinet: open the cabinet's top drawer with a Panda arm (PyTorch
port of the JAX package's `tasks/franka_cabinet.py`).

23-dim obs [franka dof_pos scaled to [-1, 1] (9), dof_vel * 0.1 (9),
grasp-to-handle vector (3), drawer position (1), drawer velocity (1)], 9
actions as integrated position targets with speed scales (fingers x 0.1)
and actionScale 7.5 at dt = 1/60; a grasp-frame reward (distance kernel,
axis alignments, fingers around the handle, drawer-open progress and
bonuses, action penalty); termination when the drawer opens past 0.39 m
or after 500 steps; reset with +-0.125 rad joint noise. The right finger's
pose is read from the right finger.

Random draws: `sample_reset` draws (`reset_draws`) and builds the state
from them (`reset_from`); `control` draws nothing.
"""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.models import franka_cabinet as fcm
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device


def _tf_combine(q1, p1, q2, p2):
    """The frame (q2, p2) given in frame (q1, p1), in the world."""
    return rot.quat_mul(q1, q2), p1 + rot.quat_rotate(q1, p2)


class FrankaCabinetTask(RLTask):
    name = "FrankaCabinet"
    num_obs = 23
    num_states = 0
    num_actions = 9

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        sim_cfg = cfg.get("sim", {})
        self.max_episode_length = env_cfg.get("episodeLength", 500)
        self.action_scale = env_cfg.get("actionScale", 7.5)
        self.dof_vel_scale = env_cfg.get("dofVelocityScale", 0.1)
        self.dist_reward_scale = env_cfg.get("distRewardScale", 2.0)
        self.rot_reward_scale = env_cfg.get("rotRewardScale", 0.5)
        self.around_handle_reward_scale = env_cfg.get("aroundHandleRewardScale", 10.0)
        self.open_reward_scale = env_cfg.get("openRewardScale", 7.5)
        self.finger_dist_reward_scale = env_cfg.get("fingerDistRewardScale", 100.0)
        self.action_penalty_scale = env_cfg.get("actionPenaltyScale", 0.01)
        self.finger_close_reward_scale = env_cfg.get("fingerCloseRewardScale", 10.0)
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 2)
        self.dt = 1.0 / 60.0

        dev = resolve_device(device)
        self.num_props = env_cfg.get("numProps", 0)
        model, drawer_body = fcm.build_franka_cabinet(self.num_props, device=dev)
        self.model = model
        self._drawer_body = drawer_body
        self.engine = PhysicsEngine(
            model,
            sim_params_from_cfg(
                sim_cfg, dt=1.0 / 120.0, substeps=2,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        self._hand_body = model.body_index("panda_joint7")
        self._lfinger_body = model.body_index("panda_finger_joint1")
        self._rfinger_body = model.body_index("panda_finger_joint2")
        drawer_dof = model.dof_index("drawer_top_joint")
        self._drawer_q = int(model.jq_idx[drawer_dof])
        self._drawer_v = int(model.jv_idx[drawer_dof])
        # the franka's dofs are the model's first 9
        long = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
        self._fq = long(model.jq_idx[0:9])
        self._fv = long(model.jv_idx[0:9])
        self._cab_q = long(model.jq_idx[9:])
        self._lo = model.dof_limit_lower[0:9]
        self._hi = model.dof_limit_upper[0:9]
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        self._local_grasp = f32(fcm.GRASP_OFFSET)
        self._drawer_local_grasp = f32(fcm.DRAWER_LOCAL_GRASP)
        self._gripper_forward = f32([0.0, 0.0, 1.0])
        self._gripper_up = f32([0.0, 1.0, 0.0])
        self._drawer_inward = f32(fcm.DRAWER_INWARD_AXIS)
        self._drawer_up = f32(fcm.DRAWER_UP_AXIS)
        self._default_dof = f32(fcm.FRANKA_DEFAULT_DOF)
        self._speed_scales = f32([1.0] * 7 + [0.1, 0.1])
        self._identity = rot.quat_identity(device=dev)

    def initial_carry(self, n: int):
        targets = torch.zeros((n, self.model.njd), device=self.device)
        targets[:, 0:9] = self._default_dof
        return dict(dof_targets=targets)

    # -- reset -----------------------------------------------------------
    def reset_draws(self, n: int, generator: torch.Generator):
        """(n, 9) uniform in [0, 1): the franka's joint noise before its
        0.25 scale about 0.5."""
        return torch.rand((n, 9), generator=generator, device=self.device)

    def reset_from(self, u):
        m = self.model
        n = u.shape[0]
        noise = 0.25 * (u - 0.5)
        fr = torch.minimum(torch.maximum(self._default_dof + noise, self._lo),
                           self._hi)
        q = m.default_q.expand(n, -1).clone()
        q[:, self._fq] = fr
        q[:, self._cab_q] = 0.0  # the cabinet closed
        targets = torch.zeros((n, m.njd), device=self.device)
        targets[:, 0:9] = fr
        return q, torch.zeros((n, m.nv), device=self.device), dict(dof_targets=targets)

    def sample_reset(self, n: int, generator: torch.Generator):
        return self.reset_from(self.reset_draws(n, generator))

    # ------------------------------------------------------------------
    def control(self, action, es: EnvState, generator=None):
        t = es.carry["dof_targets"]
        franka_t = torch.minimum(
            torch.maximum(
                t[:, 0:9]
                + self._speed_scales * self.dt * action * self.action_scale,
                self._lo),
            self._hi)
        t = torch.cat([franka_t, t[:, 9:]], dim=-1)
        es.carry["dof_targets"] = t
        ctrl = self.engine.default_control(action.shape[0])
        ctrl.pos_target = t
        return ctrl

    def _grasp_frames(self, phys):
        hand_rot = phys.body_quat[:, self._hand_body]
        hand_pos = phys.body_pos[:, self._hand_body]
        fg_rot, fg_pos = _tf_combine(hand_rot, hand_pos, self._identity,
                                     self._local_grasp)
        drawer_rot = phys.body_quat[:, self._drawer_body]
        drawer_pos = phys.body_pos[:, self._drawer_body]
        dg_rot, dg_pos = _tf_combine(drawer_rot, drawer_pos, self._identity,
                                     self._drawer_local_grasp)
        return fg_rot, fg_pos, dg_rot, dg_pos

    def observe(self, phys, carry, action):
        dof_pos = phys.q[:, self._fq]
        dof_vel = phys.qd[:, self._fv]
        dof_pos_scaled = 2.0 * (dof_pos - self._lo) / (self._hi - self._lo) - 1.0
        _, fg_pos, _, dg_pos = self._grasp_frames(phys)
        obs = torch.cat(
            [
                dof_pos_scaled,
                dof_vel * self.dof_vel_scale,
                dg_pos - fg_pos,
                phys.q[:, self._drawer_q, None],
                phys.qd[:, self._drawer_v, None],
            ],
            dim=-1,
        )
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        fg_rot, fg_pos, dg_rot, dg_pos = self._grasp_frames(phys)
        lfinger_z = phys.body_pos[:, self._lfinger_body, 2]
        rfinger_z = phys.body_pos[:, self._rfinger_body, 2]
        joint_positions = phys.q[:, self._fq]
        drawer_q = phys.q[:, self._drawer_q]
        zero = torch.zeros_like(drawer_q)

        d = torch.linalg.norm(fg_pos - dg_pos, dim=-1)
        dist_reward = (1.0 / (1.0 + d * d)) ** 2
        dist_reward = torch.where(d <= 0.02, dist_reward * 2.0, dist_reward)

        axis1 = rot.quat_rotate(fg_rot, self._gripper_forward)
        axis2 = rot.quat_rotate(dg_rot, self._drawer_inward)
        axis3 = rot.quat_rotate(fg_rot, self._gripper_up)
        axis4 = rot.quat_rotate(dg_rot, self._drawer_up)
        dot1 = (axis1 * axis2).sum(-1)
        dot2 = (axis3 * axis4).sum(-1)
        rot_reward = 0.5 * (torch.sign(dot1) * dot1 ** 2
                            + torch.sign(dot2) * dot2 ** 2)

        around = (lfinger_z > dg_pos[:, 2]) & (rfinger_z < dg_pos[:, 2])
        around_handle_reward = 0.5 * around.float()

        lfd = torch.abs(lfinger_z - dg_pos[:, 2])
        rfd = torch.abs(rfinger_z - dg_pos[:, 2])
        finger_dist_reward = torch.where(around, (0.04 - lfd) + (0.04 - rfd),
                                         zero)
        finger_close_reward = torch.where(
            d <= 0.03,
            (0.04 - joint_positions[:, 7]) + (0.04 - joint_positions[:, 8]),
            zero,
        )
        action_penalty = torch.sum(action ** 2, dim=-1)
        open_reward = drawer_q * around_handle_reward + drawer_q

        rewards = (
            self.dist_reward_scale * dist_reward
            + self.rot_reward_scale * rot_reward
            + self.around_handle_reward_scale * around_handle_reward
            + self.open_reward_scale * open_reward
            + self.finger_dist_reward_scale * finger_dist_reward
            - self.action_penalty_scale * action_penalty
            + self.finger_close_reward_scale * finger_close_reward
        )
        rewards = torch.where(drawer_q > 0.01, rewards + 0.5, rewards)
        rewards = torch.where(drawer_q > 0.2, rewards + around_handle_reward,
                              rewards)
        rewards = torch.where(drawer_q > 0.39,
                              rewards + 2.0 * around_handle_reward, rewards)
        done = (drawer_q > 0.39) | (progress >= self.max_episode_length - 1)
        return rewards, done, carry, {}
