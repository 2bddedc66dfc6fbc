"""BallBalance task: keep a ball centred on an actuated tray (PyTorch port
of the JAX package's `tasks/ball_balance.py`).

24-dim obs: actuated dof pos/vel (6), ball position and velocity (6), the
tray's contact wrench force / 20 and torque / 20 (6), ball position
relative to the tray (3), ball angular velocity / pi (3). 3 actions as
integrated position targets (dt * actionSpeedScale), reward pos_reward *
speed_reward about the ball target (0, 0, 0.7), termination on the ball
below 1.5 radii or 500 steps, reset with the ball tossed from a random
offset and height with inward velocity.
"""

from __future__ import annotations

import math

import torch

from omniisaacgymenvs_torch.models.balance_bot import (
    BALL_RADIUS,
    build_balance_bot,
)
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device


class BallBalanceTask(RLTask):
    name = "BallBalance"
    num_obs = 24
    num_states = 0
    num_actions = 3

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        sim_cfg = cfg.get("sim", {})
        self.max_episode_length = env_cfg.get("maxEpisodeLength", 500)
        self.action_speed_scale = env_cfg.get("actionSpeedScale", 20.0)
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 2)
        self.dt = sim_cfg.get("dt", 0.01)
        self.model = build_balance_bot(device=resolve_device(device))
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                dict(sim_cfg, dt=self.dt), substeps=2,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        self._ball_q = self.model.root_q_adr("ball")
        self._ball_v = self.model.root_v_adr("ball")
        self._ball_body = self.model.body_index("ball")
        self._tray_body = self.model.body_index("tray")
        self._target = torch.tensor([0.0, 0.0, 0.7], device=self.device)

    def initial_carry(self, n: int):
        return dict(dof_targets=torch.zeros((n, self.model.njd),
                                            device=self.device))

    def sample_reset(self, n: int, generator: torch.Generator):
        m = self.model
        dev = self.device
        u = torch.rand((n, 4), generator=generator, device=dev)
        # ball tossed from a random offset with inward velocity
        dist = 0.001 + (0.5 - 0.001) * u[:, 0]
        ang = 2.0 * math.pi * u[:, 1]
        direc = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        height = 1.0 + u[:, 2]
        speedscale = (dist - 0.001) / (0.5 - 0.001)
        hspeed = 2.0 * u[:, 3]

        q = m.default_q.expand(n, -1).clone()
        qa, va = self._ball_q, self._ball_v
        q[:, qa: qa + 2] = dist[:, None] * direc
        q[:, qa + 2] = height
        qd = torch.zeros((n, m.nv), device=dev)
        qd[:, va + 3: va + 5] = -(speedscale * hspeed)[:, None] * direc
        qd[:, va + 5] = -5.0
        return q, qd, self.initial_carry(n)

    def control(self, action, es: EnvState, generator=None):
        m = self.model
        targets = torch.minimum(
            torch.maximum(
                es.carry["dof_targets"]
                + self.dt * self.action_speed_scale * action,
                m.dof_limit_lower,
            ),
            m.dof_limit_upper,
        )
        es.carry["dof_targets"] = targets
        ctrl = self.engine.default_control(action.shape[0])
        ctrl.pos_target = targets
        return ctrl

    def observe(self, phys, carry, action):
        ball_pos = phys.q[:, self._ball_q: self._ball_q + 3]
        tray_wrench = phys.sensor_forces[:, 0]
        obs = torch.cat(
            [
                phys.q[:, 0:3],
                phys.qd[:, 0:3],
                ball_pos,
                phys.body_lvel[:, self._ball_body],
                tray_wrench[:, 0:3] / 20.0,
                tray_wrench[:, 3:6] / 20.0,
                ball_pos - phys.body_pos[:, self._tray_body],
                phys.body_avel[:, self._ball_body] / math.pi,
            ],
            dim=-1,
        )
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        ball_pos = phys.q[:, self._ball_q: self._ball_q + 3]
        ball_dist = torch.linalg.norm(ball_pos - self._target, dim=-1)
        ball_speed = torch.linalg.norm(phys.body_lvel[:, self._ball_body], dim=-1)
        reward = (1.0 / (1.0 + ball_dist)) * (1.0 / (1.0 + ball_speed))
        done = (ball_pos[:, 2] < BALL_RADIUS * 1.5) | (
            progress >= self.max_episode_length - 1
        )
        return reward, done, carry, {}
