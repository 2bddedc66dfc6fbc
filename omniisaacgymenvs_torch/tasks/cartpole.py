"""Cartpole balancing task (PyTorch port of the JAX package's
`tasks/cartpole.py`): obs [cart_pos, cart_vel, pole_pos, pole_vel], effort
control maxEffort * action on the cart, reward 1 - pole^2 - 0.01 |cart_vel|
- 0.005 |pole_vel| with -2 beyond bounds, termination on |cart| >
resetDist, |pole| > pi/2 or 500 steps, reset with U(-1, 1) m cart and
U(-pi/8, pi/8) pole positions and U(-0.5, 0.5) / U(-pi/4, pi/4)
velocities."""

from __future__ import annotations

import math

import torch

from omniisaacgymenvs_torch.models.cartpole import build_cartpole
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device


class CartpoleTask(RLTask):
    name = "Cartpole"
    num_obs = 4
    num_states = 0
    num_actions = 1
    max_episode_length = 500

    @property
    def timeout_progress(self) -> int:
        # Cartpole ends by time at `progress >= max_episode_length`, one
        # step later than the other tasks' `- 1` convention
        return self.max_episode_length

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        self.reset_dist = env_cfg.get("resetDist", 3.0)
        self.max_push_effort = env_cfg.get("maxEffort", 400.0)
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 2)
        self.model = build_cartpole(device=resolve_device(device))
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                cfg.get("sim", {}), dt=1.0 / 120.0, substeps=1,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        # the root is FIXED, so a joint-dof index addresses q and qd alike
        self._cart_dof = self.model.dof_index("cartJoint")
        self._pole_dof = self.model.dof_index("poleJoint")

    # ------------------------------------------------------------------
    def sample_reset(self, n: int, generator: torch.Generator):
        dev = self.device
        u = 2.0 * torch.rand((n, 4), generator=generator, device=dev) - 1.0
        q = torch.zeros((n, self.model.nq), device=dev)
        q[:, self._cart_dof] = u[:, 0]
        q[:, self._pole_dof] = 0.125 * math.pi * u[:, 1]
        qd = torch.zeros((n, self.model.nv), device=dev)
        qd[:, self._cart_dof] = 0.5 * u[:, 2]
        qd[:, self._pole_dof] = 0.25 * math.pi * u[:, 3]
        return q, qd, {}

    def control(self, action: torch.Tensor, es: EnvState, generator=None):
        ctrl = self.engine.default_control(action.shape[0])
        ctrl.effort[:, self._cart_dof] = self.max_push_effort * action[:, 0]
        return ctrl

    def observe(self, phys, carry, action):
        obs = torch.stack(
            [
                phys.q[:, self._cart_dof],
                phys.qd[:, self._cart_dof],
                phys.q[:, self._pole_dof],
                phys.qd[:, self._pole_dof],
            ],
            dim=-1,
        )
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        cart_pos, cart_vel, pole_angle, pole_vel = obs.unbind(-1)
        reward = (
            1.0
            - pole_angle * pole_angle
            - 0.01 * torch.abs(cart_vel)
            - 0.005 * torch.abs(pole_vel)
        )
        out = (torch.abs(cart_pos) > self.reset_dist) | (
            torch.abs(pole_angle) > math.pi / 2
        )
        reward = torch.where(out, torch.full_like(reward, -2.0), reward)
        done = out | (progress >= self.max_episode_length)
        return reward, done, carry, {}
