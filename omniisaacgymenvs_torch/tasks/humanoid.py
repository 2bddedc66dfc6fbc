"""Humanoid locomotion task (PyTorch port of the JAX package's
`tasks/humanoid.py`): 87-dim obs / 21 actions, per-joint gear table,
motor_effort_ratio = gears / max(gears), dof-at-limit cost scaled by the
motor effort ratio beyond 0.98 of the range."""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.models.humanoid import (
    HUMANOID_JOINT_GEARS,
    build_humanoid,
)
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.shared.locomotion import LocomotionTask
from omniisaacgymenvs_torch.utils.device import resolve_device


class HumanoidLocomotionTask(LocomotionTask):
    name = "Humanoid"
    num_obs = 87
    num_states = 0
    num_actions = 21

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        defaults = dict(
            powerScale=1.0, headingWeight=0.5, upWeight=0.1,
            actionsCost=0.01, energyCost=0.05, dofVelocityScale=0.1,
            angularVelocityScale=0.25, contactForceScale=0.01,
            jointsAtLimitCost=0.25, deathCost=-1.0, terminationHeight=0.8,
            alive_reward_scale=2.0, episodeLength=1000,
            clipActions=1.0, controlFrequencyInv=2,
        )
        env_cfg = {**defaults, **cfg.get("env", {})}
        super().__init__({**cfg, "env": env_cfg})
        dev = resolve_device(device)
        self.model = build_humanoid(device=dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                cfg.get("sim", {}), dt=1.0 / 120.0, substeps=2,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        self.joint_gears = torch.tensor(HUMANOID_JOINT_GEARS, device=dev)
        self.motor_effort_ratio = self.joint_gears / torch.max(self.joint_gears)
        self._init_constants()

    def dof_at_limit_cost(self, obs):
        d = obs[:, 12: 12 + self.model.njd]
        scaled_cost = (
            self.joints_at_limit_cost_scale * (torch.abs(d) - 0.98) / 0.02
        )
        return torch.sum(
            (torch.abs(d) > 0.98) * scaled_cost * self.motor_effort_ratio,
            dim=-1,
        )
