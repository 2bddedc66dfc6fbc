"""Ant locomotion task (PyTorch port of the JAX package's `tasks/ant.py`):
60-dim obs / 8 actions, joint gears all 15, dof-at-limit cost = count of
|scaled dof pos| > 0.99."""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.models.ant import ANT_JOINT_GEARS, build_ant
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.shared.locomotion import LocomotionTask
from omniisaacgymenvs_torch.utils.device import resolve_device


class AntLocomotionTask(LocomotionTask):
    name = "Ant"
    num_obs = 60
    num_states = 0
    num_actions = 8

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        defaults = dict(
            powerScale=0.5, headingWeight=0.5, upWeight=0.1,
            actionsCost=0.005, energyCost=0.05, dofVelocityScale=0.2,
            angularVelocityScale=1.0, contactForceScale=0.1,
            jointsAtLimitCost=0.1, deathCost=-2.0, terminationHeight=0.31,
            alive_reward_scale=0.5, episodeLength=1000,
            clipActions=1.0, controlFrequencyInv=2,
        )
        env_cfg = {**defaults, **cfg.get("env", {})}
        super().__init__({**cfg, "env": env_cfg})
        dev = resolve_device(device)
        self.model = build_ant(device=dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                cfg.get("sim", {}), dt=1.0 / 120.0, substeps=2,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        self.joint_gears = torch.tensor(ANT_JOINT_GEARS, device=dev)
        self.motor_effort_ratio = torch.ones(8, device=dev)
        self._init_constants()

    def dof_at_limit_cost(self, obs):
        return torch.sum(
            (obs[:, 12: 12 + self.model.njd] > 0.99).float(), dim=-1
        )
