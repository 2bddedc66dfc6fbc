"""Custom imported-robot task, bring-your-own URDF or MJCF (PyTorch port of
the JAX package's `tasks/custom.py`).

`task=Custom task.env.robot=path/to/robot.urdf` (or `.xml` / `.mjcf`)
imports the robot (`models/importers.py`), sets the yaml's drive block on
every dof and trains a joint-space target-reaching policy on it.

Each episode draws a joint-position target inside the joint limits (a
continuous joint's window clamped to +-pi); the policy drives the dofs
there by PD position control. reward = 1 - w_pos |q - q*|^2 - w_vel |qd|^2
- w_act |a|^2. Episodes end on the time limit and, for a FREE root, when
the base falls below `terminationHeight` (reward -1). Observations:
[dof_pos, dof_vel * scale, target] (dof positions and target unscaled to
[-1, 1] over the window), and for a FREE root [z, quat, lin_vel * scale,
ang_vel * scale] (11 more).

Random draws: `sample_reset` draws (`reset_draws`) and builds the state
from them (`reset_from`), so a caller can hand in draws of its own.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from omniisaacgymenvs_torch.models import importers
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.anymal import uniform
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device

# the drive of every imported dof where the yaml's drive block leaves a
# gain out (URDF carries none)
DRIVE_DEFAULTS = dict(stiffness=40.0, damping=2.0, max_effort=100.0)


def import_robot(robot: str, floating_base: bool = False):
    """The ModelBuilder of a URDF (`.urdf`) or MJCF (`.xml`, `.mjcf`)
    file; `floating_base` steers the URDF importer only (an MJCF file
    decides its base joint itself)."""
    ext = os.path.splitext(str(robot))[1].lower()
    if ext == ".urdf":
        return importers.from_urdf(robot, floating_base=floating_base)
    if ext in (".xml", ".mjcf"):
        return importers.from_mjcf(robot)
    raise ValueError(f"unsupported robot format {ext!r} ({robot})")


class CustomRobotTask(RLTask):
    name = "Custom"
    num_states = 0

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        robot = env_cfg.get("robot")
        if not robot:
            raise ValueError(
                "task=Custom needs task.env.robot=<path/to/robot.urdf|.xml>")
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 2)
        self.max_episode_length = env_cfg.get("episodeLength", 500)
        self.vel_obs_scale = env_cfg.get("velObsScale", 0.1)
        self.pos_reward_scale = env_cfg.get("posRewardScale", 2.0)
        self.vel_penalty_scale = env_cfg.get("velPenaltyScale", 0.01)
        self.action_penalty_scale = env_cfg.get("actionPenaltyScale", 0.01)
        self.reset_noise = env_cfg.get("resetNoise", 0.1)
        self.termination_height = env_cfg.get("terminationHeight", 0.2)
        floating = env_cfg.get("floatingBase", False)

        builder = import_robot(robot, floating)
        drive = {**DRIVE_DEFAULTS, **env_cfg.get("drive", {})}
        for dof_name in builder.dof_names:
            builder.set_drive(dof_name, **drive)
        dev = resolve_device(device)
        self.model = builder.finalize(dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(cfg.get("sim", {}), dt=1.0 / 120.0,
                                substeps=env_cfg.get("substeps", 2),
                                gravity=(0.0, 0.0, -9.81)),
        )
        m = self.model
        if m.njd == 0:
            raise ValueError(f"{robot}: imported model has no driven dofs")
        # floating-ness comes from the finalized model's root, not the
        # flag: from_mjcf decides the base joint from the file itself
        self.floating = m.root_free
        if bool(floating) != self.floating:
            print(f"custom robot: floatingBase={floating} requested but the "
                  f"imported model root is "
                  f"{'FREE' if self.floating else 'FIXED'}; using the model")
        self.num_actions = m.njd
        self.num_obs = 3 * m.njd + (11 if self.floating else 0)
        # an unbounded (continuous) joint gets a +-pi target window
        self._tgt_lo = torch.clamp(m.dof_limit_lower, min=-math.pi)
        self._tgt_hi = torch.clamp(m.dof_limit_upper, max=math.pi)
        self._jq = torch.as_tensor(m.jq_idx.astype(np.int64), device=dev)
        self._jv = torch.as_tensor(m.jv_idx.astype(np.int64), device=dev)

    def initial_carry(self, n: int):
        return dict(target=torch.zeros((n, self.model.njd), device=self.device))

    # -- reset -------------------------------------------------------------
    def reset_draws(self, n: int, generator: torch.Generator):
        """(dof noise (n, njd) in [-resetNoise, resetNoise), target (n, njd)
        uniform over the target window)."""
        m, dev = self.model, self.device
        noise = self.reset_noise * uniform(generator, (n, m.njd), -1.0, 1.0, dev)
        return noise, uniform(generator, (n, m.njd), self._tgt_lo, self._tgt_hi, dev)

    def reset_from(self, noise, target):
        m = self.model
        n = noise.shape[0]
        dof = torch.clamp(m.default_q[self._jq] + noise, self._tgt_lo, self._tgt_hi)
        q = m.default_q.expand(n, -1).clone()
        q[:, self._jq] = dof
        return q, torch.zeros((n, m.nv), device=self.device), dict(target=target)

    def sample_reset(self, n: int, generator: torch.Generator):
        return self.reset_from(*self.reset_draws(n, generator))

    # -- hooks -------------------------------------------------------------
    def control(self, action: torch.Tensor, es: EnvState, generator=None):
        ctrl = self.engine.default_control(action.shape[0])
        ctrl.pos_target = rot.scale(action, self._tgt_lo, self._tgt_hi)
        return ctrl

    def observe(self, phys, carry, action):
        parts = [
            rot.unscale(phys.q[:, self._jq], self._tgt_lo, self._tgt_hi),
            self.vel_obs_scale * phys.qd[:, self._jv],
            rot.unscale(carry["target"], self._tgt_lo, self._tgt_hi),
        ]
        if self.floating:
            # FREE root: q[0:3] position, q[3:7] wxyz quaternion; body 0's
            # world velocities
            parts += [phys.q[:, 2:7], self.vel_obs_scale * phys.body_lvel[:, 0],
                      self.vel_obs_scale * phys.body_avel[:, 0]]
        obs = torch.cat(parts, dim=-1)
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        dof_pos = phys.q[:, self._jq]
        dof_vel = phys.qd[:, self._jv]
        err = torch.sum((dof_pos - carry["target"]) ** 2, dim=-1)
        reward = (1.0 - self.pos_reward_scale * err
                  - self.vel_penalty_scale * torch.sum(dof_vel ** 2, dim=-1)
                  - self.action_penalty_scale * torch.sum(action ** 2, dim=-1))
        done = progress >= self.max_episode_length - 1
        if self.floating:
            fallen = phys.q[:, 2] < self.termination_height
            reward = torch.where(fallen, torch.full_like(reward, -1.0), reward)
            done = done | fallen
        return reward, done, carry, {}
