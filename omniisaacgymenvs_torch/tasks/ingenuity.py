"""Ingenuity Mars helicopter hover task (PyTorch port of the JAX package's
`tasks/ingenuity.py`).

13-dim obs [(target - pos) / 3, quat (wxyz), linvel / 2, angvel / pi], 6
actions -> per-rotor vertical thrust (clamped to +-2000, times dt) with
lateral components (+-0.2 of it) applied to the two rotor bodies in their
local frames; a moving target redrawn every 500 steps into x, y in (-1, 1),
z in (1, 2); reward pos + pos * (up + spin); termination on dist > 20 or
z < 0.5. Mars gravity [0, 0, -3.721].

Random draws: `sample_reset` draws (`reset_draws`) and builds the state
from them (`reset_from`); `control` draws the step's candidate target
(`control_draws`) and applies it (`control_from`), so a caller can hand
in draws of its own.
"""

from __future__ import annotations

import math

import torch

from omniisaacgymenvs_torch.envs.views import RigidPrimView
from omniisaacgymenvs_torch.models.flyers import build_ingenuity
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.anymal import uniform
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device


class IngenuityTask(RLTask):
    name = "Ingenuity"
    num_obs = 13
    num_states = 0
    num_actions = 6

    thrust_limit = 2000.0
    thrust_lateral_component = 0.2

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        sim_cfg = cfg.get("sim", {})
        self.max_episode_length = env_cfg.get("maxEpisodeLength", 2000)
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 1)
        self.dt = sim_cfg.get("dt", 0.01)
        dev = resolve_device(device)
        self.model = build_ingenuity(device=dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                dict(sim_cfg, dt=self.dt), substeps=1,
                gravity=(0.0, 0.0, -3.721),
            ),
        )
        self._rotors = RigidPrimView(
            self.model, [f"rotor_physics_{i}" for i in range(2)]
        )
        self._up = torch.tensor([0.0, 0.0, 1.0], device=dev)

    def initial_carry(self, n: int):
        return dict(target=self._up.expand(n, -1).clone())

    # -- reset -----------------------------------------------------------
    def reset_draws(self, n: int, generator: torch.Generator):
        """(joint coordinates (n, njd) in [-0.2, 0.2), root position noise
        (n, 3) in [-0.5, 0.5))."""
        dev = self.device
        return (uniform(generator, (n, self.model.njd), -0.2, 0.2, dev),
                uniform(generator, (n, 3), -0.5, 0.5, dev))

    def reset_from(self, dof, pos_noise):
        m = self.model
        n = dof.shape[0]
        q = m.default_q.expand(n, -1).clone()
        q[:, m.jq0:] = dof
        q[:, 0:3] += pos_noise
        return q, torch.zeros((n, m.nv), device=self.device), self.initial_carry(n)

    def sample_reset(self, n: int, generator: torch.Generator):
        return self.reset_from(*self.reset_draws(n, generator))

    # -- control -----------------------------------------------------------
    def control_draws(self, n: int, generator: torch.Generator):
        """The step's candidate targets (n, 3): x, y in [-1, 1), z in
        [1, 2); an env takes its own where its progress is a multiple of
        500."""
        dev = self.device
        xy = uniform(generator, (n, 2), -1.0, 1.0, dev)
        z = uniform(generator, (n, 1), 1.0, 2.0, dev)
        return torch.cat([xy, z], dim=-1)

    def control_from(self, action, es: EnvState, new_target):
        es.carry["target"] = torch.where(
            (es.progress % 500 == 0)[:, None], new_target, es.carry["target"])
        n = action.shape[0]
        lim, lat_lim = self.thrust_limit, self.thrust_lateral_component
        vert = torch.clamp(action[:, [2, 5]] * lim, -lim, lim)
        lat = torch.clamp(action[:, [0, 1, 3, 4]] * lat_lim, -lat_lim,
                          lat_lim).reshape(n, 2, 2)
        thrust_local = torch.cat(
            [vert[..., None] * lat * self.dt, (self.dt * vert)[..., None]],
            dim=-1)
        # local -> world by the rotor bodies' rotations
        return self._rotors.apply_forces(
            self.engine.default_control(n), thrust_local,
            is_global=False, state=es.phys)

    def control(self, action, es: EnvState, generator=None):
        return self.control_from(
            action, es, self.control_draws(action.shape[0], generator))

    # -- observation and reward -------------------------------------------
    def observe(self, phys, carry, action):
        obs = torch.cat(
            [
                (carry["target"] - phys.q[:, 0:3]) / 3.0,
                phys.q[:, 3:7],
                phys.body_lvel[:, 0] / 2.0,
                phys.body_avel[:, 0] / math.pi,
            ],
            dim=-1,
        )
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        root_pos = phys.q[:, 0:3]
        quat = phys.q[:, 3:7]
        target_dist = torch.linalg.norm(carry["target"] - root_pos, dim=-1)
        pos_reward = 1.0 / (1.0 + 2.5 * target_dist * target_dist)
        up_z = rot.quat_rotate(quat, self._up)[:, 2]
        tiltage = torch.abs(1.0 - up_z)
        up_reward = 1.0 / (1.0 + 30.0 * tiltage * tiltage)
        spinnage = torch.abs(phys.body_avel[:, 0, 2])
        spinnage_reward = 1.0 / (1.0 + 10.0 * spinnage * spinnage)
        reward = pos_reward + pos_reward * (up_reward + spinnage_reward)
        done = (
            (target_dist > 20.0)
            | (root_pos[:, 2] < 0.5)
            | (progress >= self.max_episode_length - 1)
        )
        return reward, done, carry, {}
