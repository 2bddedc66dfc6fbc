"""Quadcopter hover task with thrust vectoring (PyTorch port of the JAX
package's `tasks/quadcopter.py`).

21-dim obs [(target - pos) / 3, quat, linvel / 2, angvel / pi, dof_pos
(8)], 12 actions: 8 integrated dof position targets (rate 8 pi rad/s) and
4 integrated rotor thrusts (rate 100 N/s, clamped to +-2 N) along the
rotors' local z, rotated to the world by the rotor bodies' quaternions and
applied at their origins; reward pos + pos * (up + spin terms), clipped
at 0; termination on dist > 3 or z < 0.3; maxEpisodeLength 500.

Random draws: `sample_reset` draws (`reset_draws`) and builds the state
from them (`reset_from`); `control` draws nothing.
"""

from __future__ import annotations

import math

import torch

from omniisaacgymenvs_torch.envs.views import RigidPrimView
from omniisaacgymenvs_torch.models.flyers import build_quadcopter
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.anymal import uniform
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device


class QuadcopterTask(RLTask):
    name = "Quadcopter"
    num_obs = 21
    num_states = 0
    num_actions = 12

    max_thrust = 2.0

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        sim_cfg = cfg.get("sim", {})
        self.max_episode_length = env_cfg.get("maxEpisodeLength", 500)
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 1)
        self.dt = sim_cfg.get("dt", 0.01)
        dev = resolve_device(device)
        self.model = build_quadcopter(device=dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                dict(sim_cfg, dt=self.dt), substeps=1,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        self._rotors = RigidPrimView(
            self.model, [f"rotor_{i}" for i in range(4)]
        )
        self._up = torch.tensor([0.0, 0.0, 1.0], device=dev)
        self._noise_lo = torch.tensor([-1.5, -1.5, -0.2], device=dev)
        self._noise_hi = torch.tensor([1.5, 1.5, 1.5], device=dev)

    def initial_carry(self, n: int):
        z = lambda *s: torch.zeros((n,) + s, device=self.device)  # noqa: E731
        return dict(target=self._up.expand(n, -1).clone(),
                    dof_targets=z(self.model.njd), thrusts=z(4))

    # -- reset -----------------------------------------------------------
    def reset_draws(self, n: int, generator: torch.Generator):
        """(joint coordinates (n, njd) in [-0.2, 0.2), root position noise
        (n, 3) in [-1.5, 1.5) x [-1.5, 1.5) x [-0.2, 1.5))."""
        dev = self.device
        return (uniform(generator, (n, self.model.njd), -0.2, 0.2, dev),
                uniform(generator, (n, 3), self._noise_lo, self._noise_hi, dev))

    def reset_from(self, dof, noise):
        m = self.model
        n = dof.shape[0]
        q = m.default_q.expand(n, -1).clone()
        q[:, m.jq0:] = dof
        q[:, 0:3] += noise
        carry = self.initial_carry(n)
        carry["dof_targets"] = dof.clone()
        return q, torch.zeros((n, m.nv), device=self.device), carry

    def sample_reset(self, n: int, generator: torch.Generator):
        return self.reset_from(*self.reset_draws(n, generator))

    # ------------------------------------------------------------------
    def control(self, action, es: EnvState, generator=None):
        m = self.model
        n = action.shape[0]
        dof_targets = torch.minimum(
            torch.maximum(
                es.carry["dof_targets"]
                + self.dt * 8.0 * math.pi * action[:, 0:8],
                m.dof_limit_lower),
            m.dof_limit_upper)
        thrusts = torch.clamp(
            es.carry["thrusts"] + self.dt * 100.0 * action[:, 8:12],
            -self.max_thrust, self.max_thrust)
        es.carry["dof_targets"] = dof_targets
        es.carry["thrusts"] = thrusts
        f_local = torch.cat([thrusts.new_zeros((n, 4, 2)), thrusts[..., None]],
                            dim=-1)
        ctrl = self.engine.default_control(n)
        ctrl.pos_target = dof_targets
        return self._rotors.apply_forces(ctrl, f_local, is_global=False,
                                         state=es.phys)

    def observe(self, phys, carry, action):
        obs = torch.cat(
            [
                (carry["target"] - phys.q[:, 0:3]) / 3.0,
                phys.q[:, 3:7],
                phys.body_lvel[:, 0] / 2.0,
                phys.body_avel[:, 0] / math.pi,
                phys.q[:, self.model.jq0:],
            ],
            dim=-1,
        )
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        root_pos = phys.q[:, 0:3]
        quat = phys.q[:, 3:7]
        target_dist = torch.linalg.norm(carry["target"] - root_pos, dim=-1)
        pos_reward = 1.0 / (1.0 + 3.0 * target_dist * target_dist)
        up_z = rot.quat_rotate(quat, self._up)[:, 2]
        tiltage = torch.abs(1.0 - up_z)
        up_reward = 1.0 / (1.0 + 10.0 * tiltage * tiltage)
        spinnage = torch.abs(phys.body_avel[:, 0, 2])
        spinnage_reward = 1.0 / (1.0 + 0.001 * spinnage * spinnage)
        reward = torch.clamp(
            pos_reward
            + pos_reward
            * (up_reward + spinnage_reward - spinnage * spinnage / 400.0),
            min=0.0,
        )
        done = (
            (target_dist > 3.0)
            | (root_pos[:, 2] < 0.3)
            | (progress >= self.max_episode_length - 1)
        )
        return reward, done, carry, {}
