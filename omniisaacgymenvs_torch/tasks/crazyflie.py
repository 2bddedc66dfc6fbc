"""Crazyflie hover task with first-order motor lag (PyTorch port of the JAX
package's `tasks/crazyflie.py`).

18-dim obs [target - pos, the root's rotation matrix by columns, linvel,
angvel], 4 thrust actions filtered through a first-order lag in the
rotor-speed domain (tau_up = tau_down = 4 dt / 0.15) with multiplicative
thrust noise, per-motor max thrust g m thrust_to_weight / 4 (m = 0.028,
t/w 1.9); the thrusts are rotated by the ROOT's attitude and applied at
the 4 rotor bodies; reward pos + pos * (up + spin) - effort; termination
on dist > 5, z outside (0.5, 5) or flipped (up_z < 0); per-term episode
sums in the metrics. maxEpisodeLength 700.

Random draws: `control` draws the step's thrust noise (`control_draws`,
standard normal (n, 4)) and applies it (`control_from`), so a caller can
hand in draws of its own. The reset draws nothing.
"""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.envs.views import RigidPrimView
from omniisaacgymenvs_torch.models.flyers import build_crazyflie
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device

_EPS = 1e-6
_SUMS = ("rew_pos", "rew_orient", "rew_effort", "rew_spin")


class CrazyflieTask(RLTask):
    name = "Crazyflie"
    num_obs = 18
    num_states = 0
    num_actions = 4

    mass = 0.028
    thrust_to_weight = 1.9
    motor_damp_time = 0.15

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        sim_cfg = cfg.get("sim", {})
        self.max_episode_length = env_cfg.get("maxEpisodeLength", 700)
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 1)
        self.dt = sim_cfg.get("dt", 0.01)
        gravity = tuple(sim_cfg.get("gravity", (0.0, 0.0, -9.81)))
        dev = resolve_device(device)
        self.model = build_crazyflie(device=dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                dict(sim_cfg, dt=self.dt, gravity=list(gravity)),
                substeps=1,
            ),
        )
        self.motor_tau_up = min(4 * self.dt / (self.motor_damp_time + _EPS), 1.0)
        self.motor_tau_down = min(4 * self.dt / (self.motor_damp_time + _EPS), 1.0)
        self.thrust_max = -gravity[2] * self.mass * self.thrust_to_weight / 4.0
        self._rotors = RigidPrimView(
            self.model, [f"m{i + 1}_prop" for i in range(4)]
        )
        self._target = torch.tensor([0.0, 0.0, 2.0], device=dev)
        self._up = torch.tensor([0.0, 0.0, 1.0], device=dev)

    def initial_carry(self, n: int):
        z = lambda *s: torch.zeros((n,) + s, device=self.device)  # noqa: E731
        return dict(
            target=self._target.expand(n, -1).clone(),
            thrust_cmds_damp=z(4),
            thrust_rot_damp=z(4),
            episode_sums={k: z() for k in _SUMS},
        )

    def initial_metrics(self, n: int):
        return {"episode/" + k: torch.zeros(n, device=self.device)
                for k in _SUMS}

    def sample_reset(self, n: int, generator: torch.Generator):
        m = self.model
        return (m.default_q.expand(n, -1).clone(),
                torch.zeros((n, m.nv), device=self.device),
                self.initial_carry(n))

    # -- control -----------------------------------------------------------
    def control_draws(self, n: int, generator: torch.Generator):
        """The step's thrust noise before its 0.01 scale: (n, 4) N(0, 1)."""
        return torch.randn((n, 4), generator=generator, device=self.device)

    def control_from(self, action, es: EnvState, noise):
        carry = es.carry
        n = action.shape[0]
        thrust_cmds = (torch.clamp(action, -1.0, 1.0) + 1.0) / 2.0
        motor_tau = torch.where(thrust_cmds < carry["thrust_cmds_damp"],
                                self.motor_tau_down, self.motor_tau_up)
        thrust_rot = torch.sqrt(thrust_cmds)
        rot_damp = (motor_tau * (thrust_rot - carry["thrust_rot_damp"])
                    + carry["thrust_rot_damp"])
        cmds_damp = rot_damp ** 2
        cmds_damp = torch.clamp(cmds_damp + thrust_cmds * (0.01 * noise),
                                0.0, 1.0)
        carry["thrust_cmds_damp"] = cmds_damp
        carry["thrust_rot_damp"] = rot_damp

        thrusts = self.thrust_max * cmds_damp
        root_quat = es.phys.q[:, None, 3:7].expand(n, 4, 4)
        f_world = rot.quat_rotate(
            root_quat,
            torch.cat([thrusts.new_zeros((n, 4, 2)), thrusts[..., None]], dim=-1),
        )
        return self._rotors.apply_forces(self.engine.default_control(n), f_world)

    def control(self, action, es: EnvState, generator=None):
        return self.control_from(
            action, es, self.control_draws(action.shape[0], generator))

    # -- observation and reward -------------------------------------------
    def observe(self, phys, carry, action):
        R = rot.quat_to_rotmat(phys.q[:, 3:7])
        obs = torch.cat(
            [
                carry["target"] - phys.q[:, 0:3],
                R[:, :, 0], R[:, :, 1], R[:, :, 2],
                phys.body_lvel[:, 0],
                phys.body_avel[:, 0],
            ],
            dim=-1,
        )
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        root_pos = phys.q[:, 0:3]
        quat = phys.q[:, 3:7]
        target_dist = torch.linalg.norm(carry["target"] - root_pos, dim=-1)
        pos_reward = 1.0 / (1.0 + target_dist)
        up_z = rot.quat_rotate(quat, self._up)[:, 2]
        up_reward = torch.clamp(up_z, 0.0, 1.0)
        effort = torch.sum(torch.square(action), dim=-1)
        effort_reward = 0.05 * torch.exp(-0.5 * effort)
        spin = torch.sum(torch.square(phys.body_avel[:, 0]), dim=-1)
        spin_reward = 0.01 * torch.exp(-1.0 * spin)
        reward = pos_reward + pos_reward * (up_reward + spin_reward) - effort_reward
        sums = carry["episode_sums"]
        carry = dict(carry, episode_sums=dict(
            rew_pos=sums["rew_pos"] + pos_reward,
            rew_orient=sums["rew_orient"] + up_reward,
            rew_effort=sums["rew_effort"] + effort_reward,
            rew_spin=sums["rew_spin"] + spin_reward,
        ))
        done = (
            (target_dist > 5.0)
            | (root_pos[:, 2] < 0.5)
            | (root_pos[:, 2] > 5.0)
            | (up_z < 0.0)
            | (progress >= self.max_episode_length - 1)
        )
        metrics = {"episode/" + k: v / self.max_episode_length
                   for k, v in carry["episode_sums"].items()}
        return reward, done, carry, metrics
