"""ShadowHand in-hand cube reorientation (PyTorch port of the JAX package's
`tasks/shadow_hand.py`): observation modes openai (42) / full_no_vel (77) /
full (157) / full_state (187), 20 actions on the actuated dofs, optional
187-dim asymmetric states, fingertip poses and velocities and force
sensors in the richer modes."""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.models import shadow_hand as shm
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.shared.in_hand_manipulation import (
    InHandManipulationTask,
)
from omniisaacgymenvs_torch.utils.device import resolve_device

NUM_OBS_DICT = {"openai": 42, "full_no_vel": 77, "full": 157, "full_state": 187}


class ShadowHandTask(InHandManipulationTask):
    name = "ShadowHand"
    num_actions = 20
    fingertip_bodies = shm.FINGERTIP_BODIES
    force_torque_obs_scale = 10.0

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        sim_cfg = cfg.get("sim", {})
        super().__init__(cfg)
        self.obs_type = env_cfg.get("observationType", "full")
        if self.obs_type not in NUM_OBS_DICT:
            raise ValueError(f"unknown observationType {self.obs_type!r}")
        self.num_obs = NUM_OBS_DICT[self.obs_type]
        self.asymmetric_obs = env_cfg.get("asymmetric_observations", False)
        self.num_states = 187 if self.asymmetric_obs else 0

        dev = resolve_device(device)
        self.model = shm.build_shadow_hand(
            self_collisions=sim_cfg.get("shadow_hand", {}).get(
                "enable_self_collisions", False
            ),
            device=dev,
        )
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                sim_cfg, dt=1.0 / 120.0, substeps=2,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        self.goal_pos = torch.tensor(shm.GOAL_POS, device=dev)
        m = self.model
        self.actuated_dof_indices = torch.as_tensor(
            sorted(m.dof_index(n) for n in shm.ACTUATED_JOINT_NAMES),
            dtype=torch.long, device=dev,
        )
        # the distal J0 joints are tendon-coupled in the model, at the force
        # level: no target mirroring
        self.coupled_pairs = ()
        self._post_model_init()

    # ------------------------------------------------------------------
    def observe(self, phys, carry, action):
        m = self.model
        n = phys.q.shape[0]
        (object_pos, object_rot, object_linvel, object_angvel,
         quat_diff) = self._object_goal_obs(phys, carry)
        goal_rot = carry["goal_rot"]
        goal_pos = self.goal_pos.expand(n, -1)
        dof_pos_scaled = rot.unscale(
            phys.q[:, self._jq], m.dof_limit_lower, m.dof_limit_upper
        )
        dof_vel = phys.qd[:, self._jv]
        tp, tr = self.tips_view.get_world_poses(phys)
        tip_pos = tp.reshape(n, -1)
        tip_rot = tr.reshape(n, -1)
        tip_vel = self.tips_view.get_velocities(phys).reshape(n, -1)
        sensors = phys.sensor_forces.reshape(n, -1)

        core = [
            dof_pos_scaled,
            self.vel_obs_scale * dof_vel,
            object_pos, object_rot, object_linvel,
            self.vel_obs_scale * object_angvel,
            goal_pos, goal_rot, quat_diff,
            tip_pos, tip_rot, tip_vel,
        ]
        full_state = core + [self.force_torque_obs_scale * sensors, action]
        if self.obs_type == "openai":
            parts = [tip_pos, object_pos, quat_diff, action]
        elif self.obs_type == "full_no_vel":
            parts = [dof_pos_scaled, object_pos, object_rot, goal_pos,
                     goal_rot, quat_diff, tip_pos, action]
        elif self.obs_type == "full_state":
            parts = full_state
        else:  # full
            parts = core + [action]
        obs = torch.cat(parts, dim=-1)
        if self.num_states:
            states = torch.cat(full_state, dim=-1)
        else:
            states = obs.new_zeros((n, 0))
        return obs, states, carry
