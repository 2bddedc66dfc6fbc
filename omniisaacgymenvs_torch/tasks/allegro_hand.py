"""AllegroHand in-hand cube reorientation (PyTorch port of the JAX
package's `tasks/allegro_hand.py`): 16 actions on all dofs, observation
modes full_no_vel (50) and full (72), no fingertip or sensor observations
and no asymmetric states."""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.models import allegro_hand as alm
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.shared.in_hand_manipulation import (
    InHandManipulationTask,
)
from omniisaacgymenvs_torch.utils.device import resolve_device

NUM_OBS_DICT = {"full_no_vel": 50, "full": 72}


class AllegroHandTask(InHandManipulationTask):
    name = "AllegroHand"
    num_actions = 16
    num_states = 0
    fingertip_bodies = alm.FINGERTIP_BODIES
    dr_view_name = "allegro_hand_view"

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        sim_cfg = cfg.get("sim", {})
        super().__init__(cfg)
        self.obs_type = env_cfg.get("observationType", "full")
        if self.obs_type not in NUM_OBS_DICT:
            raise ValueError(f"unknown observationType {self.obs_type!r}")
        self.num_obs = NUM_OBS_DICT[self.obs_type]

        dev = resolve_device(device)
        scene = env_cfg.get("scene")  # optional authoring overrides
        self.model = alm.build_allegro_hand(scene, device=dev)
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                sim_cfg, dt=1.0 / 120.0, substeps=2,
                gravity=(0.0, 0.0, -9.81),
            ),
        )
        _, _, goal_pos = alm.scene_frames(scene)
        self.goal_pos = torch.tensor(goal_pos, dtype=torch.float32, device=dev)
        self.actuated_dof_indices = torch.arange(self.model.njd, device=dev)
        self.coupled_pairs = ()
        self._post_model_init()

    def observe(self, phys, carry, action):
        m = self.model
        n = phys.q.shape[0]
        (object_pos, object_rot, object_linvel, object_angvel,
         quat_diff) = self._object_goal_obs(phys, carry)
        goal_pos = self.goal_pos.expand(n, -1)
        dof_pos_scaled = rot.unscale(phys.q[:, self._jq], m.dof_limit_lower,
                                     m.dof_limit_upper)
        if self.obs_type == "full_no_vel":
            parts = [dof_pos_scaled, object_pos, object_rot, goal_pos,
                     carry["goal_rot"], quat_diff, action]
        else:
            parts = [dof_pos_scaled, self.vel_obs_scale * phys.qd[:, self._jv],
                     object_pos, object_rot, object_linvel,
                     self.vel_obs_scale * object_angvel,
                     goal_pos, carry["goal_rot"], quat_diff, action]
        return torch.cat(parts, dim=-1), phys.q.new_zeros((n, 0)), carry
