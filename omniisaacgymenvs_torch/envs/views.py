"""Functional views over batched physics states (the part of the JAX
package's `envs/views.py` the ported tasks call: `RigidPrimView` getters
and `ArticulationView.get_world_poses`).

A view is a stateless adapter over a `State` whose fields carry a leading
env axis: getters read (N, ...) tensors of the view's bodies.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from omniisaacgymenvs_torch.physics.model import Model
from omniisaacgymenvs_torch.physics.state import State


class ArticulationView:
    """View over one articulation tree of a model, by its root body (the
    model's first root when not named)."""

    def __init__(self, model: Model, root_body: Optional[str] = None):
        self.model = model
        self._root = (model.body_index(root_body) if root_body
                      else model.roots[0])
        if self._root not in model.roots:
            raise ValueError(f"{root_body} is not a root")

    def get_world_poses(self, state: State):
        """(position (N,3), wxyz quaternion (N,4)) of the root body."""
        return (state.body_pos[..., self._root, :],
                state.body_quat[..., self._root, :])


class RigidPrimView:
    """View over a set of bodies (fingertips, free objects)."""

    def __init__(self, model: Model, body_names: Sequence[str]):
        self.model = model
        self._bodies = torch.as_tensor(
            [model.body_index(n) for n in body_names], dtype=torch.long,
            device=model.device,
        )

    def get_world_poses(self, state: State):
        """(positions (N,k,3), wxyz quaternions (N,k,4)) of the bodies."""
        return (state.body_pos[..., self._bodies, :],
                state.body_quat[..., self._bodies, :])

    def get_velocities(self, state: State) -> torch.Tensor:
        """(N,k,6) world [linear, angular] velocities of the bodies."""
        return torch.cat([state.body_lvel[..., self._bodies, :],
                          state.body_avel[..., self._bodies, :]], dim=-1)
