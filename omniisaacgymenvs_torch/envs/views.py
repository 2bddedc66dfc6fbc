"""Functional views over batched physics states (PyTorch port of the JAX
package's `envs/views.py`): `ArticulationView` and `RigidPrimView`.

A view is a stateless adapter over a `State` whose fields carry a leading
env axis: getters read (N, ...) tensors of the view's bodies or dofs;
setters return a NEW `State` (or `Control`) and never write into the
caller's tensors, as the JAX module's setters cannot. `indices=` selects the envs a setter writes (a bool mask (N,)
or an index tensor), `joint_indices=` a subset of the view's dofs.

Example:
    view = ArticulationView(model)            # whole articulation
    pos, quat = view.get_world_poses(state)
    state = view.set_joint_positions(state, q_new, indices=env_mask)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.model import JointType, Model
from omniisaacgymenvs_torch.physics.state import Control, State


def _env_select(old: torch.Tensor, new: torch.Tensor, indices) -> torch.Tensor:
    """`new` for the envs `indices` selects (a bool mask (N,) or an index
    tensor), `old` elsewhere; all of `new` when indices is None."""
    if indices is None:
        return new
    indices = torch.as_tensor(indices, device=old.device)
    if indices.dtype == torch.bool:
        mask = indices
    else:
        mask = torch.zeros(old.shape[0], dtype=torch.bool, device=old.device)
        mask[indices.long()] = True
    return torch.where(mask.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.long, device=device)


class ArticulationView:
    """View over one articulation tree of a model, by its root body (the
    model's first root when not named)."""

    def __init__(self, model: Model, root_body: Optional[str] = None):
        self.model = model
        self._root = (model.body_index(root_body) if root_body
                      else model.roots[0])
        if self._root not in model.roots:
            raise ValueError(f"{root_body} is not a root")
        self._free = model.jtype[self._root] == JointType.FREE
        self._qa = model.q_adr[self._root]
        self._va = model.v_adr[self._root]
        tree = model.tree_id[self._root]
        dev = model.device
        self._dofs = _long([model.jdof[i] for i in range(model.nb)
                            if model.tree_id[i] == tree and model.jdof[i] >= 0],
                           dev)
        self._jq = _long(model.jq_idx, dev)
        self._jv = _long(model.jv_idx, dev)

    # -- info ----------------------------------------------------------
    @property
    def num_dof(self) -> int:
        return int(self._dofs.shape[0])

    def get_dof_index(self, name: str) -> int:
        """Position of the named dof within this view's dof list."""
        hit = (self._dofs == self.model.dof_index(name)).nonzero()
        if hit.numel() == 0:
            raise ValueError(f"{name} is not a dof of this view")
        return int(hit[0, 0])

    def get_dof_limits(self) -> torch.Tensor:
        """(num_dof, 2) [lower, upper]."""
        return torch.stack([self.model.dof_limit_lower[self._dofs],
                            self.model.dof_limit_upper[self._dofs]], dim=-1)

    def _dof_subset(self, joint_indices) -> torch.Tensor:
        if joint_indices is None:
            return self._dofs
        return self._dofs[_long(joint_indices, self._dofs.device)]

    # -- getters ---------------------------------------------------------
    def get_world_poses(self, state: State):
        """(position (N,3), wxyz quaternion (N,4)) of the root body."""
        return (state.body_pos[..., self._root, :],
                state.body_quat[..., self._root, :])

    def get_velocities(self, state: State) -> torch.Tensor:
        """(N, 6) world [linear, angular] velocity of the root body."""
        return torch.cat([state.body_lvel[..., self._root, :],
                          state.body_avel[..., self._root, :]], dim=-1)

    def get_joint_positions(self, state: State, joint_indices=None):
        return state.q[..., self._jq[self._dof_subset(joint_indices)]]

    def get_joint_velocities(self, state: State, joint_indices=None):
        return state.qd[..., self._jv[self._dof_subset(joint_indices)]]

    def get_force_sensor_forces(self, state: State) -> torch.Tensor:
        """(N, num_sensors, 6) contact wrench [force, torque] per sensor."""
        return state.sensor_forces

    # -- setters (functional) ------------------------------------------
    def set_joint_positions(self, state: State, values, indices=None,
                            joint_indices=None) -> State:
        cols = self._jq[self._dof_subset(joint_indices)]
        new_q = state.q.clone()
        new_q[..., cols] = torch.as_tensor(values, dtype=new_q.dtype,
                                           device=new_q.device)
        return dataclasses.replace(state, q=_env_select(state.q, new_q, indices))

    def set_joint_velocities(self, state: State, values, indices=None,
                             joint_indices=None) -> State:
        cols = self._jv[self._dof_subset(joint_indices)]
        new_qd = state.qd.clone()
        new_qd[..., cols] = torch.as_tensor(values, dtype=new_qd.dtype,
                                            device=new_qd.device)
        return dataclasses.replace(state,
                                   qd=_env_select(state.qd, new_qd, indices))

    def _require_free(self):
        if not self._free:
            raise ValueError("a fixed-base articulation has no root pose dofs")

    def set_world_poses(self, state: State, positions, orientations,
                        indices=None) -> State:
        """The FREE root's position and wxyz quaternion."""
        self._require_free()
        qa = self._qa
        new_q = state.q.clone()
        new_q[..., qa: qa + 3] = positions
        new_q[..., qa + 3: qa + 7] = orientations
        return dataclasses.replace(state, q=_env_select(state.q, new_q, indices))

    def set_velocities(self, state: State, velocities, indices=None) -> State:
        """velocities (N, 6) world [linear, angular], written as the FREE
        root's body-frame [angular, linear] velocities."""
        self._require_free()
        qa, va = self._qa, self._va
        quat = state.q[..., qa + 3: qa + 7]
        v_b = rot.quat_rotate_inverse(quat, velocities[..., 0:3])
        w_b = rot.quat_rotate_inverse(quat, velocities[..., 3:6])
        new_qd = state.qd.clone()
        new_qd[..., va: va + 3] = w_b
        new_qd[..., va + 3: va + 6] = v_b
        return dataclasses.replace(state,
                                   qd=_env_select(state.qd, new_qd, indices))


class RigidPrimView:
    """View over a set of bodies (rotors, fingertips, free objects)."""

    def __init__(self, model: Model, body_names: Sequence[str]):
        self.model = model
        self._bodies = _long([model.body_index(n) for n in body_names],
                             model.device)

    def get_world_poses(self, state: State):
        """(positions (N,k,3), wxyz quaternions (N,k,4)) of the bodies."""
        return (state.body_pos[..., self._bodies, :],
                state.body_quat[..., self._bodies, :])

    def get_velocities(self, state: State) -> torch.Tensor:
        """(N,k,6) world [linear, angular] velocities of the bodies."""
        return torch.cat([state.body_lvel[..., self._bodies, :],
                          state.body_avel[..., self._bodies, :]], dim=-1)

    def apply_forces(self, control: Control, forces, is_global: bool = True,
                     state: Optional[State] = None) -> Control:
        """A new Control with `forces` (N,k,3) added to the bodies' forces
        at their origins. is_global=False takes body-local forces and
        rotates them by the bodies' quaternions in `state`."""
        if not is_global:
            if state is None:
                raise ValueError("body-local forces need the state")
            forces = rot.quat_rotate(state.body_quat[..., self._bodies, :],
                                     forces)
        bf = control.body_force
        f = torch.broadcast_to(forces, bf[..., self._bodies, :].shape)
        return dataclasses.replace(
            control, body_force=bf.index_add(bf.ndim - 2, self._bodies, f))
