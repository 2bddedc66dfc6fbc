"""Physics state and control, batch-first (PyTorch port of the JAX
package's `physics/state.py`). Every field carries a leading env axis."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class State:
    """Articulation state of a batch of envs.

    q:  (N, nq) generalized positions. Floating base: [pos(3), quat wxyz(4),
        joint coords...].
    qd: (N, nv) generalized velocities. Floating base: [omega_body(3),
        vel_body(3), joint vels...] in body coordinates.
    body_pos/quat: (N, nb, 3/4) world pose per body; body_lvel/avel:
    (N, nb, 3) world-frame linear/angular velocity of each body origin;
    sensor_forces: (N, num_sensors, 6) contact wrench [force, torque] in
    world coordinates.
    """

    q: torch.Tensor
    qd: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_lvel: torch.Tensor
    body_avel: torch.Tensor
    sensor_forces: torch.Tensor


@dataclasses.dataclass
class Control:
    """Per-step control of a batch of envs.

    effort: (N, njd) direct joint torques. pos_target/vel_target: (N, njd)
    PD drive targets. body_force/body_torque: (N, nb, 3) world-frame wrench
    applied at each body origin.
    """

    effort: torch.Tensor
    pos_target: torch.Tensor
    vel_target: torch.Tensor
    body_force: torch.Tensor
    body_torque: torch.Tensor
