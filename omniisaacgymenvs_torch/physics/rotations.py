"""Quaternion and rotation math, wxyz convention (PyTorch port of the JAX
package's `physics/rotations.py`).

Every function broadcasts over leading dimensions, so the same code serves
one vector or a (num_envs, ...) batch. Includes the locomotion helpers
`compute_heading_and_up` / `compute_rot` / `get_euler_xyz` that the
observation code calls.
"""

from __future__ import annotations

import math

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-9)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by unit quaternion q (body -> world)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^-1 (world -> body for a body-attitude quaternion)."""
    return quat_rotate(quat_conjugate(q), v)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for a rotation of `angle` radians about unit `axis`."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    xyz = torch.sin(half)[..., None] * axis
    w = torch.cos(half)[..., None].expand(*xyz.shape[:-1], 1)
    return torch.cat([w, xyz], dim=-1)


def quat_exp_approx(omega_dt: torch.Tensor) -> torch.Tensor:
    """exp([0, omega_dt / 2]): the incremental rotation for angular
    velocity * dt, safe at zero through the sinc form."""
    half = 0.5 * omega_dt
    angle = torch.linalg.norm(half, dim=-1, keepdim=True)
    s = torch.sinc(angle / math.pi)
    return quat_normalize(torch.cat([torch.cos(angle), s * half], dim=-1))


def quat_integrate_body(q: torch.Tensor, omega_body: torch.Tensor, dt) -> torch.Tensor:
    """Integrate attitude with body-frame angular velocity: q ⊗ exp(ω dt)."""
    return quat_mul(q, quat_exp_approx(omega_body * dt))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R with x_world = R @ x_body."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> wxyz quaternion (branch-free Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = 0.5 * safe_sqrt(1.0 + tr)
    qx = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    qy = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    qz = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return quat_normalize(torch.stack([qw, qx, qy, qz], dim=-1))


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def get_euler_xyz(q: torch.Tensor):
    """wxyz quaternion -> (roll, pitch, yaw)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = 2.0 * (w * y - z * x)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.copysign(torch.full_like(sinp, math.pi / 2.0), sinp),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)),
    )
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return roll, pitch, yaw


def compute_heading_and_up(
    torso_rotation: torch.Tensor,
    inv_start_rot: torch.Tensor,
    to_target: torch.Tensor,
    vec0: torch.Tensor,
    vec1: torch.Tensor,
    up_idx: int,
):
    """Returns (torso_quat, up_proj, heading_proj, up_vec, heading_vec)."""
    torso_quat = quat_mul(torso_rotation, inv_start_rot)
    up_vec = quat_rotate(torso_quat, vec1)
    heading_vec = quat_rotate(torso_quat, vec0)
    up_proj = up_vec[..., up_idx]
    target_dir = to_target / torch.linalg.norm(
        to_target, dim=-1, keepdim=True
    ).clamp(min=1e-9)
    heading_proj = torch.sum(heading_vec * target_dir, dim=-1)
    return torso_quat, up_proj, heading_proj, up_vec, heading_vec


def compute_rot(
    torso_quat: torch.Tensor,
    velocity: torch.Tensor,
    ang_velocity: torch.Tensor,
    targets: torch.Tensor,
    torso_positions: torch.Tensor,
):
    """Local velocities, Euler angles and the heading angle to the target
    (atan2 over the (z, x) components, as the task's reference defines it)."""
    vel_loc = quat_rotate_inverse(torso_quat, velocity)
    angvel_loc = quat_rotate_inverse(torso_quat, ang_velocity)
    roll, pitch, yaw = get_euler_xyz(torso_quat)
    walk_target_angle = torch.atan2(
        targets[..., 2] - torso_positions[..., 2],
        targets[..., 0] - torso_positions[..., 0],
    )
    angle_to_target = walk_target_angle - yaw
    return vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target


def unscale(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Map [lower, upper] -> [-1, 1]."""
    return (2.0 * x - upper - lower) / (upper - lower)


def scale(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Map [-1, 1] -> [lower, upper]."""
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def quat_identity(shape=(), device=None) -> torch.Tensor:
    """Identity quaternion(s) of shape `shape + (4,)`."""
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q
