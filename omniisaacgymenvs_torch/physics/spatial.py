"""Spatial (6D) vector algebra for articulated rigid-body dynamics
(PyTorch port of the JAX package's `physics/spatial.py`).

Featherstone convention: a spatial motion vector is [angular; linear] and a
spatial force vector is [torque; force]. A coordinate transform from frame A
to frame B is (E, r): E takes A-coordinates to B-coordinates (x_B = E x_A)
and r is B's origin in A coordinates.

Motion transform (6x6):  X  = [[E, 0], [-E skew(r), E]]
Force transform:         X* = [[E, -E skew(r)], [0, E]]  (= X^{-T})
Inertia child -> parent: I_A = X^T I_B X.

Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product M @ v over the last axes."""
    return (M @ v[..., None])[..., 0]


def skew(v: torch.Tensor) -> torch.Tensor:
    """3x3 cross-product matrix: skew(v) @ u = v x u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def motion_transform(E: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """6x6 spatial motion transform X for (E, r)."""
    Z = torch.zeros_like(E)
    top = torch.cat([E, Z], dim=-1)
    bot = torch.cat([-E @ skew(r), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_motion(E: torch.Tensor, r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v_B = X v_A without materializing the 6x6."""
    w, vl = v[..., 0:3], v[..., 3:6]
    wB = _mv(E, w)
    vB = _mv(E, vl - _cross(r, w))
    return torch.cat([wB, vB], dim=-1)


def transform_motion_inv(E: torch.Tensor, r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v_A = X^{-1} v_B."""
    w, vl = v[..., 0:3], v[..., 3:6]
    ET = E.transpose(-1, -2)
    wA = _mv(ET, w)
    vA = _mv(ET, vl) + _cross(r, wA)
    return torch.cat([wA, vA], dim=-1)


def transform_force(E: torch.Tensor, r: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """f_B = X* f_A."""
    n, fl = f[..., 0:3], f[..., 3:6]
    nB = _mv(E, n - _cross(r, fl))
    fB = _mv(E, fl)
    return torch.cat([nB, fB], dim=-1)


def transform_force_inv(E: torch.Tensor, r: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """f_A = X*^{-1} f_B (= X^T f_B)."""
    n, fl = f[..., 0:3], f[..., 3:6]
    ET = E.transpose(-1, -2)
    fA = _mv(ET, fl)
    nA = _mv(ET, n) + _cross(r, fA)
    return torch.cat([nA, fA], dim=-1)


def cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m."""
    w, vl = v[..., 0:3], v[..., 3:6]
    mw, mv = m[..., 0:3], m[..., 3:6]
    return torch.cat(
        [_cross(w, mw), _cross(w, mv) + _cross(vl, mw)], dim=-1
    )


def cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f."""
    w, vl = v[..., 0:3], v[..., 3:6]
    n, fl = f[..., 0:3], f[..., 3:6]
    return torch.cat(
        [_cross(w, n) + _cross(vl, fl), _cross(w, fl)], dim=-1
    )


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the body frame origin:
    I = [[I_com + m c̃ c̃^T, m c̃], [m c̃^T, m 1]] with c̃ = skew(com)."""
    c = skew(com)
    mc = mass[..., None, None] * c
    eye = torch.eye(3, dtype=c.dtype, device=c.device).expand(c.shape)
    top = torch.cat([inertia_com + mc @ c.transpose(-1, -2), mc], dim=-1)
    bot = torch.cat([mc.transpose(-1, -2), mass[..., None, None] * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_inertia(E: torch.Tensor, r: torch.Tensor, I_child: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia from child coords to parent coords: X^T I X."""
    X = motion_transform(E, r)
    return X.transpose(-1, -2) @ I_child @ X
