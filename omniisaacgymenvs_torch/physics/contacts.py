"""Ground contact model: compiled contact points against the flat plane
z = 0 (PyTorch port of the ground part of the JAX package's
`physics/contacts.py`).

A regularized compliant contact: Hunt-Crossley normal force (spring scaled
by 1 - chi * vn, so no spike at first touch) capped per point, plus
stiction-capped viscous friction. The build-time gain helpers work in
numpy on the model's fields; `plane_contacts` is batched over envs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from omniisaacgymenvs_torch.physics.model import JointType, Model


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """Compliant contact material parameters.

    kn: normal stiffness [N/m]; kd: Hunt-Crossley damping factor chi [s/m];
    kt: tangential (stiction) velocity gain [N s/m]; mu: Coulomb friction
    (scaled per point by the model's cp_friction); fn_max: per-point normal
    force cap. per_mass: gains scale with each point's effective mass
    (kn_pm, kt_pm, fnm_pm per kg), see `ground_point_gains`.
    """

    kn: float = 5.0e4
    kd: float = 2.0
    kt: float = 1.0e3
    mu: float = 1.0
    fn_max: float = 1.0e9
    per_mass: bool = False
    kn_pm: float = 0.0
    kt_pm: float = 0.0
    fnm_pm: float = 0.0


def auto_contact_params(model: Model, dt_sub: float, mu: float = 1.0,
                        omega_dt: float = 0.5, chi: float = 2.0,
                        max_depenetration_velocity: float = 10.0) -> ContactParams:
    """Stable per-mass compliant-contact gains for a model and substep:
    kn = (omega_dt / dt)^2 * m_eff, kt = 0.7 * m_eff / dt, and a force cap
    of max_depenetration_velocity * m / dt."""
    if model.ncp == 0:
        return ContactParams(mu=mu)
    m_min = float(point_effective_masses(model).min())
    kn_pm = (omega_dt / dt_sub) ** 2
    kt_pm = 0.7 / dt_sub
    fnm_pm = max_depenetration_velocity / dt_sub
    return ContactParams(
        kn=kn_pm * m_min, kd=chi, kt=kt_pm * m_min, mu=mu,
        fn_max=fnm_pm * float(point_body_masses(model).min()),
        per_mass=True, kn_pm=kn_pm, kt_pm=kt_pm, fnm_pm=fnm_pm,
    )


def _eff_mass(m, I_min, r2):
    """Effective mass seen by a force at lever^2 = r2 from the CoM of a body
    of mass m and least principal inertia I_min: 1/m_eff = 1/m + r^2/I."""
    return 1.0 / (
        1.0 / np.maximum(m, 1e-9) + r2 / np.maximum(I_min, 1e-12)
    )


def point_body_masses(model: Model) -> np.ndarray:
    """(ncp,) full mass of each contact point's body."""
    cb = model.cp_body
    if cb.shape[0] == 0:
        return np.zeros(0)
    return _np(model.body_mass)[cb]


# static-load gain floor (ground_point_gains): target penetration at
# static tree weight, and the gravity it is defined against
_LOAD_DELTA = 0.005   # [m]
_LOAD_G = 9.81        # [m/s^2]


def point_share_masses(model: Model) -> np.ndarray:
    """(ncp,) per-point share of its tree's total mass: 2 * M_tree /
    n_points_tree for trees with a FREE root (half the points are assumed
    to bear the weight), 0 for fixed-base trees."""
    cb = model.cp_body
    if cb.shape[0] == 0:
        return np.zeros(0)
    parents = np.asarray(model.parents)
    nb = parents.shape[0]
    if not all(int(p) < i for i, p in enumerate(parents) if p >= 0):
        raise ValueError("bodies must be in topological order")
    tree = np.arange(nb)
    for i in range(nb):
        if parents[i] >= 0:
            tree[i] = tree[parents[i]]
    masses = _np(model.body_mass)
    jtype = np.asarray(model.jtype)
    share = np.zeros(cb.shape[0])
    for r in model.roots:
        if JointType(jtype[r]) != JointType.FREE:
            continue
        in_tree = tree == r
        pts = np.flatnonzero(in_tree[cb])
        if pts.size == 0:
            continue
        share[pts] = 2.0 * float(masses[in_tree].sum()) / pts.size
    return share


def ground_point_gains(model: Model, params: ContactParams):
    """Per-point (kn, kt, fn_max) for ground contacts under per-mass params:
      kn  = max(kn_pm * m_eff,  m_share * g / delta)   stability vs statics
      kt  = kt_pm * max(m_eff, m_share)                stiction holds weight
      fnm = fnm_pm * max(m_body, m_share)              body-level force cap
    """
    meff = point_effective_masses(model)
    mb = point_body_masses(model)
    msh = point_share_masses(model)
    kn = np.maximum(params.kn_pm * meff, msh * (_LOAD_G / _LOAD_DELTA))
    kt = params.kt_pm * np.maximum(meff, msh)
    fnm = params.fnm_pm * np.maximum(mb, msh)
    return kn, kt, fnm


def point_gains(model: Model, params: ContactParams) -> np.ndarray:
    """(3, ncp) float64 ground gains (kn, kt, fn_max) per point, per-mass or
    the params' scalars."""
    if params.per_mass:
        return np.stack(ground_point_gains(model, params))
    ones = np.ones(model.ncp)
    return np.stack([params.kn * ones, params.kt * ones, params.fn_max * ones])


def point_effective_masses(model: Model) -> np.ndarray:
    """(ncp,) effective mass per ground contact point."""
    cb = model.cp_body
    if cb.shape[0] == 0:
        return np.zeros(0)
    m = _np(model.body_mass)[cb]
    com = _np(model.body_com)[cb]
    I = _np(model.body_inertia)[cb]
    I_min = np.min(np.stack([I[:, 0, 0], I[:, 1, 1], I[:, 2, 2]], 1), axis=1)
    r2 = np.sum((_np(model.cp_pos) - com) ** 2, axis=1)
    return _eff_mass(m, I_min, r2)


class ContactResult(NamedTuple):
    f_ext: torch.Tensor          # (N, nb, 6) world wrench [torque; force]
    body_force: torch.Tensor     # (N, nb, 3) net world contact force
    body_torque: torch.Tensor    # (N, nb, 3) net world contact torque


def plane_contacts(
    model: Model,
    body_pos: torch.Tensor,     # (N, nb, 3) world
    body_rot: torch.Tensor,     # (N, nb, 3, 3) world rotation matrices
    body_avel: torch.Tensor,    # (N, nb, 3) world angular velocity
    body_lvel: torch.Tensor,    # (N, nb, 3) world velocity of body origin
    params: ContactParams,
    gains: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> ContactResult:
    """Contact forces against the ground plane z = 0. `gains`: per-point
    (kn, kt, fn_max) tensors; computed from `params` when not given (the
    engine passes them precomputed on its device)."""
    N, nb = body_pos.shape[0], model.nb
    zeros3 = body_pos.new_zeros((N, nb, 3))
    if model.ncp == 0:
        return ContactResult(body_pos.new_zeros((N, nb, 6)), zeros3, zeros3)
    if gains is None:
        g = torch.as_tensor(point_gains(model, params), dtype=body_pos.dtype,
                            device=body_pos.device)
        gains = (g[0], g[1], g[2])
    kn, kt, fnm = gains

    cb = torch.as_tensor(model.cp_body, dtype=torch.long, device=body_pos.device)
    pos_b = body_pos[:, cb]
    pt = pos_b + (body_rot[:, cb] @ model.cp_pos[..., None])[..., 0]
    pen = model.cp_radius - pt[..., 2]
    active = pen > 0.0

    rel = pt - pos_b
    avel_b = body_avel[:, cb]
    v_pt = body_lvel[:, cb] + torch.linalg.cross(avel_b, rel, dim=-1)
    vn = v_pt[..., 2]
    vt = torch.cat([v_pt[..., 0:2], torch.zeros_like(vn)[..., None]], dim=-1)

    # Hunt-Crossley: damping scaled by penetration (no touch spike)
    fn = torch.where(
        active,
        kn * torch.clamp(pen, min=0.0) * torch.clamp(1.0 - params.kd * vn, 0.0, 5.0),
        torch.zeros_like(pen),
    )
    fn = torch.minimum(fn, fnm)
    vt_norm = torch.linalg.norm(vt, dim=-1)
    mu = params.mu * model.cp_friction
    ft_mag = torch.minimum(mu * fn, kt * vt_norm)
    ft = -ft_mag[..., None] * vt / (vt_norm[..., None] + 1e-6)

    f_w = ft.clone()
    f_w[..., 2] = f_w[..., 2] + fn                      # n = +z
    n_w = torch.linalg.cross(rel, f_w, dim=-1)          # torque about origin

    body_force = zeros3.clone().index_add_(1, cb, f_w)
    body_torque = zeros3.clone().index_add_(1, cb, n_w)
    f_ext = torch.cat([body_torque, body_force], dim=-1)
    return ContactResult(f_ext, body_force, body_torque)
