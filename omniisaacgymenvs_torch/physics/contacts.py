"""Contact model: compiled contact points against the flat plane z = 0 or
against terrain (per-point contact planes, a plane function or a height
function), and against the receiver surfaces (sphere, capsule, box) of
other bodies (PyTorch port of the JAX package's `physics/contacts.py`,
without randomization scales).

A regularized compliant contact: Hunt-Crossley normal force (spring scaled
by 1 - chi * vn, so no spike at first touch) capped per point, plus
stiction-capped viscous friction. The build-time gain helpers work in
numpy on the model's fields; `plane_contacts` and `pair_contacts` are
batched over envs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.model import JointType, Model, SurfaceType


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


def surface_effective_mass(model: Model, si: int) -> float:
    """Conservative effective mass of a receiver surface's body: the lever
    is the surface's farthest point from the CoM."""
    sb = model.surf_body[si]
    stype = SurfaceType(model.surf_type[si])
    prm = np.asarray(model.surf_params[si])
    com = _np(model.body_com)[sb]
    if stype == SurfaceType.SPHERE:
        r_max = np.linalg.norm(prm[0:3] - com) + prm[3]
    elif stype == SurfaceType.CAPSULE:
        r_max = max(
            np.linalg.norm(prm[0:3] - com), np.linalg.norm(prm[3:6] - com)
        ) + prm[6]
    else:  # BOX
        r_max = np.linalg.norm(prm[0:3] - com) + np.linalg.norm(prm[3:6])
    m = float(_np(model.body_mass)[sb])
    I = _np(model.body_inertia)[sb]
    I_min = float(min(I[0, 0], I[1, 1], I[2, 2]))
    return float(_eff_mass(np.asarray(m), np.asarray(I_min),
                           np.asarray(r_max ** 2)))


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
    height_fn: Optional[Callable] = None,
    plane_fn: Optional[Callable] = None,
    planes: Optional[torch.Tensor] = None,
    mu_scale: Optional[torch.Tensor] = None,
    geom_scale: Optional[torch.Tensor] = None,
) -> ContactResult:
    """Contact forces against the ground plane z = 0, or against terrain in
    one of three forms (the first given wins): `planes` (N, ncp, 4), one
    plane [unit normal n, offset d] per contact point with penetration
    radius - (n.pt - d); `plane_fn(pt, radius) -> (n, d)`, the same planes
    computed from the points (N, ncp, 3); `height_fn(x, y) -> (h, n)`, a
    height field with penetration radius - (z - h) n_z. `gains`: per-point
    (kn, kt, fn_max) tensors; computed from `params` when not given (the
    engine passes them precomputed on its device). `mu_scale`, `geom_scale`:
    (N, nb) per-env and per-body randomization multipliers of the friction
    coefficient and of the collision geometry (a point's offset and radius
    scale with its body)."""
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
    cp_pos, cp_radius = model.cp_pos, model.cp_radius
    if geom_scale is not None:
        gs = geom_scale[:, cb]
        cp_pos = cp_pos * gs[..., None]
        cp_radius = cp_radius * gs
    pt = pos_b + (body_rot[:, cb] @ cp_pos[..., None])[..., 0]
    n = None  # flat ground: n = +z
    if planes is not None:
        n, d = planes[..., 0:3], planes[..., 3]
        pen = cp_radius - ((pt * n).sum(-1) - d)
    elif plane_fn is not None:
        n, d = plane_fn(pt, cp_radius)
        pen = cp_radius - ((pt * n).sum(-1) - d)
    elif height_fn is not None:
        # normal (not vertical) distance to the plane through (x, y, h)
        h, n = height_fn(pt[..., 0], pt[..., 1])
        pen = cp_radius - (pt[..., 2] - h) * n[..., 2]
    else:
        pen = cp_radius - pt[..., 2]
    active = pen > 0.0

    rel = pt - pos_b
    avel_b = body_avel[:, cb]
    v_pt = body_lvel[:, cb] + torch.linalg.cross(avel_b, rel, dim=-1)
    if n is None:
        vn = v_pt[..., 2]
        vt = torch.cat([v_pt[..., 0:2], torch.zeros_like(vn)[..., None]],
                       dim=-1)
    else:
        vn = (v_pt * n).sum(-1)
        vt = v_pt - vn[..., None] * n

    # Hunt-Crossley: damping scaled by penetration (no touch spike)
    fn = torch.where(
        active,
        kn * torch.clamp(pen, min=0.0) * torch.clamp(1.0 - params.kd * vn, 0.0, 5.0),
        torch.zeros_like(pen),
    )
    fn = torch.minimum(fn, fnm)
    vt_norm = torch.linalg.norm(vt, dim=-1)
    mu = params.mu * model.cp_friction
    if mu_scale is not None:
        mu = mu * mu_scale[:, cb]
    ft_mag = torch.minimum(mu * fn, kt * vt_norm)
    ft = -ft_mag[..., None] * vt / (vt_norm[..., None] + 1e-6)

    if n is None:
        f_w = ft.clone()
        f_w[..., 2] = f_w[..., 2] + fn
    else:
        f_w = fn[..., None] * n + ft
    n_w = torch.linalg.cross(rel, f_w, dim=-1)          # torque about origin

    body_force = zeros3.clone().index_add_(1, cb, f_w)
    body_torque = zeros3.clone().index_add_(1, cb, n_w)
    f_ext = torch.cat([body_torque, body_force], dim=-1)
    return ContactResult(f_ext, body_force, body_torque)


# ----------------------------------------------------------------------
# Pair contacts: contact points against the receiver surfaces of other
# bodies (tray + ball, hand + object), over a static candidate-pair list
# compiled into the model.
# ----------------------------------------------------------------------

_N_SURF_PARAMS = {SurfaceType.SPHERE: 4, SurfaceType.CAPSULE: 7,
                  SurfaceType.BOX: 10}


class PairGroups(NamedTuple):
    """Static candidate pairs grouped by surface type (numpy, build-time).
    Each group: pt (point index), sbody (surface body), params (surface
    geometry), mmin (lighter effective mass of point and surface), mbody
    (lighter full body mass), idx (position in the model's pair list)."""

    sphere: dict
    capsule: dict
    box: dict


def build_pair_groups(model: Model) -> PairGroups:
    pts = np.asarray(model.pair_point)
    groups = {t: [] for t in SurfaceType}
    for k in range(pts.shape[0]):
        si = model.pair_surf[k]
        groups[SurfaceType(model.surf_type[si])].append((int(pts[k]), si, k))

    meff_pt = point_effective_masses(model)
    bm = _np(model.body_mass)

    def pack(pairs, nparams):
        if not pairs:
            return dict(
                pt=np.zeros(0, np.int32), sbody=np.zeros(0, np.int32),
                params=np.zeros((0, nparams)), mmin=np.zeros(0),
                mbody=np.zeros(0), idx=np.zeros(0, np.int32),
            )
        pt = np.array([p for p, _, _ in pairs], np.int32)
        sbody = np.array([model.surf_body[s] for _, s, _ in pairs], np.int32)
        params = np.array([model.surf_params[s] for _, s, _ in pairs])
        mmin = np.minimum(
            meff_pt[pt],
            np.array([surface_effective_mass(model, s) for _, s, _ in pairs]),
        )
        mbody = np.minimum(bm[model.cp_body[pt]], bm[sbody])
        return dict(pt=pt, sbody=sbody, params=params, mmin=mmin,
                    mbody=mbody, idx=np.array([k for _, _, k in pairs], np.int32))

    return PairGroups(*(pack(groups[t], _N_SURF_PARAMS[t]) for t in SurfaceType))


def pair_gains(model: Model, groups: PairGroups,
               params: ContactParams) -> np.ndarray:
    """(3, npair) float64 gains (kn, kt, fn_max) in the order of the model's
    pair list: per-mass params scale with each pair's lighter effective mass
    (force cap: lighter body mass), else the params' scalars."""
    out = np.zeros((3, len(model.pair_surf)))
    for g in groups:
        if params.per_mass:
            out[:, g["idx"]] = np.stack([params.kn_pm * g["mmin"],
                                         params.kt_pm * g["mmin"],
                                         params.fnm_pm * g["mbody"]])
        else:
            out[:, g["idx"]] = np.array(
                [[params.kn], [params.kt], [params.fn_max]])
    return out


def _contact_force(pen, n, vrel, mu, chi, kn, kt, fnm):
    """Compliant normal (Hunt-Crossley damped) + stiction-capped friction:
    world-frame force on the point body. pen (N,P), n and vrel (N,P,3)."""
    vn = torch.sum(vrel * n, dim=-1)
    vt = vrel - vn[..., None] * n
    fn = torch.minimum(
        kn * torch.clamp(pen, min=0.0) * torch.clamp(1.0 - chi * vn, 0.0, 5.0),
        fnm,
    )
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-12)
    ft_mag = torch.minimum(mu * fn, kt * vt_norm)
    return fn[..., None] * n - (ft_mag / (vt_norm + 1e-6))[..., None] * vt


def _unit(d):
    """(unit vector, length) of d (N,P,3), floored as the kernel does."""
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-18)
    return d / (dist[..., None] + 1e-9), dist


def _pair_geometry(model: Model, groups: PairGroups, body_pos, body_rot,
                   geom_scale=None):
    """Per non-empty surface-type group: (group, point body, surface body,
    world point, world point where the surface's velocity is taken,
    penetration (N,P), unit normal (N,P,3) from the surface to the point).
    A box classifies a point as outside on the squared distance to the box
    (d2 > 1e-14), so a point resting inside (d2 = 0 exactly) never flips on
    the rounding of a square root. `geom_scale` (N, nb): a point's offset
    and radius scale with the point's body; a surface's centre, half
    extents, capsule ends and radii with the surface's body (a box's
    rotation does not scale)."""
    dev = body_pos.device

    def mv(R, x):
        return (R @ x[..., None])[..., 0]

    for stype, g in zip(SurfaceType, groups):
        if g["pt"].shape[0] == 0:
            continue
        idx = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=dev)
        pi, sb = idx(g["pt"]), idx(g["sbody"])
        prm = torch.as_tensor(g["params"], dtype=body_pos.dtype, device=dev)
        pb = idx(model.cp_body[g["pt"]])
        lp, r_pt = model.cp_pos[pi], model.cp_radius[pi]
        if geom_scale is not None:
            gp = geom_scale[:, pb]
            lp, r_pt = lp * gp[..., None], r_pt * gp
            ss = geom_scale[:, sb]
            # lengths scale with the surface's body: every parameter but a
            # box's rotation quaternion
            n_len = 6 if stype == SurfaceType.BOX else prm.shape[1]
            prm = torch.cat([prm[:, :n_len] * ss[..., None],
                             prm[:, n_len:].expand(ss.shape[0], -1, -1)],
                            dim=-1)
        pt_w = body_pos[:, pb] + mv(body_rot[:, pb], lp)
        Rs, ps = body_rot[:, sb], body_pos[:, sb]
        v_at = pt_w
        if stype == SurfaceType.SPHERE:
            n, dist = _unit(pt_w - (ps + mv(Rs, prm[..., 0:3])))
            pen = prm[..., 3] + r_pt - dist
        elif stype == SurfaceType.CAPSULE:
            p0 = ps + mv(Rs, prm[..., 0:3])
            seg = ps + mv(Rs, prm[..., 3:6]) - p0
            t = torch.clamp(
                torch.sum((pt_w - p0) * seg, dim=-1)
                / (torch.sum(seg * seg, dim=-1) + 1e-9), 0.0, 1.0)
            v_at = p0 + t[..., None] * seg
            n, dist = _unit(pt_w - v_at)
            pen = prm[..., 6] + r_pt - dist
        else:  # BOX
            half = prm[..., 3:6]
            R_box = Rs @ rot.quat_to_rotmat(prm[..., 6:10])  # box -> world
            c_w = ps + mv(Rs, prm[..., 0:3])
            p_l = mv(R_box.transpose(-1, -2), pt_w - c_w)    # world -> box
            d_out = p_l - torch.minimum(torch.maximum(p_l, -half), half)
            d2 = torch.sum(d_out * d_out, dim=-1)
            dist_out = torch.sqrt(d2 + 1e-18)
            outside = d2 > 1e-14
            n_out = d_out / (dist_out[..., None] + 1e-9)
            # inside: push out through the nearest face
            f0, f1, f2 = (half - torch.abs(p_l)).unbind(-1)
            is0 = f0 <= torch.minimum(f1, f2)
            is1 = ~is0 & (f1 <= f2)
            pick = torch.stack([is0, is1, ~(is0 | is1)], dim=-1)
            n_in = torch.where(pick, torch.sign(p_l), torch.zeros_like(p_l))
            min_d = torch.minimum(f0, torch.minimum(f1, f2))
            n_l = torch.where(outside[..., None], n_out, n_in)
            pen = torch.where(outside, r_pt - dist_out, r_pt + min_d)
            n = mv(R_box, n_l)
        yield g, pb, sb, pt_w, v_at, pen, n


def box_face_ties(model: Model, groups: PairGroups, body_pos, body_rot,
                  geom_scale=None) -> torch.Tensor:
    """(N,) how close each env comes to a tie of a box's two nearest faces:
    over its candidate points that lie inside a box surface, the smallest
    difference (m) between the two smallest face distances; inf where no
    point is inside a box. At a tie the contact normal jumps from one face
    to the other, so one ulp decides the direction of the force."""
    out = body_pos.new_full((body_pos.shape[0],), float("inf"))
    for g, pb, sb, pt_w, _, _, _ in _pair_geometry(model, groups, body_pos,
                                                   body_rot, geom_scale):
        if g is not groups.box:
            continue
        prm = torch.as_tensor(g["params"], dtype=body_pos.dtype,
                              device=body_pos.device)
        ss = 1.0 if geom_scale is None else geom_scale[:, sb][..., None]
        centre, half = prm[:, 0:3] * ss, prm[:, 3:6] * ss
        Rs = body_rot[:, sb]
        R_box = Rs @ rot.quat_to_rotmat(prm[:, 6:10])
        c_w = body_pos[:, sb] + (Rs @ centre[..., None])[..., 0]
        p_l = (R_box.transpose(-1, -2) @ (pt_w - c_w)[..., None])[..., 0]
        f = (half - torch.abs(p_l)).sort(dim=-1).values
        gap = torch.where(f[..., 0] > 0, f[..., 1] - f[..., 0],
                          torch.full_like(f[..., 0], float("inf")))
        out = torch.minimum(out, gap.amin(dim=1))
    return out


def pair_penetrations(model: Model, groups: PairGroups, body_pos,
                      body_rot) -> torch.Tensor:
    """(N, npair) penetration depth of every candidate pair, in the order of
    the model's pair list (positive: in contact)."""
    out = body_pos.new_zeros((body_pos.shape[0], len(model.pair_surf)))
    for g, _, _, _, _, pen, _ in _pair_geometry(model, groups, body_pos,
                                                body_rot):
        out[:, torch.as_tensor(g["idx"].astype(np.int64),
                               device=out.device)] = pen
    return out


def pair_contacts(
    model: Model,
    groups: PairGroups,
    body_pos: torch.Tensor,     # (N, nb, 3) world
    body_rot: torch.Tensor,     # (N, nb, 3, 3)
    body_avel: torch.Tensor,    # (N, nb, 3)
    body_lvel: torch.Tensor,    # (N, nb, 3)
    params: ContactParams,
    gains: Optional[np.ndarray] = None,
    mu_scale: Optional[torch.Tensor] = None,
    geom_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Point-vs-surface contact wrenches -> (N, nb, 6) [torque; force] per
    body in world coordinates, equal and opposite on the point's and the
    surface's body. `gains`: `pair_gains` of the model, computed from
    `params` when not given. `mu_scale` (N, nb): friction multiplier, taken
    at the point's body; `geom_scale` (N, nb): as in `_pair_geometry`."""
    N, nb = body_pos.shape[0], model.nb
    f_ext = body_pos.new_zeros((N, nb, 6))
    dev = body_pos.device
    if gains is None:
        gains = pair_gains(model, groups, params)

    def vel_at(b, x):
        return body_lvel[:, b] + torch.linalg.cross(
            body_avel[:, b], x - body_pos[:, b], dim=-1)

    for g, pb, sb, pt_w, v_at, pen, n in _pair_geometry(
            model, groups, body_pos, body_rot, geom_scale):
        kn, kt, fnm = torch.as_tensor(gains[:, g["idx"]],
                                      dtype=body_pos.dtype, device=dev)
        pi = torch.as_tensor(g["pt"].astype(np.int64), device=dev)
        vrel = vel_at(pb, pt_w) - vel_at(sb, v_at)
        mu = params.mu * model.cp_friction[pi]
        if mu_scale is not None:
            mu = mu * mu_scale[:, pb]
        f = _contact_force(pen, n, vrel, mu, params.kd, kn, kt, fnm)
        n_pt = torch.linalg.cross(pt_w - body_pos[:, pb], f, dim=-1)
        n_sf = torch.linalg.cross(pt_w - body_pos[:, sb], -f, dim=-1)
        f_ext.index_add_(1, pb, torch.cat([n_pt, f], dim=-1))
        f_ext.index_add_(1, sb, torch.cat([n_sf, -f], dim=-1))
    return f_ext
