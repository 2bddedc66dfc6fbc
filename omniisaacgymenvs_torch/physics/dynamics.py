"""Forward kinematics and Featherstone articulated-body dynamics (ABA),
batched over a leading env axis (PyTorch port of the JAX package's
`physics/dynamics.py`).

Per-body math is batched across the bodies of one tree depth level; the
tree recursions (velocity and pose propagation, articulated-inertia
accumulation, acceleration propagation) run level by level, with parent
accumulation by `index_add_`. This is the plain version of the physics that
the hand-written kernels (`ops/fused_step.py`) are held against.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics import spatial
from omniisaacgymenvs_torch.physics.model import JointType, Model


class Kinematics(NamedTuple):
    """Stacked per-body kinematic cache, (N, nb, ...)."""

    E: torch.Tensor    # (N,nb,3,3) rotation parent coords -> body coords
    r: torch.Tensor    # (N,nb,3)   body origin in parent coords
    v: torch.Tensor    # (N,nb,6)   spatial velocity in body coords
    Rw: torch.Tensor   # (N,nb,3,3) world rotation (x_world = Rw @ x_body)
    pw: torch.Tensor   # (N,nb,3)   world position of body origin
    S: torch.Tensor    # (N,nb,6)   motion subspace (zeros for roots)
    vJ: torch.Tensor   # (N,nb,6)   joint velocity S*qd (zeros for roots)


class _Tree(NamedTuple):
    """Per-model index tensors on the model's device."""

    jb: torch.Tensor          # (njd,) body index per joint, joint order
    is_rev: torch.Tensor      # (njd,) 1.0 revolute, 0.0 prismatic
    jq: torch.Tensor          # (njd,) indices into q
    jv: torch.Tensor          # (njd,) indices into qd
    td: torch.Tensor          # (nt, 2) joint indices coupled by each tendon
    lvl_b: tuple              # per level: body indices
    lvl_p: tuple              # per level: parent body indices
    lvl_jd: tuple             # per level: joint indices


_TREE_CACHE: dict = {}


def _tree(model: Model) -> _Tree:
    # keyed by id() with a finalizer evicting the entry, so a new Model
    # that reuses a collected one's id never sees a stale tree
    key = id(model)
    t = _TREE_CACHE.get(key)
    if t is None:
        dev = model.device

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        jb = [i for i in range(model.nb) if model.parents[i] != -1]
        is_rev = torch.tensor(
            [1.0 if model.jtype[i] == JointType.REVOLUTE else 0.0 for i in jb],
            dtype=torch.float32, device=dev,
        )
        lvl_b, lvl_p, lvl_jd = [], [], []
        for lvl in model.levels:
            lvl_b.append(idx(lvl))
            lvl_p.append(idx([model.parents[i] for i in lvl]))
            lvl_jd.append(idx([model.jdof[i] for i in lvl]))
        t = _Tree(idx(jb), is_rev, idx(model.jq_idx), idx(model.jv_idx),
                  idx(model.tendon_dof).reshape(-1, 2), tuple(lvl_b),
                  tuple(lvl_p), tuple(lvl_jd))
        _TREE_CACHE[key] = t
        weakref.finalize(model, _TREE_CACHE.pop, key, None)
    return t


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _solve_spd6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky solve of a batch of 6x6 SPD systems (the floating
    base's articulated inertia), with the diagonal floored at 1e-12."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            sacc = A[..., i, j]
            for k in range(j):
                sacc = sacc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(sacc, min=1e-12))
            else:
                L[i][j] = sacc / L[j][j]
    y = [None] * 6
    for i in range(6):
        sacc = b[..., i]
        for k in range(i):
            sacc = sacc - L[i][k] * y[k]
        y[i] = sacc / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        sacc = y[i]
        for k in range(i + 1, 6):
            sacc = sacc - L[k][i] * x[k]
        x[i] = sacc / L[i][i]
    return torch.stack(x, dim=-1)


def kinematics(model: Model, q: torch.Tensor, qd: torch.Tensor) -> Kinematics:
    """Forward pass: local transforms, body-frame velocities, world poses."""
    N, nb = q.shape[0], model.nb
    tr = _tree(model)
    f = dict(dtype=q.dtype, device=q.device)

    qj = q[:, tr.jq]
    qjd = qd[:, tr.jv]
    axis = model.joint_axis[tr.jb]
    Et = model.joint_Et[tr.jb]
    rt = model.joint_pos[tr.jb]
    is_rev = tr.is_rev

    ang = qj * is_rev
    Rj = rot.quat_to_rotmat(rot.quat_from_angle_axis(ang, axis))
    Ej = Rj.transpose(-1, -2) @ Et
    slide = axis * (qj * (1.0 - is_rev))[..., None]
    rj = rt + torch.einsum("kji,nkj->nki", Et, slide)
    S = torch.cat(
        [axis * is_rev[:, None], axis * (1.0 - is_rev)[:, None]], dim=-1
    )
    vJ = S * qjd[..., None]

    E = torch.zeros((N, nb, 3, 3), **f)
    r = torch.zeros((N, nb, 3), **f)
    S_all = torch.zeros((N, nb, 6), **f)
    vJ_all = torch.zeros((N, nb, 6), **f)
    E[:, tr.jb] = Ej
    r[:, tr.jb] = rj
    S_all[:, tr.jb] = S
    vJ_all[:, tr.jb] = vJ

    v = torch.zeros((N, nb, 6), **f)
    Rw = torch.zeros((N, nb, 3, 3), **f)
    pw = torch.zeros((N, nb, 3), **f)

    for i in model.roots:
        qa, va = model.q_adr[i], model.v_adr[i]
        if model.jtype[i] == JointType.FREE:
            Rwi = rot.quat_to_rotmat(q[:, qa + 3: qa + 7])
            Ei = Rwi.transpose(-1, -2)
            ri = q[:, qa: qa + 3]
            v[:, i] = qd[:, va: va + 6]
        else:
            Ei = model.joint_Et[i]
            ri = model.joint_pos[i]
            Rwi = Ei.transpose(-1, -2)
        E[:, i] = Ei
        r[:, i] = ri
        Rw[:, i] = Rwi
        pw[:, i] = ri

    for b, p in zip(tr.lvl_b, tr.lvl_p):
        Eb = E[:, b]
        Rwp = Rw[:, p]
        v[:, b] = spatial.transform_motion(Eb, r[:, b], v[:, p]) + vJ_all[:, b]
        Rw[:, b] = Rwp @ Eb.transpose(-1, -2)
        pw[:, b] = pw[:, p] + _mv(Rwp, r[:, b])

    return Kinematics(E, r, v, Rw, pw, S_all, vJ_all)


def world_velocities(model: Model, kin: Kinematics):
    """World-frame (angular, linear) velocity of each body origin."""
    avel = _mv(kin.Rw, kin.v[..., 0:3])
    lvel = _mv(kin.Rw, kin.v[..., 3:6])
    return avel, lvel


def aba(
    model: Model,
    q: torch.Tensor,
    qd: torch.Tensor,
    tau_joint: torch.Tensor,
    f_ext_world: torch.Tensor,
    kin: Kinematics,
    gravity: torch.Tensor,
    h: float = 0.0,
    mass_scale: Optional[torch.Tensor] = None,
    tendon_stiffness_scale: Optional[torch.Tensor] = None,
    tendon_damping_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Articulated-body algorithm -> qdd (N, nv).

    tau_joint: (N, njd) total active torque per joint dof. f_ext_world:
    (N, nb, 6) external wrench [torque; force] about each body origin, in
    world coordinates. gravity: (3,), or (N, 3) per env. h: integrator
    substep; adds h*(drive + passive damping + h*stiffness) to the joint
    diagonal (implicit damping / Stable-PD, see drive_torques); the drive's
    randomization scales do not reach this diagonal. mass_scale (N, nb):
    per-env multiplier of each body's spatial inertia and of its
    velocity-product bias force (scaled after the cross products).
    tendon_*_scale (N, nt): the tendons' share of the diagonal per env.
    """
    N, nb = q.shape[0], model.nb
    tr = _tree(model)
    d_implicit = h * (
        model.dof_drive_damping + model.dof_damping + h * model.dof_stiffness
    )
    if model.nt:
        # fixed-tendon implicit diagonal: h*(c + h*(k + k_lim))*coef^2 per
        # coupled dof, the diagonal part of the implicit tendon Jacobian
        # (the off-diagonal coupling is dropped; errs on the damped side)
        tk, klim, tc = (model.tendon_stiffness, model.tendon_limit_stiffness,
                        model.tendon_damping)
        if tendon_stiffness_scale is not None:
            tk, klim = tk * tendon_stiffness_scale, klim * tendon_stiffness_scale
        if tendon_damping_scale is not None:
            tc = tc * tendon_damping_scale
        per_t = h * (tc + h * (tk + klim))           # (nt,) or (N, nt)
        contrib = per_t[..., None] * model.tendon_coef ** 2
        if contrib.ndim == 3:
            d_implicit = d_implicit.expand(N, -1).index_add(
                1, tr.td.reshape(-1), contrib.reshape(N, -1))
        else:
            d_implicit = d_implicit.index_add(
                0, tr.td.reshape(-1), contrib.reshape(-1))

    IA0 = spatial.spatial_inertia(
        model.body_mass, model.body_com, model.body_inertia
    )
    IA = IA0.expand(N, nb, 6, 6).clone()
    v = kin.v
    pA = spatial.cross_force(v, torch.einsum("kij,nkj->nki", IA0, v))
    if mass_scale is not None:
        IA = IA * mass_scale[..., None, None]
        pA = pA * mass_scale[..., None]
    ERw = kin.Rw.transpose(-1, -2)
    f_b = torch.cat(
        [_mv(ERw, f_ext_world[..., 0:3]), _mv(ERw, f_ext_world[..., 3:6])],
        dim=-1,
    )
    pA = pA - f_b
    c = torch.zeros_like(v)
    c[:, tr.jb] = spatial.cross_motion(v[:, tr.jb], kin.vJ[:, tr.jb])
    X = spatial.motion_transform(kin.E, kin.r)  # (N,nb,6,6)

    U_all = torch.zeros_like(v)
    D_all = torch.ones((N, nb), dtype=q.dtype, device=q.device)
    u_all = torch.zeros((N, nb), dtype=q.dtype, device=q.device)

    # ---- inward by level (deepest first) ----
    for b, p, jd in zip(tr.lvl_b[::-1], tr.lvl_p[::-1], tr.lvl_jd[::-1]):
        Sb = kin.S[:, b]
        IAb = IA[:, b]
        U = _mv(IAb, Sb)
        D = torch.sum(Sb * U, dim=-1) + model.dof_armature[jd] + d_implicit[..., jd]
        uu = tau_joint[:, jd] - torch.sum(Sb * pA[:, b], dim=-1)
        Ia = IAb - U[..., :, None] * U[..., None, :] / D[..., None, None]
        pa = pA[:, b] + _mv(Ia, c[:, b]) + U * (uu / D)[..., None]
        Xb = X[:, b]
        XbT = Xb.transpose(-1, -2)
        IA.index_add_(1, p, XbT @ Ia @ Xb)
        pA.index_add_(1, p, _mv(XbT, pa))
        U_all[:, b] = U
        D_all[:, b] = D
        u_all[:, b] = uu

    # ---- outward accelerations ----
    a_world = torch.cat([torch.zeros_like(gravity), -gravity], dim=-1)
    a = torch.zeros_like(v)
    qdd = torch.zeros_like(qd)
    for i in model.roots:
        a0p = spatial.transform_motion(kin.E[:, i], kin.r[:, i], a_world)
        if model.jtype[i] == JointType.FREE:
            va = model.v_adr[i]
            qdd_root = _solve_spd6(IA[:, i], -(pA[:, i] + _mv(IA[:, i], a0p)))
            qdd[:, va: va + 6] = qdd_root
            a[:, i] = a0p + qdd_root
        else:
            a[:, i] = a0p
    for b, p, jd in zip(tr.lvl_b, tr.lvl_p, tr.lvl_jd):
        a_p = spatial.transform_motion(kin.E[:, b], kin.r[:, b], a[:, p]) + c[:, b]
        qdd_j = (u_all[:, b] - torch.sum(U_all[:, b] * a_p, dim=-1)) / D_all[:, b]
        qdd[:, tr.jv[jd]] = qdd_j
        a[:, b] = a_p + kin.S[:, b] * qdd_j[..., None]
    return qdd


def integrate(model: Model, q: torch.Tensor, qd: torch.Tensor,
              qdd: torch.Tensor, dt, limit_lower=None, limit_upper=None):
    """Semi-implicit Euler with joint velocity clamp and hard limit
    projection; FREE roots get the 64 rad/s and 1000 m/s velocity caps and
    the quaternion exponential. limit_lower / limit_upper (njd,) or
    (N, njd) take the place of the model's joint limits."""
    tr = _tree(model)
    lim_lo = model.dof_limit_lower if limit_lower is None else limit_lower
    lim_hi = model.dof_limit_upper if limit_upper is None else limit_upper
    qd_new = qd + dt * qdd
    vmax = model.dof_max_velocity
    qj_d = torch.minimum(torch.maximum(qd_new[:, tr.jv], -vmax), vmax)
    qj = q[:, tr.jq] + dt * qj_d

    # hard limit projection: clamp q, zero outward velocity
    hit_lb = qj < lim_lo
    hit_ub = qj > lim_hi
    qj = torch.minimum(torch.maximum(qj, lim_lo), lim_hi)
    qj_d = torch.where(hit_ub, torch.clamp(qj_d, max=0.0), qj_d)
    qj_d = torch.where(hit_lb, torch.clamp(qj_d, min=0.0), qj_d)

    q_new = q.clone()
    q_new[:, tr.jq] = qj
    qd_new[:, tr.jv] = qj_d

    for i in model.roots:
        if model.jtype[i] != JointType.FREE:
            continue
        qa, va = model.q_adr[i], model.v_adr[i]
        omega_b = torch.clamp(qd_new[:, va: va + 3], -64.0, 64.0)
        vel_b = torch.clamp(qd_new[:, va + 3: va + 6], -1000.0, 1000.0)
        quat = q[:, qa + 3: qa + 7]
        Rw = rot.quat_to_rotmat(quat)
        q_new[:, qa: qa + 3] = q[:, qa: qa + 3] + dt * _mv(Rw, vel_b)
        q_new[:, qa + 3: qa + 7] = rot.quat_normalize(
            rot.quat_integrate_body(quat, omega_b, dt)
        )
        qd_new[:, va: va + 3] = omega_b
        qd_new[:, va + 3: va + 6] = vel_b
    return q_new, qd_new


def drive_torques(model: Model, q: torch.Tensor, qd: torch.Tensor, control,
                  h: float = 0.0, stiffness_scale=None, damping_scale=None,
                  tendon_stiffness_scale=None,
                  tendon_damping_scale=None) -> torch.Tensor:
    """Total active joint torque: PD drive (clamped) + direct effort +
    passive damping/friction. Stable-PD: the spring acts on the
    velocity-predicted position q + h*qd, and the damping is made implicit
    by the matching h*Kd on the ABA diagonal (see aba). stiffness_scale,
    damping_scale (N, njd): per-env multipliers of the drive's kp and kd;
    tendon_stiffness_scale (N, nt) of a tendon's stiffness and limit
    stiffness, tendon_damping_scale (N, nt) of its damping."""
    tr = _tree(model)
    qj = q[:, tr.jq]
    qjd = qd[:, tr.jv]
    kp = model.dof_stiffness
    kd = model.dof_drive_damping
    if stiffness_scale is not None:
        kp = kp * stiffness_scale
    if damping_scale is not None:
        kd = kd * damping_scale
    drive = (
        kp * (control.pos_target - qj - h * qjd)
        + kd * (control.vel_target - qjd)
    )
    emax = model.dof_max_effort
    drive = torch.minimum(torch.maximum(drive, -emax), emax)
    passive = -model.dof_damping * qjd - model.dof_friction * torch.tanh(qjd * 10.0)
    tau = drive + control.effort + passive
    if model.nt:
        # fixed tendons, Stable-PD style: length at the velocity-predicted
        # position, damping made implicit by the matching diagonal in aba()
        co = model.tendon_coef                            # (nt, 2)
        L = torch.sum(co * (qj + h * qjd)[:, tr.td], dim=-1)
        Ldot = torch.sum(co * qjd[:, tr.td], dim=-1)
        excess = L - torch.minimum(
            torch.maximum(L, model.tendon_limit_lower),
            model.tendon_limit_upper)
        tk, klim, tc = (model.tendon_stiffness, model.tendon_limit_stiffness,
                        model.tendon_damping)
        if tendon_stiffness_scale is not None:
            tk, klim = tk * tendon_stiffness_scale, klim * tendon_stiffness_scale
        if tendon_damping_scale is not None:
            tc = tc * tendon_damping_scale
        F = klim * excess + tk * (L - model.tendon_rest) + tc * Ldot
        tau = tau.index_add(
            1, tr.td.reshape(-1),
            (-co * F[..., None]).reshape(q.shape[0], -1),
        )
    return tau
