"""Whole-control-step (K1), report-FK (K2) and single-substep (K3) kernels:
wrappers, plain PyTorch versions, launch counters and the loader of
`csrc/fused_step.cu`.

K1 `step` replaces the JAX package's `ops/fused_substep.py` batched_step /
_step_kernel(n_steps): n_steps physics substeps and the report FK in one
launch. K2 `fk` replaces batched_fk / fk_kernel: (q, qd) -> world pose and
velocity of every body. K3 `substep` replaces batched / kernel: one substep
without the report (a launch mode of K1's device code). The CUDA source is
built with nvcc at first use into `build/torch_kernels/` (keyed by a hash
of the source and flags) and bound with ctypes.

A wrapper given CPU tensors runs the plain version (`step_plain`,
`fk_plain`, `substep_plain`); given CUDA tensors it launches the kernel or
raises. The kernels cover forests of FREE and FIXED roots, revolute and
prismatic joints, the flat ground plane or one terrain contact plane per
contact point and env (`planes`, frozen over the substeps of a launch), pair
contacts against sphere, capsule and box surfaces, gravity compensation,
fixed tendons and per-env domain-randomization overlays (`overlay`, a dict
of (N, size) tensors under `OVERLAY_KEYS`, packed here into the one
(N, n_dr) input the kernel reads);
`scope_errors` lists what a model has beyond the kernels' compile-time
maxima, and the engine's `check_scope` refuses such a model on CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from omniisaacgymenvs_torch.physics import contacts, dynamics, rotations as rot
from omniisaacgymenvs_torch.physics.model import JointType, Model, SurfaceType

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# packed table layout, mirrored in csrc/fused_step.cu
_F_BODY, _BODY_STRIDE, _CP_STRIDE = 8, 64, 8
_GC_STRIDE, _PAIR_STRIDE, _SURF_STRIDE, _TEND_STRIDE, _IB_STRIDE = 4, 4, 16, 8, 5
(_B_AXIS, _B_ET, _B_JPOS, _B_I6, _B_ARM, _B_DAMP, _B_FRIC, _B_KP, _B_KD,
 _B_EMAX, _B_VMAX, _B_LO, _B_HI, _B_DIMPL, _B_DIMPL0) = (
    0, 3, 12, 15, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61)
# compile-time maxima of the kernel (csrc/fused_step.cu OIGE_*_MAX): bodies,
# ground contact points, sensors, pairs, surfaces, tendons, FREE roots
NB_MAX, NCP_MAX, NS_MAX = 32, 128, 8
NPAIR_MAX, NSURF_MAX, NT_MAX, NFREE_MAX = 1024, 32, 8, 4
LIMITS = (NB_MAX, NCP_MAX, NS_MAX, NPAIR_MAX, NSURF_MAX, NT_MAX, NFREE_MAX)

# The domain-randomization overlay keys in the order of the packed overlay
# the kernel reads (csrc/fused_step.cu DrOffsets), each with the Model
# attribute that gives its size per env (gravity_delta: 3). `*_scale` keys
# multiply a model constant (neutral 1), `*_delta` keys add to one (0).
OVERLAY_KEYS = {
    "damping_scale": "njd", "friction_scale": "nb", "geom_scale": "nb",
    "gravity_delta": 3, "limit_lower_delta": "njd",
    "limit_upper_delta": "njd", "mass_scale": "nb", "stiffness_scale": "njd",
    "tendon_damping_scale": "nt", "tendon_stiffness_scale": "nt",
}


# ---------------------------------------------------------------------------
# scope and model tables
# ---------------------------------------------------------------------------

def n_free_roots(model: Model) -> int:
    return sum(model.jtype[r] == JointType.FREE for r in model.roots)


def scope_errors(model: Model) -> List[str]:
    """What `model` has beyond the kernels' own scope (empty when in
    scope): the sizes must lie within the kernels' compile-time maxima."""
    errs = []
    for n, cap, what in (
        (model.nb, NB_MAX, "bodies"),
        (model.ncp, NCP_MAX, "contact points"),
        (model.num_sensors, NS_MAX, "sensors"),
        (len(model.pair_surf), NPAIR_MAX, "contact pairs"),
        (len(model.surf_type), NSURF_MAX, "receiver surfaces"),
        (model.nt, NT_MAX, "fixed tendons"),
        (n_free_roots(model), NFREE_MAX, "FREE roots"),
    ):
        if n > cap:
            errs.append(f"{n} {what} > kernel maximum {cap}")
    return errs


def overlay_sizes(model: Model) -> dict:
    """Floats per env of every overlay key, in the packed order."""
    return {k: a if isinstance(a, int) else getattr(model, a)
            for k, a in OVERLAY_KEYS.items()}


def check_overlay(model: Model, overlay, n: int, device: torch.device):
    """The overlay as a dict of its keys, or None for an empty one. Raises
    on a key outside OVERLAY_KEYS and on a value that is not a contiguous
    (n, size) float32 tensor on `device`."""
    if not overlay:
        return None
    sizes = overlay_sizes(model)
    for key, val in overlay.items():
        if key not in sizes:
            raise KeyError(f"unknown overlay key {key!r}; the engine takes "
                           f"{sorted(sizes)}")
        _check(val, (n, sizes[key]), f"overlay[{key!r}]", torch.device(device))
    return dict(overlay)


def pack_overlay(model: Model, overlay: dict, n: int,
                 device: torch.device) -> torch.Tensor:
    """(n, n_dr) float32: the overlay's keys side by side in the order of
    OVERLAY_KEYS, absent keys at their neutral value (x * 1 and x + 0 are
    exact, so the kernel computes under a neutral key what it computes
    without it)."""
    parts = []
    for key, size in overlay_sizes(model).items():
        if key in overlay:
            parts.append(overlay[key])
        else:
            fill = torch.ones if key.endswith("_scale") else torch.zeros
            parts.append(fill((n, size), device=device))
    return torch.cat(parts, dim=1)


def _np64(x) -> np.ndarray:
    return x.detach().cpu().double().numpy()


def _quat_mat64(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def table_dims(model: Model) -> tuple:
    """The sizes the kernels' entry points take beside the tables."""
    return (model.nb, model.ncp, model.num_sensors, len(model.pair_surf),
            len(model.surf_type), model.nt, model.nq, model.nv, model.njd)


def table_offsets(model: Model) -> dict:
    """Start of each section of the float (`f_*`) and int (`i_*`) table."""
    nb, ncp, ns, npair, nsurf, _, _, _, _ = table_dims(model)
    f_cp = _F_BODY + _BODY_STRIDE * nb
    f_gc = f_cp + _CP_STRIDE * ncp
    f_pair = f_gc + _GC_STRIDE * nb
    f_surf = f_pair + _PAIR_STRIDE * npair
    f_tend = f_surf + _SURF_STRIDE * nsurf
    i_cp = _IB_STRIDE * nb
    i_sens = i_cp + ncp
    i_pair = i_sens + ns
    i_surf = i_pair + 2 * npair
    i_tend = i_surf + 2 * nsurf
    return dict(f_cp=f_cp, f_gc=f_gc, f_pair=f_pair, f_surf=f_surf,
                f_tend=f_tend, f_end=f_tend + _TEND_STRIDE * model.nt,
                i_cp=i_cp, i_sens=i_sens, i_pair=i_pair, i_surf=i_surf,
                i_tend=i_tend, i_end=i_tend + 2 * model.nt)


def pack_tables(model: Model, h: float, gravity, contact, gains: np.ndarray,
                pair_gains: np.ndarray | None = None):
    """(float32 table, int32 table) of the model constants the kernels read.
    `gains`: (3, ncp) per-point ground (kn, kt, fn_max); `pair_gains`:
    (3, npair) the same per pair (`contacts.pair_gains`, computed here when
    not given)."""
    nb, ncp, npair = model.nb, model.ncp, len(model.pair_surf)
    off = table_offsets(model)
    f = np.zeros(off["f_end"])
    f[0:3] = np.asarray(gravity, np.float64)
    f[3] = h
    f[4] = contact.kd
    axis, Et, jpos = (_np64(model.joint_axis), _np64(model.joint_Et),
                      _np64(model.joint_pos))
    mass, com, I3 = (_np64(model.body_mass), _np64(model.body_com),
                     _np64(model.body_inertia))
    gcomp = _np64(model.gravity_comp)
    dof = {k: _np64(getattr(model, "dof_" + k)) for k in (
        "armature", "damping", "friction", "stiffness", "drive_damping",
        "max_effort", "max_velocity", "limit_lower", "limit_upper")}
    d_impl0 = h * (dof["drive_damping"] + dof["damping"] + h * dof["stiffness"])
    d_impl = d_impl0.copy()
    # fixed tendons add h (c + h (k + k_lim)) coef^2 to their two joints'
    # implicit diagonal; with an overlay the kernel adds that share per env
    # to the diagonal without it (B_DIMPL0)
    tend = {k: _np64(getattr(model, "tendon_" + k)) for k in (
        "coef", "rest", "stiffness", "damping", "limit_lower", "limit_upper",
        "limit_stiffness")}
    for t in range(model.nt):
        per_t = h * (tend["damping"][t] + h * (tend["stiffness"][t]
                                               + tend["limit_stiffness"][t]))
        for j in range(2):
            d_impl[model.tendon_dof[t, j]] += per_t * tend["coef"][t, j] ** 2
    for i in range(nb):
        B = _F_BODY + _BODY_STRIDE * i
        f[B + _B_AXIS: B + _B_AXIS + 3] = axis[i]
        f[B + _B_ET: B + _B_ET + 9] = Et[i].reshape(-1)
        f[B + _B_JPOS: B + _B_JPOS + 3] = jpos[i]
        cx = np.array([[0, -com[i][2], com[i][1]],
                       [com[i][2], 0, -com[i][0]],
                       [-com[i][1], com[i][0], 0]])
        I6 = np.block([[I3[i] + mass[i] * cx @ cx.T, mass[i] * cx],
                       [mass[i] * cx.T, mass[i] * np.eye(3)]])
        f[B + _B_I6: B + _B_I6 + 36] = I6.reshape(-1)
        G = off["f_gc"] + _GC_STRIDE * i
        f[G] = gcomp[i] * mass[i]
        f[G + 1: G + 4] = com[i]
        d = model.jdof[i]
        if d < 0:
            continue
        f[B + _B_ARM] = dof["armature"][d]
        f[B + _B_DAMP] = dof["damping"][d]
        f[B + _B_FRIC] = dof["friction"][d]
        f[B + _B_KP] = dof["stiffness"][d]
        f[B + _B_KD] = dof["drive_damping"][d]
        f[B + _B_EMAX] = dof["max_effort"][d]
        f[B + _B_VMAX] = dof["max_velocity"][d]
        f[B + _B_LO] = dof["limit_lower"][d]
        f[B + _B_HI] = dof["limit_upper"][d]
        f[B + _B_DIMPL] = d_impl[d]
        f[B + _B_DIMPL0] = d_impl0[d]
    cp_pos, cp_rad, cp_mu = (_np64(model.cp_pos), _np64(model.cp_radius),
                             _np64(model.cp_friction))
    for k in range(ncp):
        C = off["f_cp"] + _CP_STRIDE * k
        f[C: C + 3] = cp_pos[k]
        f[C + 3] = cp_rad[k]
        f[C + 4] = contact.mu * cp_mu[k]
        f[C + 5: C + 8] = gains[:, k]
    if npair:
        if pair_gains is None:
            pair_gains = contacts.pair_gains(
                model, contacts.build_pair_groups(model), contact)
        f[off["f_pair"]: off["f_surf"]].reshape(npair, _PAIR_STRIDE)[:, 0:3] = (
            pair_gains.T)
    for si, (stype, prm) in enumerate(zip(model.surf_type, model.surf_params)):
        S = off["f_surf"] + _SURF_STRIDE * si
        if stype == SurfaceType.BOX:
            # centre, half extents, then the rotation box -> body
            f[S: S + 6] = prm[0:6]
            f[S + 6: S + 15] = _quat_mat64(prm[6:10]).reshape(-1)
        else:
            f[S: S + len(prm)] = prm
    jbody = [i for i in range(nb) if model.jdof[i] >= 0]
    for t in range(model.nt):
        T = off["f_tend"] + _TEND_STRIDE * t
        f[T: T + 2] = tend["coef"][t]
        f[T + 2: T + 8] = [tend[k][t] for k in (
            "rest", "stiffness", "damping", "limit_lower", "limit_upper",
            "limit_stiffness")]
    body_rec = np.stack([model.parents, model.jtype, model.q_adr, model.v_adr,
                         model.jdof], axis=1).reshape(-1)
    it = np.concatenate([
        body_rec, model.cp_body, np.asarray(model.sensor_body, np.int64),
        np.stack([model.pair_point, np.asarray(model.pair_surf, np.int64)],
                 axis=1).reshape(-1) if npair else np.zeros(0, np.int64),
        np.stack([model.surf_type, model.surf_body], axis=1).reshape(-1)
        if model.surf_type else np.zeros(0, np.int64),
        np.asarray([jbody[d] for d in model.tendon_dof.reshape(-1)], np.int64),
    ])
    return f.astype(np.float32), it.astype(np.int32)


class FusedKernels:
    """The packed model tables of one engine on its CUDA device, and the
    launch count of each kernel wrapper."""

    def __init__(self, model: Model, h: float, gravity, contact,
                 gains: np.ndarray, pair_gains: np.ndarray | None = None):
        ftab, itab = pack_tables(model, h, gravity, contact, gains, pair_gains)
        self.ftab = torch.as_tensor(ftab, device=model.device)
        self.itab = torch.as_tensor(itab, device=model.device)
        self.dims = (ctypes.c_int * 9)(*table_dims(model))
        self.launches = {"step": 0, "fk": 0, "substep": 0}
        # how many of those launches read an overlay
        self.overlay_launches = {"step": 0, "substep": 0}

    def reset_counts(self):
        for counts in (self.launches, self.overlay_launches):
            for k in counts:
                counts[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def step_plain(engine, q, qd, effort, pos_target, vel_target, f_applied,
               n_steps: int, planes=None, overlay=None):
    """n_steps plain substeps (`engine._substep`), then the report FK.
    Returns (q, qd, sensor_forces, body_pos, body_quat, body_avel,
    body_lvel); sensor forces are those of the last substep. `planes`
    (N, ncp, 4): the terrain contact planes of an engine with terrain, the
    same for all n_steps substeps, as in the kernel. `overlay`: a dict of
    (N, size) randomization tensors under OVERLAY_KEYS, the same for all
    substeps."""
    from omniisaacgymenvs_torch.physics.state import Control

    m = engine.model
    N = q.shape[0]
    _check_planes(engine, planes, N, q.device)
    overlay = check_overlay(m, overlay, N, q.device)
    ctrl = Control(effort=effort, pos_target=pos_target,
                   vel_target=vel_target, body_force=None, body_torque=None)
    sf = q.new_zeros((N, m.num_sensors, 6))
    for _ in range(n_steps):
        q, qd, sf = engine._substep(q, qd, ctrl, f_applied, engine.h, planes,
                                    overlay)
    pos, quat, avel, lvel = fk_plain(m, q, qd)
    return q, qd, sf, pos, quat, avel, lvel


def substep_plain(engine, q, qd, effort, pos_target, vel_target, f_applied,
                  planes=None, overlay=None):
    """One plain substep (`engine._substep`): (q, qd, sensor_forces);
    `planes` and `overlay` as in `step_plain`."""
    from omniisaacgymenvs_torch.physics.state import Control

    N = q.shape[0]
    _check_planes(engine, planes, N, q.device)
    overlay = check_overlay(engine.model, overlay, N, q.device)
    ctrl = Control(effort=effort, pos_target=pos_target,
                   vel_target=vel_target, body_force=None, body_torque=None)
    return engine._substep(q, qd, ctrl, f_applied, engine.h, planes, overlay)


def fk_plain(model: Model, q, qd):
    """Report FK: (N,nq), (N,nv) -> world pos (N,nb,3), quat (N,nb,4),
    angular and linear velocity (N,nb,3) of every body origin."""
    kin = dynamics.kinematics(model, q, qd)
    avel, lvel = dynamics.world_velocities(model, kin)
    return kin.pw, rot.rotmat_to_quat(kin.Rw), avel, lvel


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, shape, name: str, device: torch.device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_planes(engine, planes, n: int, device: torch.device):
    """`planes` must be given, as (n, ncp, 4) float32 on `device`, exactly
    when the engine has terrain."""
    if planes is None:
        if engine.has_terrain:
            raise ValueError(f"{engine.model.name}: the engine has terrain, "
                             "so the step needs `planes`")
        return
    if not engine.has_terrain:
        raise ValueError(f"{engine.model.name}: `planes` given to an engine "
                         "without terrain")
    _check(planes, (n, engine.model.ncp, 4), "planes", device)


def _kernels(engine) -> FusedKernels:
    if engine.kernels is None:
        raise RuntimeError("engine was built for the CPU; its kernels have "
                           "no tables on a CUDA device")
    return engine.kernels


def _check_step_inputs(k, m, q, qd, effort, pos_target, vel_target, f_applied):
    N = q.shape[0]
    if N < 1:
        raise ValueError("need N >= 1")
    dev = k.ftab.device
    _check(q, (N, m.nq), "q", dev)
    _check(qd, (N, m.nv), "qd", dev)
    for name, x in (("effort", effort), ("pos_target", pos_target),
                    ("vel_target", vel_target)):
        _check(x, (N, m.njd), name, dev)
    _check(f_applied, (N, m.nb, 6), "f_applied", dev)
    return N, dev


def _ptr(x):
    return None if x is None else x.data_ptr()


def _packed_overlay(model, overlay, n, device):
    """The kernel's overlay input, or None: presence picks the kernel
    variant, so an engine without randomization runs the code it ran
    before there were overlays."""
    overlay = check_overlay(model, overlay, n, device)
    return None if overlay is None else pack_overlay(model, overlay, n, device)


def step(engine, q, qd, effort, pos_target, vel_target, f_applied,
         n_steps: int, planes=None, overlay=None):
    """K1: n_steps substeps + report FK in one launch. Same arguments and
    returns as `step_plain`, which it runs for CPU tensors."""
    if not q.is_cuda:
        return step_plain(engine, q, qd, effort, pos_target, vel_target,
                          f_applied, n_steps, planes, overlay)
    k = _kernels(engine)
    m = engine.model
    if n_steps < 1:
        raise ValueError(f"need n_steps >= 1, got {n_steps}")
    ins = (q, qd, effort, pos_target, vel_target, f_applied)
    N, dev = _check_step_inputs(k, m, *ins)
    _check_planes(engine, planes, N, dev)
    dr = _packed_overlay(m, overlay, N, dev)
    e = torch.empty
    outs = (e((N, m.nq), device=dev), e((N, m.nv), device=dev),
            e((N, m.num_sensors, 6), device=dev), e((N, m.nb, 3), device=dev),
            e((N, m.nb, 4), device=dev), e((N, m.nb, 3), device=dev),
            e((N, m.nb, 3), device=dev))
    err = library().lib.oige_step(
        k.ftab.data_ptr(), k.itab.data_ptr(), k.dims,
        *[x.data_ptr() for x in ins], _ptr(planes), _ptr(dr),
        *[x.data_ptr() for x in outs], N, int(n_steps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"oige_step launch failed: cudaError {err}")
    k.launches["step"] += 1
    if dr is not None:
        k.overlay_launches["step"] += 1
    return outs


def substep(engine, q, qd, effort, pos_target, vel_target, f_applied,
            planes=None, overlay=None):
    """K3: one substep in one launch, without the report FK: (q, qd,
    sensor_forces). Runs `substep_plain` for CPU tensors."""
    if not q.is_cuda:
        return substep_plain(engine, q, qd, effort, pos_target, vel_target,
                             f_applied, planes, overlay)
    k = _kernels(engine)
    m = engine.model
    ins = (q, qd, effort, pos_target, vel_target, f_applied)
    N, dev = _check_step_inputs(k, m, *ins)
    _check_planes(engine, planes, N, dev)
    dr = _packed_overlay(m, overlay, N, dev)
    e = torch.empty
    outs = (e((N, m.nq), device=dev), e((N, m.nv), device=dev),
            e((N, m.num_sensors, 6), device=dev))
    err = library().lib.oige_substep(
        k.ftab.data_ptr(), k.itab.data_ptr(), k.dims,
        *[x.data_ptr() for x in ins], _ptr(planes), _ptr(dr),
        *[x.data_ptr() for x in outs], N,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"oige_substep launch failed: cudaError {err}")
    k.launches["substep"] += 1
    if dr is not None:
        k.overlay_launches["substep"] += 1
    return outs


def fk(engine, q, qd):
    """K2: report FK in one launch; runs `fk_plain` for CPU tensors."""
    if not q.is_cuda:
        return fk_plain(engine.model, q, qd)
    k = _kernels(engine)
    m = engine.model
    N = q.shape[0]
    if N < 1:
        raise ValueError("need N >= 1")
    dev = k.ftab.device
    _check(q, (N, m.nq), "q", dev)
    _check(qd, (N, m.nv), "qd", dev)
    e = torch.empty
    outs = (e((N, m.nb, 3), device=dev), e((N, m.nb, 4), device=dev),
            e((N, m.nb, 3), device=dev), e((N, m.nb, 3), device=dev))
    err = library().lib.oige_fk(
        k.ftab.data_ptr(), k.itab.data_ptr(), k.dims,
        q.data_ptr(), qd.data_ptr(), *[x.data_ptr() for x in outs], N,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"oige_fk launch failed: cudaError {err}")
    k.launches["fk"] += 1
    return outs


# ---------------------------------------------------------------------------
# operation counts (for the roofline bound)
# ---------------------------------------------------------------------------

def _dot(k: int) -> int:
    """Operations of a k-term dot product: k multiplies and k - 1 adds."""
    return 2 * k - 1


def op_count(model: Model, n_steps: int, planes: bool = False,
             overlay: bool = False) -> dict:
    """FP32 operations per env that K1 (`step`, n_steps substeps + FK), K2
    (`fk`) and K3 (`substep`, one substep) need, counted over the steps of
    csrc/fused_step.cu for this model's bodies, joints, roots, contact
    points (against terrain `planes`, or flat ground), pairs by surface
    type, compensated bodies and tendons, and with `overlay` the products
    and sums that the ten randomization keys add to a substep. An add,
    multiply, compare, min/max, division, sqrt, sin, cos or tanh is 1 (a
    fused multiply-add is a multiply and an add); a product that is zero by
    the structure of its operands is not counted, nor is a value that equals
    another by symmetry (the kernel's inward pass multiplies X's zero block
    and the whole of X^T Ia X all the same), nor one the kernel computes a
    second time (a prismatic joint's offset). The only branch on the data is
    a box's inside / outside: it is counted as inside, the shorter side, so
    the count never exceeds what a run's data needs."""
    nb, ncp = model.nb, model.ncp
    jts = [model.jtype[i] for i in range(nb) if model.parents[i] >= 0]
    n_pri = sum(j == JointType.PRISMATIC for j in jts)
    n_rev = len(jts) - n_pri
    nj = n_rev + n_pri
    n_free = n_free_roots(model)
    n_fixed = len(model.roots) - n_free
    # joints whose parent is a FIXED root skip the 6x6 accumulation
    n_under_fixed = sum(
        model.parents[i] >= 0 and model.parents[model.parents[i]] < 0
        and model.jtype[model.parents[i]] == JointType.FIXED
        for i in range(nb))
    n_surf = {t: 0 for t in SurfaceType}
    for si in model.pair_surf:
        n_surf[SurfaceType(model.surf_type[si])] += 1
    n_gc = int((model.gravity_comp != 0).sum())
    mv3 = 3 * _dot(3)                       # 3x3 matrix-vector, 15
    mm3 = 9 * _dot(3)                       # 3x3 matrix product, 45
    cross = 9
    # forward kinematics, per revolute joint: sincos 2, Rodrigues 34 (1 - cos,
    # 3 diagonal entries of 3, 6 off-diagonal of 4), E = R^T Et, r x w_p and
    # subtract 12, two mat-vecs, vJ 6, two crosses, Rw = Rw_p E^T, pw mat-vec
    # and add 3; per prismatic joint: r = jpos + Et^T (a q) 21, E = Et free,
    # r x w_p and subtract 12, two mat-vecs, vJ 6, one cross, Rw, pw; per
    # body world velocities, two mat-vecs; per FREE root quaternion ->
    # matrix 30 (9 products, 3 per diagonal and 2 per other entry); a FIXED
    # root's pose is constant
    fk_rev = 2 + 34 + mm3 + 12 + 2 * mv3 + 6 + 2 * cross + mm3 + mv3 + 3
    fk_pri = 21 + 12 + 2 * mv3 + 6 + cross + mm3 + mv3 + 3
    fk = n_rev * fk_rev + n_pri * fk_pri + nb * 2 * mv3 + 30 * n_free
    # contact point: mat-vec, cross, velocity 3, penetration 2, normal force
    # 8, tangential norm 5, friction 7, torque cross, accumulate 6
    contact = mv3 + cross + 3 + 2 + 8 + 5 + 7 + cross + 6
    if planes:
        # against a terrain plane [n, d]: mat-vec, cross, velocity 3, the
        # point's world position 3, distance n.pt - d 6, penetration 1, the
        # contact force along a general normal 40 (as for a pair, below),
        # torque cross, accumulate 6
        contact = mv3 + cross + 3 + 3 + 6 + 1 + 40 + cross + 6
    # pair, whatever the surface: point mat-vec, offset from the surface's
    # body 6, two velocity crosses and the difference 9, the contact force
    # along a general normal 40 (normal speed 5, tangential part 6, normal
    # force 8, its norm 7, friction scale 5, force 9), two torque crosses
    # and 12 accumulating adds
    pair = mv3 + 6 + 2 * cross + 9 + 40 + 2 * cross + 12
    # sphere: centre mat-vec, offset 3, unit vector 12, penetration 2
    pair_sphere = pair + mv3 + 3 + 12 + 2
    # capsule: two end mat-vecs, axis 3, projection 8 + 6 + 1, clamp 2,
    # nearest point 6, offset 3, unit vector 12, penetration 2
    pair_capsule = pair + 2 * mv3 + 3 + 8 + 6 + 1 + 2 + 6 + 3 + 12 + 2
    # box: centre mat-vec, offset 3, into the box frame two mat-vecs, clamp
    # and squared distance 15, sqrt 2, outside test 1, face distances 6,
    # nearest face 3 + 2, inside normal and penetration 4, normal back to
    # the world two mat-vecs
    pair_box = pair + mv3 + 3 + 2 * mv3 + 15 + 2 + 1 + 6 + 3 + 2 + 4 + 2 * mv3
    pairs = (n_surf[SurfaceType.SPHERE] * pair_sphere
             + n_surf[SurfaceType.CAPSULE] * pair_capsule
             + n_surf[SurfaceType.BOX] * pair_box)
    # gravity compensation per compensated body: force 3, CoM mat-vec,
    # cross, 6 adds
    gravcomp = 3 + mv3 + cross + 6
    # drive per joint: PD 7, clamp 2, passive 5, sum 2
    drive = 16
    # tendon: length 7, rate 3, limit excess 3, force 6, two torques 4
    tendon = 23
    # bias force per body: I v over the structural non-zeros (3 rows of 5
    # terms, 3 of 3), three crosses, wrench adds 6, two mat-vecs, combine 9
    bias = 3 * _dot(5) + 3 * _dot(3) + 3 * cross + 6 + 2 * mv3 + 9
    # inward per joint: U = IA S 6 rows of 3 terms; D 7; u 6 (a joint under
    # a FIXED root stops here); 1/D 1; U/D 6;
    # Ia upper triangle 21 x 2; pa = pA + Ia c + U u/D: 6 rows of 6 terms,
    # 1 and 3 per row; M = r x rows(E); T = Ia X: 18 entries of 6 terms and
    # 18 of 3; X^T T upper triangle: 15 entries of 6 terms, 6 of 3, and 21
    # accumulating adds; X^T pa 3 of 6 terms and 3 of 3, accumulate 6
    inward_head = 6 * _dot(3) + 7 + 6
    inward = (inward_head + 1 + 6 + 21 * 2 + 6 * _dot(6) + 1 + 6 * 3
              + 3 * cross + 18 * _dot(6) + 18 * _dot(3)
              + 15 * _dot(6) + 6 * _dot(3) + 21
              + 3 * _dot(6) + 3 * _dot(3) + 6)
    # FREE root: gravity in the body frame (mat-vec), rhs 6 rows of 3 terms
    # and 1 add, Cholesky factor 97 and two triangular solves of 36, acc 3;
    # FIXED root: the gravity mat-vec
    root = mv3 + 6 * (_dot(3) + 1) + 97 + 2 * 36 + 3
    # outward per joint: cross, subtract 3, two mat-vecs, bias 6, U.a 6
    # terms, qdd 2, acc 6
    outward = cross + 3 + 2 * mv3 + 6 + _dot(6) + 2 + 6
    # integration: qd + h qdd 2 per dof, 10 per joint; per FREE root caps
    # 12, position mat-vec and 6; quaternion exponential 4 + 7 + 6, product
    # 28, normalization 9 + 4
    integ = 2 * model.nv + 10 * nj + n_free * (12 + mv3 + 6 + 4 + 7 + 6 + 28 + 13)
    sub = (fk + contact * ncp + pairs + gravcomp * n_gc + drive * nj
           + tendon * model.nt + bias * nb
           + inward * (nj - n_under_fixed) + inward_head * n_under_fixed
           + root * n_free + mv3 * n_fixed + outward * nj + integ)
    if overlay:
        # mass_scale: the 6x6 inertia 36 and the bias force 6 per body, the
        # compensation force 3 per compensated body; stiffness_scale and
        # damping_scale 2 per joint; friction_scale 1 per ground point and
        # pair; geom_scale: a point's offset and radius 4 per ground point
        # and pair, a sphere's centre and radius 4, a capsule's ends and
        # radius 7, a box's centre and half extents 6; gravity_delta 3;
        # the limit deltas 2 per joint; the tendon scales 3 per tendon, and
        # their share of the implicit diagonal 7 per tendon, 3 per coupled
        # joint and 1 per joint for the sum
        sub += (42 * nb + 3 * n_gc + 2 * nj + 5 * ncp
                + 5 * len(model.pair_surf) + 4 * n_surf[SurfaceType.SPHERE]
                + 7 * n_surf[SurfaceType.CAPSULE] + 6 * n_surf[SurfaceType.BOX]
                + 3 + 2 * nj + (3 + 7 + 2 * 3) * model.nt + nj)
    # Shepperd quaternion 43 per body that moves
    report = fk + 43 * (nb - n_fixed)
    return {"step": n_steps * sub + report, "fk": report, "substep": sub}


def io_bytes(model: Model, planes: bool = False,
             overlay: bool = False) -> dict:
    """Bytes per env that K1, K2 and K3 must move: each input read once
    (with `planes`, four more floats per contact point; with `overlay`, the
    packed overlay's n_dr floats), each output written once (float32)."""
    nq, nv, njd, nb, ns = (model.nq, model.nv, model.njd, model.nb,
                           model.num_sensors)
    report = 13 * nb
    sub = nq + nv + 3 * njd + 6 * nb + nq + nv + 6 * ns
    if planes:
        sub += 4 * model.ncp
    if overlay:
        sub += sum(overlay_sizes(model).values())
    return {"step": 4 * (sub + report), "fk": 4 * (nq + nv + report),
            "substep": 4 * sub}


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

class _Library:
    def __init__(self, lib: ctypes.CDLL, ptxas_log: str, build_s: float,
                 path: Path):
        self.lib = lib
        self.ptxas_log = ptxas_log
        self.build_s = build_s
        self.path = path


_LIBRARY = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "omniisaacgymenvs_torch need the CUDA toolkit")


def build(flags=NVCC_FLAGS) -> _Library:
    """Build `csrc/fused_step.cu` with `flags` (once per source and flags
    hash; the library stays in BUILD_DIR) and load it."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"fused_step_{key}.so"
    log = so.with_suffix(".log")
    t0 = time.time()
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    build_s = time.time() - t0
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.oige_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.oige_limits.restype = ci
    dims = ctypes.POINTER(ctypes.c_int)
    lib.oige_step.argtypes = [vp, vp, dims] + [vp] * 15 + [ci, ci, vp]
    lib.oige_step.restype = ci
    lib.oige_substep.argtypes = [vp, vp, dims] + [vp] * 11 + [ci, vp]
    lib.oige_substep.restype = ci
    lib.oige_fk.argtypes = [vp, vp, dims] + [vp] * 6 + [ci, vp]
    lib.oige_fk.restype = ci
    lim = (ctypes.c_int * len(LIMITS))()
    lib.oige_limits(lim)
    if tuple(lim) != LIMITS:
        raise RuntimeError(f"kernel maxima {tuple(lim)} disagree with "
                           f"{LIMITS}")
    return _Library(lib, log.read_text() if log.exists() else "", build_s, so)


def library() -> _Library:
    """The kernel library the wrappers launch: `build()` at first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY
