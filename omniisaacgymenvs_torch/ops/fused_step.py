"""Whole-control-step (K1) and report-FK (K2) kernels: wrappers, plain
PyTorch versions, launch counters and the loader of `csrc/fused_step.cu`.

K1 `step` replaces the JAX package's `ops/fused_substep.py` batched_step /
_step_kernel(n_steps): n_steps physics substeps and the report FK in one
launch. K2 `fk` replaces batched_fk / fk_kernel: (q, qd) -> world pose and
velocity of every body. The CUDA source is built with nvcc at first use
into `build/torch_kernels/` (keyed by a hash of the source and flags) and
bound with ctypes.

A wrapper given CPU tensors runs the plain version (`step_plain`,
`fk_plain`); given CUDA tensors it launches the kernel or raises. The
kernel covers one FREE root, revolute joints and the flat ground plane;
`scope_errors` lists what a model has beyond that, and the engine's
`check_scope` refuses such a model on CUDA.
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

from omniisaacgymenvs_torch.physics import dynamics, rotations as rot
from omniisaacgymenvs_torch.physics.model import JointType, Model

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# packed table layout, mirrored in csrc/fused_step.cu
_F_BODY, _BODY_STRIDE, _CP_STRIDE = 8, 64, 8
(_B_AXIS, _B_ET, _B_JPOS, _B_I6, _B_ARM, _B_DAMP, _B_FRIC, _B_KP, _B_KD,
 _B_EMAX, _B_VMAX, _B_LO, _B_HI, _B_DIMPL) = (
    0, 3, 12, 15, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60)
# compile-time maxima of the kernel (csrc/fused_step.cu OIGE_*_MAX)
NB_MAX, NCP_MAX, NS_MAX = 32, 64, 8


# ---------------------------------------------------------------------------
# scope and model tables
# ---------------------------------------------------------------------------

def scope_errors(model: Model) -> List[str]:
    """What `model` has beyond the kernels' own scope (empty when in
    scope): exactly one root, FREE, at body 0; revolute joints only; sizes
    within the kernel's compile-time maxima. Features the port has no path
    for on any device (pairs, tendons, gravity compensation) are the
    engine's `unported_features`."""
    errs = []
    if model.roots != (0,) or model.jtype[0] != JointType.FREE:
        errs.append("kernel needs exactly one root, FREE, at body 0 "
                    f"(roots {model.roots}, types "
                    f"{[JointType(model.jtype[r]).name for r in model.roots]})")
    if any(model.jtype[i] != JointType.REVOLUTE for i in range(1, model.nb)):
        errs.append("kernel supports revolute joints only")
    if model.nb > NB_MAX:
        errs.append(f"{model.nb} bodies > kernel maximum {NB_MAX}")
    if model.ncp > NCP_MAX:
        errs.append(f"{model.ncp} contact points > kernel maximum {NCP_MAX}")
    if model.num_sensors > NS_MAX:
        errs.append(f"{model.num_sensors} sensors > kernel maximum {NS_MAX}")
    return errs


def _np64(x) -> np.ndarray:
    return x.detach().cpu().double().numpy()


def pack_tables(model: Model, h: float, gravity, contact, gains: np.ndarray):
    """(float32 table, int32 table) of the model constants the kernels read.
    `gains`: (3, ncp) per-point ground (kn, kt, fn_max)."""
    nb, ncp = model.nb, model.ncp
    f = np.zeros(_F_BODY + _BODY_STRIDE * nb + _CP_STRIDE * ncp)
    f[0:3] = np.asarray(gravity, np.float64)
    f[3] = h
    f[4] = contact.kd
    axis, Et, jpos = (_np64(model.joint_axis), _np64(model.joint_Et),
                      _np64(model.joint_pos))
    mass, com, I3 = (_np64(model.body_mass), _np64(model.body_com),
                     _np64(model.body_inertia))
    dof = {k: _np64(getattr(model, "dof_" + k)) for k in (
        "armature", "damping", "friction", "stiffness", "drive_damping",
        "max_effort", "max_velocity", "limit_lower", "limit_upper")}
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
        d = model.jdof[i]
        if d < 0:
            continue
        kp, kd = dof["stiffness"][d], dof["drive_damping"][d]
        f[B + _B_ARM] = dof["armature"][d]
        f[B + _B_DAMP] = dof["damping"][d]
        f[B + _B_FRIC] = dof["friction"][d]
        f[B + _B_KP] = kp
        f[B + _B_KD] = kd
        f[B + _B_EMAX] = dof["max_effort"][d]
        f[B + _B_VMAX] = dof["max_velocity"][d]
        f[B + _B_LO] = dof["limit_lower"][d]
        f[B + _B_HI] = dof["limit_upper"][d]
        f[B + _B_DIMPL] = h * (kd + dof["damping"][d] + h * kp)
    cp_pos, cp_rad, cp_mu = (_np64(model.cp_pos), _np64(model.cp_radius),
                             _np64(model.cp_friction))
    for k in range(ncp):
        C = _F_BODY + _BODY_STRIDE * nb + _CP_STRIDE * k
        f[C: C + 3] = cp_pos[k]
        f[C + 3] = cp_rad[k]
        f[C + 4] = contact.mu * cp_mu[k]
        f[C + 5: C + 8] = gains[:, k]
    it = np.concatenate([np.asarray(model.parents), model.cp_body,
                         np.asarray(model.sensor_body, np.int64)])
    return f.astype(np.float32), it.astype(np.int32)


class FusedKernels:
    """The packed model tables of one engine on its CUDA device, and the
    launch count of each kernel wrapper."""

    def __init__(self, model: Model, h: float, gravity, contact,
                 gains: np.ndarray):
        ftab, itab = pack_tables(model, h, gravity, contact, gains)
        self.ftab = torch.as_tensor(ftab, device=model.device)
        self.itab = torch.as_tensor(itab, device=model.device)
        self.launches = {"step": 0, "fk": 0}

    def reset_counts(self):
        for k in self.launches:
            self.launches[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def step_plain(engine, q, qd, effort, pos_target, vel_target, f_applied,
               n_steps: int):
    """n_steps plain substeps (`engine._substep`), then the report FK.
    Returns (q, qd, sensor_forces, body_pos, body_quat, body_avel,
    body_lvel); sensor forces are those of the last substep."""
    from omniisaacgymenvs_torch.physics.state import Control

    m = engine.model
    N = q.shape[0]
    ctrl = Control(effort=effort, pos_target=pos_target,
                   vel_target=vel_target, body_force=None, body_torque=None)
    sf = q.new_zeros((N, m.num_sensors, 6))
    for _ in range(n_steps):
        q, qd, sf = engine._substep(q, qd, ctrl, f_applied, engine.h)
    pos, quat, avel, lvel = fk_plain(m, q, qd)
    return q, qd, sf, pos, quat, avel, lvel


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


def _kernels(engine) -> FusedKernels:
    if engine.kernels is None:
        raise RuntimeError("engine was built for the CPU; its kernels have "
                           "no tables on a CUDA device")
    return engine.kernels


def step(engine, q, qd, effort, pos_target, vel_target, f_applied,
         n_steps: int):
    """K1: n_steps substeps + report FK in one launch. Same returns as
    `step_plain`, which it runs for CPU tensors."""
    if not q.is_cuda:
        return step_plain(engine, q, qd, effort, pos_target, vel_target,
                          f_applied, n_steps)
    k = _kernels(engine)
    m = engine.model
    N = q.shape[0]
    if N < 1 or n_steps < 1:
        raise ValueError(f"need N >= 1 and n_steps >= 1, got {N}, {n_steps}")
    dev = k.ftab.device
    _check(q, (N, m.nq), "q", dev)
    _check(qd, (N, m.nv), "qd", dev)
    for name, x in (("effort", effort), ("pos_target", pos_target),
                    ("vel_target", vel_target)):
        _check(x, (N, m.njd), name, dev)
    _check(f_applied, (N, m.nb, 6), "f_applied", dev)
    ns = m.num_sensors
    e = torch.empty
    outs = (e((N, m.nq), device=dev), e((N, m.nv), device=dev),
            e((N, ns, 6), device=dev), e((N, m.nb, 3), device=dev),
            e((N, m.nb, 4), device=dev), e((N, m.nb, 3), device=dev),
            e((N, m.nb, 3), device=dev))
    ptrs = [x.data_ptr() for x in (k.ftab, k.itab)]
    args = [x.data_ptr() for x in (q, qd, effort, pos_target, vel_target,
                                   f_applied)] + [x.data_ptr() for x in outs]
    err = library().lib.oige_step(
        *ptrs, m.nb, m.ncp, ns, *args, N, int(n_steps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"oige_step launch failed: cudaError {err}")
    k.launches["step"] += 1
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
        k.ftab.data_ptr(), k.itab.data_ptr(), m.nb, m.ncp, m.num_sensors,
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


def op_count(model: Model, n_steps: int) -> dict:
    """FP32 operations per env that K1 (`step`, n_steps substeps + FK) and
    K2 (`fk`) need, counted over the steps of csrc/fused_step.cu. An add, multiply,
    compare, min/max, division, sqrt, sin, cos or tanh is 1 (a fused
    multiply-add is a multiply and an add); a product that is zero by the
    structure of its operands is not counted, nor is a value that equals
    another by symmetry (the kernel's inward pass multiplies X's zero block
    and the whole of X^T Ia X all the same). The kernel is branch-free, so
    the count does not depend on the data."""
    nb, ncp = model.nb, model.ncp
    nj = nb - 1
    nv = 5 + nb
    mv3 = 3 * _dot(3)                       # 3x3 matrix-vector, 15
    mm3 = 9 * _dot(3)                       # 3x3 matrix product, 45
    cross = 9
    # forward kinematics, per joint body: sincos 2, Rodrigues 34 (1 - cos,
    # 3 diagonal entries of 3, 6 off-diagonal of 4), E = R^T Et, r x w_p and
    # subtract 12, two mat-vecs, vJ 6, two crosses, Rw = Rw_p E^T, pw mat-vec
    # and add 3; per body world velocities, two mat-vecs; root quaternion
    # -> matrix 30 (9 products, 3 per diagonal and 2 per other entry)
    fk = (nj * (2 + 34 + mm3 + 12 + 2 * mv3 + 6 + 2 * cross + mm3 + mv3 + 3)
          + nb * 2 * mv3 + 30)
    # contact point: mat-vec, cross, velocity 3, penetration 2, normal force
    # 8, tangential norm 5, friction 7, torque cross, accumulate 6
    contact = mv3 + cross + 3 + 2 + 8 + 5 + 7 + cross + 6
    # drive per joint: PD 7, clamp 2, passive 5, sum 2
    drive = 16
    # bias force per body: I v over the structural non-zeros (3 rows of 5
    # terms, 3 of 3), three crosses, wrench adds 6, two mat-vecs, combine 9
    bias = 3 * _dot(5) + 3 * _dot(3) + 3 * cross + 6 + 2 * mv3 + 9
    # inward per joint: U = IA S 6 rows of 3 terms; D 7; u 6; 1/D 1; U/D 6;
    # Ia upper triangle 21 x 2; pa = pA + Ia c + U u/D: 6 rows of 6 terms,
    # 1 and 3 per row; M = r x rows(E); T = Ia X: 18 entries of 6 terms and
    # 18 of 3; X^T T upper triangle: 15 entries of 6 terms, 6 of 3, and 21
    # accumulating adds; X^T pa 3 of 6 terms and 3 of 3, accumulate 6
    inward = (6 * _dot(3) + 7 + 6 + 1 + 6 + 21 * 2 + 6 * _dot(6) + 1 + 6 * 3
              + 3 * cross + 18 * _dot(6) + 18 * _dot(3)
              + 15 * _dot(6) + 6 * _dot(3) + 21
              + 3 * _dot(6) + 3 * _dot(3) + 6)
    # root: gravity in the body frame (mat-vec), rhs 6 rows of 3 terms and
    # 1 add, Cholesky factor 97 and two triangular solves of 36, acc 3
    root = mv3 + 6 * (_dot(3) + 1) + 97 + 2 * 36 + 3
    # outward per joint: cross, subtract 3, two mat-vecs, bias 6, U.a 6
    # terms, qdd 2, acc 6
    outward = cross + 3 + 2 * mv3 + 6 + _dot(6) + 2 + 6
    # integration: qd + h qdd 2 per dof, root caps 12, 10 per joint; root
    # position mat-vec and 6; quaternion exponential 4 + 7 + 6, product 28,
    # normalization 9 + 4
    integ = 2 * nv + 12 + 10 * nj + mv3 + 6 + 4 + 7 + 6 + 28 + 13
    sub = (fk + contact * ncp + drive * nj + bias * nb + inward * nj + root
           + outward * nj + integ)
    report = fk + 43 * nb  # Shepperd quaternion 43 per body
    return {"step": n_steps * sub + report, "fk": report}


def io_bytes(model: Model) -> dict:
    """Bytes per env that K1 and K2 must move: each input read once, each
    output written once (float32)."""
    nq, nv, njd, nb, ns = (model.nq, model.nv, model.njd, model.nb,
                           model.num_sensors)
    report = 13 * nb
    return {"step": 4 * (nq + nv + 3 * njd + 6 * nb + nq + nv + 6 * ns + report),
            "fk": 4 * (nq + nv + report)}


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
    lib.oige_step.argtypes = [vp, vp, ci, ci, ci] + [vp] * 13 + [ci, ci, vp]
    lib.oige_step.restype = ci
    lib.oige_fk.argtypes = [vp, vp, ci, ci, ci] + [vp] * 6 + [ci, vp]
    lib.oige_fk.restype = ci
    lim = (ctypes.c_int * 3)()
    lib.oige_limits(lim)
    if tuple(lim) != (NB_MAX, NCP_MAX, NS_MAX):
        raise RuntimeError(f"kernel maxima {tuple(lim)} disagree with "
                           f"{(NB_MAX, NCP_MAX, NS_MAX)}")
    return _Library(lib, log.read_text() if log.exists() else "", build_s, so)


def library() -> _Library:
    """The kernel library the wrappers launch: `build()` at first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY
