"""Whole-control-step (K1), report-FK (K2) and single-substep (K3) kernels:
wrappers, plain PyTorch versions, launch counters and the loader of
`csrc/fused_step.cu`.

K1 `step` replaces the JAX package's `ops/fused_substep.py` batched_step /
_step_kernel(n_steps): n_steps physics substeps and the report FK in one
launch. K2 `fk` replaces batched_fk / fk_kernel: (q, qd) -> world pose and
velocity of every body. K3 `substep` replaces batched / kernel: one substep
without the report (a launch mode of K1's device code). The CUDA source is
built with nvcc at first use into `build/torch_kernels/` (keyed by a hash
of the source and flags) and bound with ctypes. K1 and K3 come in two
forms: a group of 32 lanes per env (`csrc/fused_step.cu`, which also holds
K2), and one thread per env (`csrc/fused_step_thread.cu`), faster once a
batch fills the card. The group form takes a model of any size: its
working set lives in shared memory beside the staged model tables, or, for
a model whose one env and tables do not fit a block's shared memory, in a
scratch buffer in device memory (the device-memory placement). The thread
form sizes its stack arrays by compile-time maxima (`thread_scope_errors`).
`launch_config` picks the form and the placement and sizes the launch
(envs per block, blocks, shared bytes), and the wrappers hand it to the C
entry.

A wrapper given CPU tensors runs the plain version (`step_plain`,
`fk_plain`, `substep_plain`); given CUDA tensors it launches the kernel or
raises. The kernels cover forests of FREE and FIXED roots, revolute and
prismatic joints, the flat ground plane or one terrain contact plane per
contact point and env (`planes`, frozen over the substeps of a launch), pair
contacts against sphere, capsule and box surfaces, gravity compensation,
fixed tendons and per-env domain-randomization overlays (`overlay`, a dict
of (N, size) tensors under `OVERLAY_KEYS`, packed here into the one
(N, n_dr) input the kernel reads);
`scope_errors` lists what a model has beyond the group form's scope (the
int32 range of its schedule; nothing a model of the tasks comes near), and
the engine's `check_scope` refuses such a model on CUDA.
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
# the one-thread-per-env form of K1 / K3, a library of its own
THREAD_SOURCE = SOURCE.with_name("fused_step_thread.cu")
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
# compile-time maxima of the one-thread-per-env form, the sizes of its
# stack arrays (csrc/fused_step_thread.cu OIGE_*_MAX, oige_limits): bodies,
# ground contact points, sensors, pairs, surfaces, tendons, FREE roots. The
# group form has none
NB_MAX, NCP_MAX, NS_MAX = 32, 128, 8
NPAIR_MAX, NSURF_MAX, NT_MAX, NFREE_MAX = 1024, 32, 8, 4
THREAD_LIMITS = (NB_MAX, NCP_MAX, NS_MAX, NPAIR_MAX, NSURF_MAX, NT_MAX, NFREE_MAX)

# the schedule table's header (csrc/fused_step.cu H_* and L_*): the model's
# sizes, the sections of the float and the model int table, where the
# schedule's own sections start, and the offsets of one env's working set
SCHEDULE_HEADER = (
    "nb", "ncp", "ns", "npair", "nsurf", "nt", "nq", "nv", "njd",
    "p_cp", "p_gc", "p_pair", "p_surf", "p_tend", "p_end",
    "f_cp", "f_gc", "f_pair", "f_surf", "f_tend", "f_end",
    "i_cp", "i_sens", "i_pair", "i_surf", "i_tend",
    "i_model", "nlev", "lev", "lbody", "slot", "ch", "chl", "cc", "ccl",
    "L_q", "L_qd", "L_Rw", "L_pw", "L_E", "L_rj", "L_w", "L_l", "L_cw", "L_cl",
    "L_wv", "L_lv", "L_quat", "L_qdd", "L_eff", "L_ptg", "L_vtg", "L_fapp",
    "L_fx", "L_tx", "L_tau", "L_dt", "L_IA", "L_pA", "L_U", "L_D", "L_uu", "L_idv",
    "L_acc", "L_tmp", "L_planes",
)
_TM_STRIDE = 51  # inward-pass scratch per body of a level (Q, pa, T)
_SLOT_UNDER_FIXED = 0x40000000  # a slot's flag: the parent is a FIXED root

# the card's limits the launch configuration keeps to (H100 SXM): shared
# memory a block can use and an SM holds (each block reserves 1 KB more);
# threads, blocks and registers an SM holds; threads a block of these
# kernels may have (csrc/fused_step.cu OIGE_MAX_THREADS) and the registers
# each may then take; the SMs
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
THREADS_SM = 2048
BLOCKS_SM = 32
REGS_SM = 65536
MAX_THREADS = 512
REGS = 128  # registers a thread may take under __launch_bounds__(512, 1)
N_SM_H100 = 132
# lanes per env of the group form (csrc/fused_step.cu OIGE_G): one warp;
# 16 and 8 measured slower on every main path of the H100
GROUP = 32
# K1 / K3 take the one-thread-per-env form once a batch gives every SM at
# least this many envs (blocks of THREAD_BLOCK threads), the group form
# below: on the H100 the group form was faster at 62 envs per SM and fewer,
# the thread form at 124 and more, on each of the four main-path models
# (PERF.md)
THREAD_ENVS_PER_SM = 96
THREAD_BLOCK = 128  # csrc/fused_step_thread.cu OIGE_THREADS
DESIGNS = ("group", "thread")

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
    """What `model` has beyond the group form's scope (empty when in
    scope). The group form of K1 / K3 and K2 reads every size from the
    schedule's header at run time and places a working set too large for
    shared memory in device memory, so its one limit is the header's int32:
    every offset of the tables and of one env's working set (the largest
    variant: terrain planes and an overlay) must lie below 2^31."""
    top = max(table_offsets(model)["i_end"], staged_offsets(model)["f_end"],
              env_layout(model, planes=True, overlay=True)["end"])
    if top >= 2 ** 31:
        return [f"the schedule's offsets reach {top} >= 2^31 (int32)"]
    return []


def thread_scope_errors(model: Model) -> List[str]:
    """What `model` has beyond the one-thread-per-env form (empty when that
    form takes it): its sizes must lie within the form's compile-time
    maxima, THREAD_LIMITS."""
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
            errs.append(f"{n} {what} > thread form maximum {cap}")
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


def tree_levels(model: Model) -> List[List[int]]:
    """The bodies by depth in the forest (roots at 0), each level by
    index."""
    depth = []
    for i in range(model.nb):
        p = int(model.parents[i])
        depth.append(0 if p < 0 else depth[p] + 1)
    return [[i for i in range(model.nb) if depth[i] == d]
            for d in range(max(depth) + 1)]


def env_layout(model: Model, planes: bool = False, overlay: bool = False,
               fk: bool = False) -> dict:
    """Offsets (floats) of one env's working set in shared memory
    (csrc/fused_step.cu L_*), and its length under "end": the state, the
    frames and the report's quaternions (all K2 needs, `fk`), then the
    substep's inputs, contact wrenches, torques, the articulated-body
    arrays (which the contact staging, a 6-float wrench per ground point
    and 9 floats per pair, overlays), the inward pass's per-level scratch,
    the terrain planes and the packed overlay."""
    nb, nq, nv, njd, ncp = model.nb, model.nq, model.nv, model.njd, model.ncp
    maxw = max([len(lv) for lv in tree_levels(model)[1:]] or [0])
    parts = [("q", nq), ("qd", nv), ("Rw", 9 * nb), ("pw", 3 * nb),
             ("E", 9 * nb), ("rj", 3 * nb), ("w", 3 * nb), ("l", 3 * nb),
             ("cw", 3 * nb), ("cl", 3 * nb), ("wv", 3 * nb), ("lv", 3 * nb),
             ("quat", 4 * nb)]
    if not fk:
        dyn = 57 * nb
        stage = 6 * ncp + 9 * len(model.pair_surf)
        parts += [("qdd", nv), ("eff", njd), ("ptg", njd), ("vtg", njd),
                  ("fapp", 6 * nb), ("fx", 3 * nb), ("tx", 3 * nb),
                  ("tau", nb), ("dt", nb), ("IA", 36 * nb), ("pA", 6 * nb),
                  ("U", 6 * nb), ("D", nb), ("uu", nb), ("idv", nb),
                  ("acc", 6 * nb + max(0, stage - dyn)),
                  ("tmp", _TM_STRIDE * maxw),
                  ("planes", 4 * ncp if planes else 0),
                  ("dr", sum(overlay_sizes(model).values()) if overlay else 0)]
    out, at = {}, 0
    for name, size in parts:
        out[name] = at
        at += size
    out["end"] = at
    return out


def env_floats(model: Model, planes: bool = False, overlay: bool = False,
               fk: bool = False) -> int:
    """Floats of one env's working set, rounded up to 16 bytes."""
    return -(-env_layout(model, planes, overlay, fk)["end"] // 4) * 4


def pack_schedule(model: Model) -> np.ndarray:
    """int32 schedule table: the header (SCHEDULE_HEADER, which the kernels
    take by value), then its sections, which they stage, at the offsets
    the header gives from the header's end: the level
    starts and the bodies by level, each body's slot within its level (plus
    0x10000 where its parent is a FIXED root), the
    children of each body (starts, then children by descending index), and
    each body's contact contributions (starts, then codes: ground point c
    as c; pair k as ncp + 2k on the point's body, ncp + 2k + 1 on the
    surface's body), in the order the kernels sum them."""
    nb, ncp = model.nb, model.ncp
    levels = tree_levels(model)
    lev = np.cumsum([0] + [len(lv) for lv in levels])
    lbody = [i for lv in levels for i in lv]
    slot = np.zeros(nb, np.int64)
    for lv in levels:
        for k, i in enumerate(lv):
            p = int(model.parents[i])
            under_fixed = (p >= 0 and model.parents[p] < 0
                           and model.jtype[p] == JointType.FIXED)
            slot[i] = k + (_SLOT_UNDER_FIXED if under_fixed else 0)
    children = [[j for j in range(nb - 1, -1, -1) if model.parents[j] == i]
                for i in range(nb)]
    contrib = [[] for _ in range(nb)]
    for c in range(ncp):
        contrib[int(model.cp_body[c])].append(c)
    for k, (pt, si) in enumerate(zip(model.pair_point, model.pair_surf)):
        contrib[int(model.cp_body[pt])].append(ncp + 2 * k)
        contrib[int(model.surf_body[si])].append(ncp + 2 * k + 1)

    def csr(lists):
        return (np.cumsum([0] + [len(x) for x in lists]),
                np.asarray([v for x in lists for v in x], np.int64))

    ch, chl = csr(children)
    cc, ccl = csr(contrib)
    sections = [("lev", lev), ("lbody", lbody), ("slot", slot), ("ch", ch),
                ("chl", chl), ("cc", cc), ("ccl", ccl)]
    hdr = dict(zip(("nb", "ncp", "ns", "npair", "nsurf", "nt", "nq", "nv",
                    "njd"), table_dims(model)))
    off = table_offsets(model)
    hdr.update({k: v for k, v in off.items() if k.startswith("i_")})
    hdr.update({"p" + k[1:]: v for k, v in off.items() if k.startswith("f_")})
    hdr.update(staged_offsets(model))
    at = 0  # the sections' offsets count from the end of the header
    for name, arr in sections:
        hdr[name] = at
        at += len(arr)
    hdr["i_model"] = at
    hdr["nlev"] = len(levels)
    hdr.update({"L_" + k: v for k, v in
                env_layout(model, planes=True, overlay=True).items()})
    head = [hdr[k] for k in SCHEDULE_HEADER]
    return np.concatenate([np.asarray(head, np.int64)]
                          + [np.asarray(a, np.int64) for _, a in sections]
                          ).astype(np.int32)


def staged_offsets(model: Model) -> dict:
    """Sections of the float table as a block stages it in shared memory
    (csrc/fused_step.cu staged_index): every record one float longer than
    in the packed table."""
    nb, ncp, _, npair, nsurf, nt, _, _, _ = table_dims(model)
    f_cp = _F_BODY + (_BODY_STRIDE + 1) * nb
    f_gc = f_cp + (_CP_STRIDE + 1) * ncp
    f_pair = f_gc + (_GC_STRIDE + 1) * nb
    f_surf = f_pair + (_PAIR_STRIDE + 1) * npair
    f_tend = f_surf + (_SURF_STRIDE + 1) * nsurf
    return dict(f_cp=f_cp, f_gc=f_gc, f_pair=f_pair, f_surf=f_surf,
                f_tend=f_tend, f_end=f_tend + (_TEND_STRIDE + 1) * nt)


def staged_table(model: Model, ftab: np.ndarray) -> np.ndarray:
    """The packed float table `ftab` in the layout a block stages it in
    (csrc/fused_step.cu staged_index: every record one float longer, the
    extra float 0): the device copy the device-memory placement reads when
    the tables do not fit a block's shared memory."""
    off, st = table_offsets(model), staged_offsets(model)
    out = np.zeros(st["f_end"], np.float32)
    out[:_F_BODY] = ftab[:_F_BODY]
    sections = (("f_cp", _BODY_STRIDE, _F_BODY, _F_BODY),
                ("f_gc", _CP_STRIDE, off["f_cp"], st["f_cp"]),
                ("f_pair", _GC_STRIDE, off["f_gc"], st["f_gc"]),
                ("f_surf", _PAIR_STRIDE, off["f_pair"], st["f_pair"]),
                ("f_tend", _SURF_STRIDE, off["f_surf"], st["f_surf"]),
                ("f_end", _TEND_STRIDE, off["f_tend"], st["f_tend"]))
    for end, stride, p0, s0 in sections:
        n = (off[end] - p0) // stride
        out[s0:s0 + n * (stride + 1)].reshape(n, stride + 1)[:, :stride] = (
            ftab[p0:off[end]].reshape(n, stride))
    return out


def table_floats(model: Model) -> int:
    """Words of the tables a block stages: the float table at its shared
    strides and the int table [schedule sections | model int table],
    rounded up to 16 bytes."""
    n = (staged_offsets(model)["f_end"] + len(pack_schedule(model))
         - len(SCHEDULE_HEADER) + table_offsets(model)["i_end"])
    return -(-n // 4) * 4


def launch_config(model: Model, n_env: int, planes: bool = False,
                  overlay: bool = False, fk: bool = False, design=None,
                  n_sm=None) -> dict:
    """How K1 / K3 (or K2, `fk`) launch for n_env envs. `design`: "group"
    (a group of GROUP lanes per env, csrc/fused_step.cu) or "thread" (one
    thread per env, csrc/fused_step_thread.cu; not for K2, and not for a
    model past its maxima, `thread_scope_errors`: ValueError); unless
    given, K1 / K3 take "thread" once n_env gives every SM
    THREAD_ENVS_PER_SM envs and the thread form takes the model, and
    "group" otherwise. The group form's `envs_per_block` groups per block,
    `blocks` (a persistent grid: at most what the SMs hold at once, each
    group walking over envs with the stride of all groups), shared bytes
    per block (`smem_bytes`: the staged tables, `table_bytes`, and in the
    shared placement one working set per env, `env_bytes`) and `resident`
    envs per SM; the envs per block maximise the envs an SM holds, and a
    batch spreads evenly over every SM. `working_set`: "shared" where one
    env's working set and the tables fit a block's shared memory, else
    "global" (the device-memory placement: one working set per group in a
    scratch buffer of `scratch_floats` floats, the tables staged in shared
    memory where they fit, `tables` "shared", else read from device memory,
    "global"). The thread form's blocks of THREAD_BLOCK envs, no shared
    memory, its working set in the thread's stack frame ("local").
    `n_sm`: the card's SMs (an H100's 132 unless given)."""
    n_sm = N_SM_H100 if n_sm is None else int(n_sm)
    if design is None:
        wide = not fk and n_env >= THREAD_ENVS_PER_SM * n_sm
        design = ("thread" if wide and not thread_scope_errors(model)
                  else "group")
    if design not in DESIGNS or (fk and design != "group"):
        raise ValueError(f"design {design!r}: K1 / K3 take one of {DESIGNS}, "
                         f"K2 the group form")
    off = table_offsets(model)
    common = dict(design=design, n_sm=n_sm, n_env=n_env, nf=off["f_end"],
                  ni=len(pack_schedule(model)) - len(SCHEDULE_HEADER)
                  + off["i_end"])
    if design == "thread":
        errs = thread_scope_errors(model)
        if errs:
            raise ValueError(f"{model.name}: the thread form does not take "
                             f"the model: {'; '.join(errs)}")
        return dict(common, group=1, envs_per_block=THREAD_BLOCK,
                    blocks=-(-n_env // THREAD_BLOCK), threads=THREAD_BLOCK,
                    smem_bytes=0, table_bytes=0, env_bytes=0, env_floats=0,
                    resident=None, working_set="local")
    env = env_floats(model, planes, overlay, fk)
    tab = table_floats(model)
    shared = 4 * (tab + env) <= SMEM_BLOCK_MAX
    # the device-memory placement stages the tables alone, where they fit
    tab_smem = 4 * tab if 4 * tab <= SMEM_BLOCK_MAX else 0

    def smem(epb):
        return 4 * (tab + epb * env) if shared else tab_smem

    def per_sm(epb):
        return min(SMEM_SM // (smem(epb) + SMEM_RESERVED),
                   THREADS_SM // (epb * GROUP), REGS_SM // (REGS * epb * GROUP),
                   BLOCKS_SM)

    best = None
    for epb in range(1, MAX_THREADS // GROUP + 1):
        if smem(epb) > SMEM_BLOCK_MAX:
            break
        if best is None or per_sm(epb) * epb >= per_sm(best) * best:
            best = epb
    # blocks per SM that the batch needs, spread evenly over the SMs
    k = -(-n_env // (n_sm * best))
    epb = min(best, max(1, -(-n_env // (n_sm * k))))
    blocks = min(-(-n_env // epb), n_sm * per_sm(epb))
    lc = dict(common, group=GROUP, envs_per_block=epb, blocks=blocks,
              threads=GROUP * epb, smem_bytes=smem(epb),
              table_bytes=4 * tab if shared else tab_smem, env_bytes=4 * env,
              env_floats=env, resident=per_sm(epb) * epb)
    if shared:
        return dict(lc, working_set="shared")
    return dict(lc, working_set="global", tables="shared" if tab_smem else "global",
                scratch_floats=blocks * epb * env)


def describe_config(lc: dict) -> str:
    """One line of a launch configuration, for logs."""
    if lc["design"] == "thread":
        return (f"one thread per env, {lc['blocks']} blocks of "
                f"{lc['threads']} threads")
    head = (f"G={lc['group']}, {lc['envs_per_block']} envs per block, "
            f"{lc['blocks']} blocks of {lc['threads']} threads, "
            f"{lc['smem_bytes']} B shared per block")
    if lc["working_set"] == "shared":
        return (f"{head} ({lc['table_bytes']} B tables, {lc['env_bytes']} B per "
                f"env), {lc['resident']} envs per SM, working sets in shared memory")
    where = "shared" if lc["tables"] == "shared" else "device"
    return (f"{head} (the tables, in {where} memory), {lc['env_bytes']} B "
            f"per env, {lc['resident']} envs per SM, working sets in device "
            f"memory ({4 * lc['scratch_floats']} B of scratch)")


class FusedKernels:
    """The packed model tables of one engine on its CUDA device, and the
    launch count of each kernel wrapper."""

    def __init__(self, model: Model, h: float, gravity, contact,
                 gains: np.ndarray, pair_gains: np.ndarray | None = None):
        ftab, itab = pack_tables(model, h, gravity, contact, gains, pair_gains)
        self.model = model
        self.ftab = torch.as_tensor(ftab, device=model.device)
        # the group form takes the schedule's header by value and stages
        # [schedule sections | model int table]; the thread form reads the
        # model int table alone, from `thread_itab`
        sched = pack_schedule(model)
        nh = len(SCHEDULE_HEADER)
        self.header = [int(x) for x in sched[:nh]]
        self.itab = torch.as_tensor(np.concatenate([sched[nh:], itab]),
                                    device=model.device)
        self.thread_itab = self.itab[len(sched) - nh:]
        self.dims = (ctypes.c_int * 9)(*table_dims(model))
        self.n_sm = (torch.cuda.get_device_properties(model.device)
                     .multi_processor_count
                     if model.device.type == "cuda" else N_SM_H100)
        self._configs = {}
        # the float table in its staged layout, on the device: what the
        # device-memory placement reads where the tables do not fit a
        # block's shared memory (packed at the first such configuration)
        self._ftab_staged = None
        self.launches = {"step": 0, "fk": 0, "substep": 0}
        # how many of those launches read an overlay, and how many took the
        # one-thread-per-env form
        self.overlay_launches = {"step": 0, "substep": 0}
        self.thread_launches = {"step": 0, "substep": 0}

    def config(self, n_env: int, planes=False, overlay=False, fk=False,
               design=None):
        """(launch_config dict, the group form's C int array, the scratch
        buffer of the device-memory placement or None), cached: a
        configuration's scratch is allocated once, not per launch."""
        key = (n_env, planes, overlay, fk, design)
        if key not in self._configs:
            lc = launch_config(self.model, n_env, planes, overlay, fk, design,
                               self.n_sm)
            # the launch's ints, then the schedule's header, which the
            # kernels take by value
            arr = (ctypes.c_int * (6 + len(SCHEDULE_HEADER)))(
                lc["envs_per_block"], lc["blocks"], lc["smem_bytes"],
                lc["env_floats"], lc["nf"], lc["ni"], *self.header)
            gws = None
            if lc["working_set"] == "global":
                gws = torch.empty(lc["scratch_floats"], device=self.ftab.device)
                if lc["tables"] == "global" and self._ftab_staged is None:
                    self._ftab_staged = torch.as_tensor(
                        staged_table(self.model, self.ftab.cpu().numpy()),
                        device=self.ftab.device)
            self._configs[key] = (lc, arr, gws)
        return self._configs[key]

    def group_ftab(self, lc: dict) -> torch.Tensor:
        """The float table a group-form launch of `lc` reads: the packed
        table, which the kernel stages, or its staged copy where the
        tables stay in device memory."""
        return self._ftab_staged if lc.get("tables") == "global" else self.ftab

    def reset_counts(self):
        for counts in (self.launches, self.overlay_launches,
                       self.thread_launches):
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


def _launch_step(k, key, ins, planes, dr, outs, n_steps, design):
    """Launch K1 (`key` "step": n_steps substeps and the report into the
    seven `outs`) or K3 ("substep": one substep, three `outs`) in the form
    `launch_config` picks, and count it."""
    N, dev = ins[0].shape[0], ins[0].device
    lc, cfg, gws = k.config(N, planes is not None, dr is not None, design=design)
    lib = library()
    lib.claim(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    thread = lc["design"] == "thread"
    ins_ptrs = [x.data_ptr() for x in ins] + [_ptr(planes), _ptr(dr)]
    outs_ptrs = [x.data_ptr() for x in outs] + [N]
    outs_ptrs += [int(n_steps), stream] if key == "step" else [stream]
    name = f"oige_{key}" + ("_thread" if thread else "")
    if thread:
        err = getattr(lib.thread, name)(k.ftab.data_ptr(), k.thread_itab.data_ptr(),
                                        k.dims, *ins_ptrs, *outs_ptrs)
    else:
        err = getattr(lib.lib, name)(k.group_ftab(lc).data_ptr(), k.itab.data_ptr(),
                                     k.dims, *ins_ptrs, _ptr(gws), *outs_ptrs, cfg)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    k.launches[key] += 1
    if dr is not None:
        k.overlay_launches[key] += 1
    if thread:
        k.thread_launches[key] += 1


def step(engine, q, qd, effort, pos_target, vel_target, f_applied,
         n_steps: int, planes=None, overlay=None, design=None):
    """K1: n_steps substeps + report FK in one launch. Same arguments and
    returns as `step_plain`, which it runs for CPU tensors; `design`: the
    kernel's form ("group" or "thread"), `launch_config`'s pick unless
    given."""
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
    _launch_step(k, "step", ins, planes, dr, outs, n_steps, design)
    return outs


def substep(engine, q, qd, effort, pos_target, vel_target, f_applied,
            planes=None, overlay=None, design=None):
    """K3: one substep in one launch, without the report FK: (q, qd,
    sensor_forces). Runs `substep_plain` for CPU tensors; `design` as in
    `step`."""
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
    _launch_step(k, "substep", ins, planes, dr, outs, 1, design)
    return outs


def fk(engine, q, qd):
    """K2: report FK in one launch (the group form); runs `fk_plain` for
    CPU tensors."""
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
    lc, cfg, gws = k.config(N, fk=True)
    lib = library()
    lib.claim(dev)
    err = lib.lib.oige_fk(
        k.group_ftab(lc).data_ptr(), k.itab.data_ptr(), k.dims,
        q.data_ptr(), qd.data_ptr(), _ptr(gws), *[x.data_ptr() for x in outs],
        N, torch.cuda.current_stream(dev).cuda_stream, cfg,
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
    """The two kernel libraries: `lib` (csrc/fused_step.cu: the group form
    of K1 / K3, and K2) and `thread` (csrc/fused_step_thread.cu: the
    one-thread-per-env form of K1 / K3), with their ptxas reports, the
    seconds their build took (both nvcc at once) and their paths."""

    def __init__(self, lib: ctypes.CDLL, thread: ctypes.CDLL, ptxas_log: str,
                 build_s: float, path: Path, thread_path: Path):
        self.lib = lib
        self.thread = thread
        self.ptxas_log = ptxas_log
        self.build_s = build_s
        self.path = path
        self.thread_path = thread_path
        self.device = None

    def claim(self, dev: torch.device):
        """Refuse a launch on another card than the first launch's, or on
        a card that is not the current device: each kernel raises its
        shared-memory limit once per process, on the current device
        (csrc/fused_step.cu allow_max_smem), so one process drives one card
        (one process per GPU under torchrun)."""
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if idx != torch.cuda.current_device():
            raise RuntimeError(f"launch on cuda:{idx}, but the current device "
                               f"is cuda:{torch.cuda.current_device()}")
        if self.device is None:
            self.device = idx
        elif idx != self.device:
            raise RuntimeError(f"launch on cuda:{idx} in a process whose kernels "
                               f"run on cuda:{self.device}: one process per GPU")


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
    """Build `csrc/fused_step.cu` and `csrc/fused_step_thread.cu` with
    `flags`, one nvcc for each, both at once (once per source and flags
    hash; the libraries stay in BUILD_DIR), and load them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    built, running = [], []
    for src in (SOURCE, THREAD_SOURCE):
        key = hashlib.sha256(src.read_bytes()
                             + " ".join(flags).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"{src.stem}_{key}.so"
        built.append(so)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            running.append((src, so, tmp, subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, so, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
            continue
        so.with_suffix(".log").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    build_s = time.time() - t0
    lib, thread = (ctypes.CDLL(str(so)) for so in built)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    thread.oige_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    thread.oige_limits.restype = ci
    dims = ctypes.POINTER(ctypes.c_int)
    # the group form takes one pointer more (gws) and the configuration
    for handle, tail, more, cfg in ((lib, "", 1, [dims]),
                                    (thread, "_thread", 0, [])):
        step_fn = getattr(handle, "oige_step" + tail)
        step_fn.argtypes = [vp, vp, dims] + [vp] * (15 + more) + [ci, ci, vp] + cfg
        step_fn.restype = ci
        sub_fn = getattr(handle, "oige_substep" + tail)
        sub_fn.argtypes = [vp, vp, dims] + [vp] * (11 + more) + [ci, vp] + cfg
        sub_fn.restype = ci
    lib.oige_fk.argtypes = [vp, vp, dims] + [vp] * 7 + [ci, vp, dims]
    lib.oige_fk.restype = ci
    lim = (ctypes.c_int * len(THREAD_LIMITS))()
    thread.oige_limits(lim)
    if tuple(lim) != THREAD_LIMITS:
        raise RuntimeError(f"thread form maxima {tuple(lim)} disagree with "
                           f"{THREAD_LIMITS}")
    logs = [so.with_suffix(".log") for so in built]
    ptxas = "".join(x.read_text() for x in logs if x.exists())
    return _Library(lib, thread, ptxas, build_s, *built)


def library() -> _Library:
    """The kernel library the wrappers launch: `build()` at first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY
