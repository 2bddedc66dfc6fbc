"""Articulation model specification (PyTorch port of the JAX package's
`physics/model.py`).

A model is a forest of bodies: a body with parent=-1 is a root (FREE
floating base with 7 q / 6 qd, or FIXED); every other body hangs off a
1-dof revolute or prismatic joint. Bodies are added in topological order,
so `parent < child` always holds. Collision geometry compiles to a flat
list of contact points (sphere centres with radii) tested against the
ground, plus receiver surfaces for point-vs-surface pair contacts.

`finalize(device)` freezes the builder into a `Model`: structural data
(tree topology, index tables) stays Python tuples or numpy, numeric
parameters become float32 tensors on `device`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class JointType(enum.IntEnum):
    FREE = 0
    REVOLUTE = 1
    PRISMATIC = 2
    FIXED = 3


class SurfaceType(enum.IntEnum):
    SPHERE = 0
    CAPSULE = 1
    BOX = 2


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """Frozen articulation model. Numeric fields are tensors on one device;
    structural fields are Python data."""

    name: str
    # --- structure (static) ---
    nb: int                      # number of bodies
    nq: int                      # generalized position dim
    nv: int                      # generalized velocity dim
    njd: int                     # number of 1-dof joints
    parents: Tuple[int, ...]     # parent body index per body (roots: -1)
    jtype: Tuple[int, ...]       # JointType per body
    q_adr: Tuple[int, ...]       # start index into q per body
    v_adr: Tuple[int, ...]       # start index into qd per body
    jdof: Tuple[int, ...]        # joint-dof index per body (-1 for roots)
    tree_id: Tuple[int, ...]     # which tree (root) each body belongs to
    roots: Tuple[int, ...]       # body indices of the roots
    # non-root bodies grouped by tree depth (ascending)
    levels: Tuple[Tuple[int, ...], ...]
    body_names: Tuple[str, ...]
    dof_names: Tuple[str, ...]   # 1-dof joint names, joint order
    # --- joint geometry ---
    joint_axis: torch.Tensor     # (nb, 3) axis in child coords (unit)
    joint_pos: torch.Tensor      # (nb, 3) joint frame origin in parent coords
    joint_Et: torch.Tensor       # (nb, 3, 3) fixed rot: parent->joint coords
    # --- body inertial ---
    body_mass: torch.Tensor      # (nb,)
    body_com: torch.Tensor       # (nb, 3)
    body_inertia: torch.Tensor   # (nb, 3, 3) about CoM, body coords
    # --- per joint dof (njd,), joint order; q[jq_idx] <-> qd[jv_idx] ---
    jq_idx: np.ndarray           # (njd,) int32 indices into q
    jv_idx: np.ndarray           # (njd,) int32 indices into qd
    dof_limit_lower: torch.Tensor
    dof_limit_upper: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_friction: torch.Tensor
    dof_stiffness: torch.Tensor
    dof_drive_damping: torch.Tensor
    dof_max_effort: torch.Tensor
    dof_max_velocity: torch.Tensor
    # --- contact points ---
    cp_body: np.ndarray          # (ncp,) int32 body index per contact point
    cp_pos: torch.Tensor         # (ncp, 3) point in body coords
    cp_radius: torch.Tensor      # (ncp,)
    cp_friction: torch.Tensor    # (ncp,)
    # --- receiver surfaces (point-vs-surface pair contacts) ---
    surf_type: Tuple[int, ...]
    surf_body: Tuple[int, ...]
    surf_params: Tuple[tuple, ...]
    pair_point: np.ndarray       # (npair,) int32 index into cp_*
    pair_surf: Tuple[int, ...]   # (npair,) surface index
    # --- fixed tendons ---
    nt: int
    tendon_dof: np.ndarray       # (nt, 2) int32 coupled joint-dof indices
    tendon_coef: torch.Tensor    # (nt, 2)
    tendon_rest: torch.Tensor
    tendon_stiffness: torch.Tensor
    tendon_damping: torch.Tensor
    tendon_limit_lower: torch.Tensor
    tendon_limit_upper: torch.Tensor
    tendon_limit_stiffness: torch.Tensor
    gravity_comp: torch.Tensor   # (nb,) 1.0 = body feels no gravity
    # --- force sensors: aggregate contact wrench per sensor body ---
    sensor_body: Tuple[int, ...]
    default_q: torch.Tensor      # (nq,)

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.default_q.device

    @property
    def ncp(self) -> int:
        return int(self.cp_body.shape[0])

    @property
    def root_free(self) -> bool:
        return self.jtype[self.roots[0]] == JointType.FREE

    @property
    def jd0(self) -> int:
        """First joint-dof index in qd for single-root models."""
        return 6 if self.root_free else 0

    @property
    def jq0(self) -> int:
        return 7 if self.root_free else 0

    @property
    def num_sensors(self) -> int:
        return len(self.sensor_body)

    def dof_index(self, name: str) -> int:
        """Joint-dof index by name."""
        return self.dof_names.index(name)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def _free_root(self, body_name: str) -> int:
        i = self.body_index(body_name)
        if self.jtype[i] != JointType.FREE:
            raise ValueError(f"{body_name!r} is not a FREE root")
        return i

    def root_q_adr(self, body_name: str) -> int:
        """Start of a FREE root's 7 coords [pos, quat] in q."""
        return self.q_adr[self._free_root(body_name)]

    def root_v_adr(self, body_name: str) -> int:
        """Start of a FREE root's 6 velocities [angular, linear] in qd."""
        return self.v_adr[self._free_root(body_name)]


@dataclasses.dataclass
class _BodySpec:
    name: str
    parent: int
    jtype: JointType
    axis: np.ndarray
    joint_pos: np.ndarray
    joint_quat: np.ndarray
    mass: float
    com: np.ndarray
    inertia: np.ndarray
    limit: Tuple[float, float]
    armature: float
    damping: float
    friction: float
    stiffness: float
    drive_damping: float
    max_effort: float
    max_velocity: float
    default_q: float
    default_pose: Optional[np.ndarray]  # roots: 7-vector [pos, quat]
    gravity_comp: bool


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class ModelBuilder:
    """Imperative builder; `finalize(device)` freezes into a Model."""

    def __init__(self, name: str):
        self.name = name
        self._bodies: List[_BodySpec] = []
        self._cp: List[Tuple[int, np.ndarray, float, float]] = []
        # (type, body, params, self_only)
        self._surfaces: List[Tuple[int, int, tuple, bool]] = []
        self._sensors: List[int] = []
        self._self_collide_roots: set = set()
        # (dof_name_a, dof_name_b, coef_a, coef_b, rest, k, c, lo, hi, k_lim)
        self._tendons: List[tuple] = []

    # ------------------------------------------------------------------
    def add_body(
        self,
        name: str,
        parent: int = -1,
        joint_type: JointType = JointType.REVOLUTE,
        joint_axis: Sequence[float] = (0.0, 0.0, 1.0),
        joint_pos: Sequence[float] = (0.0, 0.0, 0.0),
        joint_quat: Sequence[float] = (1.0, 0.0, 0.0, 0.0),
        mass: float = 1.0,
        com: Sequence[float] = (0.0, 0.0, 0.0),
        inertia: Sequence[float] = (0.01, 0.01, 0.01),
        limit: Tuple[float, float] = (-1e9, 1e9),
        armature: float = 0.0,
        damping: float = 0.0,
        friction: float = 0.0,
        stiffness: float = 0.0,
        drive_damping: float = 0.0,
        max_effort: float = 1e9,
        max_velocity: float = 1e9,
        default_q: float = 0.0,
        default_pos: Sequence[float] = (0.0, 0.0, 0.0),
        default_quat: Sequence[float] = (1.0, 0.0, 0.0, 0.0),
        gravity_comp: bool = False,
    ) -> int:
        """Add a body; parent=-1 adds a root (FREE or FIXED), otherwise a
        1-dof joint (REVOLUTE/PRISMATIC) connects it to `parent`. Returns
        the body index. `inertia`: 3-vector diagonal or 3x3 about the CoM."""
        idx = len(self._bodies)
        if parent == -1:
            if joint_type not in (JointType.FREE, JointType.FIXED):
                raise ValueError("a root must be FREE or FIXED")
        else:
            if not 0 <= parent < idx:
                raise ValueError("bodies must be added in topological order")
            if joint_type not in (JointType.REVOLUTE, JointType.PRISMATIC):
                raise ValueError("a non-root joint must be 1-dof")
        inertia = np.asarray(inertia, dtype=np.float64)
        if inertia.ndim == 1:
            inertia = np.diag(inertia)
        axis = np.asarray(joint_axis, dtype=np.float64)
        n = np.linalg.norm(axis)
        axis = axis / n if n > 0 else axis
        default_pose = None
        if parent == -1 and joint_type == JointType.FREE:
            default_pose = np.concatenate(
                [np.asarray(default_pos, np.float64),
                 np.asarray(default_quat, np.float64)]
            )
        self._bodies.append(
            _BodySpec(
                name=name, parent=parent, jtype=joint_type, axis=axis,
                joint_pos=np.asarray(joint_pos, dtype=np.float64),
                joint_quat=np.asarray(joint_quat, dtype=np.float64),
                mass=float(mass), com=np.asarray(com, dtype=np.float64),
                inertia=inertia, limit=limit, armature=armature,
                damping=damping, friction=friction, stiffness=stiffness,
                drive_damping=drive_damping, max_effort=max_effort,
                max_velocity=max_velocity, default_q=default_q,
                default_pose=default_pose, gravity_comp=gravity_comp,
            )
        )
        return idx

    # ------------------------------------------------------------------
    def add_sphere_collider(self, body: int, pos, radius: float,
                            friction: float = 1.0, receive: bool = False,
                            receive_self: bool = False):
        self._cp.append((body, np.asarray(pos, dtype=np.float64), radius, friction))
        if receive or receive_self:
            self._surfaces.append(
                (int(SurfaceType.SPHERE), body,
                 tuple(np.asarray(pos, float)) + (float(radius),),
                 not receive)
            )

    def add_capsule_collider(
        self, body: int, p0, p1, radius: float, friction: float = 1.0,
        n_extra: int = 0, receive: bool = False,
        receive_self: bool = False,
    ):
        """Capsule by endcap centres; contact points at the endcap spheres
        plus `n_extra` evenly spaced intermediate points."""
        p0 = np.asarray(p0, dtype=np.float64)
        p1 = np.asarray(p1, dtype=np.float64)
        for t in np.linspace(0.0, 1.0, 2 + n_extra):
            self._cp.append((body, p0 + t * (p1 - p0), radius, friction))
        if receive or receive_self:
            self._surfaces.append(
                (int(SurfaceType.CAPSULE), body,
                 tuple(p0) + tuple(p1) + (float(radius),),
                 not receive)
            )

    def add_box_collider(self, body: int, pos, half_extents,
                         friction: float = 1.0, quat=(1.0, 0.0, 0.0, 0.0),
                         receive: bool = False, dense: bool = False,
                         receive_self: bool = False):
        """Box by centre and half extents; contact points at the 8 corners
        (dense=True adds the 12 edge midpoints and 6 face centres)."""
        pos = np.asarray(pos, dtype=np.float64)
        h = np.asarray(half_extents, dtype=np.float64)
        R = _quat_to_mat_np(np.asarray(quat, dtype=np.float64))
        signs = [-1, 0, 1] if dense else [-1, 1]
        for sx in signs:
            for sy in signs:
                for sz in signs:
                    if sx == sy == sz == 0:
                        continue
                    corner = pos + R @ (h * np.array([sx, sy, sz]))
                    self._cp.append((body, corner, 0.0, friction))
        if receive or receive_self:
            self._surfaces.append(
                (int(SurfaceType.BOX), body,
                 tuple(pos) + tuple(h) + tuple(np.asarray(quat, float)),
                 not receive)
            )

    def add_contact_point(self, body: int, pos, radius: float = 0.0,
                          friction: float = 1.0):
        """A bare contact point (a finger pad), with no surface."""
        self._cp.append((body, np.asarray(pos, dtype=np.float64), radius, friction))

    def add_force_sensor(self, body: int):
        """Register a contact wrench sensor on `body`."""
        self._sensors.append(body)

    @property
    def dof_names(self) -> List[str]:
        """Names of the 1-dof (revolute / prismatic) joint bodies in
        topological order: the names `set_drive` takes, in the finalized
        Model's dof order."""
        return [b.name for b in self._bodies
                if b.jtype in (JointType.REVOLUTE, JointType.PRISMATIC)]

    def set_drive(
        self,
        dof_name: str,
        stiffness: Optional[float] = None,
        damping: Optional[float] = None,
        max_effort: Optional[float] = None,
        max_velocity: Optional[float] = None,
        armature: Optional[float] = None,
        default_q: Optional[float] = None,
    ):
        """Set a joint's drive after construction, by dof name (an imported
        URDF or MJCF model carries no PD gains). `damping` sets the DRIVE
        damping, not the passive joint damping. Raises KeyError for an
        unknown name."""
        for b in self._bodies:
            if b.parent != -1 and b.name == dof_name:
                if stiffness is not None:
                    b.stiffness = float(stiffness)
                if damping is not None:
                    b.drive_damping = float(damping)
                if max_effort is not None:
                    b.max_effort = float(max_effort)
                if max_velocity is not None:
                    b.max_velocity = float(max_velocity)
                if armature is not None:
                    b.armature = float(armature)
                if default_q is not None:
                    b.default_q = float(default_q)
                return
        raise KeyError(f"no dof named {dof_name!r}")

    def add_fixed_tendon(
        self,
        dof_a: str,
        dof_b: str,
        coef: Tuple[float, float] = (1.0, -1.0),
        rest: float = 0.0,
        stiffness: float = 0.0,
        damping: float = 0.0,
        limit: Tuple[float, float] = (0.0, 0.0),
        limit_stiffness: float = 0.0,
    ):
        """Fixed tendon coupling two joint dofs at the force level."""
        self._tendons.append(
            (dof_a, dof_b, float(coef[0]), float(coef[1]), float(rest),
             float(stiffness), float(damping), float(limit[0]),
             float(limit[1]), float(limit_stiffness))
        )

    def enable_self_collisions(self, root_body: int = 0):
        self._self_collide_roots.add(root_body)

    def set_root_default(self, pos=(0, 0, 0), quat=(1, 0, 0, 0), body: int = 0):
        self._bodies[body].default_pose = np.concatenate(
            [np.asarray(pos, np.float64), np.asarray(quat, np.float64)]
        )

    # ------------------------------------------------------------------
    def finalize(self, device="cpu", dtype=torch.float32) -> Model:
        bodies = self._bodies
        nb = len(bodies)

        q_adr, v_adr, jdof, tree_id, roots = [], [], [], [], []
        dof_names: List[str] = []
        nq = nv = njd = 0
        for i, b in enumerate(bodies):
            q_adr.append(nq)
            v_adr.append(nv)
            if b.parent == -1:
                roots.append(i)
                tree_id.append(len(roots) - 1)
                jdof.append(-1)
                if b.jtype == JointType.FREE:
                    nq += 7
                    nv += 6
            else:
                tree_id.append(tree_id[b.parent])
                jdof.append(njd)
                dof_names.append(b.name)
                nq += 1
                nv += 1
                njd += 1

        def arr(fn, shape_tail=()):
            out = np.zeros((nb,) + shape_tail)
            for i, b in enumerate(bodies):
                out[i] = fn(b)
            return out

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=device)

        jb = [b for b in bodies if b.parent != -1]
        jq_idx = np.array(
            [q_adr[i] for i, b in enumerate(bodies) if b.parent != -1],
            dtype=np.int32,
        )
        jv_idx = np.array(
            [v_adr[i] for i, b in enumerate(bodies) if b.parent != -1],
            dtype=np.int32,
        )

        default_q = np.zeros(nq)
        for i, b in enumerate(bodies):
            if b.parent == -1:
                if b.jtype == JointType.FREE:
                    pose = (
                        b.default_pose
                        if b.default_pose is not None
                        else np.array([0, 0, 0, 1, 0, 0, 0], dtype=np.float64)
                    )
                    default_q[q_adr[i]: q_adr[i] + 7] = pose
            else:
                default_q[q_adr[i]] = b.default_q

        depth = [0] * nb
        for i, b in enumerate(bodies):
            depth[i] = 0 if b.parent == -1 else depth[b.parent] + 1
        max_depth = max(depth) if nb else 0
        levels = tuple(
            tuple(i for i in range(nb) if depth[i] == d and bodies[i].parent != -1)
            for d in range(1, max_depth + 1)
        )
        levels = tuple(lvl for lvl in levels if lvl)

        cp_body = np.array([c[0] for c in self._cp], dtype=np.int32)
        cp_pos = (
            np.stack([c[1] for c in self._cp]) if self._cp else np.zeros((0, 3))
        )
        cp_radius = np.array([c[2] for c in self._cp])
        cp_friction = np.array([c[3] for c in self._cp])

        # candidate pairs: every point vs every receive surface of a
        # different tree; same-tree pairs for self-colliding trees, minus
        # same-body and directly jointed parent-child pairs
        self_trees = {tree_id[r] for r in self._self_collide_roots}
        pair_point: List[int] = []
        pair_surf: List[int] = []
        for si, (stype, sbody, sparams, self_only) in enumerate(self._surfaces):
            for pi in range(len(self._cp)):
                pbody = int(cp_body[pi])
                if tree_id[pbody] != tree_id[sbody]:
                    if not self_only:
                        pair_point.append(pi)
                        pair_surf.append(si)
                elif tree_id[sbody] in self_trees:
                    if pbody == sbody:
                        continue
                    if (bodies[pbody].parent == sbody
                            or bodies[sbody].parent == pbody):
                        continue
                    pair_point.append(pi)
                    pair_surf.append(si)

        name_to_jd = {n: i for i, n in enumerate(dof_names)}
        nt = len(self._tendons)
        t_dof = np.zeros((nt, 2), np.int32)
        t_coef = np.zeros((nt, 2))
        t_rest, t_k, t_c = np.zeros(nt), np.zeros(nt), np.zeros(nt)
        t_lo, t_hi, t_klim = np.zeros(nt), np.zeros(nt), np.zeros(nt)
        for ti, (da, db, ca, cb, rest, k, c, lo, hi, klim) in enumerate(
            self._tendons
        ):
            t_dof[ti] = (name_to_jd[da], name_to_jd[db])
            t_coef[ti] = (ca, cb)
            t_rest[ti], t_k[ti], t_c[ti] = rest, k, c
            t_lo[ti], t_hi[ti], t_klim[ti] = lo, hi, klim

        return Model(
            name=self.name,
            nb=nb, nq=nq, nv=nv, njd=njd,
            parents=tuple(b.parent for b in bodies),
            jtype=tuple(int(b.jtype) for b in bodies),
            q_adr=tuple(q_adr), v_adr=tuple(v_adr), jdof=tuple(jdof),
            tree_id=tuple(tree_id), roots=tuple(roots), levels=levels,
            body_names=tuple(b.name for b in bodies),
            dof_names=tuple(dof_names),
            joint_axis=t(arr(lambda b: b.axis, (3,))),
            joint_pos=t(arr(lambda b: b.joint_pos, (3,))),
            joint_Et=t(arr(lambda b: _quat_to_mat_np(b.joint_quat).T, (3, 3))),
            body_mass=t(arr(lambda b: b.mass)),
            body_com=t(arr(lambda b: b.com, (3,))),
            body_inertia=t(arr(lambda b: b.inertia, (3, 3))),
            jq_idx=jq_idx,
            jv_idx=jv_idx,
            dof_limit_lower=t([b.limit[0] for b in jb]),
            dof_limit_upper=t([b.limit[1] for b in jb]),
            dof_armature=t([b.armature for b in jb]),
            dof_damping=t([b.damping for b in jb]),
            dof_friction=t([b.friction for b in jb]),
            dof_stiffness=t([b.stiffness for b in jb]),
            dof_drive_damping=t([b.drive_damping for b in jb]),
            dof_max_effort=t([b.max_effort for b in jb]),
            dof_max_velocity=t([b.max_velocity for b in jb]),
            cp_body=cp_body,
            cp_pos=t(cp_pos),
            cp_radius=t(cp_radius),
            cp_friction=t(cp_friction),
            surf_type=tuple(sf[0] for sf in self._surfaces),
            surf_body=tuple(sf[1] for sf in self._surfaces),
            surf_params=tuple(sf[2] for sf in self._surfaces),
            pair_point=np.asarray(pair_point, dtype=np.int32),
            pair_surf=tuple(pair_surf),
            nt=nt,
            tendon_dof=t_dof,
            tendon_coef=t(t_coef),
            tendon_rest=t(t_rest),
            tendon_stiffness=t(t_k),
            tendon_damping=t(t_c),
            tendon_limit_lower=t(t_lo),
            tendon_limit_upper=t(t_hi),
            tendon_limit_stiffness=t(t_klim),
            gravity_comp=t([1.0 if b.gravity_comp else 0.0 for b in bodies]),
            sensor_body=tuple(self._sensors),
            default_q=t(default_q),
        )
