"""URDF / MJCF importers -> ModelBuilder (the PyTorch port's own copy of
the JAX package's `models/importers.py`: numpy and the builder).

Supported subsets (unsupported constructs raise ValueError; mesh collision
geometry is skipped with a warning, the engine is primitive-based):

URDF:  links (inertial origin/mass/inertia), joints revolute / continuous /
       prismatic / fixed (fixed children are merged into the parent body
       with transformed composite inertia), joint limits / dynamics
       (damping, friction), collision spheres / boxes / cylinders
       (cylinder ~ capsule).
MJCF:  compiler angle=degree|radian, nested <default> classes with
       class= / childclass= resolution, body pos/quat/euler, joints
       hinge / slide / free (multiple joints per body are expanded into
       the equivalent chain of intermediate bodies, the MuJoCo-documented
       semantics), geoms sphere / capsule / box / cylinder (fromto or
       pos+size), explicit <inertial> or geom-density mass properties,
       <motor> actuators (returned as `builder.actuators` gear metadata).

Imported movable bodies are NAMED BY THEIR JOINT, so that dofs are
addressed by joint name; `builder.body_by_link` / `builder.body_by_name`
map URDF link / MJCF body names to model body indices for collider and
sensor attachment.
"""

from __future__ import annotations

import os
import warnings
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms
from omniisaacgymenvs_torch.physics.model import (
    JointType,
    ModelBuilder,
    _quat_to_mat_np,
)

_BIG = 1e9


# ---------------------------------------------------------------------------
# small numpy rotation helpers (wxyz quaternions, matching physics/rotations)
# ---------------------------------------------------------------------------
def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _quat_about(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, float)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = axis / n
    h = 0.5 * angle
    return np.concatenate([[np.cos(h)], np.sin(h) * axis])


def _rpy_to_quat(rpy) -> np.ndarray:
    """Extrinsic XYZ (URDF rpy / MJCF eulerseq='xyz'): R = Rz @ Ry @ Rx."""
    r, p, y = [float(v) for v in rpy]
    return _quat_mul(
        _quat_about((0, 0, 1), y),
        _quat_mul(_quat_about((0, 1, 0), p), _quat_about((1, 0, 0), r)),
    )


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def _floats(s: Optional[str], default=None) -> Optional[np.ndarray]:
    if s is None:
        return None if default is None else np.asarray(default, float)
    return np.array([float(v) for v in s.split()])


def _parse_xml(source: str) -> ET.Element:
    if "<" in source:
        return ET.fromstring(source)
    if not os.path.exists(source):
        raise FileNotFoundError(source)
    return ET.parse(source).getroot()


class _Inertials:
    """Composite inertial accumulator over (mass, com, I_about_com) parts
    expressed in one target frame (same math as BodyGeoms.finalize)."""

    def __init__(self):
        self.parts: List[Tuple[float, np.ndarray, np.ndarray]] = []

    def add(self, mass: float, com: np.ndarray, inertia: np.ndarray,
            R: np.ndarray, p: np.ndarray):
        """Add a part whose (com, inertia) are in a frame placed at (R, p)
        in the target frame."""
        if mass <= 0.0:
            return
        self.parts.append((mass, p + R @ com, R @ inertia @ R.T))

    def finalize(self) -> Tuple[float, np.ndarray, np.ndarray]:
        if not self.parts:
            return 0.0, np.zeros(3), np.zeros((3, 3))
        mass = sum(m for m, _, _ in self.parts)
        com = sum(m * c for m, c, _ in self.parts) / mass
        I = np.zeros((3, 3))
        for m, c, Ic in self.parts:
            d = c - com
            I += Ic + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        return mass, com, I


def _add_collider(builder: ModelBuilder, body: int, kind: str,
                  pos: np.ndarray, R: np.ndarray, params: dict,
                  friction: float):
    if kind == "sphere":
        builder.add_sphere_collider(body, pos, params["radius"],
                                    friction=friction)
    elif kind == "box":
        builder.add_box_collider(body, pos, params["half"],
                                 friction=friction, quat=_mat_to_quat(R))
    elif kind in ("cylinder", "capsule"):
        h = R @ np.array([0.0, 0.0, params["half_length"]])
        builder.add_capsule_collider(body, pos - h, pos + h,
                                     params["radius"], friction=friction)
    elif kind == "capsule_fromto":
        builder.add_capsule_collider(body, params["p0"], params["p1"],
                                     params["radius"], friction=friction)
    else:  # pragma: no cover - guarded by callers
        raise ValueError(f"unsupported collider kind {kind!r}")


# ===========================================================================
# URDF
# ===========================================================================
def _urdf_origin(el: Optional[ET.Element]) -> Tuple[np.ndarray, np.ndarray]:
    """<origin xyz rpy> -> (pos, rotation matrix)."""
    if el is None:
        return np.zeros(3), np.eye(3)
    xyz = _floats(el.get("xyz"), (0, 0, 0))
    rpy = _floats(el.get("rpy"), (0, 0, 0))
    return xyz, _quat_to_mat_np(_rpy_to_quat(rpy))


def _urdf_inertial(link: ET.Element):
    el = link.find("inertial")
    if el is None:
        return 0.0, np.zeros(3), np.zeros((3, 3)), np.eye(3), np.zeros(3)
    p, R = _urdf_origin(el.find("origin"))
    mass_el = el.find("mass")
    mass = float(mass_el.get("value")) if mass_el is not None else 0.0
    ine = el.find("inertia")
    if ine is not None:
        ixx = float(ine.get("ixx", 0))
        iyy = float(ine.get("iyy", 0))
        izz = float(ine.get("izz", 0))
        ixy = float(ine.get("ixy", 0))
        ixz = float(ine.get("ixz", 0))
        iyz = float(ine.get("iyz", 0))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    else:
        I = np.zeros((3, 3))
    return mass, np.zeros(3), I, R, p


def _urdf_collisions(link: ET.Element):
    """Yield (kind, pos, R, params) per <collision> in link coordinates."""
    for col in link.findall("collision"):
        p, R = _urdf_origin(col.find("origin"))
        geo = col.find("geometry")
        if geo is None:
            continue
        g = list(geo)[0]
        if g.tag == "sphere":
            yield "sphere", p, R, {"radius": float(g.get("radius"))}
        elif g.tag == "box":
            size = _floats(g.get("size"))
            yield "box", p, R, {"half": size / 2.0}
        elif g.tag in ("cylinder", "capsule"):
            yield g.tag, p, R, {
                "radius": float(g.get("radius")),
                "half_length": float(g.get("length")) / 2.0,
            }
        elif g.tag == "mesh":
            warnings.warn(
                "URDF mesh collision geometry is not supported by the "
                "primitive contact engine; skipping (add primitive "
                "colliders via builder.add_*_collider)"
            )
        else:
            raise ValueError(f"unsupported URDF collision geometry {g.tag!r}")


def from_urdf(
    source: str,
    *,
    floating_base: bool = False,
    base_pos=(0.0, 0.0, 0.0),
    base_quat=(1.0, 0.0, 0.0, 0.0),
    name: Optional[str] = None,
    collision: bool = True,
    friction: float = 1.0,
) -> ModelBuilder:
    """Parse a URDF file (or XML string) into a ModelBuilder.

    floating_base selects a FREE vs FIXED root.
    Movable bodies are named by joint name; `builder.body_by_link` maps link
    names to body indices. Drive gains are not part of URDF: configure them
    afterwards with builder.set_drive.
    """
    root = _parse_xml(source)
    if root.tag != "robot":
        raise ValueError(f"expected <robot> root, got <{root.tag}>")
    links: Dict[str, ET.Element] = {
        el.get("name"): el for el in root.findall("link")
    }
    joints = root.findall("joint")
    children = {j.find("child").get("link") for j in joints}
    roots = [n for n in links if n not in children]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root link, got {roots}")

    builder = ModelBuilder(name or root.get("name") or "urdf")
    builder.body_by_link: Dict[str, int] = {}
    by_parent: Dict[str, List[ET.Element]] = {}
    for j in joints:
        by_parent.setdefault(j.find("parent").get("link"), []).append(j)

    # segments of links rigidly connected by fixed joints; each segment is
    # one model body. seg maps link -> (segment id, R, p) with (R, p) the
    # link frame in segment-root-link coordinates.
    seg_links: List[List[Tuple[str, np.ndarray, np.ndarray]]] = []
    seg_joint: List[Optional[ET.Element]] = []   # movable joint above segment
    seg_parent_link: List[Optional[str]] = []
    seg_of: Dict[str, int] = {}

    def new_segment(link: str, joint, parent_link):
        sid = len(seg_links)
        seg_links.append([(link, np.eye(3), np.zeros(3))])
        seg_joint.append(joint)
        seg_parent_link.append(parent_link)
        seg_of[link] = sid
        return sid

    new_segment(roots[0], None, None)
    # BFS joint traversal: breadth-first dof order
    queue = [roots[0]]
    link_T: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
        roots[0]: (np.eye(3), np.zeros(3))
    }
    while queue:
        parent = queue.pop(0)
        for j in by_parent.get(parent, []):
            child = j.find("child").get("link")
            jt = j.get("type")
            if jt == "fixed":
                Rp, pp = link_T[parent]
                xyz, Rj = _urdf_origin(j.find("origin"))
                sid = seg_of[parent]
                Rc, pc = Rp @ Rj, pp + Rp @ xyz
                seg_links[sid].append((child, Rc, pc))
                seg_of[child] = sid
                link_T[child] = (Rc, pc)
            elif jt in ("revolute", "continuous", "prismatic"):
                new_segment(child, j, parent)
                link_T[child] = (np.eye(3), np.zeros(3))
            else:
                raise ValueError(f"unsupported URDF joint type {jt!r}")
            queue.append(child)

    for sid, parts in enumerate(seg_links):
        acc = _Inertials()
        for link_name, R, p in parts:
            m, com, I, Ri, pi = _urdf_inertial(links[link_name])
            acc.add(m, com, I, R @ Ri, p + R @ pi)
        mass, com, I = acc.finalize()
        j = seg_joint[sid]
        if j is None:
            jtype = JointType.FREE if floating_base else JointType.FIXED
            kw = dict(joint_pos=base_pos, joint_quat=base_quat)
            if floating_base:
                kw = dict(default_pos=base_pos, default_quat=base_quat)
            body = builder.add_body(
                parts[0][0], parent=-1, joint_type=jtype,
                mass=max(mass, 1e-6), com=com,
                inertia=I if mass > 0 else np.eye(3) * 1e-6, **kw,
            )
        else:
            parent_link = seg_parent_link[sid]
            psid = seg_of[parent_link]
            Rp, pp = dict(
                (n, (R, p)) for n, R, p in seg_links[psid]
            )[parent_link]
            xyz, Rj = _urdf_origin(j.find("origin"))
            axis_el = j.find("axis")
            axis = (
                _floats(axis_el.get("xyz"), (1, 0, 0))
                if axis_el is not None
                else np.array([1.0, 0.0, 0.0])
            )
            limit_el = j.find("limit")
            lo, hi, max_eff, max_vel = -_BIG, _BIG, _BIG, _BIG
            if limit_el is not None:
                lo = float(limit_el.get("lower", -_BIG))
                hi = float(limit_el.get("upper", _BIG))
                max_eff = float(limit_el.get("effort", _BIG)) or _BIG
                max_vel = float(limit_el.get("velocity", _BIG)) or _BIG
            if j.get("type") == "continuous":
                lo, hi = -_BIG, _BIG
            dyn = j.find("dynamics")
            damping = float(dyn.get("damping", 0.0)) if dyn is not None else 0.0
            fric = float(dyn.get("friction", 0.0)) if dyn is not None else 0.0
            body = builder.add_body(
                j.get("name"),
                parent=builder.body_by_link[parent_link],
                joint_type=(
                    JointType.PRISMATIC
                    if j.get("type") == "prismatic"
                    else JointType.REVOLUTE
                ),
                joint_axis=axis,
                joint_pos=pp + Rp @ xyz,
                joint_quat=_mat_to_quat(Rp @ Rj),
                mass=max(mass, 1e-6), com=com,
                inertia=I if mass > 0 else np.eye(3) * 1e-6,
                limit=(lo, hi), damping=damping, friction=fric,
                max_effort=max_eff, max_velocity=max_vel,
            )
        for link_name, R, p in parts:
            builder.body_by_link[link_name] = body
            if collision:
                for kind, pc, Rc, params in _urdf_collisions(links[link_name]):
                    _add_collider(builder, body, kind, p + R @ pc, R @ Rc,
                                  params, friction)
    return builder


# ===========================================================================
# MJCF
# ===========================================================================
class _MjDefaults:
    """<default> class tree: resolves per-tag attributes with inheritance
    (class= on elements, childclass= on bodies)."""

    def __init__(self, root: ET.Element):
        self.classes: Dict[str, Dict[str, dict]] = {"main": {}}
        for d in root.findall("default"):
            self._walk(d, "main", {})

    def _walk(self, el: ET.Element, name: str, inherited: Dict[str, dict]):
        merged = {t: dict(a) for t, a in inherited.items()}
        for child in el:
            if child.tag == "default":
                continue
            merged.setdefault(child.tag, {}).update(child.attrib)
        self.classes[name] = merged
        for child in el.findall("default"):
            self._walk(child, child.get("class"), merged)

    def resolve(self, el: ET.Element, active_class: str) -> dict:
        cls = el.get("class", active_class)
        out = dict(self.classes.get(cls, {}).get(el.tag, {}))
        out.update(el.attrib)
        return out


def _mj_quat(attrs: dict, to_rad: float) -> np.ndarray:
    if "quat" in attrs:
        q = _floats(attrs["quat"])
        return q / np.linalg.norm(q)
    if "euler" in attrs:
        return _rpy_to_quat(_floats(attrs["euler"]) * to_rad)
    if "axisangle" in attrs:
        aa = _floats(attrs["axisangle"])
        return _quat_about(aa[:3], aa[3] * to_rad)
    return np.array([1.0, 0.0, 0.0, 0.0])


def _mj_geom(attrs: dict, to_rad: float):
    """-> (kind, pos, R, params, density, mass_override, collide, friction)"""
    gtype = attrs.get("type", "sphere")
    pos = _floats(attrs.get("pos"), (0, 0, 0))
    R = _quat_to_mat_np(_mj_quat(attrs, to_rad))
    size = _floats(attrs.get("size"), (0,))
    density = float(attrs.get("density", 1000.0))
    mass = float(attrs["mass"]) if "mass" in attrs else None
    collide = not (
        attrs.get("contype", "1") == "0" and attrs.get("conaffinity", "1") == "0"
    )
    fric = _floats(attrs.get("friction"), (1.0,))[0]
    if gtype == "plane":
        return None
    if gtype == "sphere":
        return "sphere", pos, R, {"radius": float(size[0])}, density, mass, \
            collide, fric
    if gtype in ("capsule", "cylinder"):
        if "fromto" in attrs:
            ft = _floats(attrs["fromto"])
            return "capsule_fromto", pos, R, {
                "p0": ft[:3], "p1": ft[3:], "radius": float(size[0]),
            }, density, mass, collide, fric
        return gtype, pos, R, {
            "radius": float(size[0]), "half_length": float(size[1]),
        }, density, mass, collide, fric
    if gtype == "box":
        return "box", pos, R, {"half": size[:3]}, density, mass, collide, fric
    raise ValueError(f"unsupported MJCF geom type {gtype!r}")


def _mj_geom_inertial(kind: str, pos, R, params, density, mass_override):
    g = BodyGeoms(density)
    if kind == "sphere":
        g.sphere(pos, params["radius"])
    elif kind == "capsule_fromto":
        g.capsule(params["p0"], params["p1"], params["radius"])
    elif kind in ("capsule", "cylinder"):
        h = R @ np.array([0.0, 0.0, params["half_length"]])
        g.capsule(pos - h, pos + h, params["radius"])
    elif kind == "box":
        # box inertia about its own axes, rotated into body frame
        m, c, I = BodyGeoms(density).box((0, 0, 0), params["half"]).finalize()
        if mass_override is not None:
            I *= mass_override / m
            m = mass_override
        return m, pos, R @ I @ R.T
    m, c, I = g.finalize()
    if mass_override is not None:
        I *= mass_override / m
        m = mass_override
    return m, c, I


def from_mjcf(source: str, *, name: Optional[str] = None) -> ModelBuilder:
    """Parse an MJCF file (or XML string) into a ModelBuilder.

    Movable bodies are named by joint name (multiple joints per body expand
    to the documented equivalent chain of intermediate near-massless
    bodies); `builder.body_by_name` maps MJCF body names to model body
    indices; `builder.actuators` maps motor names to
    {"joint", "gear"}.
    """
    root = _parse_xml(source)
    if root.tag != "mujoco":
        raise ValueError(f"expected <mujoco> root, got <{root.tag}>")
    compiler = root.find("compiler")
    angle = compiler.get("angle", "degree") if compiler is not None else "degree"
    to_rad = np.pi / 180.0 if angle == "degree" else 1.0
    if compiler is not None and compiler.get("eulerseq", "xyz") != "xyz":
        raise ValueError("only eulerseq='xyz' is supported")
    defaults = _MjDefaults(root)
    builder = ModelBuilder(name or root.get("model") or "mjcf")
    builder.body_by_name: Dict[str, int] = {}
    builder.actuators: Dict[str, dict] = {}

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("missing <worldbody>")

    def walk(el: ET.Element, parent_body: int, R_off: np.ndarray,
             p_off: np.ndarray, cls: str):
        """parent_body: model body the enclosing MJCF body belongs to (-1 at
        world level); (R_off, p_off): transform of the enclosing MJCF body
        frame expressed in the parent MODEL body frame
        (x_model = p_off + R_off @ x_mjcf; joint anchors shift and body
        quats rotate the model origins away from the MJCF ones)."""
        cls = el.get("childclass", cls)
        for b in el.findall("body"):
            bcls = b.get("childclass", cls)
            pos = _floats(b.get("pos"), (0, 0, 0))
            quat = _mj_quat(b.attrib, to_rad)
            Rb = _quat_to_mat_np(quat)

            jels = [c for c in b if c.tag in ("joint", "freejoint")]
            geoms = [
                _mj_geom(defaults.resolve(g, bcls), to_rad)
                for g in b.findall("geom")
            ]
            geoms = [g for g in geoms if g is not None]

            # inertial: explicit or from geoms (about the MJCF body frame)
            inert_el = b.find("inertial")
            if inert_el is not None:
                icom = _floats(inert_el.get("pos"), (0, 0, 0))
                imass = float(inert_el.get("mass"))
                Ri = _quat_to_mat_np(_mj_quat(inert_el.attrib, to_rad))
                if inert_el.get("diaginertia") is not None:
                    Ii = np.diag(_floats(inert_el.get("diaginertia")))
                else:
                    fi = _floats(inert_el.get("fullinertia"))
                    Ii = np.array(
                        [[fi[0], fi[3], fi[4]], [fi[3], fi[1], fi[5]],
                         [fi[4], fi[5], fi[2]]]
                    )
                mass, com, I = imass, icom, Ri @ Ii @ Ri.T
            else:
                acc = _Inertials()
                for kind, gp, gR, params, dens, mo, _, _ in geoms:
                    m, c, Ic = _mj_geom_inertial(kind, gp, gR, params, dens, mo)
                    acc.add(m, c, Ic, np.eye(3), np.zeros(3))
                mass, com, I = acc.finalize()

            free = any(j.tag == "freejoint" or
                       defaults.resolve(j, bcls).get("type") == "free"
                       for j in jels)
            if free:
                if len(jels) != 1:
                    raise ValueError("freejoint must be the only joint")
                if parent_body != -1:
                    raise ValueError("freejoint only supported at world level")
                body = builder.add_body(
                    b.get("name", f"body{len(builder._bodies)}"),
                    parent=-1, joint_type=JointType.FREE,
                    mass=max(mass, 1e-6), com=com,
                    inertia=I if mass > 0 else np.eye(3) * 1e-6,
                    default_pos=pos, default_quat=quat,
                )
                anchor = np.zeros(3)
            elif not jels:
                # jointless body: rigidly merge into the parent model body
                # (x_model = p' + R' @ x_mjcf with the composed transform);
                # at world level it becomes its own FIXED static body.
                Rc = R_off @ Rb
                pc = p_off + R_off @ pos
                if parent_body == -1:
                    acc_body = builder.add_body(
                        b.get("name", f"body{len(builder._bodies)}"),
                        parent=-1, joint_type=JointType.FIXED,
                        joint_pos=pc, joint_quat=_mat_to_quat(Rc),
                        mass=max(mass, 1e-6), com=com,
                        inertia=I if mass > 0 else np.eye(3) * 1e-6,
                    )
                    Rc, pc = np.eye(3), np.zeros(3)
                else:
                    acc_body = parent_body
                    spec = builder._bodies[acc_body]
                    accp = _Inertials()
                    accp.add(spec.mass, spec.com, spec.inertia, np.eye(3),
                             np.zeros(3))
                    accp.add(mass, com, I, Rc, pc)
                    spec.mass, spec.com, spec.inertia = accp.finalize()
                for kind, gp, gR, params, dens, mo, collide, fric in geoms:
                    if collide:
                        if kind == "capsule_fromto":
                            params = {
                                "p0": pc + Rc @ params["p0"],
                                "p1": pc + Rc @ params["p1"],
                                "radius": params["radius"],
                            }
                            _add_collider(builder, acc_body, kind,
                                          np.zeros(3), np.eye(3), params, fric)
                        else:
                            _add_collider(builder, acc_body, kind,
                                          pc + Rc @ gp, Rc @ gR, params, fric)
                if b.get("name"):
                    builder.body_by_name[b.get("name")] = acc_body
                walk(b, acc_body, Rc, pc, bcls)
                continue
            else:
                # chain of 1-dof joints (MuJoCo's documented equivalence to
                # nested massless bodies, XML order outer->inner)
                body = parent_body
                prev_anchor = None
                for k, jel in enumerate(jels):
                    a = defaults.resolve(jel, bcls)
                    jt = a.get("type", "hinge")
                    if jt not in ("hinge", "slide"):
                        raise ValueError(f"unsupported MJCF joint {jt!r}")
                    anchor_k = _floats(a.get("pos"), (0, 0, 0))
                    axis = _floats(a.get("axis"), (0, 0, 1))
                    rng = a.get("range")
                    if rng is not None:
                        lo, hi = _floats(rng)
                        if jt == "hinge":
                            lo, hi = lo * to_rad, hi * to_rad
                    else:
                        lo, hi = -_BIG, _BIG
                    ref = float(a.get("ref", 0.0))
                    if jt == "hinge":
                        ref *= to_rad
                    last = k == len(jels) - 1
                    if k == 0:
                        if body == -1:
                            # world-attached kinematic chain hangs from its
                            # own static anchor (fixed-base articulation)
                            body = builder.add_body(
                                f"{b.get('name', 'chain')}_base", parent=-1,
                                joint_type=JointType.FIXED,
                                mass=1.0, inertia=(0.1, 0.1, 0.1),
                            )
                        jpos = p_off + R_off @ (pos + Rb @ anchor_k)
                        jquat = _mat_to_quat(R_off @ Rb)
                    else:
                        jpos = anchor_k - prev_anchor
                        jquat = (1.0, 0.0, 0.0, 0.0)
                    body = builder.add_body(
                        a.get("name", f"joint{len(builder._bodies)}"),
                        parent=body,
                        joint_type=(JointType.REVOLUTE if jt == "hinge"
                                    else JointType.PRISMATIC),
                        joint_axis=axis, joint_pos=jpos, joint_quat=jquat,
                        mass=max(mass, 1e-6) if last else 1e-4,
                        com=(com - anchor_k) if last else (0, 0, 0),
                        inertia=(I if mass > 0 else np.eye(3) * 1e-6)
                        if last else np.eye(3) * 1e-6,
                        limit=(lo, hi),
                        damping=float(a.get("damping", 0.0)),
                        armature=float(a.get("armature", 0.0)),
                        friction=float(a.get("frictionloss", 0.0)),
                        default_q=ref,
                    )
                    prev_anchor = anchor_k
                anchor = prev_anchor

            for kind, gp, gR, params, dens, mo, collide, fric in geoms:
                if not collide:
                    continue
                if kind == "capsule_fromto":
                    params = {
                        "p0": params["p0"] - anchor,
                        "p1": params["p1"] - anchor,
                        "radius": params["radius"],
                    }
                    _add_collider(builder, body, kind, np.zeros(3),
                                  np.eye(3), params, fric)
                else:
                    _add_collider(builder, body, kind, gp - anchor, gR,
                                  params, fric)
            if b.get("name"):
                builder.body_by_name[b.get("name")] = body
            walk(b, body, np.eye(3), -anchor, bcls)

    walk(worldbody, -1, np.eye(3), np.zeros(3), "main")

    act = root.find("actuator")
    if act is not None:
        for m in act.findall("motor"):
            a = defaults.resolve(m, "main")
            builder.actuators[m.get("name", a.get("joint"))] = {
                "joint": a.get("joint"),
                "gear": float(_floats(a.get("gear"), (1.0,))[0]),
            }
    return builder
