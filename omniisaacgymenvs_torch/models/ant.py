"""Ant quadruped: floating torso, 4 legs x (hip z-hinge + ankle hinge) = 8 dof.

Matches the reference Ant (robots/articulations/ant.py, Nucleus ant USD whose
lineage is the classic MJCF ant): 8 dofs, joint gears all 15 (reference
tasks/ant.py:80), effort control with powerScale (tasks/shared/
locomotion.py:109), force sensors on the 4 feet (locomotion.py:89). Bodies
are inserted breadth-first (hips then ankles) matching the reference's
breadth-first dof ordering (docs/transfering_policies_from_isaac_gym.md:28-56).
"""

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms, deg
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

# legs: (name, planar direction sign pair, ankle axis, ankle range deg, default)
_LEGS = [
    ("front_left", (+1, +1), (-1, 1, 0), (30, 70), +50),
    ("front_right", (-1, +1), (1, 1, 0), (-70, -30), -50),
    ("back_left", (-1, -1), (-1, 1, 0), (-70, -30), -50),
    ("back_right", (+1, -1), (1, 1, 0), (30, 70), +50),
]

_DENSITY = 5.0  # classic MJCF ant geom density
_R = 0.08       # leg capsule radius


def build_ant(spawn_height: float = 0.5, device="cpu"):
    b = ModelBuilder("Ant")

    # torso: sphere + the 4 inner (hip-mount) capsules rigidly attached
    g = BodyGeoms(_DENSITY).sphere((0, 0, 0), 0.25)
    for _, (sx, sy), *_ in _LEGS:
        g.capsule((0, 0, 0), (0.2 * sx, 0.2 * sy, 0), _R)
    m, com, I = g.finalize()
    torso = b.add_body(
        "torso", parent=-1, joint_type=JointType.FREE,
        mass=m, com=com, inertia=I,
    )
    b.set_root_default(pos=(0, 0, spawn_height))
    b.add_sphere_collider(torso, (0, 0, 0), 0.25)

    hips = []
    for name, (sx, sy), *_ in _LEGS:
        tip = np.array([0.2 * sx, 0.2 * sy, 0.0])
        m, com, I = BodyGeoms(_DENSITY).capsule((0, 0, 0), tip, _R).finalize()
        hip = b.add_body(
            f"hip_{name}",
            parent=torso,
            joint_type=JointType.REVOLUTE,
            joint_axis=(0, 0, 1),
            joint_pos=tip,   # hip anchored at the inner capsule tip
            mass=m, com=com, inertia=I,
            limit=(deg(-30), deg(30)),
            armature=0.01, damping=1.0,
            max_velocity=30.0,
        )
        hips.append(hip)

    for (name, (sx, sy), axis, rng, dq), hip in zip(_LEGS, hips):
        knee = np.array([0.2 * sx, 0.2 * sy, 0.0])
        tip = np.array([0.4 * sx, 0.4 * sy, 0.0])
        m, com, I = BodyGeoms(_DENSITY).capsule((0, 0, 0), tip, _R).finalize()
        foot = b.add_body(
            f"ankle_{name}",
            parent=hip,
            joint_type=JointType.REVOLUTE,
            joint_axis=axis,
            joint_pos=knee,
            mass=m, com=com, inertia=I,
            limit=(deg(rng[0]), deg(rng[1])),
            armature=0.01, damping=1.0,
            max_velocity=30.0,
            default_q=deg(dq),
        )
        b.add_capsule_collider(foot, (0, 0, 0), tip, _R, n_extra=1)
        b.add_force_sensor(foot)

    return b.finalize(device)


ANT_JOINT_GEARS = tuple([15.0] * 8)  # reference tasks/ant.py:80
