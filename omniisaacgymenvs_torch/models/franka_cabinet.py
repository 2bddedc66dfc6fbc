"""Franka Panda arm + Sektion cabinet scene of the FrankaCabinet task
(PyTorch port of the JAX package's `models/franka_cabinet.py`).

Panda joints 1-7 and two prismatic fingers: drive stiffness 400 / damping
80 on the arm, 1e4 / 100 on the fingers, effort caps 87 x 4, 12 x 3, 200 x
2, velocity caps 2.175 x 4, 2.61 x 3, 0.2 x 2. The cabinet stands at (1, 0,
0.4) facing the arm, with two doors and two drawers; the top drawer (a
prismatic child of the FIXED cabinet root) slides along world -x toward the
robot and opens 0..0.4 m. Its front face and handle bar are receiver
surfaces; the finger pads carry contact points so the gripper can grip and
pull the handle. With `num_props` > 0, FREE cubes rest on a tray in the
drawer.
"""

import math

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

SQ = 0.70710678

# panda joint table: (pos in parent, joint_quat (rpy about x), limits, mass)
_PANDA = [
    ((0.0, 0.0, 0.333), (1, 0, 0, 0), (-2.8973, 2.8973), 4.97),
    ((0.0, 0.0, 0.0), (SQ, -SQ, 0, 0), (-1.7628, 1.7628), 0.65),
    ((0.0, -0.316, 0.0), (SQ, SQ, 0, 0), (-2.8973, 2.8973), 3.23),
    ((0.0825, 0.0, 0.0), (SQ, SQ, 0, 0), (-3.0718, -0.0698), 3.59),
    ((-0.0825, 0.384, 0.0), (SQ, -SQ, 0, 0), (-2.8973, 2.8973), 1.23),
    ((0.0, 0.0, 0.0), (SQ, SQ, 0, 0), (-0.0175, 3.7525), 1.67),
    ((0.088, 0.0, 0.0), (SQ, SQ, 0, 0), (-2.8973, 2.8973), 1.51),  # +hand
]

FRANKA_DEFAULT_DOF = (1.157, -1.066, -0.155, -2.239, -1.841, 1.003, 0.469,
                      0.035, 0.035)

# hand frame offsets (merged into link7)
HAND_Z = 0.107          # hand base from link7 origin
FINGER_Z = HAND_Z + 0.0584
GRASP_OFFSET = (0.0, 0.0, FINGER_Z + 0.045)  # fingertip-centre grasp frame

CABINET_POS = np.array([1.0, 0.0, 0.4])
DRAWER_JOINT_POS = (-0.2, 0.0, 0.3172)       # drawer frame: (0.8, 0, 0.7172)
DRAWER_LOCAL_GRASP = (-0.16, 0.01, 0.0)      # handle point in drawer frame
DRAWER_INWARD_AXIS = (1.0, 0.0, 0.0)         # into the cabinet (away from arm)
DRAWER_UP_AXIS = (0.0, 0.0, 1.0)


def build_franka_cabinet(num_props: int = 0, device="cpu"):
    """(model, the top drawer's body index). num_props: clutter cubes
    resting in the drawer (5 cm, gridded around the drawer's centre)."""
    b = ModelBuilder("FrankaCabinet")

    # ---------------- franka (fixed base at origin) ----------------
    base = b.add_body("panda_link0", parent=-1, joint_type=JointType.FIXED,
                      mass=3.0, inertia=(0.02, 0.02, 0.02))
    parent = base
    arm_drive = dict(stiffness=400.0, drive_damping=80.0)
    max_force = [87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0]
    max_vel = [2.175] * 4 + [2.61] * 3
    for i, (pos, quat, lim, mass) in enumerate(_PANDA):
        parent = b.add_body(
            f"panda_joint{i + 1}", parent=parent,
            joint_type=JointType.REVOLUTE, joint_axis=(0, 0, 1),
            joint_pos=pos, joint_quat=quat, limit=lim,
            mass=mass, com=(0, 0, -0.05 if i else 0.05),
            inertia=(0.02, 0.02, 0.01),
            armature=0.05, damping=1.0, max_effort=max_force[i],
            max_velocity=max_vel[i], default_q=FRANKA_DEFAULT_DOF[i],
            **arm_drive,
        )
    link7 = parent

    finger_drive = dict(stiffness=1.0e4, drive_damping=100.0,
                        max_effort=200.0, max_velocity=0.2)
    for j, sy in ((1, 1.0), (2, -1.0)):
        f = b.add_body(
            f"panda_finger_joint{j}", parent=link7,
            joint_type=JointType.PRISMATIC, joint_axis=(0, sy, 0),
            joint_pos=(0, 0, FINGER_Z), limit=(0.0, 0.04),
            mass=0.1, com=(0, 0.01 * sy, 0.03), inertia=(1e-4,) * 3,
            armature=0.01, damping=1.0, default_q=0.035,
            **finger_drive,
        )
        # finger pad contact points (grip the handle bar)
        for z in (0.035, 0.045, 0.054):
            b.add_contact_point(f, (0.0, -0.006 * sy, z), radius=0.004,
                                friction=1.5)
        if j == 1:
            b.add_force_sensor(f)

    # ---------------- cabinet (fixed, facing the arm) ----------------
    cab = b.add_body(
        "cabinet", parent=-1, joint_type=JointType.FIXED,
        joint_pos=tuple(CABINET_POS),
        mass=50.0, inertia=(2.0, 2.0, 2.0),
    )
    # doors (unactuated)
    for name, sy in (("door_left_joint", 1.0), ("door_right_joint", -1.0)):
        b.add_body(
            name, parent=cab, joint_type=JointType.REVOLUTE,
            joint_axis=(0, 0, 1), joint_pos=(-0.18, 0.3 * sy, -0.15),
            limit=(0.0, 1.5) if sy > 0 else (-1.5, 0.0),
            mass=1.0, inertia=(0.01, 0.01, 0.01),
            damping=2.0, friction=2.0, max_velocity=5.0,
        )
    # drawers: bottom, and top (the task's target)
    m, com, I = BodyGeoms(300.0).box((0.1, 0, 0), (0.18, 0.25, 0.06)).finalize()
    b.add_body(
        "drawer_bottom_joint", parent=cab, joint_type=JointType.PRISMATIC,
        joint_axis=(-1, 0, 0), joint_pos=(-0.2, 0.0, 0.1),
        limit=(0.0, 0.4), mass=m, com=com, inertia=I,
        damping=8.0, friction=2.0, max_velocity=2.0,
    )
    drawer = b.add_body(
        "drawer_top_joint", parent=cab, joint_type=JointType.PRISMATIC,
        joint_axis=(-1, 0, 0), joint_pos=DRAWER_JOINT_POS,
        limit=(0.0, 0.4), mass=m, com=com, inertia=I,
        damping=8.0, friction=2.0, max_velocity=2.0,
    )
    # drawer front face + handle bar (receiver surfaces for finger pads)
    b.add_box_collider(drawer, (0.06, 0, 0), (0.06, 0.25, 0.06), receive=True)
    b.add_capsule_collider(
        drawer, (-0.16, -0.06, 0.0), (-0.16, 0.06, 0.0), 0.012, receive=True
    )
    if num_props > 0:
        # drawer tray the props rest on
        b.add_box_collider(drawer, (0.1, 0, -0.05), (0.17, 0.24, 0.01),
                           receive=True)
        per_row = int(math.ceil(math.sqrt(num_props)))
        size = 0.05   # cubes scaled down to fit the drawer tray
        spacing = 0.06
        xmin = -0.5 * spacing * (per_row - 1)
        ymin = -0.5 * spacing * (per_row - 1)
        mass = 400.0 * size**3
        inertia = mass * size * size / 6.0
        # tray region behind the drawer front box (local x > 0.12)
        drawer_world = CABINET_POS + np.asarray(DRAWER_JOINT_POS)
        count = 0
        for j in range(per_row):
            for k in range(per_row):
                if count >= num_props:
                    break
                pos = drawer_world + np.array(
                    [0.2 + xmin + j * spacing, ymin + k * spacing,
                     -0.04 + size / 2 + 0.005]
                )
                prop = b.add_body(
                    f"prop_{count}", parent=-1, joint_type=JointType.FREE,
                    mass=mass, inertia=(inertia,) * 3,
                    default_pos=tuple(pos),
                )
                b.add_box_collider(prop, (0, 0, 0), (size / 2,) * 3)
                count += 1
    return b.finalize(device), drawer
