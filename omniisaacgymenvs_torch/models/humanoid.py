"""Humanoid biped: floating torso, 21 dof (classic MJCF humanoid lineage).

Matches the reference Humanoid (robots/articulations/humanoid.py; 21 dofs
with the gear table of reference tasks/humanoid.py:82-107). Multi-dof
anatomical joints are authored as chains of 1-dof hinges through near-
massless intermediate bodies, inserted in breadth-first order so the dof
ordering matches the reference gear table exactly:
[abdomen_z, abdomen_y, r_shoulder1, r_shoulder2, l_shoulder1, l_shoulder2,
 abdomen_x, r_elbow, l_elbow, r_hip_x, r_hip_y, r_hip_z, l_hip_x, l_hip_y,
 l_hip_z, r_knee, l_knee, r_ankle_y, r_ankle_x, l_ankle_y, l_ankle_x].
"""

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms, deg
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

# reference tasks/humanoid.py:82-107
HUMANOID_JOINT_GEARS = (
    67.5, 67.5,            # lower_waist (abdomen z, y)
    67.5, 67.5,            # right_upper_arm (shoulder 1, 2)
    67.5, 67.5,            # left_upper_arm
    67.5,                  # pelvis (abdomen x)
    45.0, 45.0,            # right/left lower_arm (elbows)
    45.0, 135.0, 45.0,     # right_thigh x, y, z
    45.0, 135.0, 45.0,     # left_thigh x, y, z
    90.0, 90.0,            # right/left knee
    22.5, 22.5,            # right_foot (ankle y, x)
    22.5, 22.5,            # left_foot
)

_DUMMY = dict(mass=0.05, inertia=(5e-4, 5e-4, 5e-4))


def _arm(damping):
    # per-joint damping follows the classic MJCF humanoid (abdomen/hips ~5,
    # knees 1, ankles 3, arms 1) — without it the 67-135 Nm gears windmill
    # the limbs into the velocity caps within milliseconds
    return dict(armature=0.02, damping=damping, max_velocity=30.0)


_ARM = _arm(1.0)


def build_humanoid(spawn_height: float = 1.34, device="cpu"):
    b = ModelBuilder("Humanoid")

    g = BodyGeoms(1000.0)
    g.capsule((0, -0.07, 0), (0, 0.07, 0), 0.07)          # torso
    g.sphere((0, 0, 0.19), 0.09)                          # head
    g.capsule((-0.01, -0.06, -0.12), (-0.01, 0.06, -0.12), 0.06)  # uwaist
    m, com, I = g.finalize()
    torso = b.add_body("torso", parent=-1, joint_type=JointType.FREE,
                       mass=m, com=com, inertia=I)
    b.set_root_default(pos=(0, 0, spawn_height))
    b.add_sphere_collider(torso, (0, 0, 0.19), 0.09)
    b.add_capsule_collider(torso, (0, -0.07, 0), (0, 0.07, 0), 0.07)

    # ---- level 1: lower_waist (2 dof), right/left upper arm (2 dof each) --
    lw_dummy = b.add_body(
        "abdomen_z", parent=torso, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 0, 1), joint_pos=(-0.01, 0, -0.26),
        limit=(deg(-45), deg(45)), **_DUMMY, **_arm(5.0),
    )
    m, com, I = BodyGeoms(1000.0).capsule((0, -0.06, 0), (0, 0.06, 0), 0.06).finalize()
    lower_waist = b.add_body(
        "abdomen_y", parent=lw_dummy, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 1, 0), limit=(deg(-75), deg(30)),
        mass=m, com=com, inertia=I, **_arm(5.0),
    )

    arms = {}
    for side, sy in (("right", -1), ("left", 1)):
        s1_axis = (2, -sy, 1)
        s1_rng = (deg(-85), deg(60)) if side == "right" else (deg(-60), deg(85))
        s2_axis = (0, sy, 1)
        s2_rng = s1_rng
        sh_dummy = b.add_body(
            f"{side}_shoulder1", parent=torso, joint_type=JointType.REVOLUTE,
            joint_axis=s1_axis, joint_pos=(0, 0.17 * sy, 0.06),
            limit=s1_rng, **_DUMMY, **_ARM,
        )
        tip = np.array([0.16, 0.16 * sy, -0.16])
        m, com, I = BodyGeoms(1000.0).capsule((0, 0, 0), tip, 0.04).finalize()
        upper_arm = b.add_body(
            f"{side}_shoulder2", parent=sh_dummy, joint_type=JointType.REVOLUTE,
            joint_axis=s2_axis, limit=s2_rng,
            mass=m, com=com, inertia=I, **_ARM,
        )
        arms[side] = upper_arm

    # ---- level 2: pelvis (abdomen_x), elbows ----
    m, com, I = BodyGeoms(1000.0).capsule((-0.02, -0.07, 0), (-0.02, 0.07, 0), 0.09).finalize()
    pelvis = b.add_body(
        "abdomen_x", parent=lower_waist, joint_type=JointType.REVOLUTE,
        joint_axis=(1, 0, 0), joint_pos=(0, 0, -0.165),
        limit=(deg(-35), deg(35)), mass=m, com=com, inertia=I, **_arm(5.0),
    )

    for side, sy in (("right", -1), ("left", 1)):
        el_axis = (0, -1, 1) if side == "right" else (0, -1, -1)
        p0 = np.array([0.01, 0.01 * -sy, 0.01])
        p1 = np.array([0.17, 0.17 * -sy, 0.17])
        geoms = BodyGeoms(1000.0).capsule(p0, p1, 0.031)
        hand = p1 + np.array([0.01, 0.01 * -sy, 0.01])
        geoms.sphere(hand, 0.04)
        m, com, I = geoms.finalize()
        lower_arm = b.add_body(
            f"{side}_elbow", parent=arms[side], joint_type=JointType.REVOLUTE,
            joint_axis=el_axis, joint_pos=(0.18, 0.18 * sy, -0.18),
            limit=(deg(-90), deg(50)), mass=m, com=com, inertia=I, **_ARM,
        )
        b.add_sphere_collider(lower_arm, hand, 0.04)

    # ---- level 3: thighs (3 dof each) ----
    thighs = {}
    for side, sy in (("right", -1), ("left", 1)):
        hx_rng = (deg(-25), deg(5)) if side == "right" else (deg(-5), deg(25))
        hz_rng = (deg(-60), deg(35)) if side == "right" else (deg(-35), deg(60))
        hip_x = b.add_body(
            f"{side}_hip_x", parent=pelvis, joint_type=JointType.REVOLUTE,
            joint_axis=(1, 0, 0), joint_pos=(0, 0.1 * sy, -0.04),
            limit=hx_rng, **_DUMMY, **_arm(5.0),
        )
        hip_y = b.add_body(
            f"{side}_hip_y", parent=hip_x, joint_type=JointType.REVOLUTE,
            joint_axis=(0, 1, 0), limit=(deg(-110), deg(30)),
            **_DUMMY, **_arm(5.0),
        )
        tip = np.array([0, 0.01 * -sy, -0.34])
        m, com, I = BodyGeoms(1000.0).capsule((0, 0, 0), tip, 0.06).finalize()
        thigh = b.add_body(
            f"{side}_hip_z", parent=hip_y, joint_type=JointType.REVOLUTE,
            joint_axis=(0, 0, 1), limit=hz_rng,
            mass=m, com=com, inertia=I, **_arm(5.0),
        )
        thighs[side] = thigh

    # ---- level 4: knees ----
    shins = {}
    for side, sy in (("right", -1), ("left", 1)):
        m, com, I = BodyGeoms(1000.0).capsule((0, 0, 0), (0, 0, -0.3), 0.049).finalize()
        shin = b.add_body(
            f"{side}_knee", parent=thighs[side], joint_type=JointType.REVOLUTE,
            joint_axis=(0, 1, 0), joint_pos=(0, 0.01 * -sy, -0.403),
            limit=(deg(2), deg(160)), default_q=deg(5),
            mass=m, com=com, inertia=I, **_ARM,
        )
        shins[side] = shin

    # ---- level 5: feet (2 dof each) ----
    for side, sy in (("right", -1), ("left", 1)):
        ankle_y = b.add_body(
            f"{side}_ankle_y", parent=shins[side], joint_type=JointType.REVOLUTE,
            joint_axis=(0, 1, 0), joint_pos=(0, 0, -0.39),
            limit=(deg(-50), deg(50)), **_DUMMY, **_arm(3.0),
        )
        m, com, I = BodyGeoms(1100.0).box((0.045, 0, -0.0275), (0.085, 0.045, 0.0275)).finalize()
        foot = b.add_body(
            f"{side}_ankle_x", parent=ankle_y, joint_type=JointType.REVOLUTE,
            joint_axis=(1, 0, 0), limit=(deg(-50), deg(50)),
            mass=m, com=com, inertia=I, **_arm(3.0),
        )
        b.add_box_collider(foot, (0.045, 0, -0.0275), (0.085, 0.045, 0.0275))
        b.add_force_sensor(foot)

    return b.finalize(device)
