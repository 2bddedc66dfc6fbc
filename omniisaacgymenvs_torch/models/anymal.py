"""ANYmal quadruped: floating base, 12 dof (HAA/HFE/KFE x 4 legs).

Matches the reference Anymal (robots/articulations/anymal.py — Nucleus
anymal_instanceable.usd, ANYbotics ANYmal B lineage) with the reference dof
ordering [LF_HAA, LH_HAA, RF_HAA, RH_HAA, LF_HFE, LH_HFE, RF_HFE, RH_HFE,
LF_KFE, LH_KFE, RF_KFE, RH_KFE] (robots/articulations/anymal.py:72-83,
breadth-first) and the PD drives Kp=400, Kd=40, max force 1000 the task
configures (reference tasks/anymal.py set_drive call via
tasks/utils/usd_utils.py:71-82).
"""

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

# (name, sx: front/hind, sy: left/right) — reference dof order
_LEGS = [("LF", +1, +1), ("LH", -1, +1), ("RF", +1, -1), ("RH", -1, -1)]

_DRIVE = dict(stiffness=400.0, drive_damping=40.0, max_effort=1000.0)

# reference cfg/task/Anymal.yaml defaultJointAngles
def _default_haa(sy):
    return 0.03 * sy


def _default_hfe(sx):
    return 0.4 * sx


def _default_kfe(sx):
    return -0.8 * sx


def build_anymal(spawn_height: float = 0.62, drive: dict | None = None,
                 dual_foot_contacts: bool = False, device="cpu"):
    """drive: optional override of the PD drive constants (stiffness,
    drive_damping, max_effort) — AnymalTerrain runs its explicit in-loop PD
    law tau = clip(Kp(targets-q) - Kd qd, +-80) (reference
    tasks/anymal_terrain.py:309-316) through the engine's per-substep drive
    evaluation by authoring those gains as the model drives.

    dual_foot_contacts: append a SECOND contact point per foot (same
    offset/radius, model indices ncp-4..ncp-1, leg order LF/LH/RF/RH).
    The terrain task routes these to a different local contact feature
    than the primary (tread support while the primary takes the riser
    wall), giving a step-corner wedge the two-plane manifold a trimesh
    collision would produce instead of nearest-feature-only contact."""
    drv = dict(_DRIVE) if drive is None else dict(drive)
    b = ModelBuilder("Anymal")

    m, com, I = BodyGeoms(470.0).box((0, 0, 0), (0.265, 0.15, 0.12)).finalize()
    base = b.add_body("base", parent=-1, joint_type=JointType.FREE,
                      mass=m, com=com, inertia=I)
    b.set_root_default(pos=(0, 0, spawn_height))
    b.add_box_collider(base, (0, 0, 0), (0.265, 0.15, 0.10))

    hips = {}
    for name, sx, sy in _LEGS:
        m, com, I = BodyGeoms(1500.0).sphere((0.06 * sx, 0.04 * sy, 0), 0.06).finalize()
        hips[name] = b.add_body(
            f"{name}_HAA", parent=base, joint_type=JointType.REVOLUTE,
            joint_axis=(1, 0, 0), joint_pos=(0.277 * sx, 0.116 * sy, 0.0),
            limit=(-0.8, 0.8), default_q=_default_haa(sy),
            mass=m, com=com, inertia=I,
            armature=0.05, damping=0.0, max_velocity=20.0, **drv,
        )

    thighs = {}
    for name, sx, sy in _LEGS:
        tip = np.array([0.0, 0.0, -0.25])
        m, com, I = BodyGeoms(1100.0).capsule((0, 0, 0), tip, 0.045).finalize()
        thighs[name] = b.add_body(
            f"{name}_HFE", parent=hips[name], joint_type=JointType.REVOLUTE,
            joint_axis=(0, 1, 0), joint_pos=(0.06 * sx, 0.08 * sy, 0.0),
            limit=(-2.2, 2.2), default_q=_default_hfe(sx),
            mass=m, com=com, inertia=I,
            armature=0.05, damping=0.0, max_velocity=20.0, **drv,
        )

    shanks = {}
    for name, sx, sy in _LEGS:
        # shank length chosen so the feet TOUCH the ground at the spawn
        # pose (base 0.62 m, defaultJointAngles): with 0.32 the feet hung
        # 6 cm in the air, the robot free-fell at every reset and crossed
        # the 0.51 m fall termination before soft contacts could catch it
        foot = np.array([0.0, 0.0, -0.386])
        g = BodyGeoms(1100.0).capsule((0, 0, 0), foot, 0.03)
        g.sphere(foot, 0.035)
        m, com, I = g.finalize()
        shank = b.add_body(
            f"{name}_KFE", parent=thighs[name], joint_type=JointType.REVOLUTE,
            joint_axis=(0, 1, 0), joint_pos=(0.0, 0.03 * sy, -0.25),
            limit=(-2.5, 2.5), default_q=_default_kfe(sx),
            mass=m, com=com, inertia=I,
            armature=0.05, damping=0.0, max_velocity=20.0, **drv,
        )
        b.add_sphere_collider(shank, foot, 0.035)
        # knee contact point (terrain task knee-contact termination,
        # reference tasks/anymal_terrain.py:359-367)
        b.add_sphere_collider(shank, (0.0, 0.0, 0.0), 0.04)
        b.add_force_sensor(shank)
        shanks[name] = shank

    if dual_foot_contacts:
        # secondary foot points LAST so their indices are ncp-4..ncp-1
        foot = np.array([0.0, 0.0, -0.386])
        for name, sx, sy in _LEGS:
            b.add_sphere_collider(shanks[name], foot, 0.035)

    return b.finalize(device)
