"""Flyer models: Ingenuity, Quadcopter, Crazyflie (PyTorch port of the JAX
package's `models/flyers.py`).

Ingenuity is the coaxial two-rotor Mars helicopter, Quadcopter an 8-dof
thrust-vectoring quadcopter, Crazyflie the CF2X nano quadcopter. Rotors
are bodies of their own, so the tasks' thrusts apply at the rotors' lever
arms (at each rotor body's origin, through `RigidPrimView.apply_forces`).
"""

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms, deg
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder


def build_ingenuity(spawn_height: float = 1.0, device="cpu"):
    """Root fuselage + 2 coaxial rotor bodies (revolute z, free-spinning)."""
    b = ModelBuilder("Ingenuity")
    g = BodyGeoms(300.0).sphere((0, 0, 0), 0.12)
    g.box((0, 0, -0.15), (0.03, 0.03, 0.1))  # legs block
    m, com, I = g.finalize()
    root = b.add_body("body", parent=-1, joint_type=JointType.FREE,
                      mass=m, com=com, inertia=I)
    b.set_root_default(pos=(0, 0, spawn_height))
    for i, h in enumerate((0.2, 0.3)):
        # rotor disc: a thin cylinder's inertia as a flat box's
        mr, comr, Ir = BodyGeoms(40.0).box((0, 0, 0), (0.6, 0.03, 0.005)).finalize()
        b.add_body(
            f"rotor_physics_{i}", parent=root, joint_type=JointType.REVOLUTE,
            joint_axis=(0, 0, 1), joint_pos=(0, 0, h),
            mass=mr, com=comr, inertia=Ir,
            damping=0.02, max_velocity=100.0,
        )
    return b.finalize(device)


def build_quadcopter(spawn_height: float = 1.0, device="cpu"):
    """Root chassis + 4 arms, each a 2-dof gimbal (thrust vectoring) ending
    in a rotor body: 8 dofs, the task's 8 dof-position actions. A rotor's
    centre of mass sits 0.08 m out along its arm from its origin."""
    b = ModelBuilder("Quadcopter")
    m, com, I = BodyGeoms(500.0).box((0, 0, 0), (0.08, 0.08, 0.02)).finalize()
    root = b.add_body("chassis", parent=-1, joint_type=JointType.FREE,
                      mass=m, com=com, inertia=I)
    b.set_root_default(pos=(0, 0, spawn_height))
    drive = dict(stiffness=1.0, drive_damping=0.1, max_effort=5.0)
    arms = []
    for i, (sx, sy) in enumerate([(1, 1), (-1, 1), (-1, -1), (1, -1)]):
        d = np.array([sx, sy, 0.0]) / np.sqrt(2.0)
        pivot = 0.12 * d
        arm = b.add_body(
            f"rotor_arm_{i}", parent=root, joint_type=JointType.REVOLUTE,
            joint_axis=(-sy / np.sqrt(2), sx / np.sqrt(2), 0.0),  # tangential
            joint_pos=pivot, limit=(deg(-30), deg(30)),
            mass=0.01, inertia=(1e-5, 1e-5, 1e-5),
            armature=1e-4, damping=0.005, max_velocity=50.0, **drive,
        )
        arms.append((arm, d))
    for i, (arm, d) in enumerate(arms):
        mr, comr, Ir = BodyGeoms(200.0).sphere(0.08 * d, 0.035).finalize()
        b.add_body(
            f"rotor_{i}", parent=arm, joint_type=JointType.REVOLUTE,
            joint_axis=(d[0], d[1], 0.0),  # radial tilt axis
            joint_pos=(0, 0, 0), limit=(deg(-30), deg(30)),
            mass=mr, com=comr, inertia=Ir,
            armature=1e-4, damping=0.005, max_velocity=50.0, **drive,
        )
    return b.finalize(device)


def build_crazyflie(spawn_height: float = 1.0, device="cpu"):
    """CF2X: 0.028 kg body + 4 rotor bodies on 0.0325 m arms."""
    b = ModelBuilder("Crazyflie")
    m, com, I = BodyGeoms(800.0).box((0, 0, 0), (0.015, 0.015, 0.01)).finalize()
    root = b.add_body("body", parent=-1, joint_type=JointType.FREE,
                      mass=m, com=com, inertia=I)
    b.set_root_default(pos=(0, 0, spawn_height))
    for i, (sx, sy) in enumerate([(1, -1), (-1, -1), (-1, 1), (1, 1)]):
        pos = np.array([0.0325 * sx, 0.0325 * sy, 0.012])
        b.add_body(
            f"m{i + 1}_prop", parent=root, joint_type=JointType.REVOLUTE,
            joint_axis=(0, 0, 1), joint_pos=pos,
            mass=0.0008, inertia=(2e-7, 2e-7, 4e-7),
            damping=1e-6, max_velocity=500.0,
        )
    return b.finalize(device)
