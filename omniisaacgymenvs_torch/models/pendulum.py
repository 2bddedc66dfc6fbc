"""Analytic-test articulations: single and double pendulum (PyTorch port of
the JAX package's `models/pendulum.py`), the dynamics tests' counterpart of
the importer tests."""

from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder


def build_pendulum(mass: float = 1.0, length: float = 1.0,
                   inertia_com: float = 0.0, device="cpu"):
    """Point-mass (inertia_com=0 -> tiny) pendulum hanging about the +y
    axis; q=0 is straight down (stable)."""
    b = ModelBuilder("Pendulum")
    base = b.add_body(
        "base", parent=-1, joint_type=JointType.FIXED,
        joint_pos=(0.0, 0.0, 2.0), mass=1.0,
    )
    b.add_body(
        "hinge",
        parent=base,
        joint_type=JointType.REVOLUTE,
        joint_axis=(0.0, 1.0, 0.0),
        mass=mass,
        com=(0.0, 0.0, -length),
        inertia=(max(inertia_com, 1e-6),) * 3,
    )
    return b.finalize(device)


def build_double_pendulum(m1=1.0, m2=1.0, l1=0.5, l2=0.5, device="cpu"):
    """Two-link planar pendulum (rods with distributed mass)."""
    b = ModelBuilder("DoublePendulum")
    base = b.add_body(
        "base", parent=-1, joint_type=JointType.FIXED,
        joint_pos=(0.0, 0.0, 2.0), mass=1.0,
    )
    i1 = m1 * l1 * l1 / 12.0
    link1 = b.add_body(
        "hinge1", parent=base, joint_type=JointType.REVOLUTE,
        joint_axis=(0.0, 1.0, 0.0), mass=m1,
        com=(0.0, 0.0, -l1 / 2), inertia=(i1, i1, 1e-6),
    )
    i2 = m2 * l2 * l2 / 12.0
    b.add_body(
        "hinge2", parent=link1, joint_type=JointType.REVOLUTE,
        joint_axis=(0.0, 1.0, 0.0), joint_pos=(0.0, 0.0, -l1),
        mass=m2, com=(0.0, 0.0, -l2 / 2), inertia=(i2, i2, 1e-6),
    )
    return b.finalize(device)
