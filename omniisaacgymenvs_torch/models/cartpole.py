"""Cartpole articulation: fixed rail, prismatic cart, revolute pole
(PyTorch port of the JAX package's `models/cartpole.py`).

Dof names cartJoint / poleJoint; the rail is mounted at z = 2. The task
drives the cart dof by effort.
"""

from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder


def build_cartpole(
    cart_mass: float = 1.0,
    pole_mass: float = 1.0,
    pole_half_length: float = 0.5,
    base_height: float = 2.0,
    device="cpu",
):
    b = ModelBuilder("Cartpole")
    rail = b.add_body(
        "rail",
        parent=-1,
        joint_type=JointType.FIXED,
        joint_pos=(0.0, 0.0, base_height),
        mass=10.0,
        inertia=(0.1, 0.1, 0.1),
    )
    cart = b.add_body(
        "cartJoint",
        parent=rail,
        joint_type=JointType.PRISMATIC,
        joint_axis=(1.0, 0.0, 0.0),
        mass=cart_mass,
        inertia=(0.01, 0.01, 0.01),
        limit=(-5.0, 5.0),
    )
    # pole: hinge about +y at the cart origin; +z along the pole (upright at
    # q=0, unstable equilibrium); positive q tips the pole toward +x.
    l = pole_half_length
    rod_inertia = pole_mass * (2 * l) ** 2 / 12.0
    b.add_body(
        "poleJoint",
        parent=cart,
        joint_type=JointType.REVOLUTE,
        joint_axis=(0.0, 1.0, 0.0),
        mass=pole_mass,
        com=(0.0, 0.0, l),
        inertia=(rod_inertia, rod_inertia, 1e-5),
        limit=(-4.0 * 3.14159265, 4.0 * 3.14159265),
    )
    return b.finalize(device)
