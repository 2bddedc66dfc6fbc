"""Balance-bot tray + free ball (BallBalance scene; PyTorch port of the JAX
package's `models/balance_bot.py`).

The three-leg mechanism is a loop-free serial tripod: fixed base ->
prismatic lift -> tilt-x -> tilt-y tray, with three position-target
actions raising and tilting the tray. The tray carries a receiver box
surface for the ball's pair contacts and a force sensor.
"""

from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

TRAY_HEIGHT = 0.56
BALL_RADIUS = 0.1


def build_balance_bot(device="cpu"):
    b = ModelBuilder("BallBalance")
    base = b.add_body(
        "base", parent=-1, joint_type=JointType.FIXED,
        mass=5.0, inertia=(0.1, 0.1, 0.1),
    )
    # static tripod feet (visual/contact only)
    for lx, ly in ((0.4, 0.0), (-0.2, 0.34641), (-0.2, -0.34641)):
        b.add_sphere_collider(base, (lx, ly, 0.03), 0.03)

    lift = b.add_body(
        "lift", parent=base, joint_type=JointType.PRISMATIC,
        joint_axis=(0, 0, 1), joint_pos=(0, 0, TRAY_HEIGHT),
        limit=(-0.15, 0.15), mass=0.2, inertia=(1e-3,) * 3,
        stiffness=400.0, drive_damping=40.0, max_effort=200.0,
        armature=0.01, max_velocity=5.0,
    )
    tilt_x = b.add_body(
        "tilt_x", parent=lift, joint_type=JointType.REVOLUTE,
        joint_axis=(1, 0, 0), limit=(-0.5, 0.5),
        mass=0.1, inertia=(5e-4,) * 3,
        stiffness=100.0, drive_damping=10.0, max_effort=100.0,
        armature=0.01, max_velocity=10.0,
    )
    tray = b.add_body(
        "tray", parent=tilt_x, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 1, 0), limit=(-0.5, 0.5),
        mass=1.5, com=(0, 0, 0), inertia=(0.08, 0.08, 0.16),
        stiffness=100.0, drive_damping=10.0, max_effort=100.0,
        armature=0.01, max_velocity=10.0,
    )
    b.add_box_collider(tray, (0, 0, 0), (0.45, 0.45, 0.02), receive=True)
    b.add_force_sensor(tray)

    ball = b.add_body(
        "ball", parent=-1, joint_type=JointType.FREE,
        mass=0.5, inertia=(0.002, 0.002, 0.002),
        default_pos=(0.0, 0.0, 1.0),
    )
    b.add_sphere_collider(ball, (0, 0, 0), BALL_RADIUS)
    return b.finalize(device)
