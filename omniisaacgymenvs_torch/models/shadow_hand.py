"""Shadow Dexterous Hand (24 dof, 20 actuated) + cube object scene (PyTorch
port of the JAX package's `models/shadow_hand.py`).

2 wrist + 4x4 finger + LFJ4 + 5 thumb joints; drive stiffness 1 N m/rad on
the fingers and 5 on the wrist, damping 0.1 / 0.5, per-joint effort caps;
gravity is compensated on every hand link. The hand is palm-up with the
fingers along +y. The four distal J0 joints carry no drive: fixed tendons
couple them to J1 at the force level (limit stiffness 30, damping 0.1), so
a free J0 under contact load deflects against the tendon spring. The
object is a 65 mm block of 0.07087 kg. Bodies are inserted breadth-first.
"""

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

OBJECT_SIZE = 0.065          # block edge length (scale 1.0)
OBJECT_MASS = 0.07087        # reference in_hand_manipulation.py:121

PALM_POS = np.array([0.0, 0.0, 0.49])       # palm center, palm-up
OBJECT_START = (0.0, 0.01, 0.545)           # block resting above the palm
GOAL_POS = (0.0, 0.01, 0.505)               # object_init + (0,0,-0.04)

_FR = 0.0085   # finger capsule radius
_SEG = dict(proximal=0.045, middle=0.025, distal=0.026)
_FINGERS = [("FF", 0.033), ("MF", 0.011), ("RF", -0.011), ("LF", -0.033)]

_W = dict(stiffness=5.0, drive_damping=0.5)
_F = dict(stiffness=1.0, drive_damping=0.1)

# actuated joint names in the reference's order
ACTUATED_JOINT_NAMES = (
    "WRJ1", "WRJ0",
    "FFJ3", "FFJ2", "FFJ1",
    "MFJ3", "MFJ2", "MFJ1",
    "RFJ3", "RFJ2", "RFJ1", "LFJ4",
    "LFJ3", "LFJ2", "LFJ1",
    "THJ4", "THJ3", "THJ2", "THJ1", "THJ0",
)
# distal joints tendon-coupled to their J1 (reference fixed tendons,
# views/shadow_hand_view.py:71-73) — force-level, NOT target mirroring
COUPLED = {"FFJ0": "FFJ1", "MFJ0": "MFJ1", "RFJ0": "RFJ1", "LFJ0": "LFJ1"}
TENDON_LIMIT_STIFFNESS = 30.0   # reference limit_stiffness
TENDON_DAMPING = 0.1            # reference damping
# undriven distal joints (tendon-coupled)
_J0 = dict(stiffness=0.0, drive_damping=0.0)

FINGERTIP_BODIES = ("FFJ0", "MFJ0", "RFJ0", "LFJ0", "THJ0")


def _seg_inertial(length, r=_FR, density=800.0):
    return BodyGeoms(density).capsule((0, 0, 0), (0, length, 0), r).finalize()


def build_shadow_hand(self_collisions: bool = False, device="cpu"):
    """self_collisions: enable intra-hand collision (reference
    cfg/task/ShadowHand.yaml:93 enable_self_collisions: True for the hand
    actor). Finger capsules become same-tree receiver surfaces; candidate
    pairs exclude directly-jointed links (PhysX adjacency filter). Off by
    default here: it multiplies the pairwise-contact count ~6x (see
    docs/performance.md) and the fingers' joint limits already prevent
    most interpenetration."""
    b = ModelBuilder("ShadowHand")
    gc = dict(gravity_comp=True)
    sc = dict(receive_self=self_collisions)

    forearm = b.add_body(
        "forearm", parent=-1, joint_type=JointType.FIXED,
        joint_pos=tuple(PALM_POS - np.array([0, 0, 0.09])),
        mass=1.0, inertia=(0.01, 0.01, 0.01), **gc,
    )
    # wrist: WRJ1 (flex about x), WRJ0 (deviation about y) -> palm
    wr1 = b.add_body(
        "WRJ1", parent=forearm, joint_type=JointType.REVOLUTE,
        joint_axis=(1, 0, 0), joint_pos=(0, 0, 0.055),
        limit=(-0.489, 0.14), mass=0.05, inertia=(2e-5,) * 3,
        max_effort=4.785, max_velocity=20.0, armature=2e-3, **_W, **gc,
    )
    m, com, I = BodyGeoms(900.0).box((0, 0.01, 0), (0.045, 0.05, 0.012)).finalize()
    palm = b.add_body(
        "WRJ0", parent=wr1, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 1, 0), joint_pos=(0, 0, 0.035),
        limit=(-0.698, 0.489), mass=m, com=com, inertia=I,
        max_effort=2.175, max_velocity=20.0, armature=2e-3, **_W, **gc,
    )
    b.add_box_collider(palm, (0, 0.01, 0), (0.045, 0.05, 0.012), receive=True)

    fkw = dict(max_velocity=20.0, armature=5e-4, damping=0.01)

    # ---- level 3: knuckle abduction (J3 / LFJ4 / THJ4) ----
    knuckles = {}
    for name, x in _FINGERS:
        if name == "LF":
            # pinky metacarpal (LFJ4) precedes its knuckle chain
            knuckles["LF4"] = b.add_body(
                "LFJ4", parent=palm, joint_type=JointType.REVOLUTE,
                joint_axis=(1, 0, 0), joint_pos=(x, 0.03, 0),
                limit=(0.0, 0.785), mass=0.02, inertia=(4e-6,) * 3,
                max_effort=0.9, **_F, **fkw, **gc,
            )
        else:
            knuckles[name] = b.add_body(
                f"{name}J3", parent=palm, joint_type=JointType.REVOLUTE,
                joint_axis=(0, 0, 1), joint_pos=(x, 0.06, 0.005),
                limit=(-0.349, 0.349), mass=0.008, inertia=(2e-6,) * 3,
                max_effort=0.9, **_F, **fkw, **gc,
            )
    th_base = b.add_body(
        "THJ4", parent=palm, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 0, 1), joint_pos=(0.034, -0.01, -0.005),
        limit=(-1.047, 1.047), mass=0.01, inertia=(3e-6,) * 3,
        max_effort=2.3722, **_F, **fkw, **gc,
    )

    # ---- level 4: proximal flex (J2 / LFJ3 / THJ3) ----
    proximal = {}
    for name, x in _FINGERS:
        if name == "LF":
            proximal["LF_knuckle"] = b.add_body(
                "LFJ3", parent=knuckles["LF4"], joint_type=JointType.REVOLUTE,
                joint_axis=(0, 0, 1), joint_pos=(0, 0.03, 0.005),
                limit=(-0.349, 0.349), mass=0.008, inertia=(2e-6,) * 3,
                max_effort=0.9, **_F, **fkw, **gc,
            )
        else:
            mm, com, I = _seg_inertial(_SEG["proximal"])
            proximal[name] = b.add_body(
                f"{name}J2", parent=knuckles[name],
                joint_type=JointType.REVOLUTE, joint_axis=(1, 0, 0),
                limit=(0.0, 1.571), mass=mm, com=com, inertia=I,
                max_effort=0.9, **_F, **fkw, **gc,
            )
            b.add_capsule_collider(
                proximal[name], (0, 0, 0), (0, _SEG["proximal"], 0), _FR,
                **sc,
            )
    mm, com, I = _seg_inertial(0.038)
    th3 = b.add_body(
        "THJ3", parent=th_base, joint_type=JointType.REVOLUTE,
        joint_axis=(1, 0, 0), joint_pos=(0.005, 0.01, 0),
        limit=(0.0, 1.222), mass=mm, com=com, inertia=I,
        max_effort=1.45, **_F, **fkw, **gc,
    )
    b.add_capsule_collider(th3, (0, 0, 0), (0, 0.038, 0), 0.011, **sc)

    # ---- level 5: middle (J1 / LFJ2 / THJ2) ----
    middle = {}
    for name, x in _FINGERS:
        if name == "LF":
            mm, com, I = _seg_inertial(_SEG["proximal"])
            middle["LF_prox"] = b.add_body(
                "LFJ2", parent=proximal["LF_knuckle"],
                joint_type=JointType.REVOLUTE, joint_axis=(1, 0, 0),
                limit=(0.0, 1.571), mass=mm, com=com, inertia=I,
                max_effort=0.9, **_F, **fkw, **gc,
            )
            b.add_capsule_collider(
                middle["LF_prox"], (0, 0, 0), (0, _SEG["proximal"], 0), _FR,
                **sc,
            )
        else:
            mm, com, I = _seg_inertial(_SEG["middle"])
            middle[name] = b.add_body(
                f"{name}J1", parent=proximal[name],
                joint_type=JointType.REVOLUTE, joint_axis=(1, 0, 0),
                joint_pos=(0, _SEG["proximal"], 0),
                limit=(0.0, 1.571), mass=mm, com=com, inertia=I,
                max_effort=0.7245, **_F, **fkw, **gc,
            )
            b.add_capsule_collider(
                middle[name], (0, 0, 0), (0, _SEG["middle"], 0), _FR, **sc
            )
    mm, com, I = _seg_inertial(0.032)
    th2 = b.add_body(
        "THJ2", parent=th3, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 1, 0), joint_pos=(0, 0.038, 0),
        limit=(-0.209, 0.209), mass=mm, com=com, inertia=I,
        max_effort=0.99, **_F, **fkw, **gc,
    )
    b.add_capsule_collider(th2, (0, 0, 0), (0, 0.032, 0), 0.010, **sc)

    # ---- level 6: distal (J0 coupled / LFJ1 / THJ1) ----
    tips = {}
    for name, x in _FINGERS:
        if name == "LF":
            mm, com, I = _seg_inertial(_SEG["middle"])
            tips["LF_mid"] = b.add_body(
                "LFJ1", parent=middle["LF_prox"],
                joint_type=JointType.REVOLUTE, joint_axis=(1, 0, 0),
                joint_pos=(0, _SEG["proximal"], 0),
                limit=(0.0, 1.571), mass=mm, com=com, inertia=I,
                max_effort=0.7245, **_F, **fkw, **gc,
            )
            b.add_capsule_collider(
                tips["LF_mid"], (0, 0, 0), (0, _SEG["middle"], 0), _FR, **sc
            )
        else:
            mm, com, I = _seg_inertial(_SEG["distal"])
            tip = b.add_body(
                f"{name}J0", parent=middle[name],
                joint_type=JointType.REVOLUTE, joint_axis=(1, 0, 0),
                joint_pos=(0, _SEG["middle"], 0),
                limit=(0.0, 1.571), mass=mm, com=com, inertia=I,
                max_effort=0.7245, **_J0, **fkw, **gc,
            )
            b.add_capsule_collider(
                tip, (0, 0, 0), (0, _SEG["distal"], 0), _FR, n_extra=1, **sc
            )
            b.add_force_sensor(tip)
            tips[name] = tip
    mm, com, I = _seg_inertial(0.0275)
    th1 = b.add_body(
        "THJ1", parent=th2, joint_type=JointType.REVOLUTE,
        joint_axis=(1, 0, 0), joint_pos=(0, 0.032, 0),
        limit=(-0.524, 0.524), mass=mm, com=com, inertia=I,
        max_effort=0.99, **_F, **fkw, **gc,
    )

    # ---- level 7: pinky distal + thumb tip ----
    mm, com, I = _seg_inertial(_SEG["distal"])
    lf_tip = b.add_body(
        "LFJ0", parent=tips["LF_mid"], joint_type=JointType.REVOLUTE,
        joint_axis=(1, 0, 0), joint_pos=(0, _SEG["middle"], 0),
        limit=(0.0, 1.571), mass=mm, com=com, inertia=I,
        max_effort=0.7245, **_J0, **fkw, **gc,
    )
    b.add_capsule_collider(lf_tip, (0, 0, 0), (0, _SEG["distal"], 0), _FR,
                           n_extra=1, **sc)
    b.add_force_sensor(lf_tip)
    mm, com, I = _seg_inertial(0.0275)
    th_tip = b.add_body(
        "THJ0", parent=th1, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 1, 0), joint_pos=(0, 0.0275, 0),
        limit=(-1.571, 0.0), mass=mm, com=com, inertia=I,
        max_effort=0.81, **_F, **fkw, **gc,
    )
    b.add_capsule_collider(th_tip, (0, 0, 0), (0, 0.0275, 0), 0.010,
                           n_extra=1, **sc)
    b.add_force_sensor(th_tip)

    if self_collisions:
        b.enable_self_collisions(forearm)

    # ---- fixed tendons: J0 follows J1 on the four fingers ----
    for follower, leader in COUPLED.items():
        b.add_fixed_tendon(
            leader, follower, coef=(1.0, -1.0),
            damping=TENDON_DAMPING,
            limit_stiffness=TENDON_LIMIT_STIFFNESS,
        )

    # ---- object: free 65 mm block ----
    h = OBJECT_SIZE / 2.0
    obj_inertia = OBJECT_MASS * (2 * h) ** 2 / 6.0
    obj = b.add_body(
        "object", parent=-1, joint_type=JointType.FREE,
        mass=OBJECT_MASS, inertia=(obj_inertia,) * 3,
        default_pos=OBJECT_START,
    )
    b.add_box_collider(obj, (0, 0, 0), (h, h, h), receive=True, friction=1.0, dense=True)

    return b.finalize(device)
