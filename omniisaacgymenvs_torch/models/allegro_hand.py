"""Allegro Hand (16 dofs, all actuated) + cube scene (PyTorch port of the
JAX package's `models/allegro_hand.py`).

Four fingers of [abduction + 3 flexion], no tendons and no force sensors;
every hand body is gravity-compensated. The hand is authored palm-up with
the fingers along +y, dofs breadth-first [abductions x 4, then the flexion
levels]. The palm is tilted so that gravity presses the cube into the
pocket between the tilted palm, the flexed thumb on the downhill side and
the finger shelf. The cube carries a dense box collider (26 points) against
the palm's box and its own box surface. `build_allegro_hand(scene)` takes
the authoring knobs (tilt, thumb rest pose, finger curl, spawn offset);
the defaults are the cradle scene the task uses.
"""

import numpy as np

from omniisaacgymenvs_torch.models.common import BodyGeoms
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

OBJECT_SIZE = 0.065
OBJECT_MASS = 0.07087
PALM_POS = np.array([0.0, 0.0, 0.47])

_FR = 0.012
_SEGS = (0.054, 0.0384, 0.0437)
_FINGERS = [("index", 0.045), ("middle", 0.0), ("pinky", -0.045)]

_DRIVE = dict(stiffness=3.0, drive_damping=0.1, max_effort=0.7,
              max_velocity=20.0, armature=5e-4, damping=0.01)

FINGERTIP_BODIES = ("index_tip", "middle_tip", "pinky_tip", "thumb_tip")

# The cradle scene: the palm tilted about the finger axis so the thumb side
# (+x) is downhill, the thumb half-abducted and base-flexed so its raised
# segments wall the downhill edge, the fingers slightly curled, the cube
# spawned over the downhill half of the palm.
DEFAULT_SCENE = dict(
    tilt=(-0.15, 0.3),           # (roll about x, pitch about y) radians
    thumb_abduct=0.35,           # thumb_abduct default_q
    thumb_flex=(1.1, 0.4, 0.3),  # thumb flex1/flex2/tip default_q
    finger_curl=(0.65, 0.7, 0.35),  # finger flex1/flex2/tip default_q
    object_local=(0.015, 0.035, 0.052),  # cube spawn, palm frame
)


def _rot_xy(roll: float, pitch: float) -> np.ndarray:
    """R = R_y(pitch) @ R_x(roll). R_y(+pitch) drops the +x (thumb) side."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    return ry @ rx


def _quat_from_mat(R: np.ndarray) -> tuple:
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return (w, x, y, z)


def scene_frames(scene=None):
    """(R, object_start, goal_pos) in the world frame for a scene dict."""
    s = dict(DEFAULT_SCENE, **(scene or {}))
    R = _rot_xy(*s["tilt"])
    obj = PALM_POS + R @ np.asarray(s["object_local"])
    goal = obj + np.array([0.0, 0.0, -0.04])
    return R, tuple(obj), tuple(goal)


def build_allegro_hand(scene=None, device="cpu"):
    s = dict(DEFAULT_SCENE, **(scene or {}))
    R, object_start, _ = scene_frames(s)
    root_quat = _quat_from_mat(R)

    b = ModelBuilder("AllegroHand")
    gc = dict(gravity_comp=True)
    m, com, I = BodyGeoms(900.0).box((0, 0, 0), (0.05, 0.06, 0.015)).finalize()
    palm = b.add_body(
        "palm", parent=-1, joint_type=JointType.FIXED,
        joint_pos=tuple(PALM_POS), joint_quat=root_quat,
        mass=m, com=com, inertia=I, **gc,
    )
    b.add_box_collider(palm, (0, 0, 0), (0.05, 0.06, 0.015), receive=True)

    # level 1: abductions (3 fingers about z) + thumb base rotation
    bases = {}
    for name, x in _FINGERS:
        bases[name] = b.add_body(
            f"{name}_abduct", parent=palm, joint_type=JointType.REVOLUTE,
            joint_axis=(0, 0, 1), joint_pos=(x, 0.07, 0.005),
            limit=(-0.47, 0.47), mass=0.02, inertia=(4e-6,) * 3,
            **_DRIVE, **gc,
        )
    # the thumb rests half-abducted with its base flexed: its raised
    # proximal segment walls the downhill (+x) palm edge
    bases["thumb"] = b.add_body(
        "thumb_abduct", parent=palm, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 0, 1), joint_pos=(0.05, -0.02, -0.005),
        limit=(0.263, 1.396), default_q=s["thumb_abduct"],
        mass=0.03, inertia=(6e-6,) * 3, **_DRIVE, **gc,
    )

    # levels 2-4: three flexion joints per finger
    names = ["index", "middle", "pinky", "thumb"]
    prev = dict(bases)
    for level, seg_len in enumerate(_SEGS):
        for name in names:
            mm, com, I = _seg(seg_len)
            dq = (s["thumb_flex"] if name == "thumb"
                  else s["finger_curl"])[level]
            kwargs = dict(
                joint_axis=(1, 0, 0),
                joint_pos=(0, _SEGS[level - 1], 0) if level else (0, 0.01, 0),
                limit=(-0.196, 1.61) if name != "thumb" else (-0.105, 1.163),
                mass=mm, com=com, inertia=I, default_q=dq,
            )
            suffix = "tip" if level == 2 else f"flex{level}"
            body = b.add_body(
                f"{name}_{suffix}", parent=prev[name],
                joint_type=JointType.REVOLUTE, **kwargs, **_DRIVE, **gc,
            )
            n_extra = 1 if level == 2 else 0
            b.add_capsule_collider(body, (0, 0, 0), (0, seg_len, 0), _FR,
                                   n_extra=n_extra)
            prev[name] = body

    # object block
    h = OBJECT_SIZE / 2.0
    obj_inertia = OBJECT_MASS * (2 * h) ** 2 / 6.0
    obj = b.add_body(
        "object", parent=-1, joint_type=JointType.FREE,
        mass=OBJECT_MASS, inertia=(obj_inertia,) * 3,
        default_pos=object_start,
    )
    b.add_box_collider(obj, (0, 0, 0), (h, h, h), receive=True, dense=True)
    return b.finalize(device)


def _seg(length, r=_FR, density=600.0):
    return BodyGeoms(density).capsule((0, 0, 0), (0, length, 0), r).finalize()
