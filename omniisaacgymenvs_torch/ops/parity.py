"""Holding the kernels against their plain versions: the check states, the
tolerances and the comparison, shared by `chip_smoke.py`, the tolerance
controls (`scripts/tolerance_controls.py`) and the card tests.

An output element passes when

    |kernel - plain| <= atol + rtol * |plain| + scale * max_env |plain|

where max_env is the largest magnitude of that output within the same env
(a contact force is judged against that env's forces, not against the
deepest contact of the whole batch). `tolerance_use` is the largest ratio
of the error to that limit: below 1 passes.
"""

from __future__ import annotations

import numpy as np
import torch

STEP_NAMES = ("q", "qd", "sensor_forces", "body_pos", "body_quat",
              "body_avel", "body_lvel")
FK_NAMES = ("body_pos", "body_quat", "body_avel", "body_lvel")

# (rtol, scale, atol) per output. K1: float32 in another operation order
# over 4 substeps with stiff contacts. Each limit sits between the largest
# error of the sound build and the reading of a broken control: the
# velocities' limits refuse a --use_fast_math build, and every output
# refuses a dropped substep or a 0.1% gain error (readings from
# scripts/tolerance_controls.py in PERF.md, Findings). A contact force
# errs by the point gain times the position error whatever the force's
# size: 5.5e4 N/m (the stiffest point) times 2e-5 m (twice the sound
# runs' largest q error) gives the sensor forces' 1 N floor.
STEP_TOL = {"q": (1e-3, 1e-4, 0.0), "qd": (2e-3, 4e-4, 0.0),
            "sensor_forces": (1e-3, 5e-4, 1.0), "body_pos": (1e-3, 1e-4, 0.0),
            "body_quat": (1e-3, 1e-3, 0.0), "body_avel": (2e-3, 4e-4, 0.0),
            "body_lvel": (2e-3, 4e-4, 0.0)}
# K2: one FK pass; Shepperd's small quaternion components round at about
# sqrt(float32 eps) of their size
FK_TOL = {"body_pos": (1e-4, 1e-5, 0.0), "body_quat": (0.0, 1e-3, 0.0),
          "body_avel": (1e-4, 1e-5, 0.0), "body_lvel": (1e-4, 1e-5, 0.0)}

# The ShadowHand scene (8 substeps, fingers of a few grams, the cube's 26
# points sticking and slipping on the palm) spreads its velocities three
# times as far: the sound build read up to 1.37 of the limits above on qd
# and body_avel, and so did a --use_fast_math build (1.11), while a dropped
# substep, a dropped pair, a box 1 mm larger or tendons 0.1% stiffer read
# 639 and more (scripts/tolerance_controls.py task=ShadowHand, PERF.md).
# Its velocity limits sit between the two, at three times the above; they
# do not tell a fast-math build from a sound one, the Humanoid's do.
_WIDE = (6e-3, 1.2e-3, 0.0)
STEP_TOL_BY_MODEL = {
    "ShadowHand": {**STEP_TOL, "qd": _WIDE, "body_avel": _WIDE},
}


# AnymalTerrain on its terrain planes stays within the default limits: the
# sound build read at most 0.38 over one substep and 0.67 over four on the
# same planes, a plane offset 1 mm high, one point's normals set vertical or
# planes shifted by one env 412 and more, a 0.1% gain error 3.4
# (scripts/tolerance_controls.py task=AnymalTerrain, PERF.md).


def step_tol(model) -> dict:
    """K1's tolerances for `model`."""
    return STEP_TOL_BY_MODEL.get(model.name, STEP_TOL)


# K3: one substep (a fraction of K1's drift) and no report; every model's
# sound build stays below 0.1 of K1's limits, and a tendon 0.1% stiffer
# reads 2.0 on the ShadowHand
SUBSTEP_NAMES = ("q", "qd", "sensor_forces")
SUBSTEP_TOL = {k: STEP_TOL[k] for k in SUBSTEP_NAMES}

# the check states lower every FREE root by up to this much (m): Humanoid
# feet press into the ground about as deep as in a standing rollout's first
# steps
CHECK_DROP = 0.1

# How the check states of a model are drawn (`check_inputs`), by model name:
# joint and FREE-root jitter, velocity scale, how far the FREE roots are
# lowered (uniform in [drop_min, drop]), the range of the efforts and of the
# position targets about the joint coordinates. `anchors`: root positions
# the first FREE root cycles through, env by env, instead of default_q's.
# `roots`: the position of every FREE root, in order, instead of
# default_q's. A profile under "<name>/<bodies>" takes precedence over the
# model name's.
# `curl`: joint angles (by dof name, jittered by `joint`) that every other
# env takes instead of its draw.
_DEFAULT_PROFILE = dict(joint=0.05, root_pos=0.05, root_rot=0.05, vel=0.3,
                        drop_min=0.0, drop=CHECK_DROP, effort=40.0,
                        target=0.1, anchors=None, curl=None, roots=None)
CHECK_PROFILES = {
    # the cube 1 cm above the palm at default_q: tilted by some 15 degrees
    # and lowered onto and up to 1 cm into it (corners), less than the palm's half
    # thickness of 1.2 cm, where the nearest face changes; efforts within
    # the fingers' caps. In every other env the middle and ring fingers curl
    # onto the cube's side, so their tips' force sensors read a contact
    # (those two sit 2 cm from the cube's other faces; the first finger
    # would press at an edge, where the nearest face changes)
    "ShadowHand": dict(joint=0.1, root_pos=0.002, root_rot=0.15, drop=0.01,
                       effort=0.5, target=0.3,
                       curl={"MFJ2": 1.1, "MFJ1": 0.9, "MFJ0": 0.3,
                             "RFJ2": 1.1, "RFJ1": 0.9, "RFJ0": 0.3}),
    # the ball rests on the tray at z = 0.68 and spawns at 1.0
    "BallBalance": dict(drop_min=0.28, drop=0.35, effort=2.0),
    # the puck over the box, the sphere, the capsule and the arm's capsule
    # (lowered by at most 2 cm: a point deeper in than the surface's half
    # thickness, or near a capsule's axis, meets a true discontinuity of
    # the contact normal, where one ulp decides the direction of the force)
    "PairScene": dict(root_pos=0.005, root_rot=0.2, drop=0.02, effort=1.0,
                      anchors=((0.0, 0.0, 0.575), (0.5, 0.0, 0.755),
                               (-0.6, 0.0, 0.705), (0.0, 0.7, 0.705))),
    # every other env holds the drawer's handle bar between the finger
    # pads: the arm's angles put the grasp frame on the bar's axis, gripper
    # forward along the drawer's inward axis and its up along world z (a
    # damped least-squares solve of the plain FK), the fingers closed to
    # 18 mm, so the pads sit up to 4 mm deep in the bar (well off its
    # axis); the props dropped 6-12 mm onto the drawer's tray, less than
    # its half thickness of 1 cm
    "FrankaCabinet": dict(joint=0.002, root_pos=0.003, root_rot=0.02,
                          drop_min=0.006, drop=0.012,
                          curl={"panda_joint1": 1.914, "panda_joint2": -1.3624,
                                "panda_joint3": -0.9355, "panda_joint4": -1.8869,
                                "panda_joint5": -2.2875, "panda_joint6": 2.188,
                                "panda_joint7": -0.6408,
                                "panda_finger_joint1": 0.018,
                                "panda_finger_joint2": 0.018}),
    # the cube 4.5 mm above the tilted palm at default_q, tilted by some 15
    # degrees and lowered by up to 1 cm onto it, less than the palm's half
    # thickness of 1.5 cm; efforts within the fingers' cap of 0.7
    "AllegroHand": dict(joint=0.1, root_pos=0.002, root_rot=0.15, drop=0.01,
                        effort=0.5, target=0.3),
    # examples/double_pendulum.urdf (task=Custom): hanging from its FIXED
    # base the pendulum's lowest corners stay 0.2 m above the ground; with
    # floatingBase the FREE base is lowered by 0.2-0.225 m, so the lower
    # link's box corners sit up to 2.5 cm in the ground
    "double_pendulum": dict(drop_min=0.2, drop=0.225),
    # chip_smoke.py's MJCF chain hangs its foot's sphere and box 1 cm in the
    # ground from a FIXED base; its slide joint moves the foot by its own
    # coordinate, so the jitter stays at 1 cm
    "mjcf_chain": dict(joint=0.01),
    # chip_smoke.py's many-legged MJCF robot (mjcf_legs) stands with its
    # feet's lowest spheres 5 mm in the ground at default_q: lowered by up
    # to 1 cm more, tilted by some 0.6 degrees (its hips sit 0.2 m from the
    # torso's centre), the legs jittered by 0.02 rad
    "many_legs": dict(joint=0.02, root_pos=0.01, root_rot=0.01, drop=0.01),
    # build_wide_tree: its feet 5 mm in the ground at default_q, the same
    "WideTree": dict(joint=0.02, root_pos=0.01, root_rot=0.01, drop=0.01),
}


# FrankaCabinet with 16 props (31 bodies): the task's 4 x 4 grid puts the
# first row 3.5 cm into the drawer's front box and the last row over the
# tray's back edge, points deep in a box whose nearest face decides the
# force: 148 of 512 check states were ill conditioned (`well_conditioned`).
# Its check states set the props on a 2 x 8 grid on the tray instead, 5 mm
# apart, 2.25 cm clear of the front box and of the tray's edge, and drop
# them onto it as the four props are dropped
_DRAWER = (0.8, 0.0, 0.7172)  # the drawer's frame in the world
CHECK_PROFILES["FrankaCabinet/31"] = dict(
    CHECK_PROFILES["FrankaCabinet"],
    roots=tuple((_DRAWER[0] + x, _DRAWER[1] - 0.1925 + 0.055 * k, _DRAWER[2] - 0.01)
                for x in (0.1675, 0.2225) for k in range(8)))


def by_model(table: dict, model, default=None):
    """`table`'s entry for `model`: under "<name>/<bodies>", else under its
    name."""
    own = table.get(f"{model.name}/{getattr(model, 'nb', '')}")
    return table.get(model.name, default) if own is None else own


def check_profile(model) -> dict:
    return {**_DEFAULT_PROFILE, **by_model(CHECK_PROFILES, model, {})}


def perturbed_batch(default_q, jq, lower, upper, nv, rng, N, scale=0.05,
                    vel=0.3, drop=0.0, free_q=(0,), root_pos=None,
                    root_rot=None, drop_min=0.0, anchors=None, roots=None):
    """(q, qd) float32 numpy batch near default_q: joint coords jittered by
    `scale` within limits; every FREE root (its q address in `free_q`)
    jittered in position (`root_pos`, default `scale`) and orientation
    (`root_rot`, default `scale`; renormalized) and lowered by a uniform
    draw from [drop_min, drop]."""
    root_pos = scale if root_pos is None else root_pos
    root_rot = scale if root_rot is None else root_rot
    q = np.tile(np.asarray(default_q, np.float64), (N, 1))
    q[:, jq] += scale * rng.standard_normal((N, len(jq)))
    q[:, jq] = np.clip(q[:, jq], lower, upper)
    for k, qa in enumerate(free_q):
        if roots is not None:
            q[:, qa:qa + 3] = roots[k]
        if k == 0 and anchors is not None:
            q[:, qa:qa + 3] = np.asarray(anchors, np.float64)[
                np.arange(N) % len(anchors)]
        q[:, qa:qa + 3] += root_pos * rng.standard_normal((N, 3))
        q[:, qa + 2] -= rng.uniform(drop_min, max(drop, drop_min), N)
        q[:, qa + 3:qa + 7] += root_rot * rng.standard_normal((N, 4))
        q[:, qa + 3:qa + 7] /= np.linalg.norm(q[:, qa + 3:qa + 7], axis=1,
                                              keepdims=True)
    qd = vel * rng.standard_normal((N, nv))
    return q.astype(np.float32), qd.astype(np.float32)


def _free_q(model):
    return tuple(model.q_adr[r] for r in model.roots if model.jtype[r] == 0)


def check_inputs(model, n: int, seed: int, device, drop: float | None = None):
    """(q, qd, effort) on `device`: states near default_q (perturbed_batch,
    drawn as the model's `check_profile` says; `drop` overrides the
    profile's) and uniform efforts, made from `seed` with numpy."""
    cpu = lambda x: x.detach().cpu().numpy()  # noqa: E731
    pr = check_profile(model)
    rng = np.random.default_rng(seed)
    q, qd = perturbed_batch(
        cpu(model.default_q), model.jq_idx, cpu(model.dof_limit_lower),
        cpu(model.dof_limit_upper), model.nv, rng, n, scale=pr["joint"],
        vel=pr["vel"], drop=pr["drop"] if drop is None else drop,
        free_q=_free_q(model), root_pos=pr["root_pos"],
        root_rot=pr["root_rot"], drop_min=pr["drop_min"],
        anchors=pr["anchors"], roots=pr["roots"])
    eff = rng.uniform(-pr["effort"], pr["effort"],
                      (n, model.njd)).astype(np.float32)
    for name, angle in (pr["curl"] or {}).items():
        d = model.dof_index(name)
        q[1::2, model.jq_idx[d]] = np.clip(
            angle + pr["joint"] * rng.standard_normal(q[1::2].shape[0]),
            cpu(model.dof_limit_lower)[d], cpu(model.dof_limit_upper)[d])
    return tuple(torch.as_tensor(x, device=device) for x in (q, qd, eff))


# terrain check states: the lowest contact point of each env sits this deep
# (m) in its tread, a few millimetres to 2 cm as under a walking robot
TERRAIN_DEPTH = (0.002, 0.02)


def terrain_check_inputs(task, n: int, seed: int, device,
                         depth=TERRAIN_DEPTH):
    """(q, qd, effort) on `device` for a task on terrain (AnymalTerrain):
    `check_inputs` states with the bases spread over every level and type of
    the terrain grid, up to 3.5 m from their cell's centre (stairs, slopes,
    obstacles and stones under the feet), and set down so that each env's
    lowest contact point is `depth` (a range, m) deep in the tread below
    it. Feet beside a riser then meet its wall or its edge."""
    m = task.model
    q, qd, eff = check_inputs(m, n, seed, device, drop=0.0)
    rng = np.random.default_rng(seed + 104729)
    rows, cols = task.terrain.env_rows, task.terrain.env_cols
    cell = np.arange(n) % (rows * cols)
    origin = task._origins[torch.as_tensor(cell // cols, device=device),
                           torch.as_tensor(cell % cols, device=device)]
    t32 = lambda a: torch.as_tensor(a, dtype=q.dtype, device=device)  # noqa: E731
    q[:, 0:2] = origin[:, 0:2] + t32(rng.uniform(-3.5, 3.5, (n, 2)))
    q[:, 2] = 0.0
    pt = task.engine.contact_points(task.engine.init_state(q, qd))
    # how far each point is over its tread with the base at z = 0
    clear = pt[..., 2] - m.cp_radius - task.tread_height(pt[..., 0], pt[..., 1])
    q[:, 2] = -clear.amin(dim=1) - t32(rng.uniform(*depth, n))
    return q.contiguous(), qd, eff


def terrain_contacts(task, engine, q, qd) -> dict:
    """Active ground contacts of the states by the terrain feature their
    plane came from: `tread`, `wall`, `edge`, and `wedge` (a secondary foot
    point on its own-cell tread)."""
    from omniisaacgymenvs_torch.tasks import anymal_terrain as at

    m = engine.model
    pt = engine.contact_points(engine.init_state(q, qd))
    n_, d, kind = task.contact_features(pt, m.cp_radius)
    active = m.cp_radius - ((pt * n_).sum(-1) - d) > 0
    count = lambda ks: int((active & torch.isin(  # noqa: E731
        kind, torch.as_tensor(list(ks), device=q.device))).sum())
    return dict(tread=count([at.TREAD]), wall=count(at.WALLS),
                edge=count(at.EDGES), wedge=count([at.WEDGE_ON]))


# How the check overlays are drawn (`overlay_inputs`), per key: the
# distribution and range of the ShadowHandOpenAI_FF yaml's randomization
# block (log-uniform drive and tendon scales, uniform friction, geometry and
# mass scales, gaussian limit and gravity deltas), here on every body,
# joint and tendon of the model, not only on a view's.
OVERLAY_DRAWS = {
    "damping_scale": ("loguniform", 0.3, 3.0),
    "friction_scale": ("uniform", 0.7, 1.3),
    "geom_scale": ("uniform", 0.95, 1.05),
    "gravity_delta": ("gaussian", 0.0, (0.0, 0.0, 0.4)),
    "limit_lower_delta": ("gaussian", 0.0, 0.01),
    "limit_upper_delta": ("gaussian", 0.0, 0.01),
    "mass_scale": ("uniform", 0.5, 1.5),
    "stiffness_scale": ("loguniform", 0.75, 1.5),
    "tendon_damping_scale": ("loguniform", 0.3, 3.0),
    "tendon_stiffness_scale": ("loguniform", 0.75, 1.5),
}


def overlay_inputs(model, n: int, seed: int, device) -> dict:
    """A randomization overlay for the checks: every key that the model has
    a size for, as an (n, size) float32 tensor on `device`, drawn with numpy
    from `seed` as OVERLAY_DRAWS says. Every env differs from every other in
    every key."""
    from omniisaacgymenvs_torch.ops.fused_step import overlay_sizes

    rng = np.random.default_rng(seed + 15485863)
    out = {}
    for key, size in overlay_sizes(model).items():
        dist, a, b = OVERLAY_DRAWS[key]
        if dist == "gaussian":
            x = a + np.asarray(b) * rng.standard_normal((n, size))
        elif dist == "uniform":
            x = rng.uniform(a, b, (n, size))
        else:
            x = np.exp(rng.uniform(np.log(a), np.log(b), (n, size)))
        if size:
            out[key] = torch.as_tensor(x.astype(np.float32), device=device)
    return out


# check states keep every point that lies inside a box at least this far
# (m) from a tie of the box's two nearest faces: some 2,000 float32 ulps of
# a 5 cm coordinate
TIE_MARGIN = 1e-5
# a state too close to a tie has its FREE roots moved by this much (m): a
# direction that is no box's axis, so the two face distances part; the
# nudges after the first take its components in turn (the AllegroHand's
# rotated cube can hold a point whose two face distances this direction
# moves alike)
TIE_NUDGE = (5e-5, 1.15e-4, 3e-5)


def clear_box_ties(engine, q: torch.Tensor, qd: torch.Tensor,
                   overlay=None) -> torch.Tensor:
    """`q` with the envs moved off the ties of two box faces: where a contact
    point inside a box surface (under the overlay's `geom_scale`) lies
    within TIE_MARGIN of having two nearest faces, every FREE root of that
    env is moved by TIE_NUDGE (its components rolled by one more place at
    each try), up to eight times. On such a tie the contact
    normal is discontinuous: kernel and plain version, which round the
    point's box coordinates differently, would push it out through
    different faces. A model without box pairs comes back as it is."""
    from omniisaacgymenvs_torch.physics import contacts, dynamics

    m = engine.model
    if not len(engine.pair_groups.box["pt"]):
        return q
    gs = (overlay or {}).get("geom_scale")
    q = q.clone()
    for k in range(8):
        nudge = q.new_tensor(np.roll(TIE_NUDGE, k))
        kin = dynamics.kinematics(m, q, qd)
        near = contacts.box_face_ties(m, engine.pair_groups, kin.pw, kin.Rw,
                                      gs) < TIE_MARGIN
        if not bool(near.any()):
            return q
        for qa in _free_q(m):
            q[near, qa:qa + 3] += nudge
    raise RuntimeError(f"{m.name}: check states stay on a box-face tie")


def check_targets(model, q: torch.Tensor, seed: int) -> torch.Tensor:
    """Position targets for the check: the joint coordinates of `q` plus
    the profile's jitter, within the joint limits."""
    rng = np.random.default_rng(seed + 7919)
    jq = torch.as_tensor(model.jq_idx.astype(np.int64), device=q.device)
    jit = check_profile(model)["target"] * rng.standard_normal(
        (q.shape[0], model.njd))
    tgt = q[:, jq] + torch.as_tensor(jit, dtype=q.dtype, device=q.device)
    return torch.minimum(torch.maximum(tgt, model.dof_limit_lower),
                         model.dof_limit_upper).contiguous()


def active_contacts(engine, q, qd) -> dict:
    """Contacts of the states (q, qd), counted with the plain FK: `ground`
    contact points in the ground, candidate `pairs` in contact, and those
    pairs by the surface's type (`sphere`, `capsule`, `box`)."""
    from omniisaacgymenvs_torch.physics import contacts, dynamics

    m = engine.model
    kin = dynamics.kinematics(m, q, qd)
    out = dict(ground=0, pairs=0)
    if m.ncp:
        cb = torch.as_tensor(m.cp_body.astype(np.int64), device=q.device)
        pt = kin.pw[:, cb] + (kin.Rw[:, cb] @ m.cp_pos[..., None])[..., 0]
        out["ground"] = int((pt[..., 2] < m.cp_radius).sum())
    pen = contacts.pair_penetrations(m, engine.pair_groups, kin.pw, kin.Rw)
    for name, g in zip(("sphere", "capsule", "box"), engine.pair_groups):
        out[name] = int((pen[:, g["idx"].astype(np.int64)] > 0).sum())
    out["pairs"] = out["sphere"] + out["capsule"] + out["box"]
    return out


def build_pair_scene(device="cpu"):
    """A small scene that holds every pair-contact branch: a FIXED base with
    a box, a sphere and a capsule surface; on it an arm of a prismatic and
    two revolute joints, the last two coupled by a fixed tendon with limits,
    carrying a capsule surface that moves and a gravity-compensated link;
    and a FREE puck (a dense box of 26 points and a sphere) that the check
    states set on each surface in turn (CHECK_PROFILES["PairScene"])."""
    from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

    b = ModelBuilder("PairScene")
    base = b.add_body("base", parent=-1, joint_type=JointType.FIXED,
                      joint_pos=(0.0, 0.0, 0.5), mass=1.0)
    b.add_box_collider(base, (0, 0, -0.08), (0.3, 0.3, 0.1), receive=True)
    b.add_sphere_collider(base, (0.5, 0.0, 0.1), 0.1, receive=True)
    b.add_capsule_collider(base, (-0.6, -0.2, 0.05), (-0.6, 0.2, 0.05), 0.1,
                           receive=True)
    slide = b.add_body("slide", parent=base, joint_type=JointType.PRISMATIC,
                       joint_axis=(0, 0, 1), joint_pos=(0.0, 0.6, 0.05),
                       limit=(-0.05, 0.05), mass=0.5, inertia=(1e-3,) * 3,
                       stiffness=200.0, drive_damping=20.0, max_effort=50.0,
                       armature=0.01, max_velocity=5.0)
    hinge = b.add_body("hinge", parent=slide, joint_type=JointType.REVOLUTE,
                       joint_axis=(1, 0, 0), limit=(-0.4, 0.4), mass=0.2,
                       com=(0.0, 0.1, 0.0), inertia=(1e-3,) * 3,
                       stiffness=5.0, drive_damping=0.5, max_effort=5.0,
                       armature=1e-3, max_velocity=20.0)
    b.add_capsule_collider(hinge, (0, 0, 0), (0, 0.2, 0), 0.1, receive=True)
    b.add_body("hinge2", parent=hinge, joint_type=JointType.REVOLUTE,
               joint_axis=(1, 0, 0), joint_pos=(0.0, 0.2, 0.0),
               limit=(-0.4, 0.4), mass=0.1, com=(0.0, 0.05, 0.0),
               inertia=(5e-4,) * 3, damping=0.01, armature=1e-3,
               max_velocity=20.0, gravity_comp=True)
    b.add_fixed_tendon("hinge", "hinge2", coef=(1.0, -1.0), stiffness=2.0,
                       damping=0.05, limit=(-0.05, 0.05),
                       limit_stiffness=10.0)
    b.add_force_sensor(hinge)
    puck = b.add_body("puck", parent=-1, joint_type=JointType.FREE,
                      mass=0.3, inertia=(5e-4,) * 3,
                      default_pos=(0.0, 0.0, 0.575))
    b.add_box_collider(puck, (0, 0, 0), (0.05, 0.05, 0.05), dense=True)
    b.add_sphere_collider(puck, (0, 0, 0), 0.06)
    b.add_force_sensor(puck)
    return b.finalize(device)


def build_wide_tree(n_legs: int = 150, device="cpu"):
    """A shallow tree of 2 n_legs + 1 bodies whose working set does not fit
    a block's shared memory (the group form's device-memory placement): a
    FREE base on n_legs legs of two hinged links, hung from a ring of hips
    and each ending in a foot sphere 5 mm in the ground at default_q. Its
    three levels keep the plain step quick at any width."""
    from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

    b = ModelBuilder("WideTree")
    base = b.add_body("base", parent=-1, joint_type=JointType.FREE, mass=2.0,
                      inertia=(0.1, 0.1, 0.1), default_pos=(0.0, 0.0, 0.215))
    for k in range(n_legs):
        a = 2 * np.pi * k / n_legs
        c, s = float(np.cos(a)), float(np.sin(a))
        hip = b.add_body(f"hip{k}", parent=base, joint_type=JointType.REVOLUTE,
                         joint_axis=(-s, c, 0.0), joint_pos=(0.3 * c, 0.3 * s, 0.0),
                         com=(0.0, 0.0, -0.05), mass=0.02, inertia=(2e-5,) * 3,
                         limit=(-0.3, 0.3), stiffness=5.0, drive_damping=0.2,
                         max_effort=10.0, armature=1e-3)
        foot = b.add_body(f"foot{k}", parent=hip, joint_type=JointType.REVOLUTE,
                          joint_axis=(-s, c, 0.0), joint_pos=(0.0, 0.0, -0.1),
                          com=(0.0, 0.0, -0.05), mass=0.02, inertia=(2e-5,) * 3,
                          limit=(-0.3, 0.3), stiffness=5.0, drive_damping=0.2,
                          max_effort=10.0, armature=1e-3)
        b.add_sphere_collider(foot, (0.0, 0.0, -0.1), 0.02)
    return b.finalize(device)


REST_SURFACES = ("sphere", "capsule", "box")


def build_rest_scene(surface: str, device="cpu"):
    """(model, engine) of a ball resting on a receiver: a FIXED base 0.5 m
    up, a revolute holder carrying a `surface` receiver ("sphere",
    "capsule" or "box"; the surface's body is not a root, as a palm, a tray
    or a drawer is not), and a FREE 0.5 kg "ball" with one contact point of
    radius 0.03 at its origin; dt 1/60 in 4 substeps. The box's top lies at
    z = 0.54, so a ball centre below it is a point inside the box: the
    branch decided on the squared distance (scripts/gpu_regression.py)."""
    from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
    from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder

    if surface not in REST_SURFACES:
        raise ValueError(f"surface {surface!r}: one of {REST_SURFACES}")
    b = ModelBuilder(f"pair_{surface}")
    root = b.add_body("base", parent=-1, joint_type=JointType.FIXED,
                      joint_pos=(0.0, 0.0, 0.5))
    holder = b.add_body(
        "holder", parent=root, joint_type=JointType.REVOLUTE,
        joint_axis=(0, 0, 1), mass=2.0, inertia=(0.02, 0.02, 0.02),
        stiffness=100.0, drive_damping=10.0, limit=(-1.0, 1.0),
    )
    if surface == "sphere":
        b.add_sphere_collider(holder, (0, 0, 0), 0.12, receive=True)
    elif surface == "capsule":
        b.add_capsule_collider(holder, (-0.1, 0, 0), (0.1, 0, 0), 0.08,
                               receive=True)
    else:
        b.add_box_collider(holder, (0, 0, 0), (0.15, 0.15, 0.04),
                           receive=True)
    ball = b.add_body(
        "ball", parent=-1, joint_type=JointType.FREE, mass=0.5,
        inertia=(0.001, 0.001, 0.001), default_pos=(0.0, 0.02, 0.75),
    )
    b.add_contact_point(ball, (0, 0, 0), radius=0.03)
    m = b.finalize(device)
    return m, PhysicsEngine(m, SimParams(dt=1 / 60, substeps=4))


def sign_align(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a with each quaternion's sign flipped to agree with b (q and -q are
    one rotation)."""
    s = torch.sign((a * b).sum(-1, keepdim=True))
    return a * torch.where(s == 0, torch.ones_like(s), s)


def env_tolerance_use(a: torch.Tensor, b: torch.Tensor, rtol: float,
                      scale: float, atol: float) -> torch.Tensor:
    """(N,) float64: per env the largest |a - b| / (atol + rtol |b| + scale
    max_env |b|); inf where a is not finite or an error meets a zero limit;
    0 for an empty output."""
    if a.numel() == 0:
        return torch.zeros(a.shape[0], dtype=torch.float64, device=a.device)
    a64, b64 = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    err = (a64 - b64).abs()
    lim = atol + rtol * b64.abs() + scale * b64.abs().amax(dim=1, keepdim=True)
    use = torch.where(err == 0, torch.zeros_like(err), err / lim)
    use = torch.where(torch.isfinite(a64), use, torch.full_like(use, float("inf")))
    return use.amax(dim=1)


def tolerance_use(a: torch.Tensor, b: torch.Tensor, rtol: float,
                  scale: float, atol: float) -> float:
    """The largest `env_tolerance_use` over the envs."""
    if a.numel() == 0:
        return 0.0
    return float(env_tolerance_use(a, b, rtol, scale, atol).max())


def compare(outs, refs, names, tol, keep=None) -> dict:
    """{name: (max abs err, tolerance use)} of kernel outputs against plain
    ones, over the envs of the bool mask `keep` (default all); quaternions
    are sign-aligned first."""
    res = {}
    for n, a, b in zip(names, outs, refs):
        if keep is not None:
            a, b = a[keep], b[keep]
        if n == "body_quat":
            a = sign_align(a, b)
        err = float((a - b).abs().max()) if a.numel() else 0.0
        res[n] = (err, tolerance_use(a, b, *tol[n]))
    return res


# Under a randomization overlay the step of some envs is ill conditioned: a
# cube of half its mass on the model's contact gains chatters, and a
# rounding difference grows some threefold per substep over the 12 substeps
# of a control step (seen: 5e-5 rad/s after one substep, 0.55 after twelve,
# in one env of 8229). No two implementations agree there to any fixed
# limit. Such an env shows itself without the kernel: the plain version, run
# again on a state changed by COND_EPS of its size (two float32 ulps; a
# coordinate larger than 1, a base some 80 m out on the terrain, by at most
# COND_EPS in all, which rounds away), moves its own result by more than
# COND_SHARE of the limit. A chattering env can be insensitive to one
# direction of change and not to another: in seed 1 of the randomized hand's
# check states (8229 envs, a cube at 0.53 of its mass) the plain step moved
# its body_avel by 0.11 of the limit when every coordinate grew by COND_EPS
# of its size, by 2.9 and 6.6 under changes of the same size with random
# signs, and the kernel's result differed by 1.097; the gap grew substep by
# substep as the plain step's own spread did
# (tools/conditioning_probe.py, PERF.md Findings). So the state is changed in
# each of COND_DIRECTIONS: every coordinate up, every one down, and four
# fixed random sign patterns. The overlay checks
# judge the kernel on the other envs and fail if more than COND_MAX_EXCLUDED
# of the envs are left out (seen: 26 to 32 of 8229).
COND_EPS = 2.0 ** -22
COND_SHARE = 0.5
COND_MAX_EXCLUDED = 0.01
COND_DIRECTIONS = ("+", "-", "r0", "r1", "r2", "r3")


def cond_nudge(x: torch.Tensor, direction: str) -> torch.Tensor:
    """x changed by COND_EPS of its size (of 1 for a larger entry) in one of
    COND_DIRECTIONS: `+` every entry up, `-` every entry down, `r<i>` up or
    down by a fixed random sign per entry (drawn from a generator on x's
    device seeded by i and x's width)."""
    step = COND_EPS * x.clamp(-1.0, 1.0)
    if direction == "+":
        return x + step
    if direction == "-":
        return x - step
    g = torch.Generator(device=x.device).manual_seed(
        1000 + int(direction[1:]) + x.shape[1])
    sign = torch.randint(0, 2, x.shape, generator=g, device=x.device) * 2 - 1
    return x + step * sign


# The AllegroHand at its yaml's 16 substeps per K1 launch (a 71 g cube on a
# tilted palm, twice the ShadowHand's depth) is ill conditioned in some envs
# with no overlay at all. Over all 8229 envs of its check states the sound
# kernel (both forms alike) read 4.35 of the limits on body_avel
# (chip_smoke.py); on seeds 0-3 the plain step of 108-142 envs (1.3-1.7%)
# moved by more than COND_SHARE of the limits under a COND_EPS change of the
# state, the largest gap (1.32) was in such an env, and the envs kept read at
# most 0.81 (tools/conditioning_probe.py task=AllegroHand, PERF.md Findings),
# while a dropped substep, a dropped pair or a box 1 mm larger read 5766 and
# more (scripts/tolerance_controls.py task=AllegroHand). Its K1 checks judge
# the well-conditioned envs, as the overlay checks do, and fail if more than
# this share of the envs falls out.
# FrankaCabinet with 16 props (its "<name>/<bodies>" key, as in
# CHECK_PROFILES): 16 cubes bounce and slide on the tray over 12 substeps,
# and a cube that switches between sticking and slipping turns a nudge of
# 2^-22 into 52-240 times K1's limits; 2 of 512 check states on the CPU (1
# of 4133 out of the limits between the host build of K1 and the plain
# version, that one ill conditioned). Its K1 checks judge the
# well-conditioned envs at the overlay checks' share. Its 3-step rollout
# from the task's resets keeps within 0.03 of its limits under the same
# nudges (the cubes are not observed), so it is judged whole.
COND_MAX_EXCLUDED_BY_MODEL = {"AllegroHand": 0.02,
                              "FrankaCabinet/31": COND_MAX_EXCLUDED}


def check_keep(model, run_plain, q, qd, refs, names, tol):
    """The envs an unrandomized K1 check judges: all (None), or on a model of
    COND_MAX_EXCLUDED_BY_MODEL (by "<name>/<bodies>", else by name)
    `well_conditioned`'s at the model's share."""
    cap = by_model(COND_MAX_EXCLUDED_BY_MODEL, model)
    if cap is None:
        return None
    return well_conditioned(run_plain, q, qd, refs, names, tol, max_excluded=cap)


def well_conditioned(run_plain, q, qd, refs, names, tol,
                     max_excluded: float = COND_MAX_EXCLUDED) -> torch.Tensor:
    """(N,) bool: the envs whose plain result `refs` = run_plain(q, qd) moves
    by less than COND_SHARE of its limits when the state is changed by
    COND_EPS of its size (of 1 for a larger entry) in any of
    COND_DIRECTIONS. Raises if more than `max_excluded` of the envs fall
    out."""
    use = torch.zeros(q.shape[0], dtype=torch.float64, device=q.device)
    for d in COND_DIRECTIONS:
        again = run_plain(cond_nudge(q, d), cond_nudge(qd, d))
        for n, a, b in zip(names, again, refs):
            if n == "body_quat":
                a = sign_align(a, b)
            use = torch.maximum(use, env_tolerance_use(a, b, *tol[n]))
    keep = use < COND_SHARE
    if float((~keep).float().mean()) > max_excluded:
        raise AssertionError(f"{int((~keep).sum())} of {q.shape[0]} envs are "
                             "ill conditioned: the check states are too harsh")
    return keep


def assert_within(label: str, res: dict, tol: dict, log=print) -> float:
    """Log each field of a `compare` result and raise if any is out of
    tolerance; returns the largest abs error."""
    for n, (err, use) in res.items():
        log(f"  {label} {n}: max abs err {err:.3e}, tolerance use "
            f"{use:.3f} (rtol, scale, atol {tol[n]})")
    bad = [n for n, (_, use) in res.items() if not use <= 1.0]
    if bad:
        raise AssertionError(f"{label}: {bad} out of tolerance")
    return max(err for err, _ in res.values())
