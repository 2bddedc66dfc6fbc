"""Port parity of the plain physics on scenes with FIXED roots, forests,
prismatic joints, pair contacts, gravity compensation and fixed tendons:
`_substep`, `step_n` and the report FK on Cartpole, BallBalance, ShadowHand,
the synthetic pair scene and six one-feature scenes, each against the JAX
engine's XLA path on the same numpy-seeded inputs (float32); `step_n` also
on two models past the thread form's maxima, which the group form steps
on the card: FrankaCabinet with 16 props and a 35-body chain."""

import functools

import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.physics.engine import PhysicsEngine as JPhysicsEngine
from omniisaacgymenvs_tpu.physics.engine import SimParams as JSimParams
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from torch_parity import (assert_step_close, jax_model_from_port, jax_step,
                          jax_substep, np_)

N = 6
N_STEPS = 4
TASKS = ("Cartpole", "BallBalance", "ShadowHand", "FrankaCabinet",
         "AllegroHand", "Ingenuity", "Quadcopter", "Crazyflie")
# FrankaCabinet with its yaml's four props: four FREE roots, the kernels'
# maximum
TASK_CFGS = {"FrankaCabinet": {"env": {"numProps": 4}}}
KINDS = ("fixed_root", "prismatic", "tendon", "gravity_comp", "forest", "pairs")
# past the thread form's maxima: FrankaCabinet with 16 FREE props (152
# contact points, 402 pairs) and a chain of fs.NB_MAX + 3 bodies
LARGE = ("FrankaCabinet16", "chain35")


def one_feature_scene(kind, n_chain=0):
    """A three-body scene with one feature beyond a FREE-root revolute tree
    (`kind`), or a chain of `n_chain` extra bodies."""
    b = ModelBuilder(kind)
    if kind == "fixed_root":
        root = b.add_body("base", parent=-1, joint_type=JointType.FIXED,
                          joint_pos=(0.0, 0.0, 0.4))
    else:
        root = b.add_body("base", parent=-1, joint_type=JointType.FREE,
                          default_pos=(0.0, 0.0, 0.12))
    jt = JointType.PRISMATIC if kind == "prismatic" else JointType.REVOLUTE
    b.add_body("j1", parent=root, joint_type=jt, joint_axis=(0, 1, 0),
               joint_pos=(0.1, 0, 0), com=(0.05, 0, 0), limit=(-0.5, 0.5),
               stiffness=2.0, drive_damping=0.2, armature=0.01,
               gravity_comp=(kind == "gravity_comp"))
    b.add_body("j2", parent=root, joint_axis=(1, 0, 0), joint_pos=(-0.1, 0, 0),
               com=(0, 0.05, 0), limit=(-0.5, 0.5), armature=0.01)
    b.add_sphere_collider(root, (0, 0, 0), 0.1, receive=(kind == "pairs"))
    if kind == "tendon":
        b.add_fixed_tendon("j1", "j2", stiffness=1.0, damping=0.1,
                           limit=(-0.02, 0.02), limit_stiffness=5.0)
    if kind in ("forest", "pairs"):
        b.add_body("ball", parent=-1, joint_type=JointType.FREE, mass=0.2,
                   default_pos=(0.0, 0.0, 0.26))
        b.add_sphere_collider(3, (0, 0, 0), 0.05)
    p = 1
    for i in range(n_chain):
        p = b.add_body(f"x{i}", parent=p)
    return b.finalize()


@functools.lru_cache(maxsize=None)
def engines(name):
    """(port engine, JAX engine) of a task's scene, the pair scene or a
    one-feature scene, on the CPU."""
    if name in TASKS:
        cfg = TASK_CFGS.get(name)
        return (get_task(name, cfg, device="cpu").engine,
                jget_task(name, cfg).engine)
    if name == "FrankaCabinet16":
        cfg = {"env": {"numProps": 16}}
        return (get_task("FrankaCabinet", cfg, device="cpu").engine,
                jget_task("FrankaCabinet", cfg).engine)
    if name == "chain35":
        pm = one_feature_scene("plain", n_chain=fs.NB_MAX)
    else:
        pm = (parity.build_pair_scene() if name == "PairScene"
              else one_feature_scene(name))
    return (PhysicsEngine(pm, SimParams(dt=1.0 / 120.0, substeps=2)),
            JPhysicsEngine(jax_model_from_port(pm),
                           JSimParams(dt=1.0 / 120.0, substeps=2)))


def inputs(eng, seed=3):
    m = eng.model
    q, qd, eff = parity.check_inputs(m, N, seed=seed, device="cpu")
    ptg = parity.check_targets(m, q, seed)
    rng = np.random.default_rng(seed)
    fa = (0.05 * rng.standard_normal((N, m.nb, 6))).astype(np.float32)
    return tuple(np_(x) for x in (q, qd, eff, ptg)) + (fa,)


@pytest.mark.parametrize("name", TASKS + ("PairScene",) + KINDS + LARGE)
def test_step_n_matches_jax(name):
    eng, jeng = engines(name)
    q, qd, eff, ptg, fa = inputs(eng)
    t = torch.as_tensor
    out = fs.step_plain(eng, t(q), t(qd), t(eff), t(ptg),
                        torch.zeros(N, eng.model.njd), t(fa), N_STEPS)
    # the Humanoid step_n tolerances (torch_parity.STEP_N_TOL), unchanged
    assert_step_close(out, jax_step(jeng, q, qd, eff, ptg, fa, N_STEPS))
    if name in ("BallBalance", "ShadowHand", "PairScene", "pairs",
                "FrankaCabinet", "AllegroHand", "FrankaCabinet16"):
        active = parity.active_contacts(eng, t(q), t(qd))
        assert active["pairs"] > 0, "the check states must put pairs in contact"


@pytest.mark.parametrize("name", TASKS + ("PairScene",))
def test_substep_matches_jax(name):
    eng, jeng = engines(name)
    q, qd, eff, ptg, fa = inputs(eng, seed=4)
    t = torch.as_tensor
    out = fs.substep_plain(eng, t(q), t(qd), t(eff), t(ptg),
                           torch.zeros(N, eng.model.njd), t(fa))
    ref = jax_substep(jeng, q, qd, eff, ptg, fa)
    # one substep: positions to 1e-5, velocities and wrenches relative
    tol = {"q": (1e-4, 1e-5), "qd": (2e-3, 2e-3), "sensor_forces": (1e-3, 1e-2)}
    assert_step_close(out, ref, parity.SUBSTEP_NAMES, tol)
    # the wrapper routes CPU tensors to the plain version
    out2 = fs.substep(eng, t(q), t(qd), t(eff), t(ptg),
                      torch.zeros(N, eng.model.njd), t(fa))
    for a, b in zip(out, out2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", TASKS + ("PairScene", "forest"))
def test_fk_plain_matches_jax_on_forests(name):
    import jax
    import jax.numpy as jnp

    eng, jeng = engines(name)
    q, qd, *_ = inputs(eng, seed=5)
    out = fs.fk_plain(eng.model, torch.as_tensor(q), torch.as_tensor(qd))
    ns = eng.model.num_sensors
    st = jax.vmap(lambda a, b: jeng._report_xla(a, b, jnp.zeros((ns, 6))))(
        jnp.asarray(q), jnp.asarray(qd))
    ref = (st.body_pos, st.body_quat, st.body_avel, st.body_lvel)
    # one FK pass; Shepperd's small components round at ~sqrt(float32 eps)
    tol = {"pos": (1e-5, 2e-6), "quat": (0.0, 1e-3), "avel": (1e-5, 2e-6),
           "lvel": (1e-5, 2e-6)}
    assert_step_close(out, ref, ("pos", "quat", "avel", "lvel"), tol)


def test_sensors_exclude_applied_forces_and_gravity_compensation():
    eng, _ = engines("ShadowHand")
    q, qd, eff, ptg, fa = (torch.as_tensor(x) for x in inputs(eng, seed=6))
    z = torch.zeros(N, eng.model.njd)
    a = fs.substep_plain(eng, q, qd, eff, ptg, z, torch.zeros_like(fa))
    b = fs.substep_plain(eng, q, qd, eff, ptg, z, 100.0 * fa)
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    assert not torch.equal(a[1], b[1])


def _off_com_scene():
    """One FREE body whose centre of mass sits 8 cm out along x from its
    origin (a Quadcopter rotor's offset), with no contact."""
    b = ModelBuilder("off_com")
    b.add_body("body", parent=-1, joint_type=JointType.FREE, mass=0.5,
               com=(0.08, 0.0, 0.0), inertia=(1e-3, 2e-3, 3e-3),
               default_pos=(0.0, 0.0, 1.0))
    return b.finalize()


@pytest.mark.parametrize("name", ["off_com", "Quadcopter"])
def test_applied_force_acts_at_the_body_origin(name):
    """`body_force` acts at each body's origin, not at its centre of mass:
    on a body whose centre of mass is off its origin a force turns it. The
    port's step_n against the JAX engine's with forces of 1 N on such
    bodies only (the off-centre body; the Quadcopter's four rotors)."""
    if name == "off_com":
        pm = _off_com_scene()
        eng = PhysicsEngine(pm, SimParams(dt=0.01, substeps=1, gravity=(0, 0, 0)))
        jeng = JPhysicsEngine(jax_model_from_port(pm),
                              JSimParams(dt=0.01, substeps=1, gravity=(0, 0, 0)))
        bodies = [0]
    else:
        eng, jeng = engines(name)
        pm = eng.model
        bodies = [pm.body_index(f"rotor_{i}") for i in range(4)]
    m = eng.model
    q = np.tile(np_(m.default_q), (N, 1))
    qd = np.zeros((N, m.nv), np.float32)
    z = np.zeros((N, m.njd), np.float32)
    rng = np.random.default_rng(8)
    fa = np.zeros((N, m.nb, 6), np.float32)
    f = rng.standard_normal((N, len(bodies), 3)).astype(np.float32)
    fa[:, bodies, 3:6] = f / np.linalg.norm(f, axis=-1, keepdims=True)
    t = torch.as_tensor
    out = fs.step_plain(eng, t(q), t(qd), t(z), t(z), t(z), t(fa), N_STEPS)
    assert_step_close(out, jax_step(jeng, q, qd, z, z, fa, N_STEPS))
    if name == "off_com":
        # the body turns at alpha = I^-1 ((origin - com) x F) about its
        # centre of mass; at the centre of mass the same force would not
        # turn it (a few degrees in 4 substeps: to 5%)
        arm = np.array([-0.08, 0.0, 0.0])
        torque = np.cross(arm, fa[:, 0, 3:6])
        inertia = np.array([1e-3, 2e-3, 3e-3])
        want = torque / inertia * N_STEPS * 0.01
        np.testing.assert_allclose(np_(out[5])[:, 0], want, rtol=0.05,
                                   atol=0.02 * np.abs(want).max())
