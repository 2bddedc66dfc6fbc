"""Port parity of the plain physics on scenes with FIXED roots, forests,
prismatic joints, pair contacts, gravity compensation and fixed tendons:
`_substep`, `step_n` and the report FK on Cartpole, BallBalance, ShadowHand,
the synthetic pair scene and six one-feature scenes, each against the JAX
engine's XLA path on the same numpy-seeded inputs (float32)."""

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
TASKS = ("Cartpole", "BallBalance", "ShadowHand")
KINDS = ("fixed_root", "prismatic", "tendon", "gravity_comp", "forest", "pairs")


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
        return get_task(name, device="cpu").engine, jget_task(name).engine
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


@pytest.mark.parametrize("name", TASKS + ("PairScene",) + KINDS)
def test_step_n_matches_jax(name):
    eng, jeng = engines(name)
    q, qd, eff, ptg, fa = inputs(eng)
    t = torch.as_tensor
    out = fs.step_plain(eng, t(q), t(qd), t(eff), t(ptg),
                        torch.zeros(N, eng.model.njd), t(fa), N_STEPS)
    # the Humanoid step_n tolerances (torch_parity.STEP_N_TOL), unchanged
    assert_step_close(out, jax_step(jeng, q, qd, eff, ptg, fa, N_STEPS))
    if name in ("BallBalance", "ShadowHand", "PairScene", "pairs"):
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
