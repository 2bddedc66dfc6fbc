"""Port parity of the pair contacts (per surface type, with a point inside
a box), their build-time groups and gains, gravity compensation and the
fixed tendons' drive torques and ABA diagonal, against the JAX package's
functions under vmap on the same numpy-seeded inputs (float32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.models import build_balance_bot, build_shadow_hand
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics import contacts as tcontacts
from omniisaacgymenvs_torch.physics import dynamics as tdyn
from omniisaacgymenvs_torch.physics.model import (JointType, ModelBuilder,
                                                  SurfaceType)
from omniisaacgymenvs_torch.physics.state import Control
from omniisaacgymenvs_tpu.physics import contacts as jcontacts
from omniisaacgymenvs_tpu.physics import dynamics as jdyn
from omniisaacgymenvs_tpu.physics.state import Control as JControl
from torch_parity import jax_model_from_port, np_

N = 8
H = 1.0 / 240.0


def _t(x):
    return torch.as_tensor(np.asarray(x))


def surface_scene(stype):
    """A FIXED base with one receiver surface of `stype` (the box turned by
    30 degrees about z) and a FREE probe with a sphere and a dense box of
    points."""
    b = ModelBuilder(f"probe_{stype.name}")
    base = b.add_body("base", parent=-1, joint_type=JointType.FIXED,
                      joint_pos=(0.0, 0.0, 0.5), mass=2.0)
    if stype == SurfaceType.SPHERE:
        b.add_sphere_collider(base, (0.02, 0.0, 0.0), 0.15, receive=True)
    elif stype == SurfaceType.CAPSULE:
        b.add_capsule_collider(base, (-0.2, 0.0, 0.0), (0.2, 0.0, 0.0), 0.1,
                               receive=True)
    else:
        c, s = np.cos(np.pi / 12), np.sin(np.pi / 12)
        b.add_box_collider(base, (0.0, 0.01, 0.0), (0.2, 0.15, 0.1),
                           quat=(c, 0.0, 0.0, s), receive=True)
    probe = b.add_body("probe", parent=-1, joint_type=JointType.FREE,
                       mass=0.3, inertia=(5e-4,) * 3,
                       default_pos=(0.0, 0.0, 0.7))
    b.add_box_collider(probe, (0, 0, 0), (0.04, 0.04, 0.04), dense=True)
    b.add_sphere_collider(probe, (0, 0, 0), 0.05)
    return b.finalize()


def _states(pm, rng, z_lo, z_hi):
    q, qd = parity.perturbed_batch(
        np_(pm.default_q), pm.jq_idx, np_(pm.dof_limit_lower),
        np_(pm.dof_limit_upper), pm.nv, rng, N, scale=0.3, vel=0.5,
        free_q=(pm.root_q_adr("probe"),), root_pos=0.03)
    q[:, pm.root_q_adr("probe") + 2] = rng.uniform(z_lo, z_hi, N)
    return q, qd


def _pair_wrenches(pm, q, qd):
    jm = jax_model_from_port(pm)
    pp = tcontacts.auto_contact_params(pm, H)
    jp = jcontacts.auto_contact_params(jm, H)
    groups = tcontacts.build_pair_groups(pm)
    kin = tdyn.kinematics(pm, _t(q), _t(qd))
    avel, lvel = tdyn.world_velocities(pm, kin)
    out = tcontacts.pair_contacts(pm, groups, kin.pw, kin.Rw, avel, lvel, pp)
    pen = tcontacts.pair_penetrations(pm, groups, kin.pw, kin.Rw)
    jgroups = jcontacts.build_pair_groups(jm)

    def one(q1, qd1):
        k = jdyn.kinematics(jm, q1, qd1)
        a, l_ = jdyn.world_velocities(jm, k)
        return jcontacts.pair_contacts(jm, jgroups, k.pw, k.Rw, a, l_, jp)

    ref = jax.vmap(one)(jnp.asarray(q), jnp.asarray(qd))
    return np_(out), np.asarray(ref), np_(pen), kin


@pytest.mark.parametrize("stype", list(SurfaceType), ids=lambda s: s.name)
def test_pair_contacts_per_surface_type(stype):
    pm = surface_scene(stype)
    rng = np.random.default_rng(int(stype))
    # the probe from well inside the surface's top to just clear of it
    q, qd = _states(pm, rng, 0.56, 0.72)
    out, ref, pen, _ = _pair_wrenches(pm, q, qd)
    assert (pen > 0).any() and (pen < 0).any()
    assert np.abs(ref).max() > 1.0
    # wrenches: rtol 1e-4, atol 1e-5 (float32 in another operation order)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    # equal and opposite forces on the two bodies
    np.testing.assert_allclose(out[:, 0, 3:6], -out[:, 1, 3:6], rtol=1e-5,
                               atol=1e-5)


def test_box_interior_point_is_pushed_out_through_nearest_face():
    pm = surface_scene(SurfaceType.BOX)
    q = np.tile(np_(pm.default_q), (N, 1))
    qd = np.zeros((N, pm.nv), np.float32)
    qa = pm.root_q_adr("probe")
    # the probe's centre inside the box, 5 cm under its top face: every
    # point of the probe is an interior point (d_out = 0 exactly)
    q[:, qa:qa + 3] = [0.0, 0.01, 0.5 + 0.1 - 0.05]
    q[:, qa] += np.linspace(-0.05, 0.05, N)
    out, ref, pen, _ = _pair_wrenches(pm, q.astype(np.float32), qd)
    assert (pen > 0).all(), "every interior point is in contact"
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    # the probe's upper points leave through the box's top, their nearest
    # face: the net push on the probe has an upward part
    assert (out[:, 1, 5] > 0).all()


@pytest.mark.parametrize("build", [build_balance_bot, build_shadow_hand],
                         ids=["BallBalance", "ShadowHand"])
def test_pair_groups_and_gains(build):
    pm = build()
    jm = jax_model_from_port(pm)
    groups = tcontacts.build_pair_groups(pm)
    jgroups = jcontacts.build_pair_groups(jm)
    for g, jg in zip(groups, jgroups):
        for key in ("pt", "sbody", "params", "mmin", "mbody"):
            np.testing.assert_allclose(g[key], jg[key], rtol=1e-12, err_msg=key)
    order = np.concatenate([g["idx"] for g in groups])
    assert sorted(order.tolist()) == list(range(len(pm.pair_surf)))
    for si in range(len(pm.surf_type)):
        assert tcontacts.surface_effective_mass(pm, si) == pytest.approx(
            jcontacts.surface_effective_mass(jm, si), rel=1e-12)
    pp = tcontacts.auto_contact_params(pm, H)
    gains = tcontacts.pair_gains(pm, groups, pp)
    assert gains.shape == (3, len(pm.pair_surf)) and (gains > 0).all()
    g = groups.box
    np.testing.assert_allclose(gains[0, g["idx"]], pp.kn_pm * g["mmin"])
    np.testing.assert_allclose(gains[2, g["idx"]], pp.fnm_pm * g["mbody"])


@pytest.fixture(scope="module")
def hand():
    pm = build_shadow_hand()
    rng = np.random.default_rng(5)
    q, qd = parity.perturbed_batch(
        np_(pm.default_q), pm.jq_idx, np_(pm.dof_limit_lower),
        np_(pm.dof_limit_upper), pm.nv, rng, N, scale=0.3, vel=2.0,
        free_q=(pm.root_q_adr("object"),), root_pos=0.01)
    return pm, jax_model_from_port(pm), q, qd, rng


def test_tendon_drive_torques(hand):
    pm, jm, q, qd, rng = hand
    assert pm.nt == 4
    eff, ptg, vtg = (rng.standard_normal((N, pm.njd)).astype(np.float32)
                     for _ in range(3))
    ctrl = Control(effort=_t(eff), pos_target=_t(ptg), vel_target=_t(vtg),
                   body_force=None, body_torque=None)
    out = tdyn.drive_torques(pm, _t(q), _t(qd), ctrl, H)

    def one(q1, qd1, e, p, v):
        c = JControl(effort=e, pos_target=p, vel_target=v,
                     body_force=jnp.zeros((jm.nb, 3)),
                     body_torque=jnp.zeros((jm.nb, 3)))
        return jdyn.drive_torques(jm, q1, qd1, c, H)

    ref = jax.vmap(one)(*map(jnp.asarray, (q, qd, eff, ptg, vtg)))
    np.testing.assert_allclose(np_(out), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the tendons act: an undriven J0 joint gets a torque from its J1
    j0 = pm.dof_index("FFJ0")
    ctrl0 = Control(effort=torch.zeros(N, pm.njd), pos_target=_t(ptg),
                    vel_target=_t(vtg), body_force=None, body_torque=None)
    tau0 = tdyn.drive_torques(pm, _t(q), torch.zeros(N, pm.nv), ctrl0, H)
    assert (tau0[:, j0].abs() > 1e-3).any()


def test_tendon_aba(hand):
    pm, jm, q, qd, rng = hand
    tau = (0.2 * rng.standard_normal((N, pm.njd))).astype(np.float32)
    fext = (0.05 * rng.standard_normal((N, pm.nb, 6))).astype(np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    pk = tdyn.kinematics(pm, _t(q), _t(qd))
    jk = jax.vmap(functools.partial(jdyn.kinematics, jm))(
        jnp.asarray(q), jnp.asarray(qd))
    out = tdyn.aba(pm, _t(q), _t(qd), _t(tau), _t(fext), pk, _t(g), H)
    ref = jax.jit(jax.vmap(
        lambda q1, qd1, t1, f1, k1: jdyn.aba(jm, q1, qd1, t1, f1, k1,
                                             jnp.asarray(g), H)
    ))(*map(jnp.asarray, (q, qd, tau, fext)), jk)
    # finger links of a few grams: accelerations of 1e3 rad/s^2 out of a
    # 7-level recursion in float32, relative tolerance as on the Humanoid
    np.testing.assert_allclose(np_(out), np.asarray(ref), rtol=2e-3, atol=2e-3)
    # the tendons' implicit diagonal is in: without it qdd differs
    import dataclasses

    no_t = dataclasses.replace(pm, nt=0)
    other = tdyn.aba(no_t, _t(q), _t(qd), _t(tau), _t(fext), pk, _t(g), H)
    assert not torch.allclose(out, other, rtol=1e-3, atol=1e-3)
