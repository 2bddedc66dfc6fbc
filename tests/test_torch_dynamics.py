"""Port parity: kinematics, ABA, drives, integration and ground contacts on
the Humanoid at N=8, against the JAX package's functions under vmap."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.models import build_humanoid
from omniisaacgymenvs_torch.physics import contacts as tcontacts
from omniisaacgymenvs_torch.physics import dynamics as tdyn
from omniisaacgymenvs_torch.physics.dynamics import _solve_spd6
from omniisaacgymenvs_torch.physics.state import Control
from omniisaacgymenvs_tpu.models import build_humanoid as jbuild_humanoid
from omniisaacgymenvs_tpu.physics import contacts as jcontacts
from omniisaacgymenvs_tpu.physics import dynamics as jdyn
from omniisaacgymenvs_tpu.physics.state import Control as JControl
from omniisaacgymenvs_torch.ops.parity import perturbed_batch
from torch_parity import np_

N = 8
H = 1.0 / 240.0


@pytest.fixture(scope="module")
def case():
    pm, jm = build_humanoid(), jbuild_humanoid()
    rng = np.random.default_rng(0)
    q, qd = perturbed_batch(
        np_(pm.default_q), pm.jq_idx, np_(pm.dof_limit_lower),
        np_(pm.dof_limit_upper), pm.nv, rng, N, drop=0.6,
    )
    return pm, jm, q, qd, rng


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _kin_pair(pm, jm, q, qd):
    pk = tdyn.kinematics(pm, _t(q), _t(qd))
    jk = jax.vmap(functools.partial(jdyn.kinematics, jm))(
        jnp.asarray(q), jnp.asarray(qd))
    return pk, jk


def test_kinematics(case):
    pm, jm, q, qd, _ = case
    pk, jk = _kin_pair(pm, jm, q, qd)
    for name in pk._fields:
        # float32 products chained over up to 9 tree levels
        np.testing.assert_allclose(np_(getattr(pk, name)),
                                   np.asarray(getattr(jk, name)),
                                   rtol=1e-5, atol=2e-6, err_msg=name)
    pa, pl = tdyn.world_velocities(pm, pk)
    ja, jl = jax.vmap(functools.partial(jdyn.world_velocities, jm))(jk)
    np.testing.assert_allclose(np_(pa), np.asarray(ja), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(np_(pl), np.asarray(jl), rtol=1e-5, atol=2e-6)


def test_drive_torques(case):
    pm, jm, q, qd, rng = case
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


def test_aba(case):
    pm, jm, q, qd, rng = case
    tau = (20.0 * rng.standard_normal((N, pm.njd))).astype(np.float32)
    fext = (5.0 * rng.standard_normal((N, pm.nb, 6))).astype(np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    pk, jk = _kin_pair(pm, jm, q, qd)
    out = tdyn.aba(pm, _t(q), _t(qd), _t(tau), _t(fext), pk, _t(g), H)
    ref = jax.jit(jax.vmap(
        lambda q1, qd1, t1, f1, k1: jdyn.aba(jm, q1, qd1, t1, f1, k1,
                                             jnp.asarray(g), H)
    ))(*map(jnp.asarray, (q, qd, tau, fext)), jk)
    # accelerations of light (0.05 kg) intermediate bodies are large and
    # come out of a 9-level recursion in float32: relative tolerance
    np.testing.assert_allclose(np_(out), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_integrate(case):
    pm, jm, q, qd, rng = case
    qdd = (50.0 * rng.standard_normal((N, pm.nv))).astype(np.float32)
    qn, qdn = tdyn.integrate(pm, _t(q), _t(qd), _t(qdd), H)
    jq, jqd = jax.vmap(functools.partial(jdyn.integrate, jm, dt=H))(
        *map(jnp.asarray, (q, qd, qdd)))
    np.testing.assert_allclose(np_(qn), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(qdn), np.asarray(jqd), rtol=1e-6, atol=1e-6)


def test_solve_spd6():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((N, 6, 6))
    A = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    b = rng.standard_normal((N, 6)).astype(np.float32)
    x = _solve_spd6(_t(A), _t(b))
    ref = jdyn._solve_spd6(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(np_(x), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(x), np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-4, atol=1e-5)


def test_plane_contacts(case):
    pm, jm, q, qd, _ = case
    pk, jk = _kin_pair(pm, jm, q, qd)
    pa, pl = tdyn.world_velocities(pm, pk)
    pp = tcontacts.auto_contact_params(pm, H)
    out = tcontacts.plane_contacts(pm, pk.pw, pk.Rw, pa, pl, pp)
    jp = jcontacts.auto_contact_params(jm, H)

    def one(k):
        a, l_ = jdyn.world_velocities(jm, k)
        return jcontacts.plane_contacts(jm, k.pw, k.Rw, a, l_, jp)

    ref = jax.vmap(one)(jk)
    active = np.asarray(ref.body_force)[..., 2] > 0
    assert active.any(), "the states must put some points into the ground"
    for a, b in zip(out, ref):
        # forces of order 1e3 N from sub-mm penetrations: relative
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=2e-4, atol=2e-2)
