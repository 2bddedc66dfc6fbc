"""Port parity of the view API (`envs/views.py`) against the JAX package's:
every getter and setter of `ArticulationView` and `RigidPrimView` on the
same batched state, made from a seed with numpy; `indices=` as a mask and
as an index tensor, `joint_indices=`, the `set_velocities` round trip
through the report FK, and `apply_forces` with global and body-local
forces. Views only index, rotate and merge, so the tolerances are float32
rounding of one rotation (1e-6) or none."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.envs.views import (ArticulationView, RigidPrimView,
                                               _env_select)
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.envs import views as jviews
from omniisaacgymenvs_tpu.physics.state import Control as JControl
from omniisaacgymenvs_tpu.physics.state import State as JState
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from torch_parity import np_

N = 6
ROT = dict(rtol=1e-6, atol=1e-6)   # one quaternion rotation in float32
INDICES = {"none": None, "mask": np.array([1, 0, 1, 0, 0, 1], bool),
           "index": np.array([4, 0])}


def _state(task, seed=0):
    """(port State, JAX State): random fields of the task's shapes, unit
    quaternions."""
    m = task.model
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal((N,) + s).astype(np.float32)  # noqa: E731
    q = r(m.nq)
    for root in m.roots:
        if m.jtype[root] == 0:
            qa = m.q_adr[root]
            q[:, qa + 3:qa + 7] /= np.linalg.norm(q[:, qa + 3:qa + 7], axis=1,
                                                  keepdims=True)
    quat = r(m.nb, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    f = dict(q=q, qd=r(m.nv), body_pos=r(m.nb, 3), body_quat=quat,
             body_lvel=r(m.nb, 3), body_avel=r(m.nb, 3),
             sensor_forces=r(m.num_sensors, 6))
    from omniisaacgymenvs_torch.physics.state import State
    return (State(**{k: torch.as_tensor(v) for k, v in f.items()}),
            JState(**{k: jnp.asarray(v) for k, v in f.items()}))


def _tasks(name, cfg=None):
    return get_task(name, cfg, device="cpu"), jget_task(name, cfg)


def _close(a, b, **tol):
    np.testing.assert_allclose(np_(a), np.asarray(b), **(tol or dict(rtol=0, atol=0)))


@pytest.mark.parametrize("name,root", [("Anymal", None), ("BallBalance", None),
                                       ("FrankaCabinet", "cabinet"),
                                       ("FrankaCabinet", None)])
def test_articulation_getters(name, root):
    task, jtask = _tasks(name, {"env": {"numProps": 2}} if name == "FrankaCabinet" else None)
    st, jst = _state(task)
    v, jv = ArticulationView(task.model, root), jviews.ArticulationView(jtask.model, root)
    assert v.num_dof == jv.num_dof
    _close(v.get_dof_limits(), jv.get_dof_limits())
    for a, b in zip(v.get_world_poses(st), jv.get_world_poses(jst)):
        _close(a, b)
    _close(v.get_velocities(st), jv.get_velocities(jst))
    _close(v.get_joint_positions(st), jv.get_joint_positions(jst))
    _close(v.get_joint_velocities(st), jv.get_joint_velocities(jst))
    sub = [0, v.num_dof - 1]
    _close(v.get_joint_positions(st, joint_indices=sub),
           jv.get_joint_positions(jst, joint_indices=jnp.asarray(sub)))
    _close(v.get_joint_velocities(st, joint_indices=sub),
           jv.get_joint_velocities(jst, joint_indices=jnp.asarray(sub)))
    _close(v.get_force_sensor_forces(st), jv.get_force_sensor_forces(jst))
    for dof in (0, v.num_dof - 1):
        dname = task.model.dof_names[int(v._dofs[dof])]
        assert v.get_dof_index(dname) == jv.get_dof_index(dname) == dof


def test_dof_index_and_fixed_root_guards():
    task, _ = _tasks("FrankaCabinet")
    arm, cab = ArticulationView(task.model), ArticulationView(task.model, "cabinet")
    assert (arm.num_dof, cab.num_dof) == (9, 4)
    assert cab.get_dof_index("drawer_top_joint") == 3
    with pytest.raises(ValueError):
        arm.get_dof_index("drawer_top_joint")
    st, _ = _state(task)
    with pytest.raises(ValueError):
        arm.set_world_poses(st, st.q[:, 0:3], st.q[:, 3:7])
    with pytest.raises(ValueError):
        ArticulationView(task.model, "panda_joint1")


@pytest.mark.parametrize("kind", sorted(INDICES))
@pytest.mark.parametrize("joints", [None, [0, 4, 8]])
def test_joint_setters(kind, joints):
    task, jtask = _tasks("Anymal")
    st, jst = _state(task, seed=1)
    v, jv = ArticulationView(task.model), jviews.ArticulationView(jtask.model)
    k = v.num_dof if joints is None else len(joints)
    vals = np.random.default_rng(2).standard_normal((N, k)).astype(np.float32)
    idx = INDICES[kind]
    tidx = None if idx is None else torch.as_tensor(idx)
    jidx = None if idx is None else jnp.asarray(idx)
    jj = None if joints is None else jnp.asarray(joints)
    q0, qd0 = st.q.clone(), st.qd.clone()
    out = v.set_joint_positions(st, torch.as_tensor(vals), indices=tidx,
                                joint_indices=joints)
    ref = jv.set_joint_positions(jst, jnp.asarray(vals), indices=jidx,
                                 joint_indices=jj)
    _close(out.q, ref.q)
    out = v.set_joint_velocities(out, torch.as_tensor(vals), indices=tidx,
                                 joint_indices=joints)
    ref = jv.set_joint_velocities(ref, jnp.asarray(vals), indices=jidx,
                                  joint_indices=jj)
    _close(out.qd, ref.qd)
    # a new state; the caller's tensors stay as they were
    assert torch.equal(st.q, q0) and torch.equal(st.qd, qd0)
    assert out.body_pos is st.body_pos
    if idx is not None:
        sel = np.zeros(N, bool)
        sel[idx] = True
        assert torch.equal(out.q[~sel], q0[~sel])
        assert not torch.equal(out.q[sel], q0[sel])


@pytest.mark.parametrize("kind", sorted(INDICES))
def test_root_setters(kind):
    task, jtask = _tasks("Anymal")
    st, jst = _state(task, seed=3)
    v, jv = ArticulationView(task.model), jviews.ArticulationView(jtask.model)
    rng = np.random.default_rng(4)
    pos = rng.standard_normal((N, 3)).astype(np.float32)
    quat = rng.standard_normal((N, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    vel = rng.standard_normal((N, 6)).astype(np.float32)
    idx = INDICES[kind]
    tidx = None if idx is None else torch.as_tensor(idx)
    jidx = None if idx is None else jnp.asarray(idx)
    q0 = st.q.clone()
    out = v.set_world_poses(st, torch.as_tensor(pos), torch.as_tensor(quat),
                            indices=tidx)
    ref = jv.set_world_poses(jst, jnp.asarray(pos), jnp.asarray(quat), indices=jidx)
    _close(out.q, ref.q)
    out = v.set_velocities(out, torch.as_tensor(vel), indices=tidx)
    ref = jv.set_velocities(ref, jnp.asarray(vel), indices=jidx)
    _close(out.qd, ref.qd, **ROT)
    assert torch.equal(st.q, q0)


def test_set_velocities_world_round_trip():
    """World [linear, angular] velocities written through the root's
    body frame read back from the report FK."""
    task, _ = _tasks("Anymal")
    st, _ = _state(task, seed=5)
    v = ArticulationView(task.model)
    vel = torch.as_tensor(np.random.default_rng(6).standard_normal((N, 6)),
                          dtype=torch.float32)
    out = v.set_velocities(st, vel)
    rep = task.engine.init_state(out.q, out.qd)
    torch.testing.assert_close(v.get_velocities(rep), vel, rtol=1e-5, atol=1e-5)


def test_env_select_mask_and_index():
    old, new = torch.zeros(N, 2), torch.ones(N, 2)
    a = _env_select(old, new, torch.tensor([True, False] * 3))
    b = _env_select(old, new, torch.tensor([0, 2, 4]))
    ref = jviews._env_select(jnp.zeros((N, 2)), jnp.ones((N, 2)), jnp.array([0, 2, 4]))
    _close(a, ref)
    _close(b, ref)
    assert _env_select(old, new, None) is new


@pytest.mark.parametrize("is_global", [True, False])
def test_rigid_prim_view(is_global):
    """Getters and apply_forces (global, and body-local rotated by the
    bodies' quaternions) on the Ingenuity's rotors, the force added to the
    control's own."""
    task, jtask = _tasks("Ingenuity")
    st, jst = _state(task, seed=7)
    names = ["rotor_physics_0", "rotor_physics_1"]
    v, jv = RigidPrimView(task.model, names), jviews.RigidPrimView(jtask.model, names)
    for a, b in zip(v.get_world_poses(st), jv.get_world_poses(jst)):
        _close(a, b)
    _close(v.get_velocities(st), jv.get_velocities(jst))
    rng = np.random.default_rng(8)
    f = rng.standard_normal((N, 2, 3)).astype(np.float32)
    base = rng.standard_normal((N, task.model.nb, 3)).astype(np.float32)
    ctrl = task.engine.default_control(N)
    ctrl.body_force = torch.as_tensor(base)
    jd = jtask.engine.default_control()
    jctrl = JControl(**{fl.name: jnp.broadcast_to(getattr(jd, fl.name),
                                                  (N,) + getattr(jd, fl.name).shape)
                        for fl in dataclasses.fields(jd)}).replace(
        body_force=jnp.asarray(base))
    out = v.apply_forces(ctrl, torch.as_tensor(f), is_global=is_global,
                         state=None if is_global else st)
    ref = jv.apply_forces(jctrl, jnp.asarray(f), is_global=is_global,
                          state=None if is_global else jst)
    _close(out.body_force, ref.body_force, **ROT)
    assert torch.equal(ctrl.body_force, torch.as_tensor(base))
    assert out.pos_target is ctrl.pos_target
    if not is_global:
        with pytest.raises(ValueError):
            v.apply_forces(ctrl, torch.as_tensor(f), is_global=False)
