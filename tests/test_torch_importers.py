"""Port parity of the URDF / MJCF importers (`models/importers.py`), the
builder's `dof_names` / `set_drive`, and the analytic pendulum models.

- Every case of the JAX package's tests/test_importers.py (XML copied
  here), examples/double_pendulum.urdf (FIXED and FREE base) and
  chip_smoke.py's MJCF chain: every field of the port's finalized Model
  equal to the JAX one's (both build in float64 numpy and cast to float32,
  so exactly), and the builders' dof_names, body_by_link, body_by_name and
  actuators equal.
- The importer tests' own checks, on the port's dynamics.
- 8 plain substeps of the port's engine against the JAX engine on the URDF
  example and the MJCF chain, at the step_n tolerances of
  torch_parity.STEP_N_TOL.
- `thread_scope_errors` names a chain beyond the thread form's NB_MAX
  bodies, and the group form takes it: the engine accepts it on CUDA
  (`check_scope`).
- The pendulums' analytic checks (the JAX package's tests/test_dynamics.py).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.models import (build_cartpole, build_double_pendulum,
                                           build_pendulum)
from omniisaacgymenvs_torch.models.common import BodyGeoms
from omniisaacgymenvs_torch.models.importers import from_mjcf, from_urdf
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics import dynamics, spatial
from omniisaacgymenvs_torch.physics.engine import (PhysicsEngine, SimParams,
                                                   check_scope)
from omniisaacgymenvs_tpu.models import importers as jimporters
from omniisaacgymenvs_tpu.models import pendulum as jpendulum
from omniisaacgymenvs_tpu.physics.engine import PhysicsEngine as JPhysicsEngine
from omniisaacgymenvs_tpu.physics.engine import SimParams as JSimParams
from test_torch_model import _assert_model_equal
from torch_parity import assert_step_close, jax_fields, jax_step, np_

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import MJCF_CHAIN  # noqa: E402

EXAMPLE = os.path.join(ROOT, "examples", "double_pendulum.urdf")
G = 9.81
ROD_I = 1.0 * (2 * 0.5) ** 2 / 12.0

CARTPOLE_URDF = f"""
<robot name="Cartpole">
  <link name="rail">
    <inertial><mass value="10"/>
      <inertia ixx="0.1" iyy="0.1" izz="0.1" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="cart">
    <inertial><mass value="1"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="pole">
    <inertial><origin xyz="0 0 0.5"/><mass value="1"/>
      <inertia ixx="{ROD_I}" iyy="{ROD_I}" izz="1e-5" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="cartJoint" type="prismatic">
    <parent link="rail"/><child link="cart"/><axis xyz="1 0 0"/>
    <limit lower="-5" upper="5"/>
  </joint>
  <joint name="poleJoint" type="revolute">
    <parent link="cart"/><child link="pole"/><axis xyz="0 1 0"/>
    <limit lower="-12.56637" upper="12.56637"/>
  </joint>
</robot>
"""

MERGED_URDF = """
<robot name="merged">
  <link name="base">
    <inertial><mass value="2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.02"/>
    </inertial>
  </link>
  <link name="tool">
    <inertial><mass value="3"/>
      <inertia ixx="0.03" iyy="0.03" izz="0.03"/>
    </inertial>
    <collision><origin xyz="0 0 0.1"/>
      <geometry><sphere radius="0.05"/></geometry>
    </collision>
  </link>
  <joint name="weld" type="fixed">
    <parent link="base"/><child link="tool"/>
    <origin xyz="0 0 0.4"/>
  </joint>
</robot>
"""

DEFAULTS_MJCF = """
<mujoco model="pend">
  <compiler angle="degree"/>
  <default>
    <joint damping="0.5" armature="0.02"/>
    <default class="stiff"><joint damping="2.0"/></default>
  </default>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="shoulder" type="hinge" axis="0 1 0"
             range="-90 90" class="stiff"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.6" size="0.04"/>
      <body name="fore" pos="0 0 -0.6">
        <joint name="elbow" type="hinge" axis="0 1 0" range="-45 45"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.03"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

BALL_MJCF = """
<mujoco><compiler angle="radian"/>
  <worldbody>
    <body name="ball" pos="0 0 1">
      <freejoint/>
      <geom type="sphere" size="0.1" density="500"/>
    </body>
  </worldbody>
</mujoco>
"""

MULTI_MJCF = """
<mujoco><compiler angle="radian"/>
  <worldbody>
    <body name="leg" pos="0.1 0 0.5">
      <joint name="hip_x" type="hinge" axis="1 0 0" armature="0.01"/>
      <joint name="hip_y" type="hinge" axis="0 1 0" pos="0 0 -0.1"
             armature="0.01"/>
      <geom type="capsule" fromto="0 0 -0.1 0 0 -0.5" size="0.04"/>
    </body>
  </worldbody>
</mujoco>
"""

NESTED_MJCF = """
<mujoco><compiler angle="radian"/>
  <worldbody>
    <body name="dummy" pos="0.1 0 0.5">
      <joint name="hip_x" type="hinge" axis="1 0 0" armature="0.01"/>
      <geom type="sphere" size="0.01" density="23.8732414637845"
            contype="0" conaffinity="0"/>
      <body name="leg" pos="0 0 0">
        <joint name="hip_y" type="hinge" axis="0 1 0" pos="0 0 -0.1"
               armature="0.01"/>
        <geom type="capsule" fromto="0 0 -0.1 0 0 -0.5" size="0.04"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

QUAT_MJCF = """
<mujoco><compiler angle="radian"/>
  <worldbody>
    <body name="seg" pos="0 0 1" euler="0 1.5707963 0">
      <joint name="j" type="hinge" axis="0 0 1"/>
      <geom type="capsule" fromto="0 0 0 0 0 0.4" size="0.05"/>
    </body>
  </worldbody>
</mujoco>
"""

ACTUATOR_MJCF = """
<mujoco><compiler angle="radian"/>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="shoulder" type="hinge" axis="0 1 0"/>
      <geom type="sphere" size="0.1"/>
    </body>
  </worldbody>
  <actuator><motor name="m1" joint="shoulder" gear="150"/></actuator>
</mujoco>
"""

SWING_URDF = """
<robot name="pend">
  <link name="base"/>
  <link name="bob">
    <inertial><origin xyz="0 0 -1"/><mass value="1"/>
      <inertia ixx="1e-6" iyy="1e-6" izz="1e-6"/>
    </inertial>
  </link>
  <joint name="swing" type="continuous">
    <parent link="base"/><child link="bob"/><axis xyz="0 1 0"/>
  </joint>
</robot>
"""

# name -> (importer, source, keyword arguments)
CASES = {
    "urdf_cartpole": ("urdf", CARTPOLE_URDF, dict(base_pos=(0, 0, 2))),
    "urdf_fixed_merge": ("urdf", MERGED_URDF, dict(floating_base=True)),
    "urdf_swing": ("urdf", SWING_URDF, dict(base_pos=(0, 0, 2))),
    "urdf_example_fixed": ("urdf", EXAMPLE, {}),
    "urdf_example_floating": ("urdf", EXAMPLE, dict(floating_base=True)),
    "mjcf_defaults": ("mjcf", DEFAULTS_MJCF, {}),
    "mjcf_ball": ("mjcf", BALL_MJCF, {}),
    "mjcf_multi_joint": ("mjcf", MULTI_MJCF, {}),
    "mjcf_nested": ("mjcf", NESTED_MJCF, {}),
    "mjcf_body_quat": ("mjcf", QUAT_MJCF, {}),
    "mjcf_actuator": ("mjcf", ACTUATOR_MJCF, {}),
    "mjcf_chain": ("mjcf", MJCF_CHAIN, {}),
}


def builders(name):
    """(port builder, JAX builder) of a case."""
    kind, src, kw = CASES[name]
    if kind == "urdf":
        return from_urdf(src, **kw), jimporters.from_urdf(src, **kw)
    return from_mjcf(src, **kw), jimporters.from_mjcf(src, **kw)


def qdd_of(model, q, qd, tau):
    """ABA of one state (1-D inputs) under gravity."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))[None]  # noqa: E731
    q, qd, tau = t(q), t(qd), t(tau)
    kin = dynamics.kinematics(model, q, qd)
    f_ext = torch.zeros((1, model.nb, 6))
    return dynamics.aba(model, q, qd, tau, f_ext, kin,
                        torch.tensor([0.0, 0.0, -G]))[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_imported_model_equals_jax(name):
    b, jb = builders(name)
    assert b.dof_names == jb.dof_names
    for attr in ("body_by_link", "body_by_name", "actuators"):
        assert getattr(b, attr, None) == getattr(jb, attr, None), attr
    _assert_model_equal(b.finalize(), jax_fields(jb.finalize()))


def test_urdf_cartpole_matches_hand_built():
    ref = build_cartpole()
    imp = from_urdf(CARTPOLE_URDF, base_pos=(0, 0, 2)).finalize()
    assert imp.dof_names == ref.dof_names == ("cartJoint", "poleJoint")
    torch.testing.assert_close(imp.body_mass, ref.body_mass, rtol=1e-6, atol=0)
    torch.testing.assert_close(imp.body_com, ref.body_com, rtol=0, atol=1e-7)
    torch.testing.assert_close(imp.body_inertia, ref.body_inertia, rtol=1e-5, atol=0)
    torch.testing.assert_close(imp.dof_limit_lower, ref.dof_limit_lower,
                               rtol=1e-4, atol=0)
    q, qd, tau = [0.3, 0.7], [-0.2, 1.1], [2.0, 0.0]
    torch.testing.assert_close(qdd_of(imp, q, qd, tau), qdd_of(ref, q, qd, tau),
                               rtol=1e-4, atol=1e-6)
    kin = dynamics.kinematics(imp, imp.default_q[None], torch.zeros(1, imp.nv))
    assert float(kin.pw[0, 1, 2]) == pytest.approx(2.0, abs=1e-6)


def test_urdf_fixed_joint_merging():
    b = from_urdf(MERGED_URDF, floating_base=True)
    m = b.finalize()
    assert m.nb == 1 and m.njd == 0
    assert float(m.body_mass[0]) == pytest.approx(5.0)
    np.testing.assert_allclose(np_(m.body_com[0]), [0, 0, 0.24], atol=1e-7)
    exp = 0.05 + 2 * 0.24 ** 2 + 3 * 0.16 ** 2
    assert float(m.body_inertia[0, 0, 0]) == pytest.approx(exp, rel=1e-6)
    np.testing.assert_allclose(np_(m.cp_pos[0]), [0, 0, 0.5], atol=1e-7)
    assert b.body_by_link["tool"] == 0


def test_mjcf_defaults_degrees_and_limits():
    m = from_mjcf(DEFAULTS_MJCF).finalize()
    assert m.dof_names == ("shoulder", "elbow")
    np.testing.assert_allclose(np_(m.dof_limit_lower), [-np.pi / 2, -np.pi / 4],
                               rtol=1e-6)
    np.testing.assert_allclose(np_(m.dof_damping), [2.0, 0.5])
    np.testing.assert_allclose(np_(m.dof_armature), [0.02, 0.02])


def test_mjcf_geom_density_mass():
    m = from_mjcf(BALL_MJCF).finalize()
    exp_m, _, exp_I = BodyGeoms(500.0).sphere((0, 0, 0), 0.1).finalize()
    assert float(m.body_mass[0]) == pytest.approx(exp_m, rel=1e-6)
    assert float(m.body_inertia[0, 0, 0]) == pytest.approx(exp_I[0, 0], rel=1e-6)
    np.testing.assert_allclose(np_(m.default_q[:3]), [0, 0, 1])


def test_mjcf_multi_joint_chain_equivalence():
    """Two hinges in one body: the explicit nested chain with a 1e-4 kg
    dummy body."""
    ma, mb = from_mjcf(MULTI_MJCF).finalize(), from_mjcf(NESTED_MJCF).finalize()
    assert ma.njd == mb.njd == 2
    q, qd, tau = [0.4, -0.3], [0.5, 0.2], [0.7, -0.1]
    torch.testing.assert_close(qdd_of(ma, q, qd, tau), qdd_of(mb, q, qd, tau),
                               rtol=2e-3, atol=1e-6)
    t = lambda x: torch.tensor([x])  # noqa: E731
    ka = dynamics.kinematics(ma, t(q), t(qd))
    kb = dynamics.kinematics(mb, t(q), t(qd))
    torch.testing.assert_close(ka.pw[0, ma.body_index("hip_y")],
                               kb.pw[0, mb.body_index("hip_y")], rtol=0, atol=1e-5)


def test_mjcf_body_quat_rotation():
    m = from_mjcf(QUAT_MJCF).finalize()
    kin = dynamics.kinematics(m, m.default_q[None], torch.zeros(1, m.nv))
    body = m.body_index("j")
    tip = kin.pw[0, body] + kin.Rw[0, body] @ m.cp_pos[-1]
    np.testing.assert_allclose(np_(tip), [0.4, 0, 1.0], atol=1e-5)


def test_mjcf_actuators_and_set_drive():
    b = from_mjcf(ACTUATOR_MJCF)
    assert b.actuators["m1"] == {"joint": "shoulder", "gear": 150.0}
    b.set_drive("shoulder", stiffness=400.0, damping=40.0, max_effort=80.0)
    m = b.finalize()
    i = m.dof_index("shoulder")
    assert float(m.dof_stiffness[i]) == 400.0
    # damping sets the drive damping, not the passive joint damping
    assert float(m.dof_drive_damping[i]) == 40.0 and float(m.dof_damping[i]) == 0.0
    assert float(m.dof_max_effort[i]) == 80.0
    with pytest.raises(KeyError):
        b.set_drive("nope", stiffness=1.0)


def test_urdf_rotated_fixed_base_swings_at_the_analytic_period():
    m = from_urdf(SWING_URDF, base_pos=(0, 0, 2)).finalize()
    dt = 1e-3
    q, qd = torch.tensor([[0.05]]), torch.zeros(1, 1)
    traj = []
    f_ext = torch.zeros((1, m.nb, 6))
    g = torch.tensor([0.0, 0.0, -G])
    for _ in range(2500):
        kin = dynamics.kinematics(m, q, qd)
        qdd = dynamics.aba(m, q, qd, torch.zeros(1, 1), f_ext, kin, g)
        qd = qd + dt * qdd
        q = q + dt * qd
        traj.append(float(q[0, 0]))
    zc = np.where(np.diff(np.sign(traj)) != 0)[0]
    assert (zc[1] - zc[0]) * dt == pytest.approx(np.pi * np.sqrt(1.0 / G), rel=0.02)


@pytest.mark.parametrize("name", ["urdf_example_fixed", "urdf_example_floating",
                                  "mjcf_chain"])
def test_eight_plain_substeps_match_jax(name):
    """The port's plain step (8 substeps, K1's plain version) against the
    JAX engine's on the check states of ops/parity.py: the FREE example
    lowered onto the ground, the chain's foot in the ground."""
    b, jb = builders(name)
    for bb in (b, jb):
        for dof in bb.dof_names:
            bb.set_drive(dof, stiffness=40.0, damping=2.0, max_effort=100.0)
    pm, jm = b.finalize(), jb.finalize()
    params = dict(dt=1.0 / 120.0, substeps=2)
    eng = PhysicsEngine(pm, SimParams(**params))
    jeng = JPhysicsEngine(jm, JSimParams(**params))
    n = 8
    q, qd, eff = parity.check_inputs(pm, n, seed=3, device="cpu")
    ptg = parity.check_targets(pm, q, 3)
    rng = np.random.default_rng(3)
    fa = (0.05 * rng.standard_normal((n, pm.nb, 6))).astype(np.float32)
    out = fs.step_plain(eng, q, qd, eff, ptg, torch.zeros(n, pm.njd),
                        torch.as_tensor(fa), 8)
    assert_step_close(out, jax_step(jeng, *(np_(x) for x in (q, qd, eff, ptg)), fa, 8))
    if name != "urdf_example_fixed":
        assert parity.active_contacts(eng, q, qd)["ground"] > 0


def test_scope_errors_name_a_chain_beyond_the_kernel_maximum():
    n = fs.NB_MAX + 2
    links = "".join(f'<link name="l{i}"><inertial><mass value="1"/>'
                    f'<inertia ixx="0.01" iyy="0.01" izz="0.01"/></inertial></link>'
                    for i in range(n))
    joints = "".join(f'<joint name="j{i}" type="revolute"><parent link="l{i - 1}"/>'
                     f'<child link="l{i}"/><origin xyz="0 0 -0.1"/>'
                     f'<axis xyz="0 1 0"/></joint>' for i in range(1, n))
    m = from_urdf(f'<robot name="long">{links}{joints}</robot>').finalize()
    assert m.nb == n
    errs = fs.thread_scope_errors(m)
    assert errs == [f"{n} bodies > thread form maximum {fs.NB_MAX}"], errs
    with pytest.raises(ValueError, match=f"{n} bodies"):
        fs.launch_config(m, 512, design="thread")
    assert fs.scope_errors(m) == []
    check_scope(m, cuda=True)
    check_scope(m, cuda=False)


# -- the pendulums (the JAX package's tests/test_dynamics.py) ---------------

def test_pendulum_models_equal_jax():
    _assert_model_equal(build_pendulum(1.3, 0.7), jax_fields(jpendulum.build_pendulum(1.3, 0.7)))
    _assert_model_equal(build_double_pendulum(), jax_fields(jpendulum.build_double_pendulum()))


def test_pendulum_analytic():
    m, l = 1.3, 0.7
    model = build_pendulum(mass=m, length=l)
    for theta in [0.0, 0.4, -1.1, 2.5]:
        qdd = qdd_of(model, [theta], [0.0], [0.0])
        expected = -(m * G * l) * np.sin(theta) / (m * l * l + 1e-6)
        np.testing.assert_allclose(float(qdd[0]), expected, rtol=2e-3, atol=1e-4)


def test_pendulum_applied_torque_at_rest():
    model = build_pendulum(mass=1.0, length=1.0)
    qdd = qdd_of(model, [0.0], [0.0], [2.0])
    np.testing.assert_allclose(float(qdd[0]), 2.0 / (1.0 + 1e-6), rtol=1e-3)


def test_cartpole_analytic():
    mc, mp, hl = 1.0, 1.0, 0.5
    model = build_cartpole(cart_mass=mc, pole_mass=mp, pole_half_length=hl)
    Ip = mp * (2 * hl) ** 2 / 12.0
    rng = np.random.default_rng(3)
    for _ in range(5):
        x, th = rng.uniform(-1, 1), rng.uniform(-1.0, 1.0)
        xd, thd = rng.uniform(-1, 1), rng.uniform(-2, 2)
        F = rng.uniform(-5, 5)
        qdd = qdd_of(model, [x, th], [xd, thd], [F, 0.0])
        A = np.array([[mc + mp, mp * hl * np.cos(th)],
                      [mp * hl * np.cos(th), Ip + mp * hl * hl]])
        rhs = np.array([F + mp * hl * thd * thd * np.sin(th),
                        mp * G * hl * np.sin(th)])
        np.testing.assert_allclose(np_(qdd), np.linalg.solve(A, rhs), rtol=5e-2,
                                   atol=2e-2)


def test_double_pendulum_energy_conservation():
    model = build_double_pendulum()
    engine = PhysicsEngine(model, SimParams(dt=1.0 / 1000.0, substeps=1,
                                            gravity=(0, 0, -G)))
    state = engine.init_state(torch.tensor([[1.2, 0.5]]), torch.zeros(1, 2))
    ctrl = engine.default_control(1)

    def energy(s):
        kin = dynamics.kinematics(model, s.q, s.qd)
        I = spatial.spatial_inertia(model.body_mass, model.body_com,
                                    model.body_inertia)
        ke = 0.5 * torch.einsum("bi,bij,bj->", kin.v[0], I, kin.v[0])
        com_w = kin.pw[0] + (kin.Rw[0] @ model.body_com[..., None])[..., 0]
        return float(ke + (model.body_mass * G * com_w[:, 2]).sum())

    e0 = energy(state)
    for _ in range(500):
        state = engine.step_n(state, ctrl)
    assert abs(energy(state) - e0) / abs(e0) < 0.02
    assert math.isfinite(e0)
