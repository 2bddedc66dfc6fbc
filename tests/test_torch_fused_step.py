"""Port parity of the whole-control-step (K1) and report-FK (K2) plain
versions against the JAX engine's XLA path; the wrappers' CPU routing and
launch counters; and the kernels' scope check. The kernels themselves
run in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.models import build_humanoid
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.ops.parity import perturbed_batch, sign_align
from omniisaacgymenvs_torch.physics.engine import (PhysicsEngine, SimParams,
                                                   check_scope)
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder
from omniisaacgymenvs_tpu.physics.state import Control as JControl
from omniisaacgymenvs_tpu.physics.state import State as JState
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from torch_parity import np_

N = 8
N_STEPS = 4  # Humanoid: decimation 2 x substeps 2


@pytest.fixture(scope="module")
def humanoid():
    jtask = jget_task("Humanoid")
    eng = PhysicsEngine(build_humanoid(), SimParams(dt=1.0 / 120.0, substeps=2))
    m = eng.model
    rng = np.random.default_rng(1)
    q, qd = perturbed_batch(np_(m.default_q), m.jq_idx,
                            np_(m.dof_limit_lower), np_(m.dof_limit_upper),
                            m.nv, rng, N, drop=0.5)
    eff = rng.uniform(-40.0, 40.0, (N, m.njd)).astype(np.float32)
    ptg = (0.1 * rng.standard_normal((N, m.njd))).astype(np.float32)
    fa = (2.0 * rng.standard_normal((N, m.nb, 6))).astype(np.float32)
    return jtask.engine, eng, q, qd, eff, ptg, fa


def _jax_step(jeng, q, qd, eff, ptg, fa):
    m = jeng.model

    def one(q1, qd1, e1, p1, f1):
        st = jeng.init_state(q1, qd1)
        ctrl = JControl(effort=e1, pos_target=p1, vel_target=jnp.zeros(m.njd),
                        body_force=f1[:, 3:6], body_torque=f1[:, 0:3])
        s = jeng.step_n(st, ctrl, N_STEPS // jeng.params.substeps)
        return (s.q, s.qd, s.sensor_forces, s.body_pos, s.body_quat,
                s.body_avel, s.body_lvel)

    return jax.jit(jax.vmap(one))(*map(jnp.asarray, (q, qd, eff, ptg, fa)))


def test_step_plain_matches_jax_step_n(humanoid):
    jeng, eng, q, qd, eff, ptg, fa = humanoid
    t = torch.as_tensor
    out = fs.step_plain(eng, t(q), t(qd), t(eff), t(ptg), torch.zeros(N, 21),
                        t(fa), N_STEPS)
    ref = _jax_step(jeng, q, qd, eff, ptg, fa)
    names = ("q", "qd", "sensor_forces", "pos", "quat", "avel", "lvel")
    assert (np.asarray(ref[3])[:, np.asarray(eng.model.cp_body)[-8:], 2]
            < 0.05).any(), "some feet must be at the ground"
    # 4 substeps of float32 dynamics in another operation order:
    # positions to 1e-4, velocities and contact wrenches (stiff contacts
    # amplify rounding) relative; quaternions sign-aligned
    tol = {"q": (1e-3, 1e-4), "qd": (5e-3, 5e-3), "sensor_forces": (1e-3, 1e-2),
           "pos": (1e-3, 1e-4), "quat": (1e-3, 1e-3), "avel": (5e-3, 5e-3),
           "lvel": (5e-3, 5e-3)}
    for name, a, b in zip(names, out, ref):
        a, b = np_(a), np.asarray(b)
        assert a.shape == b.shape, name
        if name == "quat":
            a = np_(sign_align(torch.tensor(a), torch.tensor(b)))
        rtol, atol = tol[name]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def test_fk_plain_matches_jax_report(humanoid):
    jeng, eng, q, qd, *_ = humanoid
    out = fs.fk_plain(eng.model, torch.as_tensor(q), torch.as_tensor(qd))
    st = jax.vmap(lambda a, b: jeng._report_xla(a, b, jnp.zeros((2, 6))))(
        jnp.asarray(q), jnp.asarray(qd))
    ref = (st.body_pos, st.body_quat, st.body_avel, st.body_lvel)
    for name, a, b in zip(("pos", "quat", "avel", "lvel"), out, ref):
        a, b = np_(a), np.asarray(b)
        if name == "quat":
            # Shepperd's small components: ~sqrt(float32 eps) rounding
            a = np_(sign_align(torch.tensor(a), torch.tensor(b)))
            np.testing.assert_allclose(a, b, atol=1e-3)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6, err_msg=name)


def test_cpu_tensors_take_plain_path_and_count_nothing(humanoid):
    _, eng, q, qd, eff, ptg, fa = humanoid
    m = eng.model
    # kernel tables attached, yet CPU tensors must route to the plain path
    eng.kernels = fs.FusedKernels(m, eng.h, eng.params.gravity,
                                  eng.contact_params,
                                  np.stack([np_(g) for g in eng.contact_gains]))
    try:
        t = torch.as_tensor
        args = (t(q), t(qd), t(eff), t(ptg), torch.zeros(N, m.njd), t(fa))
        out = fs.step(eng, *args, N_STEPS)
        ref = fs.step_plain(eng, *args, N_STEPS)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(fs.fk(eng, t(q), t(qd)), fs.fk_plain(m, t(q), t(qd))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert eng.kernels.launches == {"step": 0, "fk": 0}
    finally:
        eng.kernels = None


def test_pack_tables_layout(humanoid):
    _, eng, *_ = humanoid
    m = eng.model
    gains = np.stack([np_(g) for g in eng.contact_gains])
    ftab, itab = fs.pack_tables(m, eng.h, eng.params.gravity,
                                eng.contact_params, gains)
    assert ftab.dtype == np.float32 and itab.dtype == np.int32
    assert ftab.shape == (8 + 64 * m.nb + 8 * m.ncp,)
    assert itab.tolist() == (list(m.parents) + m.cp_body.tolist()
                             + list(m.sensor_body))
    B = 8 + 64 * 5  # body 5, joint dof 4
    h = eng.h
    kd, damp, kp = (float(np_(getattr(m, f))[4]) for f in
                    ("dof_drive_damping", "dof_damping", "dof_stiffness"))
    assert ftab[B + 60] == pytest.approx(h * (kd + damp + h * kp), rel=1e-6)
    np.testing.assert_array_equal(ftab[B:B + 3], np_(m.joint_axis)[5])
    C = 8 + 64 * m.nb + 8 * 3
    np.testing.assert_allclose(ftab[C + 5:C + 8], gains[:, 3], rtol=1e-6)


def test_humanoid_bounds_per_env(humanoid):
    m = humanoid[1].model
    # 250 input and 353 output floats per env
    assert fs.io_bytes(m) == {"step": 4 * 603, "fk": 4 * 341}
    # the counts PERF.md's bounds use: per substep FK 5100, contacts 1344,
    # drives 336, bias 2508, inward 16002, root 223, outward 1407,
    # integration 355; the report FK adds 43 per body to FK
    assert fs.op_count(m, N_STEPS) == {"step": 4 * 27275 + 6046, "fk": 6046}


def test_tolerance_use_scales_per_env():
    b = torch.tensor([[1000.0, 1.0], [1.0, 0.5]])
    a = b + torch.tensor([[0.0, 0.4], [0.4, 0.0]])
    # scale 1e-3: env 0's limit is 1.0, env 1's 1e-3 (its largest is 1.0)
    assert parity.tolerance_use(a, b, 0.0, 1e-3, 0.0) == pytest.approx(400.0)
    assert parity.tolerance_use(a, b, 0.0, 1e-3, 1.0) == pytest.approx(0.4 / 1.001)
    assert parity.tolerance_use(a, b, 0.5, 0.0, 0.0) == pytest.approx(0.8)
    a[1, 1] = float("nan")
    assert parity.tolerance_use(a, b, 1.0, 1.0, 1.0) == float("inf")


def test_check_inputs_put_feet_in_the_ground(humanoid):
    eng = humanoid[1]
    m = eng.model
    q, qd, eff = parity.check_inputs(m, 64, seed=0, device="cpu")
    assert q.dtype == qd.dtype == eff.dtype == torch.float32
    assert q.shape == (64, m.nq) and eff.shape == (64, m.njd)
    z = torch.zeros((64, m.njd))
    sf = fs.step_plain(eng, q, qd, eff, z, z, torch.zeros((64, m.nb, 6)),
                       N_STEPS)[2]
    assert (sf.abs().amax((1, 2)) > 0).float().mean() > 0.25


def _scene(kind):
    b = ModelBuilder(kind)
    if kind == "fixed_root":
        root = b.add_body("base", parent=-1, joint_type=JointType.FIXED)
    else:
        root = b.add_body("base", parent=-1, joint_type=JointType.FREE)
    jt = JointType.PRISMATIC if kind == "prismatic" else JointType.REVOLUTE
    b.add_body("j1", parent=root, joint_type=jt,
               gravity_comp=(kind == "gravity_comp"))
    b.add_body("j2", parent=root)
    b.add_sphere_collider(root, (0, 0, 0), 0.1, receive=(kind == "pairs"))
    if kind == "tendon":
        b.add_fixed_tendon("j1", "j2", stiffness=1.0)
    if kind == "forest":
        b.add_body("ball", parent=-1, joint_type=JointType.FREE)
    if kind == "pairs":
        b.add_body("ball", parent=-1, joint_type=JointType.FREE)
        b.add_sphere_collider(3, (0, 0, 0), 0.05)
    if kind == "too_many_bodies":
        p = 1
        for i in range(fs.NB_MAX):
            p = b.add_body(f"x{i}", parent=p)
    return b.finalize()


@pytest.mark.parametrize("kind", ["fixed_root", "prismatic", "tendon",
                                  "gravity_comp", "forest", "pairs",
                                  "too_many_bodies"])
def test_scope_rejects_out_of_slice_scene(kind):
    with pytest.raises(NotImplementedError):
        check_scope(_scene(kind), cuda=True)


def test_scope_accepts_slice_models():
    from omniisaacgymenvs_torch.models import build_ant

    for m in (build_humanoid(), build_ant(), _scene("plain")):
        assert fs.scope_errors(m) == []
        check_scope(m, cuda=True)
    # a FIXED root is refused only where the kernels would run
    check_scope(_scene("fixed_root"), cuda=False)


@pytest.mark.parametrize("kind", ["tendon", "gravity_comp", "pairs"])
def test_engine_refuses_unported_features(kind):
    with pytest.raises(NotImplementedError):
        PhysicsEngine(_scene(kind), SimParams())
