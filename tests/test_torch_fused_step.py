"""Port parity of the whole-control-step (K1) and report-FK (K2) plain
versions against the JAX engine's XLA path; the wrappers' CPU routing and
launch counters; the packed tables; and the kernels' scope check. The
kernels themselves run in tests/test_torch_cuda.py."""

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
from omniisaacgymenvs_tpu.physics.engine import PhysicsEngine as JPhysicsEngine
from omniisaacgymenvs_tpu.physics.engine import SimParams as JSimParams
from omniisaacgymenvs_tpu.physics.state import Control as JControl
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from test_torch_scenes import one_feature_scene
from torch_parity import assert_step_close, jax_model_from_port, jax_step, np_

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
        assert eng.kernels.launches == {"step": 0, "fk": 0, "substep": 0}
    finally:
        eng.kernels = None


def test_pack_tables_layout(humanoid):
    _, eng, *_ = humanoid
    m = eng.model
    gains = np.stack([np_(g) for g in eng.contact_gains])
    ftab, itab = fs.pack_tables(m, eng.h, eng.params.gravity,
                                eng.contact_params, gains)
    assert ftab.dtype == np.float32 and itab.dtype == np.int32
    # header, body and contact-point records, then a 4-float gravity
    # compensation record per body; no pairs, surfaces or tendons
    assert ftab.shape == (8 + 64 * m.nb + 8 * m.ncp + 4 * m.nb,)
    body_rec = np.stack([m.parents, m.jtype, m.q_adr, m.v_adr, m.jdof], 1)
    assert itab.tolist() == (body_rec.reshape(-1).tolist()
                             + m.cp_body.tolist() + list(m.sensor_body))
    assert fs.table_dims(m) == (m.nb, m.ncp, 2, 0, 0, 0, m.nq, m.nv, m.njd)
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
    assert fs.io_bytes(m) == {"step": 4 * 603, "fk": 4 * 341,
                              "substep": 4 * 317}
    # the counts PERF.md's bounds use: per substep FK 5100, contacts 1344,
    # drives 336, bias 2508, inward 16002, root 223, outward 1407,
    # integration 355; the report FK adds 43 per body to FK
    assert fs.op_count(m, N_STEPS) == {"step": 4 * 27275 + 6046, "fk": 6046,
                                       "substep": 27275}


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


def test_pack_tables_sections_of_the_hand_scene():
    from omniisaacgymenvs_torch.tasks import get_task

    eng = get_task("ShadowHand", device="cpu").engine
    m = eng.model
    gains = np.stack([np_(g) for g in eng.contact_gains]).astype(np.float64)
    ftab, itab = fs.pack_tables(m, eng.h, eng.params.gravity,
                                eng.contact_params, gains, eng.pair_gains)
    off = fs.table_offsets(m)
    assert ftab.shape == (off["f_end"],) and itab.shape == (off["i_end"],)
    # gravity compensation: mass of every hand link, none on the cube
    gc = ftab[off["f_gc"]:off["f_pair"]].reshape(m.nb, 4)
    np.testing.assert_allclose(gc[:, 0], np_(m.gravity_comp * m.body_mass))
    np.testing.assert_array_equal(gc[:, 1:], np_(m.body_com))
    assert gc[m.body_index("object"), 0] == 0 and gc[0, 0] > 0
    # pairs: gains, and (point, surface) in the model's order
    pg = ftab[off["f_pair"]:off["f_surf"]].reshape(-1, 4)
    np.testing.assert_allclose(pg[:, :3], eng.pair_gains.T, rtol=1e-6)
    pairs = itab[off["i_pair"]:off["i_surf"]].reshape(-1, 2)
    np.testing.assert_array_equal(pairs[:, 0], m.pair_point)
    assert pairs[:, 1].tolist() == list(m.pair_surf)
    # a box record: centre, half extents, rotation (identity here)
    box = ftab[off["f_surf"]:off["f_surf"] + 16]
    np.testing.assert_allclose(box[:6], m.surf_params[0][:6], rtol=1e-6)
    np.testing.assert_array_equal(box[6:15].reshape(3, 3), np.eye(3))
    # tendons: the joint bodies they couple, and their share of the
    # implicit diagonal h (c + h k_lim) coef^2 on both joints
    tb = itab[off["i_tend"]:].reshape(-1, 2)
    assert [m.body_names[i] for i in tb[0]] == ["FFJ1", "FFJ0"]
    h = eng.h
    for b in tb[0]:
        d = m.jdof[b]
        base = h * float(np_(m.dof_drive_damping)[d] + np_(m.dof_damping)[d]
                         + h * np_(m.dof_stiffness)[d])
        assert ftab[8 + 64 * b + 60] == pytest.approx(
            base + h * (0.1 + h * 30.0), rel=1e-5)


def test_hand_scene_bounds_per_env():
    from omniisaacgymenvs_torch.models import build_shadow_hand

    m = build_shadow_hand()
    # 289 input and 429 output floats per env for K1; K3 writes no report
    assert fs.io_bytes(m) == {"step": 4 * 718, "fk": 4 * 399,
                              "substep": 4 * 380}
    ops = fs.op_count(m, 4)
    assert ops["step"] == 4 * ops["substep"] + ops["fk"]
    # 69 box pairs of 229, 25 compensated bodies of 33 and 4 tendons of 23
    # operations a substep are part of the count
    bare = fs.op_count(dataclasses_replace_no_contacts(m), 4)
    assert ops["substep"] - bare["substep"] == 69 * 229 + 25 * 33 + 4 * 23


def dataclasses_replace_no_contacts(m):
    import dataclasses

    return dataclasses.replace(
        m, pair_surf=(), pair_point=np.zeros(0, np.int32), nt=0,
        tendon_dof=np.zeros((0, 2), np.int32),
        gravity_comp=torch.zeros_like(m.gravity_comp))


@pytest.mark.parametrize("kind", ["fixed_root", "prismatic", "tendon",
                                  "gravity_comp", "forest", "pairs",
                                  "too_many_bodies"])
def test_scope_rejects_out_of_slice_scene(kind):
    """No scene the JAX kernel steps is refused on the card; FIXED roots,
    prismatic joints, tendons, gravity compensation, forests and pairs are
    in both forms' scope, and their plain step matches the JAX engine's on
    the same scene. A chain past the thread form's NB_MAX bodies is in the
    group form's scope, which `launch_config` takes at every width; the
    thread form refuses it by name."""
    if kind == "too_many_bodies":
        pm = one_feature_scene("plain", n_chain=fs.NB_MAX)
        assert fs.scope_errors(pm) == []
        check_scope(pm, cuda=True)
        assert fs.thread_scope_errors(pm) == [
            f"{pm.nb} bodies > thread form maximum {fs.NB_MAX}"]
        with pytest.raises(ValueError, match="bodies > thread form maximum"):
            fs.launch_config(pm, 64, design="thread")
        assert fs.launch_config(pm, 10 ** 6)["design"] == "group"
        # its plain step against the JAX engine: tests/test_torch_scenes.py
        return
    pm = one_feature_scene(kind)
    assert fs.scope_errors(pm) == []
    check_scope(pm, cuda=True)
    _compare_one_step(pm, seed=11)


def _compare_one_step(pm, seed):
    eng = PhysicsEngine(pm, SimParams(dt=1.0 / 120.0, substeps=2))
    jeng = JPhysicsEngine(jax_model_from_port(pm),
                          JSimParams(dt=1.0 / 120.0, substeps=2))
    n = 4
    q, qd, eff = parity.check_inputs(pm, n, seed=seed, device="cpu")
    ptg = parity.check_targets(pm, q, seed)
    fa = torch.zeros((n, pm.nb, 6))
    out = fs.step_plain(eng, q, qd, eff, ptg, torch.zeros_like(ptg), fa, 2)
    ref = jax_step(jeng, np_(q), np_(qd), np_(eff), np_(ptg), np_(fa), 2)
    assert_step_close(out, ref)


def test_scope_accepts_slice_models():
    from omniisaacgymenvs_torch.models import (build_ant, build_balance_bot,
                                               build_cartpole,
                                               build_shadow_hand)

    for m in (build_humanoid(), build_ant(), build_cartpole(),
              build_balance_bot(), build_shadow_hand(),
              build_shadow_hand(self_collisions=True),
              parity.build_pair_scene(), one_feature_scene("plain")):
        assert fs.scope_errors(m) == [] and fs.thread_scope_errors(m) == []
        check_scope(m, cuda=True)
    # a chain past the thread form's maxima is taken on every device
    for cuda in (False, True):
        check_scope(one_feature_scene("plain", n_chain=fs.NB_MAX), cuda=cuda)


@pytest.mark.parametrize("kind", ["tendon", "gravity_comp", "pairs"])
def test_engine_refuses_unported_features(kind):
    """The engine steps tendons, gravity compensation and pair contacts on
    every device (a second seed of the scene against the JAX engine), and
    takes terrain functions and randomization overlays; what it refuses is
    an overlay of the wrong shape."""
    pm = one_feature_scene(kind)
    _compare_one_step(pm, seed=12)
    eng = PhysicsEngine(pm, SimParams())
    assert not eng.has_terrain
    flat_n = torch.tensor([0.0, 0.0, 1.0])
    by_height = PhysicsEngine(
        pm, SimParams(),
        height_fn=lambda x, y: (torch.zeros_like(x), flat_n.expand(x.shape + (3,))))
    by_plane = PhysicsEngine(
        pm, SimParams(), plane_refresh=True,
        contact_plane_fn=lambda p, r: (flat_n.expand(p.shape),
                                       torch.zeros_like(p[..., 0])))
    assert by_height.has_terrain and by_plane.has_terrain
    # the refresh needs a contact_plane_fn: one launch per substep with it
    assert (eng.k1_launches(2), by_height.k1_launches(2),
            by_plane.k1_launches(2)) == (1, 1, 2)
    st = eng.init_state(pm.default_q[None], torch.zeros((1, pm.nv)))
    with pytest.raises(ValueError, match="shape"):
        eng.step_n(st, eng.default_control(1), 1,
                   overlay={"mass_scale": torch.ones(pm.nb)})
    heavy = eng.step_n(st, eng.default_control(1), 1,
                       overlay={"mass_scale": torch.full((1, pm.nb), 1.5)})
    assert torch.isfinite(heavy.qd).all()
    # a terrain that is the plane z = 0 steps as flat ground does (another
    # friction formula: the general normal's, three tangential components)
    a = eng.step_n(st, eng.default_control(1), 1)
    for other in (by_height, by_plane):
        b = other.step_n(st, other.default_control(1), 1)
        torch.testing.assert_close(b.q, a.q, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b.qd, a.qd, rtol=1e-4, atol=1e-5)


def _oversized(what):
    b = ModelBuilder(what)
    root = b.add_body("base", parent=-1, joint_type=JointType.FREE)
    b.add_body("j1", parent=root)
    b.add_body("j2", parent=root)
    if what == "contact points":
        for _ in range(fs.NCP_MAX + 1):
            b.add_sphere_collider(root, (0, 0, 0), 0.1)
    elif what == "sensors":
        for _ in range(fs.NS_MAX + 1):
            b.add_force_sensor(root)
    elif what == "receiver surfaces":
        for _ in range(fs.NSURF_MAX + 1):
            b.add_sphere_collider(root, (0, 0, 0), 0.1, receive=True)
    elif what == "contact pairs":
        for _ in range(20):
            b.add_sphere_collider(root, (0, 0, 0), 0.1, receive=True)
        ball = b.add_body("ball", parent=-1, joint_type=JointType.FREE)
        for _ in range(fs.NPAIR_MAX // 20 + 1):
            b.add_sphere_collider(ball, (0, 0, 0), 0.1)
    elif what == "fixed tendons":
        for _ in range(fs.NT_MAX + 1):
            b.add_fixed_tendon("j1", "j2")
    elif what == "FREE roots":
        for i in range(fs.NFREE_MAX):
            b.add_body(f"r{i}", parent=-1, joint_type=JointType.FREE)
    return b.finalize()


@pytest.mark.parametrize("what", ["contact points", "sensors",
                                  "receiver surfaces", "contact pairs",
                                  "fixed tendons", "FREE roots"])
def test_scope_rejects_beyond_kernel_maxima(what):
    """Each compile-time maximum binds the thread form alone: its scope
    names exactly that maximum and `launch_config` refuses the form, while
    the group form takes the model, so the engine accepts it on the card
    and `launch_config` never picks the thread form for it."""
    pm = _oversized(what)
    errs = fs.thread_scope_errors(pm)
    assert len(errs) == 1 and f"{what} > thread form maximum" in errs[0], errs
    with pytest.raises(ValueError, match=what):
        fs.launch_config(pm, 64, design="thread")
    assert fs.scope_errors(pm) == []
    check_scope(pm, cuda=True)
    check_scope(pm, cuda=False)
    assert fs.launch_config(pm, 10 ** 6)["design"] == "group"


def test_task_registry_refuses_randomization_and_unported_tasks():
    """Randomization and the OpenAI names are ported; Custom without a robot
    raises as the JAX package's does; an unknown name raises KeyError."""
    from omniisaacgymenvs_torch.tasks import get_task

    task = get_task("ShadowHand", {"domain_randomization": {"randomize": True}},
                    device="cpu")
    assert task._dr_on
    assert get_task("ShadowHandOpenAI_FF", device="cpu").num_obs == 42
    with pytest.raises(ValueError, match="robot"):
        get_task("Custom", device="cpu")
    with pytest.raises(KeyError, match="unknown task"):
        get_task("NoSuchTask", device="cpu")


def test_registry_holds_the_fourteen_reference_names():
    """The port registers the JAX package's 15 names: the 14 reference
    tasks and Custom."""
    from omniisaacgymenvs_torch import tasks as ttasks
    from omniisaacgymenvs_tpu import tasks as jtasks

    assert len(ttasks._registry()) == 15
    assert not hasattr(ttasks, "NOT_PORTED")
    assert set(ttasks._registry()) == set(jtasks._registry())


@pytest.mark.parametrize("name", ["FrankaCabinet", "Crazyflie", "Quadcopter",
                                  "Ingenuity", "AllegroHand"])
def test_arm_hand_and_flyer_tasks_run_on_cuda_by_default(name):
    """A task builds on the card unless the CPU is asked for, and raises
    where there is no card; device="cpu" builds it on the CPU."""
    from omniisaacgymenvs_torch.tasks import get_task

    if torch.cuda.is_available():
        assert get_task(name).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_task(name)
    task = get_task(name, device="cpu")
    assert task.device.type == "cpu" and task.model.default_q.device.type == "cpu"
