"""Card tests of the PyTorch port: each kernel (K1 whole control step, K2
report FK, K3 single substep) against its plain version on the card, on
the Humanoid, BallBalance, ShadowHand, Anymal and the synthetic pair scene,
K1 and K3 on AnymalTerrain's contact planes, K1 and K3 under a
domain-randomization overlay (all four kernel variants), the engine's
launches with and without the plane refresh, a chain past the thread
form's maxima stepped by the group form, the learner's checkpoints across
devices (saved on the card and loaded on the CPU, and back, FF and LSTM),
and FrankaCabinet, AllegroHand, Ingenuity, Quadcopter and Crazyflie (K1 in
both forms and K2 at their yamls' depths, a rollout's launches, 16 Franka
props stepped by the group form), and Custom on imported robots (the URDF
example with a FIXED and a FREE base, chip_smoke.py's MJCF chain: K1 in
both forms and K2, a rollout's launches, a URDF chain beyond NB_MAX
stepped by the group form) and the
refusal of a launch on a second device in one process, and the networks'
"bf16_operands" matmul rule on the card against the same layer on the CPU.
They skip without a CUDA device. This file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.networks import round_bf16, rounded_linear
from omniisaacgymenvs_torch.learn.ppo import _flatten
from omniisaacgymenvs_torch.models import build_humanoid
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder
from omniisaacgymenvs_torch.tasks import get_task
from torch_parity import cuda_device  # noqa: F401

N_STEPS = 4


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    """K1 and K2 on the card against their plain versions on the card, at
    an env count that is not a multiple of the block size (masked tail),
    with the tolerances of ops/parity.py."""
    eng = PhysicsEngine(build_humanoid(device=cuda_device),
                        SimParams(dt=1.0 / 120.0, substeps=2))
    m = eng.model
    n = 515
    q, qd, eff = parity.check_inputs(m, n, seed=2, device=cuda_device)
    z = torch.zeros((n, m.njd), device=cuda_device)
    fa = torch.zeros((n, m.nb, 6), device=cuda_device)
    out = fs.step(eng, q, qd, eff, z, z, fa, N_STEPS)
    ref = fs.step_plain(eng, q, qd, eff, z, z, fa, N_STEPS)
    torch.cuda.synchronize()
    assert eng.kernels.launches["step"] == 1
    parity.assert_within("K1", parity.compare(out, ref, parity.STEP_NAMES,
                                              parity.STEP_TOL), parity.STEP_TOL)
    out = fs.fk(eng, q, qd)
    ref = fs.fk_plain(m, q, qd)
    parity.assert_within("K2", parity.compare(out, ref, parity.FK_NAMES,
                                              parity.FK_TOL), parity.FK_TOL)
    assert eng.kernels.launches["fk"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["BallBalance", "ShadowHand", "Cartpole",
                                  "PairScene", "Anymal"])
def test_kernels_match_plain_on_card_forest_scenes(name, cuda_device):
    """K1, K2 and K3 on scenes with FIXED roots, forests, prismatic joints,
    pair contacts, gravity compensation and tendons, on check states with
    pairs in contact; tolerances from ops/parity.py only."""
    if name == "PairScene":
        eng = PhysicsEngine(parity.build_pair_scene(cuda_device),
                            SimParams(dt=1.0 / 120.0, substeps=2))
    else:
        eng = get_task(name, device=cuda_device).engine
    m = eng.model
    n = 1061
    q, qd, eff = parity.check_inputs(m, n, seed=3, device=cuda_device)
    ptg = parity.check_targets(m, q, 3)
    z = torch.zeros((n, m.njd), device=cuda_device)
    fa = torch.zeros((n, m.nb, 6), device=cuda_device)
    active = parity.active_contacts(eng, q, qd)
    if len(m.pair_surf):
        assert active["pairs"] > 0
    if name == "PairScene":
        assert min(active[k] for k in ("sphere", "capsule", "box")) > 0
    tol = parity.step_tol(m)
    out = fs.step(eng, q, qd, eff, ptg, z, fa, N_STEPS)
    ref = fs.step_plain(eng, q, qd, eff, ptg, z, fa, N_STEPS)
    parity.assert_within(f"{name} K1", parity.compare(
        out, ref, parity.STEP_NAMES, tol), tol)
    out = fs.substep(eng, q, qd, eff, ptg, z, fa)
    ref = fs.substep_plain(eng, q, qd, eff, ptg, z, fa)
    parity.assert_within(f"{name} K3", parity.compare(
        out, ref, parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL), parity.SUBSTEP_TOL)
    out = fs.fk(eng, q, qd)
    ref = fs.fk_plain(m, q, qd)
    parity.assert_within(f"{name} K2", parity.compare(
        out, ref, parity.FK_NAMES, parity.FK_TOL), parity.FK_TOL)
    torch.cuda.synchronize()
    assert eng.kernels.launches == {"step": 1, "fk": 1, "substep": 1}


@pytest.mark.cuda
def test_engine_step_and_substep_launch_once_on_card(cuda_device):
    """`step_n` is one K1 launch and `init_state` one K2 launch; a K3
    launch agrees bit for bit with K1 run for one substep."""
    eng = get_task("BallBalance", device=cuda_device).engine
    m = eng.model
    q, qd, _ = parity.check_inputs(m, 300, seed=4, device=cuda_device)
    st = eng.init_state(q, qd)
    ctrl = eng.default_control(300)
    eng.step_n(st, ctrl, 2)
    assert eng.kernels.launches == {"step": 1, "fk": 1, "substep": 0}
    fa = torch.zeros((300, m.nb, 6), device=cuda_device)
    q3, qd3, sf3 = fs.substep(eng, q, qd, ctrl.effort, ctrl.pos_target,
                              ctrl.vel_target, fa)
    one = fs.step(eng, q, qd, ctrl.effort, ctrl.pos_target, ctrl.vel_target,
                  fa, 1)
    for a, b in zip((q3, qd3, sf3), one[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# a small terrain grid: 4 levels x 10 types, every terrain kind twice
TERRAIN = {"numLevels": 4, "numTerrains": 10}


def _terrain_case(device, n, seed, **terrain):
    task = get_task("AnymalTerrain", {"env": {"terrain": {**TERRAIN, **terrain}}},
                    device=device)
    eng, m = task.engine, task.model
    q, qd, eff = parity.terrain_check_inputs(task, n, seed, device)
    ptg = parity.check_targets(m, q, seed)
    z = torch.zeros((n, m.njd), device=device)
    fa = torch.zeros((n, m.nb, 6), device=device)
    planes = eng._contact_planes(eng.init_state(q, qd))
    return task, (q, qd, eff, ptg, z, fa), planes


@pytest.mark.cuda
def test_kernels_match_plain_on_card_with_terrain_planes(cuda_device):
    """K1 (one substep, as the plane refresh launches it, and four substeps
    on the same planes) and K3 on AnymalTerrain's planes against their
    plain versions given the same planes tensor; treads, riser walls, step
    edges and wedge points all in contact; K3 equals K1 run for one substep
    bit for bit."""
    n = 1061
    task, ins, planes = _terrain_case(cuda_device, n, seed=3)
    eng, m = task.engine, task.model
    active = parity.terrain_contacts(task, eng, ins[0], ins[1])
    assert min(active.values()) > 0, active
    tol = parity.step_tol(m)
    one = fs.step(eng, *ins, 1, planes=planes)
    for n_steps, out in ((1, one), (4, fs.step(eng, *ins, 4, planes=planes))):
        ref = fs.step_plain(eng, *ins, n_steps, planes=planes)
        parity.assert_within(f"AnymalTerrain K1 x{n_steps}", parity.compare(
            out, ref, parity.STEP_NAMES, tol), tol)
    out = fs.substep(eng, *ins, planes=planes)
    ref = fs.substep_plain(eng, *ins, planes=planes)
    parity.assert_within("AnymalTerrain K3", parity.compare(
        out, ref, parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL), parity.SUBSTEP_TOL)
    for a, b in zip(out, one[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.cuda.synchronize()
    eng.kernels.reset_counts()
    # a wrong shape, the planes missing, and planes on a flat engine raise
    # before any launch
    with pytest.raises(ValueError, match="shape"):
        fs.step(eng, *ins, 1, planes=planes[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fs.substep(eng, *ins, planes=planes[:, :, [3, 0, 1, 2]].transpose(1, 2)
                   .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="needs `planes`"):
        fs.step(eng, *ins, 1)
    with pytest.raises(ValueError):
        fs.step(eng, *ins, 1, planes=planes.cpu())
    flat = get_task("Anymal", device=cuda_device).engine
    with pytest.raises(ValueError, match="without terrain"):
        fs.step(flat, ins[0][:, :flat.model.nq].contiguous(), *ins[1:], 1,
                planes=planes[:, :flat.model.ncp].contiguous())
    assert eng.kernels.launches == {"step": 0, "fk": 0, "substep": 0}
    assert flat.kernels.launches == {"step": 0, "fk": 0, "substep": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("refresh", [True, False])
def test_terrain_engine_launches_once_per_substep_with_refresh(refresh, cuda_device):
    """`step_n` with the plane refresh is one K1 launch of one substep per
    substep, each on the planes of the state before it; without, one launch
    of all substeps on planes sampled once. Either way it equals the plain
    path run the same way."""
    n = 300
    task, ins, planes = _terrain_case(cuda_device, n, seed=4,
                                      planeRefresh=refresh)
    eng = task.engine
    q, qd, eff, ptg, z, fa = ins
    st = eng.init_state(q, qd)
    ctrl = eng.default_control(n)
    ctrl.effort, ctrl.pos_target = eff, ptg
    eng.kernels.reset_counts()
    out = eng.step_n(st, ctrl, task.decimation)
    assert eng.kernels.launches == {"step": 4 if refresh else 1, "fk": 0,
                                    "substep": 0}
    assert eng.k1_launches(task.decimation) == (4 if refresh else 1)
    rq, rqd = q, qd
    ref = None
    pl = planes
    for _ in range(4 if refresh else 1):
        ref = fs.step_plain(eng, rq, rqd, eff, ptg, z, fa, 1 if refresh else 4,
                            planes=pl)
        rq, rqd = ref[0], ref[1]
        if refresh:
            # the kernel path samples from its own reported state; feed the
            # plain path planes from the plain state (no tie in these states)
            pl = eng._contact_planes(eng.init_state(rq, rqd))
    tol = parity.step_tol(task.model)
    got = (out.q, out.qd, out.sensor_forces, out.body_pos, out.body_quat,
           out.body_avel, out.body_lvel)
    parity.assert_within("AnymalTerrain step_n", parity.compare(
        got, ref, parity.STEP_NAMES, tol), tol)


def _scene_engine(name, device):
    if name == "PairScene":
        return PhysicsEngine(parity.build_pair_scene(device),
                             SimParams(dt=1.0 / 120.0, substeps=2))
    return get_task(name, device=device).engine


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ShadowHand", "BallBalance", "PairScene",
                                  "Humanoid"])
def test_kernels_match_plain_on_card_with_overlay(name, cuda_device):
    """K1 and K3 under an overlay of every key the model has a size for
    (drawn over the ShadowHandOpenAI_FF yaml's ranges, on every body, joint
    and tendon) against their plain versions; every key moves the result;
    an all-neutral overlay gives what no overlay gives, to rounding; the
    counters tell the overlay launches apart."""
    eng = _scene_engine(name, cuda_device)
    m = eng.model
    n = 1061
    q, qd, eff = parity.check_inputs(m, n, seed=3, device=cuda_device)
    ptg = parity.check_targets(m, q, 3)
    z = torch.zeros((n, m.njd), device=cuda_device)
    fa = torch.zeros((n, m.nb, 6), device=cuda_device)
    ins = (q, qd, eff, ptg, z, fa)
    ov = parity.overlay_inputs(m, n, seed=3, device=cuda_device)
    assert set(ov) == {k for k, s in fs.overlay_sizes(m).items() if s}
    q = parity.clear_box_ties(eng, q, qd, ov)
    ins = (q, *ins[1:])
    tol = parity.step_tol(m)
    out = fs.step(eng, *ins, N_STEPS, overlay=ov)
    ref = fs.step_plain(eng, *ins, N_STEPS, overlay=ov)
    # judged on the envs whose step is well conditioned (ops/parity.py)
    keep = parity.well_conditioned(
        lambda q_, qd_: fs.step_plain(eng, q_, qd_, *ins[2:], N_STEPS, overlay=ov),
        q, qd, ref, parity.STEP_NAMES, tol)
    parity.assert_within(f"{name} K1 overlay", parity.compare(
        out, ref, parity.STEP_NAMES, tol, keep), tol)
    out3 = fs.substep(eng, *ins, overlay=ov)
    ref3 = fs.substep_plain(eng, *ins, overlay=ov)
    keep3 = parity.well_conditioned(
        lambda q_, qd_: fs.substep_plain(eng, q_, qd_, *ins[2:], overlay=ov),
        q, qd, ref3, parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL)
    parity.assert_within(f"{name} K3 overlay", parity.compare(
        out3, ref3, parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL, keep3),
        parity.SUBSTEP_TOL)
    assert eng.kernels.launches == {"step": 1, "fk": 0, "substep": 1}
    assert eng.kernels.overlay_launches == {"step": 1, "substep": 1}
    bare = fs.step(eng, *ins, N_STEPS)
    assert eng.kernels.overlay_launches["step"] == 1
    for key, val in ov.items():
        one = fs.step(eng, *ins, N_STEPS, overlay={key: val})
        if name not in ("ShadowHand", "BallBalance") or (
                key.startswith("limit_") and name != "ShadowHand"):
            # the Humanoid has no drive gains to scale, and only the hand's
            # check states hold joints on a limit
            continue
        assert (one[1] - bare[1]).abs().max() > 1e-6, key
    neutral = {k: torch.ones_like(v) if k.endswith("_scale")
               else torch.zeros_like(v) for k, v in ov.items()}
    same = fs.step(eng, *ins, N_STEPS, overlay=neutral)
    parity.assert_within(f"{name} K1 neutral overlay vs none", parity.compare(
        same, bare, parity.STEP_NAMES, tol), tol)
    # a wrong shape, dtype, device or key raises before any launch
    eng.kernels.reset_counts()
    key = next(iter(ov))
    with pytest.raises(ValueError, match="shape"):
        fs.step(eng, *ins, 1, overlay={key: ov[key][:-1]})
    with pytest.raises(TypeError):
        fs.substep(eng, *ins, overlay={key: ov[key].double()})
    with pytest.raises(ValueError):
        fs.step(eng, *ins, 1, overlay={key: ov[key].cpu()})
    with pytest.raises(KeyError, match="unknown overlay key"):
        fs.step(eng, *ins, 1, overlay={"inertia_scale": ov[key]})
    assert eng.kernels.launches == {"step": 0, "fk": 0, "substep": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card_with_planes_and_overlay(cuda_device):
    """The fourth kernel variant: terrain planes and an overlay together,
    K1 at one and at four substeps and K3; through the engine the plane
    refresh hands every launch the same overlay."""
    n = 1061
    task, ins, planes = _terrain_case(cuda_device, n, seed=3)
    eng, m = task.engine, task.model
    ov = parity.overlay_inputs(m, n, seed=3, device=cuda_device)
    tol = parity.step_tol(m)
    for n_steps in (1, 4):
        out = fs.step(eng, *ins, n_steps, planes=planes, overlay=ov)
        ref = fs.step_plain(eng, *ins, n_steps, planes=planes, overlay=ov)
        parity.assert_within(f"AnymalTerrain K1 x{n_steps} overlay",
                             parity.compare(out, ref, parity.STEP_NAMES, tol),
                             tol)
    out = fs.substep(eng, *ins, planes=planes, overlay=ov)
    ref = fs.substep_plain(eng, *ins, planes=planes, overlay=ov)
    parity.assert_within("AnymalTerrain K3 overlay", parity.compare(
        out, ref, parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL), parity.SUBSTEP_TOL)
    q, qd, eff, ptg, z, fa = ins
    st = eng.init_state(q, qd)
    ctrl = eng.default_control(n)
    ctrl.effort, ctrl.pos_target = eff, ptg
    eng.kernels.reset_counts()
    eng.step_n(st, ctrl, task.decimation, overlay=ov)
    assert eng.kernels.launches["step"] == eng.k1_launches(task.decimation) == 4
    assert eng.kernels.overlay_launches == {"step": 4, "substep": 0}


def _k1_against_plain(eng, label, n=515, seed=7, n_steps=N_STEPS):
    """One K1 launch (the form and placement `launch_config` picks) against
    its plain version on the card, on check states; the group form for a
    model past the thread form's maxima, and no plain physics in the
    launch."""
    m = eng.model
    q, qd, eff = parity.check_inputs(m, n, seed=seed, device=eng.device)
    ptg = parity.check_targets(m, q, seed)
    z = torch.zeros((n, m.njd), device=eng.device)
    fa = torch.zeros((n, m.nb, 6), device=eng.device)
    eng.kernels.reset_counts()
    out = fs.step(eng, q, qd, eff, ptg, z, fa, n_steps)
    torch.cuda.synchronize()
    assert eng.kernels.launches["step"] == 1
    assert eng.kernels.config(n)[0]["design"] == "group"
    tol = parity.step_tol(m)

    def run_plain(q_, qd_):
        return fs.step_plain(eng, q_, qd_, eff, ptg, z, fa, n_steps)

    ref = run_plain(q, qd)
    # FrankaCabinet's 16 props are judged where the step is well conditioned
    keep = parity.check_keep(m, run_plain, q, qd, ref, parity.STEP_NAMES, tol)
    parity.assert_within(label, parity.compare(out, ref, parity.STEP_NAMES, tol, keep), tol)


@pytest.mark.cuda
def test_engine_steps_a_chain_past_the_thread_maxima_on_card(cuda_device):
    """A FIXED root and a chain of NB_MAX bodies (33 in all): the engine
    builds on the card, and the group form's K1 matches the plain step."""
    b = ModelBuilder("long")
    p = b.add_body("base", parent=-1, joint_type=JointType.FIXED)
    for i in range(fs.NB_MAX):
        p = b.add_body(f"x{i}", parent=p)
    eng = PhysicsEngine(b.finalize(cuda_device), SimParams())
    assert fs.thread_scope_errors(eng.model)
    _k1_against_plain(eng, "33-body chain K1")


@pytest.mark.cuda
def test_wrapper_refuses_bad_inputs_on_card(cuda_device):
    eng = PhysicsEngine(build_humanoid(device=cuda_device), SimParams())
    m = eng.model
    q = m.default_q.expand(4, -1).contiguous()
    qd = torch.zeros((4, m.nv), device=cuda_device)
    with pytest.raises(TypeError):
        fs.fk(eng, q.double(), qd)
    with pytest.raises(ValueError):
        fs.fk(eng, q[:, :-1], qd)
    with pytest.raises(ValueError):
        fs.fk(eng, q.t().contiguous().t(), qd)
    with pytest.raises(ValueError):
        fs.substep(eng, q, qd, qd, qd, qd, qd)
    assert eng.kernels.launches == {"step": 0, "fk": 0, "substep": 0}


def _variant_case(variant, n, cuda_device):
    """(engine, K1 inputs, keyword inputs) of one step-kernel variant: the
    Humanoid flat, the ShadowHand under an overlay, AnymalTerrain on its
    planes, with or without an overlay."""
    if variant.startswith("planes"):
        task, ins, planes = _terrain_case(cuda_device, n, seed=5)
        eng, kw = task.engine, {"planes": planes}
    else:
        eng = _scene_engine("Humanoid" if variant == "flat" else "ShadowHand",
                            cuda_device)
        q, qd, eff = parity.check_inputs(eng.model, n, seed=5, device=cuda_device)
        z = torch.zeros((n, eng.model.njd), device=cuda_device)
        fa = torch.zeros((n, eng.model.nb, 6), device=cuda_device)
        ins, kw = (q, qd, eff, parity.check_targets(eng.model, q, 5), z, fa), {}
    if variant.endswith("overlay"):
        kw["overlay"] = parity.overlay_inputs(eng.model, n, seed=5, device=cuda_device)
    if not variant.startswith("planes"):
        # check states off the ties of two box faces (ops/parity.py)
        ins = (parity.clear_box_ties(eng, ins[0], ins[1], kw.get("overlay")),
               *ins[1:])
    return eng, ins, kw


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "overlay", "planes", "planes_overlay"])
def test_kernels_are_deterministic_and_independent_of_group(variant, cuda_device):
    """Each K1 variant and K3 in both forms (a group of lanes per env, one
    thread per env) and K2: two launches on the same inputs give
    bitwise-equal outputs (in the group form every sum is taken by one lane
    in a fixed order)."""
    eng, ins, kw = _variant_case(variant, 1061, cuda_device)
    runs = {("K2", "group"): lambda: fs.fk(eng, ins[0], ins[1])}
    for d in fs.DESIGNS:
        runs["K1", d] = lambda d=d: fs.step(eng, *ins, N_STEPS, design=d, **kw)
        runs["K3", d] = lambda d=d: fs.substep(eng, *ins, design=d, **kw)
    for name, run in runs.items():
        ref = run()
        for a, b in zip(run(), ref):
            assert torch.isfinite(a).all(), name
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "overlay", "planes", "planes_overlay"])
def test_thread_form_matches_plain_on_card(variant, cuda_device):
    """Each K1 variant and K3 in the one-thread-per-env form, which the
    engine takes for batches that fill the card, against the plain versions
    at a small width, with the tolerances of ops/parity.py."""
    eng, ins, kw = _variant_case(variant, 515, cuda_device)
    m = eng.model
    tol = parity.step_tol(m)
    for label, run_k, run_p, names, t in (
            ("K1", lambda: fs.step(eng, *ins, N_STEPS, design="thread", **kw),
             lambda q, qd: fs.step_plain(eng, q, qd, *ins[2:], N_STEPS, **kw),
             parity.STEP_NAMES, tol),
            ("K3", lambda: fs.substep(eng, *ins, design="thread", **kw),
             lambda q, qd: fs.substep_plain(eng, q, qd, *ins[2:], **kw),
             parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL)):
        before = eng.kernels.thread_launches[{"K1": "step", "K3": "substep"}[label]]
        out, ref = run_k(), run_p(ins[0], ins[1])
        torch.cuda.synchronize()
        assert eng.kernels.thread_launches[
            {"K1": "step", "K3": "substep"}[label]] == before + 1
        keep = (parity.well_conditioned(run_p, ins[0], ins[1], ref, names, t)
                if "overlay" in kw else None)
        parity.assert_within(f"{variant} {label} thread form",
                             parity.compare(out, ref, names, t, keep), t)


def _cartpole_trainer(device, rnn):
    cfg = PPOConfig(horizon_length=8, minibatch_size=128, mini_epochs=2,
                    units=(16,), rnn=rnn, rnn_units=16, seq_len=4)
    return PPOTrainer(VecEnv(get_task("Cartpole", device=device), 64, seed=0),
                      cfg, seed=0)


def _checkpoint_leaves(tr):
    return _flatten({"main": tr._main_tree(), "env": tr._env_state_tree()})


@pytest.mark.cuda
@pytest.mark.parametrize("rnn", [None, "lstm"])
def test_checkpoint_saved_on_card_loads_on_cpu_and_back(rnn, tmp_path, cuda_device):
    """A checkpoint written on the card loads on the CPU with every leaf
    bitwise equal (the generators, of another device type, are left as
    they were), trains on there, and its checkpoint loads on the card."""
    card = _cartpole_trainer(cuda_device, rnn)
    card.train(max_epochs=2, log_fn=None)
    card.save(str(tmp_path / "card"))
    cpu, msgs = _cartpole_trainer("cpu", rnn), []
    cpu.load(str(tmp_path / "card"), log_fn=msgs.append)
    assert "another device type" in msgs[-1], msgs
    want = _checkpoint_leaves(card)
    got = _checkpoint_leaves(cpu)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if isinstance(v, torch.Tensor):
            assert v.device.type == "cpu" and torch.equal(v, want[k].cpu()), k
        else:
            assert v == want[k], k
    cpu.train(max_epochs=3, log_fn=None)
    cpu.save(str(tmp_path / "cpu"))
    back = _cartpole_trainer(cuda_device, rnn)
    back.load(str(tmp_path / "cpu"), log_fn=lambda s: None)
    assert back.state.epoch == 3
    want = _checkpoint_leaves(cpu)
    for k, v in _checkpoint_leaves(back).items():
        ref = want[k]
        if isinstance(v, torch.Tensor):
            assert v.device.type == "cuda" and torch.equal(v.cpu(), ref), k


# the arm, the second hand and the flyers, each under its yaml
ARM_HAND_FLYERS = ("FrankaCabinet", "AllegroHand", "Ingenuity", "Quadcopter", "Crazyflie")


def _yaml_task(name, device):
    from omniisaacgymenvs_torch.utils.config import load_config
    return get_task(name, load_config({"task": name})["task"], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARM_HAND_FLYERS)
def test_arm_hand_flyer_kernels_match_plain_in_both_forms(name, cuda_device):
    """K1 in both forms, forced with `design=`, and K2 against their plain
    versions on the card at the yaml's depth: FrankaCabinet's four FREE
    props on the tray and pads on the handle bar, the flyers' forces on
    their rotor bodies (centres of mass off the origins); the AllegroHand's
    K1 on its well-conditioned envs (`parity.check_keep`)."""
    task = _yaml_task(name, cuda_device)
    eng, m = task.engine, task.model
    n, seed = 515, 6
    n_sub = task.decimation * eng.params.substeps
    q, qd, eff = parity.check_inputs(m, n, seed=seed, device=cuda_device)
    q = parity.clear_box_ties(eng, q, qd)
    ptg = parity.check_targets(m, q, seed)
    z = torch.zeros((n, m.njd), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    fa = 0.05 * torch.randn((n, m.nb, 6), device=cuda_device, generator=gen)
    if len(m.pair_surf):
        assert parity.active_contacts(eng, q, qd)["pairs"] > 0
    tol = parity.step_tol(m)

    def run_plain(q_, qd_):
        return fs.step_plain(eng, q_, qd_, eff, ptg, z, fa, n_sub)

    ref = run_plain(q, qd)
    keep = parity.check_keep(m, run_plain, q, qd, ref, parity.STEP_NAMES, tol)
    assert (keep is None) == (name != "AllegroHand")
    for d in fs.DESIGNS:
        out = fs.step(eng, q, qd, eff, ptg, z, fa, n_sub, design=d)
        parity.assert_within(f"{name} K1 {d}", parity.compare(
            out, ref, parity.STEP_NAMES, tol, keep), tol)
    parity.assert_within(f"{name} K2", parity.compare(
        fs.fk(eng, q, qd), fs.fk_plain(m, q, qd), parity.FK_NAMES,
        parity.FK_TOL), parity.FK_TOL)
    torch.cuda.synchronize()
    assert eng.kernels.thread_launches["step"] == 1
    assert eng.kernels.launches["step"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARM_HAND_FLYERS)
def test_arm_hand_flyer_rollout_launches_k1_once_per_step(name, cuda_device):
    task = _yaml_task(name, cuda_device)
    env = VecEnv(task, 256, seed=0)
    es = env.reset(seed=0)
    kern = task.engine.kernels
    kern.reset_counts()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(4):
        a = 2 * torch.rand((256, task.num_actions), device=cuda_device, generator=g) - 1
        es = env.step(es, a)
    torch.cuda.synchronize()
    assert kern.launches["step"] == 4 and kern.launches["substep"] == 0
    assert kern.launches["fk"] >= 4
    assert torch.isfinite(es.obs).all() and torch.isfinite(es.phys.q).all()


@pytest.mark.cuda
@pytest.mark.parametrize("props", [5, 16])
def test_franka_props_past_the_thread_maxima_step_on_card(props, cuda_device):
    """FrankaCabinet with 5 and 16 FREE props builds on the card, and the
    group form's K1 at the yaml's depth matches the plain step, the pads
    on the handle bar and the props on the tray."""
    task = get_task("FrankaCabinet", {"env": {"numProps": props}}, device=cuda_device)
    assert fs.thread_scope_errors(task.model)
    _k1_against_plain(task.engine, f"FrankaCabinet {props} props K1",
                      n_steps=task.decimation * task.engine.params.substeps)


# Custom on imported robots: the URDF example (FIXED and FREE base) and
# chip_smoke.py's MJCF chain
CUSTOM_CASES = ("fixed", "floating", "mjcf")


def _custom_task(case, tmp_path, device):
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import MJCF_CHAIN, URDF_EXAMPLE

    env = {"robot": os.path.join(root, URDF_EXAMPLE),
           "floatingBase": case == "floating"}
    if case == "mjcf":
        env["robot"] = str(tmp_path / "chain.xml")
        (tmp_path / "chain.xml").write_text(MJCF_CHAIN)
    from omniisaacgymenvs_torch.utils.config import load_config
    cfg = load_config({"task": "Custom"})["task"]
    return get_task("Custom", {**cfg, "env": {**cfg["env"], **env}}, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUSTOM_CASES)
def test_custom_kernels_match_plain_in_both_forms(case, tmp_path, cuda_device):
    """K1 in both forms and K2 against their plain versions on the card at
    Custom.yaml's depth (4 substeps), on check states that put the FREE
    example's and the chain's contact points in the ground."""
    task = _custom_task(case, tmp_path, cuda_device)
    eng, m = task.engine, task.model
    n, seed = 515, 6
    n_sub = task.decimation * eng.params.substeps
    q, qd, eff = parity.check_inputs(m, n, seed=seed, device=cuda_device)
    ptg = parity.check_targets(m, q, seed)
    z = torch.zeros((n, m.njd), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    fa = 0.05 * torch.randn((n, m.nb, 6), device=cuda_device, generator=gen)
    if case != "fixed":
        assert parity.active_contacts(eng, q, qd)["ground"] > 0
    tol = parity.step_tol(m)

    def run_plain(q_, qd_):
        return fs.step_plain(eng, q_, qd_, eff, ptg, z, fa, n_sub)

    ref = run_plain(q, qd)
    keep = parity.check_keep(m, run_plain, q, qd, ref, parity.STEP_NAMES, tol)
    for d in fs.DESIGNS:
        out = fs.step(eng, q, qd, eff, ptg, z, fa, n_sub, design=d)
        parity.assert_within(f"Custom {case} K1 {d}", parity.compare(
            out, ref, parity.STEP_NAMES, tol, keep), tol)
    parity.assert_within(f"Custom {case} K2", parity.compare(
        fs.fk(eng, q, qd), fs.fk_plain(m, q, qd), parity.FK_NAMES,
        parity.FK_TOL), parity.FK_TOL)
    torch.cuda.synchronize()
    assert eng.kernels.launches["step"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUSTOM_CASES)
def test_custom_rollout_launches_k1_once_per_step(case, tmp_path, cuda_device):
    task = _custom_task(case, tmp_path, cuda_device)
    env = VecEnv(task, 256, seed=0)
    es = env.reset(seed=0)
    kern = task.engine.kernels
    kern.reset_counts()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(4):
        a = 2 * torch.rand((256, task.num_actions), device=cuda_device, generator=g) - 1
        es = env.step(es, a)
    torch.cuda.synchronize()
    assert kern.launches["step"] == 4 and kern.launches["substep"] == 0
    assert kern.launches["fk"] >= 4
    assert torch.isfinite(es.obs).all() and torch.isfinite(es.phys.q).all()


@pytest.mark.cuda
def test_custom_chain_beyond_the_thread_maximum_steps_on_card(tmp_path, cuda_device):
    """A URDF chain of NB_MAX + 1 links builds as Custom on the card, and
    the group form's K1 matches the plain step."""
    n = fs.NB_MAX + 1
    links = "".join(f'<link name="l{i}"><inertial><mass value="1"/>'
                    f'<inertia ixx="0.01" iyy="0.01" izz="0.01"/></inertial></link>'
                    for i in range(n))
    joints = "".join(f'<joint name="j{i}" type="revolute"><parent link="l{i - 1}"/>'
                     f'<child link="l{i}"/><axis xyz="0 1 0"/></joint>'
                     for i in range(1, n))
    path = tmp_path / "long.urdf"
    path.write_text(f'<robot name="long">{links}{joints}</robot>')
    task = get_task("Custom", {"env": {"robot": str(path)}}, device=cuda_device)
    assert task.model.nb == n and fs.thread_scope_errors(task.model)
    _k1_against_plain(task.engine, f"Custom {n}-link chain K1")


@pytest.mark.cuda
def test_launch_on_a_second_device_is_refused(cuda_device):
    """The kernels raise their shared-memory limit once per process, on the
    current device: a launch elsewhere is refused."""
    lib = fs.library()
    other = torch.device("cuda", torch.cuda.current_device() + 1)
    with pytest.raises(RuntimeError, match="current device"):
        lib.claim(other)


@pytest.mark.cuda
def test_rounded_linear_on_card_matches_cpu(cuda_device):
    """The "bf16_operands" layer (TF32 off) on the card against the same
    layer on the CPU, forward and both backward products: equal operands
    after the rounding, so the two differ only by the order of their f32
    sums (within n * 2^-24 * sum |a_i b_i|, n the length of the sum)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4096, 211, generator=gen)
    layer = torch.nn.Linear(211, 512)
    g = torch.randn(4096, 512, generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        lay = torch.nn.Linear(211, 512).to(dev)
        lay.load_state_dict(layer.state_dict())
        xd = x.to(dev, copy=True).requires_grad_(True)
        y = rounded_linear(lay, xd)
        y.backward(g.to(dev))
        out[str(dev)] = [t.detach().cpu().double()
                         for t in (y, xd.grad, lay.weight.grad, lay.bias.grad)]
    xr, wr, gr = (round_bf16(t).double().abs()
                  for t in (x, layer.weight.detach(), g))
    bounds = [(xr @ wr.T + layer.bias.detach().double().abs(), 212),
              (gr @ wr, 512), (gr.T @ xr, 4096), (g.double().abs().sum(0), 4096)]
    for a, b, (terms, n) in zip(out["cpu"], out[str(cuda_device)], bounds):
        assert ((a - b).abs() <= 2 * n * 2.0 ** -24 * terms).all()
