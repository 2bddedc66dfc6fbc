"""Port parity of the Anymal and AnymalTerrain tasks: `observe`,
`reward_done` and `control` from the same state, carry and action as the
JAX tasks (a JAX reset and one JAX step carried across as numpy), the
terrain curriculum of `resample_reset`, the pushes and the observation noise
of `pre_physics`, the two hooks of the base step, and short VecEnv rollouts
of both tasks against the JAX VecEnv."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.convert import env_state_from_arrays
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.envs.views import ArticulationView
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.tasks.base import RLTask
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from torch_parity import np_, to_numpy_tree

N = 8
TASKS = ("Anymal", "AnymalTerrain")
# a small terrain grid (3 levels x 5 types) and no observation noise: the
# two packages draw their noise from different generators
CFGS = {"Anymal": None,
        "AnymalTerrain": {"env": {"terrain": {"numLevels": 3, "numTerrains": 5},
                                  "learn": {"addNoise": False}}}}
# positions and angles to 1e-4; velocity terms carry the step's float32
# rounding (tests/test_torch_env.py)
OBS_TOL = dict(rtol=2e-3, atol=2e-3)


def _fields(jes):
    f = {fl.name: to_numpy_tree(getattr(jes, fl.name))
         for fl in dataclasses.fields(jes)}
    f.pop("rng")
    return f


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX task, port task, JAX env, JAX state after a reset and one step,
    the same state in the port, actions)."""
    jtask = jget_task(name, CFGS[name])
    task = get_task(name, CFGS[name], device="cpu")
    jenv = JVecEnv(jtask, N)
    rng = np.random.default_rng(len(name))
    actions = rng.uniform(-1, 1, (5, N, task.num_actions)).astype(np.float32)
    jes = jenv.step(jenv.reset(seed=2), jnp.asarray(actions[0]))
    es = env_state_from_arrays(_fields(jes), device="cpu")
    return jtask, task, jenv, jes, es, actions


def _assert_tree_close(a, b, **tol):
    assert set(a) == set(b)
    for k in b:
        if isinstance(b[k], dict):
            _assert_tree_close(a[k], b[k], **tol)
        else:
            np.testing.assert_allclose(np_(a[k]), np.asarray(b[k]),
                                       err_msg=k, **tol)


def test_converted_state_carries_the_terrain_carry():
    _, task, _, jes, es, _ = case("AnymalTerrain")
    assert set(es.carry) == (set(jes.carry) - {"noise_key"}) | {"obs_noise"}
    assert es.carry["level"].dtype == es.carry["ttype"].dtype == torch.int32
    assert set(es.carry["episode_sums"]) == set(jes.carry["episode_sums"])
    assert es.carry["obs_noise"].shape == (N, 188)
    fresh = task.reset(N, torch.Generator().manual_seed(0))
    assert set(fresh.carry) == set(es.carry)
    for k, v in fresh.carry.items():
        if k != "episode_sums":
            assert v.shape == es.carry[k].shape and v.dtype == es.carry[k].dtype, k
    assert set(fresh.metrics) == set(es.metrics)


@pytest.mark.parametrize("name", TASKS)
def test_observe(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    obs, states, carry = task.observe(es.phys, es.carry, torch.as_tensor(a))
    jobs, _, jcarry = jax.vmap(jtask.observe)(jes.phys, dict(jes.carry),
                                              jnp.asarray(a))
    assert obs.shape == (N, task.num_obs) == jobs.shape
    assert states.shape == (N, 0)
    # same state in, so only the observation's own float32 arithmetic
    np.testing.assert_allclose(np_(obs), np.asarray(jobs), rtol=1e-5, atol=1e-5)
    if name == "AnymalTerrain":
        # the yaw command and the torque at the new state
        for k in ("commands", "torques"):
            np.testing.assert_allclose(np_(carry[k]), np.asarray(jcarry[k]),
                                       rtol=1e-5, atol=1e-4, err_msg=k)
        assert np.abs(np_(obs)[:, 36:176]).max() > 0, "the height scan reads"
        assert carry is not es.carry


@pytest.mark.parametrize("name", TASKS)
def test_reward_done(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    L = task.max_episode_length
    assert L == jtask.max_episode_length
    prog = np.array([1, 2, L - 3, L - 2, L - 1, L, 5, 6], np.int32)
    r, d, carry, metrics = task.reward_done(
        es.obs, torch.as_tensor(a), es.phys, es.carry, torch.as_tensor(prog))
    jr, jd, jcarry, jmetrics = jax.vmap(jtask.reward_done)(
        jes.obs, jnp.asarray(a), jes.phys, dict(jes.carry), jnp.asarray(prog))
    np.testing.assert_allclose(np_(r), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np_(d), np.asarray(jd))
    assert np_(d).any() and not np_(d).all()  # the time limit ends some
    _assert_tree_close(metrics, jmetrics, rtol=1e-5, atol=1e-7)
    jcarry = {k: v for k, v in jcarry.items() if k != "noise_key"}
    carry = {k: v for k, v in carry.items() if k != "obs_noise"}
    _assert_tree_close(carry, jcarry, rtol=1e-5, atol=1e-6)
    assert task.timeout_progress == jtask.timeout_progress
    if name == "AnymalTerrain":
        assert "episode/terrain_level" in metrics
        assert np.abs(np_(metrics["episode/rew_lin_vel_xy"])).max() > 0


def test_terrain_termination_reads_the_height_field():
    jtask, task, _, jes, es, actions = case("AnymalTerrain")
    # the base lowered to 15 cm over the ground, a knee to 5 cm
    q = es.phys.q.clone()
    q[0, 2] -= 0.5
    pos = es.phys.body_pos.clone()
    pos[1, task._knee_bodies[2], 2] -= 0.35
    phys = dataclasses.replace(es.phys, q=q, body_pos=pos)
    jphys = jes.phys.replace(q=jnp.asarray(np_(q)), body_pos=jnp.asarray(np_(pos)))
    prog = np.full(N, 3, np.int32)
    a = actions[1]
    r, d, _, _ = task.reward_done(es.obs, torch.as_tensor(a), phys, es.carry,
                                  torch.as_tensor(prog))
    jr, jd, _, _ = jax.vmap(jtask.reward_done)(
        jes.obs, jnp.asarray(a), jphys, dict(jes.carry), jnp.asarray(prog))
    assert np_(d).tolist() == [True, True] + [False] * (N - 2)
    np.testing.assert_array_equal(np_(d), np.asarray(jd))
    np.testing.assert_allclose(np_(r), np.asarray(jr), rtol=1e-5, atol=1e-6)
    assert (np_(r)[:2] < np_(r)[2:].min()).all()  # the fallen-over penalty


@pytest.mark.parametrize("name", TASKS)
def test_control(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    es1 = dataclasses.replace(es, carry=dict(es.carry))
    ctrl = task.control(torch.as_tensor(a), es1)

    def jcontrol(act, jes1):
        jes1 = jes1.replace(carry=dict(jes1.carry))
        c = jtask.control(act, jes1)
        return c, jes1.carry

    jctrl, jcarry = jax.vmap(jcontrol)(jnp.asarray(a), jes)
    for f in dataclasses.fields(ctrl):
        np.testing.assert_allclose(np_(getattr(ctrl, f.name)),
                                   np.asarray(getattr(jctrl, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)
    key = "targets" if name == "AnymalTerrain" else "current_targets"
    np.testing.assert_allclose(np_(es1.carry[key]), np.asarray(jcarry[key]),
                               rtol=1e-6, atol=1e-6)
    # the step's own carry took the update, the caller's did not
    assert not torch.equal(es1.carry[key], es.carry[key])
    assert np.abs(np_(ctrl.pos_target)).max() > 0


def test_resample_reset_moves_the_level_with_the_distance_walked():
    """Promotion over half a cell's length, demotion under a quarter of the
    commanded distance, level 0 stays, the top level wraps to 0, the terrain
    column is kept; the levels equal the JAX task's on the same states."""
    jtask, task, _, jes, es, _ = case("AnymalTerrain")
    rows = task.terrain.env_rows
    level = np.array([0, 1, rows - 1, 0, 1, 2, 1, 1], np.int32)
    ttype = np.array([0, 1, 2, 3, 4, 0, 1, 2], np.int32)
    walked = np.array([4.5, 4.5, 4.5, 0.5, 0.5, 2.0, 4.5, 3.0], np.float32)
    cmd = np.array([0.3, 0.3, 0.3, 0.9, 0.9, 0.3, 1.0, 0.0], np.float32)
    # 4.5 m > 4 m promotes; 0.5 m < 0.9 * 20 s / 4 demotes; 2 m under a 0.3
    # m/s command does neither; 4.5 m under 1 m/s does both; no command
    # never demotes
    want = np.array([1, 2, 0, 0, 0, 2, 1, 1], np.int32)
    origin = np.asarray(jtask._origins)[level, ttype]
    q = np_(es.phys.q).copy()
    q[:, 0] = origin[:, 0] + walked
    q[:, 1] = origin[:, 1]
    commands = np_(es.carry["commands"]).copy()
    commands[:, 0], commands[:, 1] = cmd, 0.0
    es1 = dataclasses.replace(
        es, phys=dataclasses.replace(es.phys, q=torch.as_tensor(q)),
        carry=dict(es.carry, level=torch.as_tensor(level),
                   ttype=torch.as_tensor(ttype), origin=torch.as_tensor(origin),
                   commands=torch.as_tensor(commands)))
    fresh = task.resample_reset(es1, torch.Generator().manual_seed(0))
    jes1 = jes.replace(
        phys=jes.phys.replace(q=jnp.asarray(q)),
        carry=dict(jes.carry, level=jnp.asarray(level), ttype=jnp.asarray(ttype),
                   origin=jnp.asarray(origin), commands=jnp.asarray(commands)))
    jfresh = jax.vmap(jtask.resample_reset)(
        jax.random.split(jax.random.PRNGKey(0), N), jes1)
    np.testing.assert_array_equal(np_(fresh.carry["level"]), want)
    np.testing.assert_array_equal(np_(fresh.carry["level"]),
                                  np.asarray(jfresh.carry["level"]))
    np.testing.assert_array_equal(np_(fresh.carry["ttype"]), ttype)
    assert fresh.carry["level"].dtype == torch.int32
    new_origin = np.asarray(jtask._origins)[want, ttype]
    np.testing.assert_array_equal(np_(fresh.carry["origin"]), new_origin)
    np.testing.assert_array_equal(np.asarray(jfresh.carry["origin"]), new_origin)
    # spawned within half a metre of the new origin, 0.62 m over it, at rest
    fq = np_(fresh.phys.q)
    assert (np.abs(fq[:, 0:2] - new_origin[:, 0:2]) <= 0.5).all()
    np.testing.assert_allclose(fq[:, 2], new_origin[:, 2] + 0.62, atol=1e-6)
    assert not fresh.phys.qd.any() and not fresh.done.any()
    assert (fresh.progress == 0).all() and not fresh.carry["last_actions"].any()
    for k in fresh.carry["episode_sums"].values():
        assert not k.any()
    # without the curriculum the level stays
    cfg = {"env": {"terrain": {"numLevels": 3, "numTerrains": 5,
                               "curriculum": False}}}
    flat = get_task("AnymalTerrain", cfg, device="cpu")
    assert flat.max_init_level == rows - 1
    kept = flat.resample_reset(es1, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np_(kept.carry["level"]), level)


def test_pre_physics_pushes_only_on_push_steps():
    jtask, task, _, jes, es, _ = case("AnymalTerrain")
    P = task.push_interval
    assert P == jtask.push_interval == 750
    prog = np.array([0, P - 1, P, 2 * P - 1, 5, P - 2, 3 * P - 1, 7], np.int32)
    push = prog % P == P - 1
    es1 = dataclasses.replace(es, progress=torch.as_tensor(prog),
                              carry=dict(es.carry))
    out = task.pre_physics(es1, torch.Generator().manual_seed(1))
    quat = es.phys.q[:, 3:7]
    v0 = np_(rot.quat_rotate(quat, es.phys.qd[:, 3:6]))
    v1 = np_(rot.quat_rotate(quat, out.phys.qd[:, 3:6]))
    # off a push step the state stays (rotated there and back: rounding)
    np.testing.assert_allclose(np_(out.phys.qd)[~push], np_(es.phys.qd)[~push],
                               rtol=0, atol=1e-6)
    # on one, the base's world x, y velocity is drawn from [-1, 1] m/s
    assert (np.abs(v1[push, 0:2]) <= 1.0 + 1e-6).all()
    assert (np.abs(v1[push, 0:2] - v0[push, 0:2]) > 1e-3).all()
    np.testing.assert_allclose(v1[:, 2], v0[:, 2], atol=1e-6)
    for f in ("q", "body_pos", "sensor_forces"):
        assert getattr(out.phys, f) is getattr(es.phys, f)
    assert torch.equal(out.phys.qd[:, 0:3], es.phys.qd[:, 0:3])
    assert torch.equal(out.phys.qd[:, 6:], es.phys.qd[:, 6:])
    assert not out.carry["obs_noise"].any()  # addNoise is off here
    # the JAX task leaves the same state off a push step
    jout = jax.vmap(jtask.pre_physics)(
        jes.replace(progress=jnp.asarray(prog), carry=dict(jes.carry)),
        jax.random.split(jax.random.PRNGKey(1), N))
    np.testing.assert_allclose(np_(out.phys.qd)[~push],
                               np.asarray(jout.phys.qd)[~push], atol=1e-6)
    jv1 = np_(rot.quat_rotate(quat, torch.tensor(np.asarray(jout.phys.qd)[:, 3:6])))
    assert (np.abs(jv1[push, 0:2]) <= 1.0 + 1e-6).all()


def test_noise_and_commands_stay_in_their_ranges():
    cfg = {"env": {"terrain": {"numLevels": 3, "numTerrains": 5}}}
    jtask = jget_task("AnymalTerrain", cfg)
    task = get_task("AnymalTerrain", cfg, device="cpu")
    assert task.add_noise
    g = torch.Generator().manual_seed(2)
    n = 4096
    es = task.reset(n, g)
    nv = np.asarray(jtask.noise_vec)
    noise = np_(es.carry["obs_noise"])
    assert (np.abs(noise) <= nv + 1e-7).all()
    # uniform in +-noise_vec: mean 0, standard deviation noise_vec / sqrt(3)
    on = nv > 0
    assert on.sum() == 3 + 3 + 3 + 12 + 12 + 140
    np.testing.assert_allclose(noise[:, on].std(0) / nv[on], 1 / np.sqrt(3), rtol=0.1)
    assert np.abs(noise[:, on].mean(0) / nv[on]).max() < 0.1
    assert not noise[:, ~on].any()
    # the reset's observation carries it; `observe` itself draws nothing
    clean = dict(es.carry, obs_noise=torch.zeros_like(es.carry["obs_noise"]))
    z = torch.zeros(n, 12)
    o0, _, _ = task.observe(es.phys, clean, z)
    o1, _, _ = task.observe(es.phys, es.carry, z)
    o2, _, _ = task.observe(es.phys, es.carry, z)
    assert torch.equal(o1, o2) and torch.equal(o1, es.obs)
    np.testing.assert_allclose(np_(o1 - o0), noise, atol=1e-6)
    # a step draws the next noise in pre_physics
    es2 = task.pre_physics(dataclasses.replace(es, carry=dict(es.carry)), g)
    assert not torch.equal(es2.carry["obs_noise"], es.carry["obs_noise"])
    # commands: x, y in [-1, 1], zeroed together when their norm is <= 0.25;
    # the yaw target in [-3.14, 3.14]; the yaw rate is computed by observe
    c = np_(task._sample_commands(n, g))
    norm = np.linalg.norm(c[:, 0:2], axis=1)
    assert (np.abs(c[:, 0:2]) <= 1).all() and (np.abs(c[:, 3]) <= 3.14).all()
    assert ((norm == 0) | (norm > 0.25)).all() and not c[:, 2].any()
    assert 0.02 < (norm == 0).mean() < 0.09  # pi 0.25^2 / 4 = 0.049
    # resets start on the allowed levels and on every terrain type
    assert int(es.carry["level"].max()) <= task.max_init_level == 0
    assert set(np_(es.carry["ttype"]).tolist()) == set(range(5))
    h = np_(task._sample_height(es.phys.q[:, 0], es.phys.q[:, 1]))
    assert (np_(es.phys.q[:, 2]) - h > 0.4).all()


def test_base_step_calls_the_hooks_in_order():
    """The fresh state comes from `resample_reset` of the ending state, is
    merged on `done`, then `pre_physics` sees the merged state."""
    task = get_task("Anymal", device="cpu")
    env = VecEnv(task, 4, seed=0)
    es = env.reset(seed=0)
    done = torch.tensor([False, True, False, True])
    es = dataclasses.replace(es, done=done,
                             progress=torch.full((4,), 9, dtype=torch.int32))
    seen = {}

    def resample(es_in, generator):
        seen["resample"] = (es_in.done.clone(), es_in.progress.clone())
        return RLTask.resample_reset(task, es_in, generator)

    def pre(es_in, generator):
        seen["pre"] = es_in.progress.clone()
        qd = es_in.phys.qd.clone()
        qd[:, 5] = 0.25
        return dataclasses.replace(
            es_in, phys=dataclasses.replace(es_in.phys, qd=qd))

    task.resample_reset, task.pre_physics = resample, pre
    out = task.step(es, torch.zeros(4, 12), env.generator)
    assert torch.equal(seen["resample"][0], done)
    assert seen["resample"][1].tolist() == [9, 9, 9, 9]
    assert seen["pre"].tolist() == [9, 0, 9, 0]   # merged before pre_physics
    assert out.progress.tolist() == [10, 1, 10, 1]
    # the defaults: a plain reset, and no perturbation
    plain = get_task("Anymal", device="cpu")
    es0 = plain.reset(4, torch.Generator().manual_seed(3))
    assert plain.pre_physics(es0, None) is es0
    fresh = plain.resample_reset(es0, torch.Generator().manual_seed(3))
    assert torch.equal(fresh.phys.qd, es0.phys.qd)


def test_articulation_view_reads_the_root():
    task = get_task("Anymal", device="cpu")
    es = task.reset(3, torch.Generator().manual_seed(0))
    pos, quat = ArticulationView(task.model).get_world_poses(es.phys)
    assert torch.equal(pos, es.phys.body_pos[:, 0])
    assert torch.equal(quat, es.phys.body_quat[:, 0])
    pos2, _ = ArticulationView(task.model, "base").get_world_poses(es.phys)
    assert torch.equal(pos, pos2)
    with pytest.raises(ValueError):
        ArticulationView(task.model, "LF_HAA")


@pytest.mark.parametrize("name", TASKS)
def test_rollout_matches_jax(name):
    """The slice as a whole: three more steps of both VecEnvs from the same
    state under the same actions (AnymalTerrain: four refreshed-plane
    substeps per step)."""
    _, task, jenv, jes, es, actions = case(name)
    env = VecEnv(task, N, seed=0)
    ever_done = np.zeros(N, bool)
    for k in range(1, 4):
        jes = jenv.step(jes, jnp.asarray(actions[k]))
        es = env.step(es, torch.as_tensor(actions[k]))
        ever_done |= np.asarray(jes.done) | np_(es.done)
        keep = ~ever_done
        np.testing.assert_allclose(np_(es.obs)[keep], np.asarray(jes.obs)[keep],
                                   err_msg=f"step {k}", **OBS_TOL)
        np.testing.assert_allclose(np_(es.reward)[keep],
                                   np.asarray(jes.reward)[keep], rtol=1e-3,
                                   atol=1e-3, err_msg=f"step {k}")
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
        np.testing.assert_array_equal(np_(es.timeout), np.asarray(jes.timeout))
        np.testing.assert_array_equal(np_(es.progress), np.asarray(jes.progress))
    assert (~ever_done).sum() > N // 2
    if name == "AnymalTerrain":
        _assert_tree_close(es.metrics, jes.metrics, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("name", TASKS)
def test_reset_stays_within_the_task_ranges(name):
    task = get_task(name, CFGS[name], device="cpu")
    es = task.reset(64, torch.Generator().manual_seed(1))
    m = task.model
    assert es.obs.shape == (64, task.num_obs) and torch.isfinite(es.obs).all()
    assert not es.done.any() and (es.progress == 0).all()
    torch.testing.assert_close(es.phys.q[:, 3:7].norm(dim=1), torch.ones(64))
    if name == "Anymal":
        assert (es.phys.qd[:, m.jd0:].abs() <= 0.1).all()
        c = es.carry["commands"]
        assert (c[:, 0].abs() <= 2).all() and (c[:, 1:].abs() <= 1).all()
        assert c.std(0).min() > 0.3
