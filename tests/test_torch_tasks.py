"""Port parity of the Cartpole, BallBalance and ShadowHand tasks: `observe`,
`reward_done` and `control` from the same state, carry and action as the
JAX tasks (a JAX reset and one JAX step carried across as numpy), the four
ShadowHand observation types, a 3-step ShadowHand VecEnv rollout with
resetting envs left out, and ShadowHand's goal hits, success counts and
goal re-draws from one shared state."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.convert import env_state_from_arrays
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.tasks.shared.in_hand_manipulation import (
    randomize_rotation)
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from omniisaacgymenvs_tpu.tasks.shared import in_hand_manipulation as jihm
from torch_parity import np_, to_numpy_tree

N = 8
TASKS = ("Cartpole", "BallBalance", "ShadowHand")
# positions and angles to 1e-4; velocity terms and contact wrenches carry
# the step's float32 rounding (tests/test_torch_env.py)
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
    jtask, task = jget_task(name), get_task(name, device="cpu")
    jenv = JVecEnv(jtask, N)
    rng = np.random.default_rng(len(name))
    actions = rng.uniform(-1, 1, (5, N, task.num_actions)).astype(np.float32)
    jes = jenv.step(jenv.reset(seed=2), jnp.asarray(actions[0]))
    es = env_state_from_arrays(_fields(jes), device="cpu")
    return jtask, task, jenv, jes, es, actions


@pytest.mark.parametrize("name", TASKS)
def test_observe(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    obs, states, carry = task.observe(es.phys, es.carry, torch.as_tensor(a))
    jobs, jstates, _ = jax.vmap(jtask.observe)(jes.phys, jes.carry,
                                               jnp.asarray(a))
    assert obs.shape == (N, task.num_obs) == jobs.shape
    assert states.shape == (N, task.num_states)
    # same state in, so only the observation's own float32 arithmetic
    np.testing.assert_allclose(np_(obs), np.asarray(jobs), rtol=1e-5, atol=1e-5)
    assert carry is es.carry


@pytest.mark.parametrize("name", TASKS)
def test_reward_done(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    prog = np.array([1, 2, 498, 499, 500, 597, 598, 599], np.int32)
    r, d, carry, metrics = task.reward_done(
        es.obs, torch.as_tensor(a), es.phys, es.carry, torch.as_tensor(prog))
    jr, jd, jcarry, jmetrics = jax.vmap(jtask.reward_done)(
        jes.obs, jnp.asarray(a), jes.phys, jes.carry, jnp.asarray(prog))
    np.testing.assert_allclose(np_(r), np.asarray(jr), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np_(d), np.asarray(jd))
    assert np_(d).any() and not np_(d).all()  # the time limit ends some
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(np_(metrics[k]), np.asarray(jmetrics[k]))
    if isinstance(jcarry, dict):
        for k in jcarry:
            np.testing.assert_allclose(np_(carry[k]), np.asarray(jcarry[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert task.timeout_progress == jtask.timeout_progress


@pytest.mark.parametrize("name", TASKS)
def test_control(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    es1 = dataclasses.replace(es, carry=dict(es.carry))
    ctrl = task.control(torch.as_tensor(a), es1,
                        torch.Generator().manual_seed(0))

    def jcontrol(act, jes1):
        jes1 = jes1.replace(carry=dict(jes1.carry)
                            if isinstance(jes1.carry, dict) else jes1.carry)
        c = jtask.control(act, jes1)
        return c, jes1.carry

    jctrl, jcarry = jax.vmap(jcontrol)(jnp.asarray(a), jes)
    for f in dataclasses.fields(ctrl):
        np.testing.assert_allclose(np_(getattr(ctrl, f.name)),
                                   np.asarray(getattr(jctrl, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)
    # no env hit its goal in the first step, so no goal is re-drawn and the
    # updated carries agree
    if isinstance(jcarry, dict):
        assert not np.asarray(jes.carry.get("reset_goal", False)).any()
        for k in jcarry:
            np.testing.assert_allclose(np_(es1.carry[k]), np.asarray(jcarry[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    # the step's own carry took the update, the caller's did not
    if name == "BallBalance":
        assert not torch.equal(es1.carry["dof_targets"], es.carry["dof_targets"])


@pytest.mark.parametrize("obs_type,asym", [("openai", True), ("full_no_vel", False),
                                           ("full", False), ("full_state", True)])
def test_shadow_hand_observation_types(obs_type, asym):
    _, _, _, jes, es, actions = case("ShadowHand")
    cfg = {"env": {"observationType": obs_type, "asymmetric_observations": asym}}
    jtask, task = jget_task("ShadowHand", cfg), get_task("ShadowHand", cfg,
                                                          device="cpu")
    a = actions[2]
    obs, states, _ = task.observe(es.phys, es.carry, torch.as_tensor(a))
    jobs, jstates, _ = jax.vmap(jtask.observe)(jes.phys, jes.carry,
                                               jnp.asarray(a))
    assert obs.shape == (N, task.num_obs) and task.num_obs == jtask.num_obs
    assert states.shape == (N, 187 if asym else 0) == jstates.shape
    np.testing.assert_allclose(np_(obs), np.asarray(jobs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(states), np.asarray(jstates), rtol=1e-5,
                               atol=1e-5)


def test_randomize_rotation_and_goal_redraw():
    rng = np.random.default_rng(1)
    r = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    out = randomize_rotation(torch.as_tensor(r[:, 0]), torch.as_tensor(r[:, 1]))
    ref = jax.vmap(jihm.randomize_rotation)(jnp.asarray(r[:, 0]),
                                            jnp.asarray(r[:, 1]))
    np.testing.assert_allclose(np_(out), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # a goal hit re-draws that env's goal only, from the given generator
    _, task, _, _, es, actions = case("ShadowHand")
    hit = torch.zeros(N, dtype=torch.bool)
    hit[[1, 4]] = True
    es1 = dataclasses.replace(es, carry=dict(es.carry, reset_goal=hit))
    task.control(torch.as_tensor(actions[1]), es1,
                 torch.Generator().manual_seed(3))
    new, old = es1.carry["goal_rot"], es.carry["goal_rot"]
    changed = (new != old).any(dim=1)
    assert changed.tolist() == hit.tolist()
    torch.testing.assert_close(new.norm(dim=1), torch.ones(N))
    assert not es1.carry["reset_goal"].any()


def test_force_perturbation_block_uses_the_generator():
    cfg = {"env": {"forceScale": 2.0, "forceProbRange": [0.9, 0.99]}}
    task = get_task("ShadowHand", cfg, device="cpu")
    env = VecEnv(task, N, seed=0)
    es = env.reset(seed=0)
    assert es.carry["rb_force"].shape == (N, 3)
    assert ((es.carry["force_prob"] >= 0.9) & (es.carry["force_prob"] <= 0.99)).all()
    a = torch.zeros(N, task.num_actions)
    es1 = dataclasses.replace(es, carry=dict(es.carry))
    c1 = task.control(a, es1, torch.Generator().manual_seed(5))
    es2 = dataclasses.replace(es, carry=dict(es.carry))
    c2 = task.control(a, es2, torch.Generator().manual_seed(5))
    obj = task.model.body_index("object")
    torch.testing.assert_close(c1.body_force, c2.body_force, rtol=0, atol=0)
    assert (c1.body_force[:, obj].abs().sum(1) > 0).float().mean() > 0.5
    assert c1.body_force[:, :obj].abs().sum() == 0
    # a kick is N(0, 1) * mass * scale; without one the force decays
    assert c1.body_force[:, obj].abs().max() < 6 * 0.07087 * 2.0
    stats = task.episode_stats_update(task.episode_stats_init(), env.step(es, a))
    assert stats["consecutive_successes"].shape == ()


def test_adjust_progress_and_episode_stats():
    cfg = {"env": {"maxConsecutiveSuccesses": 5}}
    jtask, task = jget_task("ShadowHand", cfg), get_task("ShadowHand", cfg,
                                                          device="cpu")
    hit = np.array([True, False] * (N // 2))
    prog = np.arange(10, 10 + N, dtype=np.int32)
    out = task.adjust_progress({"reset_goal": torch.as_tensor(hit)},
                               torch.as_tensor(prog))
    ref = jax.vmap(jtask.adjust_progress)({"reset_goal": jnp.asarray(hit)},
                                          jnp.asarray(prog))
    np.testing.assert_array_equal(np_(out), np.asarray(ref))
    assert np_(out)[0] == 0 and np_(out)[1] == 11
    # the default task leaves progress alone
    plain = get_task("Cartpole", device="cpu")
    assert plain.adjust_progress({}, out) is out
    assert plain.episode_stats_update({}, None) == {}
    # the consecutive-success average over the envs that ended
    _, _, _, jes, es, _ = case("ShadowHand")
    done = np.array([True, True] + [False] * (N - 2))
    succ = np.arange(N, dtype=np.float32)
    es1 = dataclasses.replace(es, done=torch.as_tensor(done),
                              metrics={"successes": torch.as_tensor(succ)})
    jes1 = jes.replace(done=jnp.asarray(done),
                       metrics={"successes": jnp.asarray(succ)})
    st = task.episode_stats_update(
        {"consecutive_successes": torch.tensor(2.0)}, es1)
    jst = jtask.episode_stats_update(
        {"consecutive_successes": jnp.asarray(2.0)}, jes1)
    assert float(st["consecutive_successes"]) == pytest.approx(
        float(jst["consecutive_successes"]))


def test_shadow_hand_rollout_matches_jax():
    _, task, jenv, jes, es, actions = case("ShadowHand")
    env = VecEnv(task, N, seed=0)
    ever_done = np.zeros(N, bool)
    for k in range(1, 4):
        jes = jenv.step(jes, jnp.asarray(actions[k]))
        es = env.step(es, torch.as_tensor(actions[k]))
        ever_done |= np.asarray(jes.done) | np_(es.done)
        keep = ~ever_done
        np.testing.assert_allclose(np_(es.obs)[keep], np.asarray(jes.obs)[keep],
                                   err_msg=f"step {k}", **OBS_TOL)
        # the rotation reward 1 / (|rot_dist| + 0.1) is steep near a hit
        np.testing.assert_allclose(np_(es.reward)[keep],
                                   np.asarray(jes.reward)[keep], rtol=1e-3,
                                   atol=1e-2, err_msg=f"step {k}")
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
        np.testing.assert_array_equal(np_(es.progress), np.asarray(jes.progress))
    assert (~ever_done).sum() > N // 2


def test_shadow_hand_goal_hits_match_jax():
    """The success path on one shared state. Envs whose goal is set to
    their object's rotation hit it in the next step in both packages: the
    reach bonus, successes, reset_goal and progress agree. Two envs time
    out in that step, one with successes counted before it: metrics, done
    and the consecutive-success average agree. The step after re-draws the
    goals of the envs that hit (each package from its own draws) and of no
    other; an env that ended starts again at zero successes."""
    jtask, task, jenv, jes, es, actions = case("ShadowHand")
    assert not np.asarray(jes.done).any()
    qa = task._obj_q
    hit = np.arange(N) < N // 2
    goal = np.where(hit[:, None], np.asarray(jes.phys.q)[:, qa + 3: qa + 7],
                    np.asarray(jes.carry["goal_rot"]))
    succ = np.zeros(N, np.float32)
    succ[[0, 2]] = [3.0, 5.0]
    prog = np.asarray(jes.progress).copy()
    ends = [0, N // 2]
    prog[ends] = task.max_episode_length - 2
    jes = jes.replace(progress=jnp.asarray(prog), carry=dict(
        jes.carry, goal_rot=jnp.asarray(goal), successes=jnp.asarray(succ)))
    es = dataclasses.replace(es, progress=torch.as_tensor(prog), carry=dict(
        es.carry, goal_rot=torch.as_tensor(goal), successes=torch.as_tensor(succ)))
    env = VecEnv(task, N, seed=0)

    jes1 = jenv.step(jes, jnp.asarray(actions[1]))
    es1 = env.step(es, torch.as_tensor(actions[1]))
    np.testing.assert_array_equal(np.asarray(jes1.carry["reset_goal"]), hit)
    np.testing.assert_array_equal(np_(es1.carry["reset_goal"]), hit)
    np.testing.assert_allclose(np_(es1.reward), np.asarray(jes1.reward), rtol=1e-3, atol=1e-2)
    assert (np_(es1.reward)[hit] > task.reach_goal_bonus).all()
    assert (np_(es1.reward)[~hit] < task.reach_goal_bonus).all()
    np.testing.assert_array_equal(np_(es1.metrics["successes"]), succ + hit)
    np.testing.assert_array_equal(np.asarray(jes1.metrics["successes"]), succ + hit)
    np.testing.assert_array_equal(np_(es1.done), np.isin(np.arange(N), ends))
    np.testing.assert_array_equal(np.asarray(jes1.done), np.isin(np.arange(N), ends))
    np.testing.assert_array_equal(np_(es1.progress), np.asarray(jes1.progress))
    st = task.episode_stats_update(task.episode_stats_init(), es1)
    jst = jtask.episode_stats_update(jtask.episode_stats_init(), jes1)
    assert float(st["consecutive_successes"]) == pytest.approx(0.1 * 4.0 / 2)
    assert float(jst["consecutive_successes"]) == pytest.approx(0.1 * 4.0 / 2)

    jes2 = jenv.step(jes1, jnp.asarray(actions[2]))
    es2 = env.step(es1, torch.as_tensor(actions[2]))
    going = ~np.isin(np.arange(N), ends)
    for g, old in ((np_(es2.carry["goal_rot"]), goal),
                   (np.asarray(jes2.carry["goal_rot"]), goal)):
        redrawn = (g != old).any(axis=1)
        np.testing.assert_array_equal(redrawn[going], hit[going])
        np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, rtol=1e-5)
    for s in (np_(es2.metrics["successes"]), np.asarray(jes2.metrics["successes"])):
        np.testing.assert_array_equal(s[ends], 0.0)
        np.testing.assert_array_equal(s[going], (succ + hit)[going])
    keep = going & ~hit
    np.testing.assert_allclose(np_(es2.obs)[keep], np.asarray(jes2.obs)[keep], **OBS_TOL)
    np.testing.assert_allclose(np_(es2.reward)[keep], np.asarray(jes2.reward)[keep],
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("name", ["Cartpole", "BallBalance"])
def test_small_task_rollout_matches_jax(name):
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
                                   atol=1e-3)
        np.testing.assert_array_equal(np_(es.timeout), np.asarray(jes.timeout))
    assert (~ever_done).sum() > N // 2


@pytest.mark.parametrize("name", TASKS)
def test_reset_stays_within_the_task_ranges(name):
    task = get_task(name, device="cpu")
    es = task.reset(64, torch.Generator().manual_seed(1))
    m = task.model
    assert es.obs.shape == (64, task.num_obs) and torch.isfinite(es.obs).all()
    jq = torch.as_tensor(m.jq_idx.astype(np.int64))
    assert (es.phys.q[:, jq] >= m.dof_limit_lower - 1e-6).all()
    assert (es.phys.q[:, jq] <= m.dof_limit_upper + 1e-6).all()
    assert not es.done.any() and (es.progress == 0).all()
    for r in m.roots:
        if m.jtype[r] == 0:
            qa = m.q_adr[r]
            torch.testing.assert_close(es.phys.q[:, qa + 3:qa + 7].norm(dim=1),
                                       torch.ones(64))
