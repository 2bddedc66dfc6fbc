"""The ShadowHandOpenAI_FF / _LSTM tasks and the task base's randomization
plumbing against the JAX package: both names build with openai observations
and 187 asymmetric states, a JAX `EnvState` whose carry holds `_dr` crosses
through `convert.py`, three steps of both packages agree when the per-step
observation and action noise is taken out of the cfg (a step is then
deterministic given the carry), the once-only overlay survives a reset, and
the interval keys follow `progress`."""

import copy
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.convert import env_state_from_arrays
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config
from omniisaacgymenvs_torch.utils.domain_randomization import Randomizer
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from omniisaacgymenvs_tpu.utils.config import load_config as jload_config
from torch_parity import np_, to_numpy_tree

N = 8
NAMES = ("ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM")
# as tests/test_torch_tasks.py holds the ShadowHand rollout
OBS_TOL = dict(rtol=2e-3, atol=2e-3)
# the 187 asymmetric states also hold the joints', the cube's and the
# fingertips' velocities, which drift apart faster than the positions that
# make up the openai observation: a control step here is 12 substeps, three
# steps 36, against 12 in that file's rollout (seen: 8.7e-3 on the cube's
# scaled angular velocity of 0.73 after the third step, 4.2e-4 after the
# second)
STATES_TOL = dict(rtol=5e-3, atol=1e-2)
TEN_KEYS = {"damping_scale", "friction_scale", "geom_scale", "gravity_delta",
            "limit_lower_delta", "limit_upper_delta", "mass_scale",
            "stiffness_scale", "tendon_damping_scale",
            "tendon_stiffness_scale"}


def quiet(task_cfg: dict) -> dict:
    """The cfg without the per-step (on_interval) observation and action
    noise and without the random forces on the cube: what is left of a step
    is deterministic given the carry. The episode's correlated noise and
    every physics overlay stay."""
    cfg = copy.deepcopy(task_cfg)
    params = cfg["domain_randomization"]["randomization_params"]
    for grp in ("observations", "actions"):
        del params[grp]["on_interval"]
    cfg["env"]["forceScale"] = 0.0
    return cfg


@pytest.mark.parametrize("name", NAMES)
def test_openai_names_build_with_openai_obs_and_asymmetric_states(name):
    cfg = load_config({"task": name})["task"]
    assert cfg == jload_config({"task": name})["task"]
    task, jtask = get_task(name, cfg, device="cpu"), jget_task(name, cfg)
    assert (task.obs_type, task.num_obs, task.num_states) == ("openai", 42, 187)
    assert (task.num_obs, task.num_states, task.num_actions) == (
        jtask.num_obs, jtask.num_states, jtask.num_actions)
    assert task._dr_on and jtask._dr_on
    assert task.decimation == 3 and task.engine.params.substeps == 4
    assert task.engine.h == pytest.approx(1.0 / 240.0, rel=1e-4)
    assert task.max_episode_length == 160 and task.max_consecutive_successes == 50
    # without a cfg the name still gives the openai variant, unrandomized
    bare = get_task(name, device="cpu")
    assert (bare.num_obs, bare.num_states, bare._dr_on) == (42, 187, False)
    assert isinstance(bare.randomizer, Randomizer)


def test_registry_attaches_a_randomizer_to_every_task():
    for name in ("Cartpole", "ShadowHand"):
        task = get_task(name, device="cpu")
        assert isinstance(task.randomizer, Randomizer) and not task._dr_on
    cfg = load_config({"task": "ShadowHand",
                       "task.domain_randomization.randomize": True})["task"]
    task = get_task("ShadowHand", cfg, device="cpu")
    assert task._dr_on and task.num_obs == 157
    es = task.reset(N, torch.Generator().manual_seed(0))
    assert set(es.carry["_dr"]) >= {"obs_corr", "act_corr", "overlay"}


@functools.lru_cache(maxsize=None)
def case():
    """(JAX env, port env, JAX state after reset and one step, the same
    state in the port, actions) of the quiet ShadowHandOpenAI_FF."""
    cfg = quiet(load_config({"task": "ShadowHandOpenAI_FF"})["task"])
    jtask = jget_task("ShadowHandOpenAI_FF", cfg)
    task = get_task("ShadowHandOpenAI_FF", cfg, device="cpu")
    jenv = JVecEnv(jtask, N)
    rng = np.random.default_rng(11)
    actions = rng.uniform(-1, 1, (5, N, task.num_actions)).astype(np.float32)
    jes = jenv.step(jenv.reset(seed=3), jnp.asarray(actions[0]))
    fields = {f.name: to_numpy_tree(getattr(jes, f.name))
              for f in dataclasses.fields(jes) if f.name != "rng"}
    es = env_state_from_arrays(fields, device="cpu")
    return jenv, VecEnv(task, N, seed=0), jes, es, actions


def test_dr_carry_crosses_from_jax():
    jenv, env, jes, es, _ = case()
    dr, jdr = es.carry["_dr"], jes.carry["_dr"]
    assert set(dr) == set(jdr) == {"obs_corr", "act_corr", "overlay", "startup"}
    assert set(dr["startup"]) == {"geom_scale", "mass_scale"}
    assert set(dr["overlay"]) | set(dr["startup"]) == TEN_KEYS
    for grp in ("overlay", "startup"):
        for k, v in dr[grp].items():
            assert v.dtype == torch.float32 and v.shape[0] == N
            np.testing.assert_array_equal(np_(v), np.asarray(jdr[grp][k]))
    np.testing.assert_array_equal(np_(dr["obs_corr"]), np.asarray(jdr["obs_corr"]))
    # a reset of the port draws the same structure
    own = env.reset(seed=0).carry["_dr"]
    assert set(own) == set(dr)
    for grp in ("overlay", "startup"):
        assert {k: tuple(v.shape) for k, v in own[grp].items()} == {
            k: tuple(v.shape) for k, v in dr[grp].items()}


def test_three_randomized_steps_match_jax():
    """Same carry (overlays of all ten keys, correlated noise), same
    actions: three control steps of 12 substeps each through both packages.
    Envs that reset in either are left out: their fresh draws differ."""
    jenv, env, jes, es, actions = case()
    ever_done = np.zeros(N, bool)
    for k in range(1, 4):
        jes = jenv.step(jes, jnp.asarray(actions[k]))
        es = env.step(es, torch.as_tensor(actions[k]))
        ever_done |= np.asarray(jes.done) | np_(es.done)
        keep = ~ever_done
        np.testing.assert_allclose(np_(es.obs)[keep], np.asarray(jes.obs)[keep],
                                   err_msg=f"step {k}", **OBS_TOL)
        np.testing.assert_allclose(np_(es.states)[keep],
                                   np.asarray(jes.states)[keep],
                                   err_msg=f"step {k}", **STATES_TOL)
        np.testing.assert_allclose(np_(es.reward)[keep],
                                   np.asarray(jes.reward)[keep], rtol=1e-3,
                                   atol=1e-2, err_msg=f"step {k}")
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
        np.testing.assert_array_equal(np_(es.progress), np.asarray(jes.progress))
    assert (~ever_done).sum() > N // 2
    # the overlay was in force: the unrandomized task ends elsewhere
    _, _, _, es0, _ = case()
    plain = get_task("ShadowHandOpenAI_FF", device="cpu")
    carry = {k: v for k, v in es0.carry.items() if k != "_dr"}
    pes = VecEnv(plain, N).step(dataclasses.replace(es0, carry=carry),
                                torch.as_tensor(actions[1]))
    res = env.step(es0, torch.as_tensor(actions[1]))
    assert (pes.phys.qd - res.phys.qd).abs().max() > 1e-2


def test_startup_overlay_survives_a_forced_done():
    _, env, _, es, actions = case()
    done = torch.zeros(N, dtype=torch.bool)
    done[[1, 5]] = True
    before = es.carry["_dr"]
    es1 = env.step(dataclasses.replace(es, done=done), torch.as_tensor(actions[1]))
    after = es1.carry["_dr"]
    for k in before["startup"]:
        assert torch.equal(after["startup"][k], before["startup"][k]), k
    # the episode's draws were made anew where the env was reset, and only
    # there
    for k in ("stiffness_scale", "friction_scale", "limit_lower_delta"):
        changed = (after["overlay"][k] != before["overlay"][k]).any(dim=1)
        assert changed.tolist() == done.tolist(), k
    changed = (after["obs_corr"] != before["obs_corr"]).any(dim=1)
    assert changed.tolist() == done.tolist()
    # a fresh episode: one step old (zero where that step hit the goal)
    assert (es1.progress[done] <= 1).all() and (es1.progress[~done] != 1).all()
    # the caller's carry is untouched
    assert es.carry["_dr"] is before


def test_interval_gravity_follows_progress():
    """gravity_delta is zero at the reset and is drawn anew exactly in the
    envs whose progress is a multiple of 720 when the step begins (so in
    every env at its first step)."""
    _, env, jes, es, actions = case()
    fresh = env.reset(seed=0)
    assert torch.equal(fresh.carry["_dr"]["overlay"]["gravity_delta"],
                       torch.zeros(N, 3))
    first = env.step(fresh, torch.as_tensor(actions[0]))
    g1 = first.carry["_dr"]["overlay"]["gravity_delta"]
    assert (g1[:, 2] != 0).all() and torch.equal(g1[:, :2], torch.zeros(N, 2))
    assert (np.asarray(jes.carry["_dr"]["overlay"]["gravity_delta"])[:, 2] != 0).all()
    progress = torch.tensor([1, 719, 720, 721, 1440, 5, 0, 100], dtype=torch.int32)
    es1 = env.step(dataclasses.replace(first, progress=progress),
                   torch.as_tensor(actions[1]))
    g2 = es1.carry["_dr"]["overlay"]["gravity_delta"]
    due = progress % 720 == 0
    assert due.tolist() == [False, False, True, False, True, False, True, False]
    assert torch.equal(g2[~due], g1[~due])
    assert (g2[due][:, 2] != g1[due][:, 2]).all()


def test_actions_are_randomized_after_the_clamp_and_observations_before_the_clip():
    cfg = load_config({"task": "ShadowHandOpenAI_FF"})["task"]
    params = cfg["domain_randomization"]["randomization_params"]
    params["actions"] = {"on_reset": {"operation": "additive",
                                      "distribution": "uniform",
                                      "distribution_parameters": [0.5, 0.5]}}
    params["observations"] = {"on_reset": {"operation": "additive",
                                           "distribution": "uniform",
                                           "distribution_parameters": [9.0, 9.0]}}
    task = get_task("ShadowHandOpenAI_FF", cfg, device="cpu")
    env = VecEnv(task, N, seed=0)
    es = env.reset(seed=0)
    es1 = env.step(es, torch.full((N, task.num_actions), 3.0))
    # clamped to 1, then shifted by 0.5: the observation's action slot reads
    # 1.5 before its own shift by 9, and the clip at 5 comes last
    assert torch.equal(es1.obs[:, -20:], torch.full((N, 20), 5.0))
    assert (es1.states[:, -20:] == 1.5).all()
