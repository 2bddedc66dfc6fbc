"""Port parity of the Custom task (`tasks/custom.py`) on
examples/double_pendulum.urdf, with a FIXED and a FREE base, and on
chip_smoke.py's MJCF chain: num_obs, `sample_reset` on JAX's own draws
(`reset_from`), `observe` / `reward_done` from a JAX state, 3 steps of
obs / reward / done of both VecEnvs from one state under the same actions;
the ValueError without a robot and for an unknown extension, and the fall
termination of a FREE base."""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.convert import env_state_from_arrays
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from torch_parity import np_, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import MJCF_CHAIN  # noqa: E402

EXAMPLE = os.path.join(ROOT, "examples", "double_pendulum.urdf")
N = 8
# the hooks on the same state: float32 arithmetic in another order
HOOK_TOL = dict(rtol=1e-5, atol=1e-5)
# three steps of the plain physics in another operation order
# (tests/test_torch_env.py)
OBS_TOL = dict(rtol=2e-3, atol=2e-3)
# a FREE base falls from z = 0 at once: its rollout runs with the fall
# termination below any height it reaches in three steps
CASES = {"fixed": {},
         "floating": {"floatingBase": True, "terminationHeight": -5.0},
         "mjcf": {}}


@functools.lru_cache(maxsize=None)
def chain_file():
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "chain.xml")
    with open(path, "w") as f:
        f.write(MJCF_CHAIN)
    return path


def cfg_of(case):
    robot = chain_file() if case == "mjcf" else EXAMPLE
    return {"env": {"robot": robot, **CASES[case]}}


@functools.lru_cache(maxsize=None)
def setup(case):
    """(JAX task, port task, JAX env, JAX state after a reset and one step,
    the same state in the port, actions)."""
    jtask = jget_task("Custom", cfg_of(case))
    task = get_task("Custom", cfg_of(case), device="cpu")
    jenv = JVecEnv(jtask, N)
    rng = np.random.default_rng(len(case))
    actions = rng.uniform(-1, 1, (5, N, task.num_actions)).astype(np.float32)
    jes = jenv.step(jenv.reset(seed=2), jnp.asarray(actions[0]))
    f = {fl.name: to_numpy_tree(getattr(jes, fl.name))
         for fl in dataclasses.fields(jes)}
    f.pop("rng")
    return jtask, task, jenv, jes, env_state_from_arrays(f, device="cpu"), actions


@pytest.mark.parametrize("case", sorted(CASES))
def test_sizes_equal_jax(case):
    jtask, task, *_ = setup(case)
    assert (task.num_obs, task.num_actions, task.num_states) == (
        jtask.num_obs, jtask.num_actions, jtask.num_states)
    assert task.num_obs == {"fixed": 6, "floating": 17, "mjcf": 12}[case]
    assert task.floating == jtask.floating == (case == "floating")
    assert task.max_episode_length == jtask.max_episode_length


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_reset_on_jax_draws(case):
    jtask, task, *_ = setup(case)
    keys = jax.random.split(jax.random.PRNGKey(11), N)
    jq, jqd, jcarry = jax.vmap(jtask.sample_reset)(keys)
    m = jtask.model

    def draws(k):
        k1, k2, _ = jax.random.split(k, 3)
        noise = jtask.reset_noise * jax.random.uniform(k1, (m.njd,), minval=-1.0,
                                                       maxval=1.0)
        return noise, jax.random.uniform(k2, (m.njd,), minval=jtask._tgt_lo,
                                         maxval=jtask._tgt_hi)

    noise, target = jax.vmap(draws)(keys)
    q, qd, carry = task.reset_from(torch.tensor(np.asarray(noise)),
                                   torch.tensor(np.asarray(target)))
    np.testing.assert_allclose(np_(q), np.asarray(jq), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(np_(qd), np.asarray(jqd))
    np.testing.assert_array_equal(np_(carry["target"]), np.asarray(jcarry["target"]))
    # the port's own draws lie in the same windows
    g = torch.Generator().manual_seed(0)
    nz, tg = task.reset_draws(4096, g)
    assert (nz.abs() <= task.reset_noise).all()
    assert (tg >= task._tgt_lo).all() and (tg <= task._tgt_hi).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_observe_and_reward_done(case):
    jtask, task, _, jes, es, actions = setup(case)
    a = actions[1]
    ctrl = task.control(torch.as_tensor(a), es)
    jctrl = jax.vmap(jtask.control)(jnp.asarray(a), jes)
    for f in dataclasses.fields(ctrl):
        np.testing.assert_allclose(np_(getattr(ctrl, f.name)),
                                   np.asarray(getattr(jctrl, f.name)),
                                   err_msg=f.name, **HOOK_TOL)
    obs, states, _ = task.observe(es.phys, es.carry, torch.as_tensor(a))
    jobs, _, _ = jax.vmap(jtask.observe)(jes.phys, jes.carry, jnp.asarray(a))
    assert obs.shape == (N, task.num_obs) and states.shape == (N, 0)
    np.testing.assert_allclose(np_(obs), np.asarray(jobs), **HOOK_TOL)
    L = task.max_episode_length
    prog = np.array([1, 2, L - 3, L - 2, L - 1, L, 5, 6], np.int32)
    r, d, _, metrics = task.reward_done(es.obs, torch.as_tensor(a), es.phys,
                                        es.carry, torch.as_tensor(prog))
    jr, jd, _, _ = jax.vmap(jtask.reward_done)(jes.obs, jnp.asarray(a), jes.phys,
                                               jes.carry, jnp.asarray(prog))
    np.testing.assert_allclose(np_(r), np.asarray(jr), **HOOK_TOL)
    np.testing.assert_array_equal(np_(d), np.asarray(jd))
    assert np_(d).any() and not np_(d).all() and metrics == {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_matches_jax(case):
    """Three more steps of both VecEnvs from the same state under the same
    actions; envs that reset in either are left out (the two draw their
    resets from different generators)."""
    jtask, task, jenv, jes, es, actions = setup(case)
    env = VecEnv(task, N, seed=0)
    ever_done = np.zeros(N, bool)
    for k in range(1, 4):
        jes = jenv.step(jes, jnp.asarray(actions[k]))
        es = env.step(es, torch.as_tensor(actions[k]))
        ever_done |= np.asarray(jes.done) | np_(es.done)
        keep = ~ever_done
        np.testing.assert_allclose(np_(es.obs)[keep], np.asarray(jes.obs)[keep],
                                   err_msg=f"step {k}", **OBS_TOL)
        np.testing.assert_allclose(np_(es.reward)[keep], np.asarray(jes.reward)[keep],
                                   rtol=1e-3, atol=1e-3, err_msg=f"step {k}")
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
    assert keep.sum() > N // 2


def test_free_base_falls_and_terminates_as_jax():
    """At the default terminationHeight 0.2 a FREE base that starts at
    z = 0 ends its episode at the first step, with reward -1, in both."""
    cfg = {"env": {"robot": EXAMPLE, "floatingBase": True}}
    task, jtask = get_task("Custom", cfg, device="cpu"), jget_task("Custom", cfg)
    env, jenv = VecEnv(task, 4, seed=0), JVecEnv(jtask, 4)
    es, jes = env.reset(seed=0), jenv.reset(seed=0)
    zero = np.zeros((4, task.num_actions), np.float32)
    es, jes = env.step(es, torch.as_tensor(zero)), jenv.step(jes, jnp.asarray(zero))
    assert np_(es.done).all() and np.asarray(jes.done).all()
    np.testing.assert_array_equal(np_(es.reward), np.full(4, -1.0, np.float32))
    np.testing.assert_array_equal(np.asarray(jes.reward), np_(es.reward))


def test_custom_refuses_a_missing_robot_and_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="robot"):
        get_task("Custom", device="cpu")
    with pytest.raises(ValueError, match="robot"):
        get_task("Custom", {"env": {"robot": None}}, device="cpu")
    bad = tmp_path / "robot.sdf"
    bad.write_text("<sdf/>")
    with pytest.raises(ValueError, match="unsupported robot format '.sdf'"):
        get_task("Custom", {"env": {"robot": str(bad)}}, device="cpu")


def test_floating_flag_on_a_fixed_mjcf_uses_the_model(capsys):
    """floatingBase=True on an MJCF whose base is FIXED: the same notice as
    the JAX package's, and the model's FIXED root decides the obs."""
    cfg = {"env": {"robot": chain_file(), "floatingBase": True}}
    task = get_task("Custom", cfg, device="cpu")
    ours = capsys.readouterr().out
    jtask = jget_task("Custom", cfg)
    theirs = capsys.readouterr().out
    assert ours == theirs == ("custom robot: floatingBase=True requested but the "
                              "imported model root is FIXED; using the model\n")
    assert not task.floating and task.num_obs == jtask.num_obs == 3 * task.model.njd


def test_custom_runs_on_cuda_by_default():
    """The task builds on the card unless device='cpu' is given; without a
    card it raises instead of running on the CPU."""
    cfg = {"env": {"robot": EXAMPLE}}
    if torch.cuda.is_available():
        assert get_task("Custom", cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_task("Custom", cfg)
