"""Port parity of the flyer tasks (Ingenuity, Quadcopter, Crazyflie): the
models field by field, `sample_reset` and `control` on JAX's own draws
rebuilt from its keys, `observe` and `reward_done` from a JAX state and
carry (a JAX reset and one JAX step carried across as numpy), a 3-step
VecEnv rollout against JAX's with the step's draws handed in, and the
physics checks of tests/test_flyers.py: Ingenuity's thrust lifts it,
Crazyflie's motors lag."""

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
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from test_torch_model import BUILDERS, _assert_model_equal
from torch_parity import jax_fields, np_, to_numpy_tree

N = 8
FLYERS = ("Ingenuity", "Quadcopter", "Crazyflie")
# the hooks on the same state: float32 arithmetic in another order
HOOK_TOL = dict(rtol=1e-5, atol=1e-5)
# the rollout: positions and angles to 1e-4; velocity terms carry the
# step's float32 rounding (tests/test_torch_env.py)
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


def jax_control_draws(name, jtask, rngs):
    """The draws JAX's `control` makes from each env's key, as the port's
    `control_draws` returns them (None where it draws nothing)."""
    if name == "Ingenuity":
        return jax.vmap(lambda r: jtask._sample_target(
            jax.random.fold_in(r, 7)))(rngs)
    if name == "Crazyflie":
        return jax.vmap(lambda r: jax.random.normal(
            jax.random.fold_in(r, 3), (4,)))(rngs)
    return None


def _tree_close(a, b, **tol):
    assert set(a) == set(b)
    for k in b:
        if isinstance(b[k], dict):
            _tree_close(a[k], b[k], **tol)
        else:
            np.testing.assert_allclose(np_(a[k]), np.asarray(b[k]), err_msg=k, **tol)


@pytest.mark.parametrize("name", FLYERS)
def test_model_fields_equal(name):
    build, jbuild = BUILDERS[name]
    m = build()
    _assert_model_equal(m, jax_fields(jbuild()))
    # no contact: the group form leaves its contact phases empty
    assert (m.ncp, len(m.pair_surf), m.nb) == (0, 0, {"Ingenuity": 3,
                                                      "Quadcopter": 9,
                                                      "Crazyflie": 5}[name])


@pytest.mark.parametrize("name", ("Ingenuity", "Quadcopter"))
def test_sample_reset_on_jax_draws(name):
    jtask, task, *_ = case(name)
    keys = jax.random.split(jax.random.PRNGKey(11), N)
    jq, jqd, jcarry = jax.vmap(jtask.sample_reset)(keys)
    m = jtask.model
    k12 = jax.vmap(jax.random.split)(keys)
    dof = jax.vmap(lambda k: jax.random.uniform(k, (m.njd,), minval=-0.2,
                                                maxval=0.2))(k12[:, 0])
    if name == "Ingenuity":
        noise = jax.vmap(lambda k: jax.random.uniform(
            k, (3,), minval=-0.5, maxval=0.5))(k12[:, 1])
    else:
        noise = jax.vmap(lambda k: jax.random.uniform(
            k, (3,), minval=jnp.array([-1.5, -1.5, -0.2]),
            maxval=jnp.array([1.5, 1.5, 1.5])))(k12[:, 1])
    q, qd, carry = task.reset_from(torch.tensor(np.asarray(dof)),
                                   torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(np_(q), np.asarray(jq), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(np_(qd), np.asarray(jqd))
    _tree_close(carry, jcarry, rtol=0, atol=0)
    # the port's own draws lie in the same ranges
    g = torch.Generator().manual_seed(0)
    d, n = task.reset_draws(4096, g)
    assert (d.abs() <= 0.2).all() and d.std() > 0.1
    lo = np.array([-0.5] * 3 if name == "Ingenuity" else [-1.5, -1.5, -0.2])
    hi = np.array([0.5] * 3 if name == "Ingenuity" else [1.5, 1.5, 1.5])
    assert (np_(n) >= lo).all() and (np_(n) <= hi).all()
    np.testing.assert_allclose(np_(n).mean(0), (lo + hi) / 2, atol=0.05)


@pytest.mark.parametrize("name", FLYERS)
def test_control_on_jax_draws(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    # Ingenuity takes its redrawn target where progress % 500 == 0
    prog = np.array([0, 1, 500, 3, 1000, 7, 499, 2], np.int32)
    # a key of its own: the state's key drew the current target
    jes = jes.replace(progress=jnp.asarray(prog),
                      rng=jax.vmap(lambda r: jax.random.fold_in(r, 99))(jes.rng))
    es = dataclasses.replace(es, progress=torch.as_tensor(prog),
                             carry=dict(es.carry))

    def jcontrol(act, jes1):
        jes1 = jes1.replace(carry=dict(jes1.carry))
        return jtask.control(act, jes1), jes1.carry

    jctrl, jcarry = jax.vmap(jcontrol)(jnp.asarray(a), jes)
    draws = jax_control_draws(name, jtask, jes.rng)
    if draws is None:
        ctrl = task.control(torch.as_tensor(a), es)
    else:
        ctrl = task.control_from(torch.as_tensor(a), es,
                                 torch.tensor(np.asarray(draws)))
    for f in dataclasses.fields(ctrl):
        np.testing.assert_allclose(np_(getattr(ctrl, f.name)),
                                   np.asarray(getattr(jctrl, f.name)),
                                   err_msg=f.name, **HOOK_TOL)
    _tree_close({k: es.carry[k] for k in jcarry}, jcarry, **HOOK_TOL)
    # the forces act on the rotors only
    bf = np_(ctrl.body_force)
    assert np.abs(bf[:, 0]).max() == 0 and np.abs(bf[:, 1:]).max() > 0
    if name == "Ingenuity":
        moved = (np_(es.carry["target"]) != np_(case(name)[4].carry["target"])).any(1)
        assert moved.tolist() == (prog % 500 == 0).tolist()


@pytest.mark.parametrize("name", FLYERS)
def test_observe_and_reward_done(name):
    jtask, task, _, jes, es, actions = case(name)
    a = actions[1]
    obs, states, carry = task.observe(es.phys, es.carry, torch.as_tensor(a))
    jobs, _, _ = jax.vmap(jtask.observe)(jes.phys, jes.carry, jnp.asarray(a))
    assert obs.shape == (N, task.num_obs) == jobs.shape and states.shape == (N, 0)
    np.testing.assert_allclose(np_(obs), np.asarray(jobs), **HOOK_TOL)
    L = task.max_episode_length
    assert L == jtask.max_episode_length
    prog = np.array([1, 2, L - 3, L - 2, L - 1, L, 5, 6], np.int32)
    r, d, carry, metrics = task.reward_done(es.obs, torch.as_tensor(a), es.phys,
                                            es.carry, torch.as_tensor(prog))
    jr, jd, jcarry, jmetrics = jax.vmap(jtask.reward_done)(
        jes.obs, jnp.asarray(a), jes.phys, jes.carry, jnp.asarray(prog))
    np.testing.assert_allclose(np_(r), np.asarray(jr), **HOOK_TOL)
    np.testing.assert_array_equal(np_(d), np.asarray(jd))
    assert np_(d).any() and not np_(d).all()
    _tree_close(carry, jcarry, **HOOK_TOL)
    _tree_close(metrics, jmetrics, **HOOK_TOL)


@pytest.mark.parametrize("name", FLYERS)
def test_rollout_matches_jax(name):
    """Three more steps of both VecEnvs from the same state under the same
    actions, the port's control draws handed in from JAX's keys; envs that
    reset in either are left out (the two reset from different draws)."""
    jtask, task, jenv, jes, es, actions = case(name)
    env = VecEnv(task, N, seed=0)
    ever_done = np.zeros(N, bool)
    orig = task.control_draws if hasattr(task, "control_draws") else None
    try:
        for k in range(1, 4):
            # the key JAX's step hands its control: the first of a split
            rngs = jax.vmap(lambda r: jax.random.split(r)[0])(jes.rng)
            draws = jax_control_draws(name, jtask, rngs)
            if draws is not None:
                task.control_draws = lambda n, g, d=draws: torch.tensor(np.asarray(d))
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
            np.testing.assert_array_equal(np_(es.progress), np.asarray(jes.progress))
    finally:
        if orig is not None:
            task.control_draws = orig
    assert (~ever_done).sum() > N // 2
    if name == "Crazyflie":
        _tree_close({k: v[keep] for k, v in es.metrics.items()},
                    {k: np.asarray(v)[keep] for k, v in jes.metrics.items()},
                    rtol=1e-4, atol=1e-6)


def test_ingenuity_thrust_lifts():
    """Full vertical thrust lifts the copter against Mars gravity; none
    lets it fall."""
    env = VecEnv(get_task("Ingenuity", device="cpu"), 2, seed=0)
    es = env.reset(seed=0)
    z0 = es.phys.q[:, 2].clone()
    up = torch.zeros(2, 6)
    up[:, [2, 5]] = 1.0
    for _ in range(30):
        es = env.step(es, up)
    assert (es.phys.q[:, 2] > z0 + 0.05).all()
    es = env.reset(seed=1)
    z0 = es.phys.q[:, 2].clone()
    for _ in range(30):
        es = env.step(es, torch.zeros(2, 6))
    assert (es.phys.q[:, 2] < z0 - 0.05).all()


def test_crazyflie_motor_lag():
    """The damped thrust follows a full command with a first-order lag:
    far below it after one step, near it after 60."""
    env = VecEnv(get_task("Crazyflie", device="cpu"), 2, seed=0)
    es = env.reset(seed=0)
    full = torch.ones(2, 4)
    es = env.step(es, full)
    assert (es.carry["thrust_cmds_damp"] < 0.3).all()
    for _ in range(60):
        es = env.step(es, full)
    assert (es.carry["thrust_cmds_damp"] > 0.8).all()
    assert "episode/rew_pos" in es.metrics
