"""Port parity of the Humanoid VecEnv: a JAX reset carried across, three
steps with the same actions, then a step with done forced on some envs
(the auto-reset merge) and a non-finite state (the finite guard)."""

import dataclasses

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

N = 8
FORCED = [1, 5]   # envs forced done in the merge step
NAN_ENV = 2       # env whose state is made non-finite

# obs tolerance: positions and angles to 1e-4; velocity terms and contact
# wrenches carry the step's float32 rounding (see test_torch_fused_step)
OBS_TOL = dict(rtol=2e-3, atol=2e-3)


def _jax_env_state_fields(jes):
    f = {fl.name: to_numpy_tree(getattr(jes, fl.name))
         for fl in dataclasses.fields(jes)}
    f.pop("rng")
    return f


@pytest.fixture(scope="module")
def rollout():
    jenv = JVecEnv(jget_task("Humanoid"), N)
    env = VecEnv(get_task("Humanoid", device="cpu"), N, seed=0)
    jes = jenv.reset(seed=3)
    es = env_state_from_arrays(_jax_env_state_fields(jes), device="cpu")
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (5, N, env.num_actions)).astype(np.float32)
    out = {"jax": [], "torch": []}
    for k in range(3):
        jes = jenv.step(jes, jnp.asarray(actions[k]))
        es = env.step(es, torch.as_tensor(actions[k]))
        out["jax"].append(jes)
        out["torch"].append(es)
    return jenv, env, jes, es, actions, out


def test_three_steps_match(rollout):
    _, _, _, _, _, out = rollout
    for k, (jes, es) in enumerate(zip(out["jax"], out["torch"])):
        np.testing.assert_allclose(np_(es.obs), np.asarray(jes.obs),
                                   err_msg=f"step {k}", **OBS_TOL)
        # the reward's potential term differences positions / dt: 1e-4 m
        # of drift is 6e-3 in reward
        np.testing.assert_allclose(np_(es.reward), np.asarray(jes.reward),
                                   rtol=1e-3, atol=1e-2, err_msg=f"step {k}")
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
        np.testing.assert_array_equal(np_(es.progress), np.asarray(jes.progress))
        np.testing.assert_array_equal(np_(es.timeout), np.asarray(jes.timeout))
    assert not np_(out["torch"][-1].done).any()


def test_forced_done_merge_and_finite_guard(rollout):
    jenv, env, jes, es, actions, _ = rollout
    done = np.zeros(N, bool)
    done[FORCED] = True
    jes = jes.replace(done=jnp.asarray(done))
    jes = jes.replace(phys=jes.phys.replace(
        qd=jes.phys.qd.at[NAN_ENV, 0].set(jnp.nan)))
    es = dataclasses.replace(es, done=torch.as_tensor(done))
    qd = es.phys.qd.clone()
    qd[NAN_ENV, 0] = float("nan")
    es = dataclasses.replace(es, phys=dataclasses.replace(es.phys, qd=qd))

    a = torch.as_tensor(actions[3])
    gen_state = env.generator.get_state()
    nxt = env.step(es, a)
    jnxt = jenv.step(jes, jnp.asarray(actions[3]))

    keep = np.setdiff1d(np.arange(N), FORCED + [NAN_ENV])
    np.testing.assert_allclose(np_(nxt.obs)[keep], np.asarray(jnxt.obs)[keep],
                               **OBS_TOL)
    np.testing.assert_allclose(np_(nxt.reward)[keep],
                               np.asarray(jnxt.reward)[keep], rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_array_equal(np_(nxt.done), np.asarray(jnxt.done))
    np.testing.assert_array_equal(np_(nxt.progress), np.asarray(jnxt.progress))

    # finite guard: the NaN env ends with zero reward and finite obs, the
    # same in both packages
    assert bool(nxt.done[NAN_ENV]) and float(nxt.reward[NAN_ENV]) == 0.0
    assert torch.isfinite(nxt.obs).all()
    np.testing.assert_allclose(np_(nxt.obs)[NAN_ENV],
                               np.asarray(jnxt.obs)[NAN_ENV], **OBS_TOL)

    # merge: forced envs restart from the fresh reset the step drew, so they
    # equal one step of that fresh state
    env.generator.set_state(gen_state)
    fresh = env.task.reset(N, env.generator)
    expect = env.step(fresh, a)
    assert np_(nxt.progress)[FORCED].tolist() == [1, 1]
    for name in ("obs", "reward", "done", "progress"):
        torch.testing.assert_close(getattr(nxt, name)[FORCED],
                                   getattr(expect, name)[FORCED])
    torch.testing.assert_close(nxt.phys.q[FORCED], expect.phys.q[FORCED])


def test_rollout_shapes_and_counters_on_cpu():
    env = VecEnv(get_task("Humanoid", device="cpu"), 4, seed=1)
    es = env.reset(seed=1)

    def policy(obs, gen):
        return 2 * torch.rand((obs.shape[0], env.num_actions),
                              generator=gen) - 1

    es, (obs, rew, done) = env.rollout(es, policy, 2)
    assert obs.shape == (2, 4, 87) and rew.shape == (2, 4)
    assert done.dtype == torch.bool
    assert env.task.engine.kernels is None  # CPU engines carry no tables


def test_entry_points_need_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_task("Humanoid")
