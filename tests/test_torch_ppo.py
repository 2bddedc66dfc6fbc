"""Port parity of the FF PPO learner against the JAX learner on the CPU:
_gae, _loss (value and gradients, with and without the central value and
advantage normalization), the clip + Adam step, one _update on JAX's
permutations under the legacy and the standard schedule (with a minibatch
whose gradient is not finite), _cv_update, _adapt_lr, a rollout across
timeouts (value_bootstrap), and one whole _epoch of Cartpole with JAX's
action noise and permutations handed in. The networks' weights cross from
the JAX trainer through convert.py; datasets are made from a numpy seed.

Tolerances (float32):
- forward values, losses and gradients: rtol 1e-4, atol 1e-6 (another
  summation order through the MLP and its backward pass);
- one Adam step on identical gradients: rtol 1e-6, atol 1e-9;
- a whole _update: Adam turns a gradient difference of a few ulps into a
  step of up to lr on an element whose gradient is near zero, so in each
  parameter tensor at least 99.9% of the elements agree within 1e-5 and
  every one within 2 * lr_max * n_updates (lr_max the largest learning rate
  the run used); and each tensor moves as the reference moves: the norm of
  the two results' difference is at most 1e-3 of the norm of the
  reference's change (measured at most 2e-6).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.ppo import AdamState, clip_adam_step
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.learn import PPOConfig as JPPOConfig
from omniisaacgymenvs_tpu.learn import PPOTrainer as JPPOTrainer
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from torch_parity import np_, to_numpy_tree

# the JAX learner on the CPU computes its networks in exact f32; the port's
# default for f32 feed-forward networks is the TPU's rule, so the port's
# trainers here ask for f32
F32 = dict(net_matmul="f32")

FWD = dict(rtol=1e-4, atol=1e-6)
ADAM = dict(rtol=1e-6, atol=1e-9)


class _Task:
    def episode_stats_init(self):
        return {}


class StubEnv:
    """The sizes a trainer reads, for tests of its pieces without an env."""

    def __init__(self, n, n_obs, n_states, n_act):
        self.num_envs, self.num_obs = n, n_obs
        self.num_states, self.num_actions = n_states, n_act
        self.device = torch.device("cpu")
        self.task = _Task()

    def reset(self, seed=0):
        return None


def _named_from_jax(tree, n_trunk, actor=True):
    """A flax network tree as {port parameter name: numpy array in the
    port's layout}."""
    p = tree["params"]
    out = {}
    for i in range(n_trunk):
        out[f"trunk.layers.{i}.weight"] = np.asarray(p[f"Dense_{i}"]["kernel"]).T
        out[f"trunk.layers.{i}.bias"] = np.asarray(p[f"Dense_{i}"]["bias"])
    heads = ["mu", "value"] if actor else ["value"]
    for k, name in enumerate(heads):
        out[f"{name}.weight"] = np.asarray(p[f"Dense_{n_trunk + k}"]["kernel"]).T
        out[f"{name}.bias"] = np.asarray(p[f"Dense_{n_trunk + k}"]["bias"])
    if actor:
        out["log_std"] = np.asarray(p["log_std"])
    return out


def _sync_trainers(jtr, tr):
    """The port trainer's networks and norms set to the JAX trainer's."""
    convert.actor_critic_from_arrays(to_numpy_tree(jtr.state.params["ac"]),
                                     tr.state.ac)
    if tr.use_cv:
        convert.central_value_from_arrays(to_numpy_tree(jtr.state.cv_params),
                                          tr.state.cv)
    from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
    for name in ("obs_norm", "value_norm", "states_norm"):
        jn = getattr(jtr.state, name)
        setattr(tr.state, name, RunningNorm(
            *(torch.as_tensor(np.asarray(getattr(jn, f)))
              for f in ("mean", "var", "count"))))


def _pair(kw, n=64, n_obs=12, n_states=0, n_act=4, seed=0, norm_seed=1):
    """(jax trainer, port trainer) on stub envs with equal networks and
    non-trivial running norms."""
    jtr = JPPOTrainer(StubEnv(n, n_obs, n_states, n_act), JPPOConfig(**kw), seed)
    tr = PPOTrainer(StubEnv(n, n_obs, n_states, n_act), PPOConfig(**kw, **F32), seed)
    rng = np.random.default_rng(norm_seed)
    js = jtr.state
    js = js.replace(
        obs_norm=js.obs_norm.update(jnp.asarray(
            2.0 * rng.standard_normal((256, n_obs)) + 0.5, jnp.float32)),
        value_norm=js.value_norm.update(jnp.asarray(
            3.0 * rng.standard_normal(256) + 1.0, jnp.float32)))
    if n_states:
        js = js.replace(states_norm=js.states_norm.update(jnp.asarray(
            rng.standard_normal((256, n_states)), jnp.float32)))
    jtr.state = js
    _sync_trainers(jtr, tr)
    return jtr, tr


def _dataset(jtr, S, n_obs, n_states, n_act, seed=2):
    """A flat dataset of S transitions whose behaviour policy is near the
    current one (so the ratio and value clips are active on some rows)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    obs = 2.0 * f(S, n_obs) + 0.5
    x = jtr.state.obs_norm.normalize(jnp.asarray(obs))
    mu, log_std, v = jtr.net.apply(jtr.state.params["ac"], x)
    mu = np.asarray(mu) + 0.05 * f(S, n_act)
    ls = np.broadcast_to(np.asarray(log_std), mu.shape) + 0.05 * f(S, n_act)
    action = mu + np.exp(ls) * f(S, n_act)
    from omniisaacgymenvs_tpu.learn.networks import gaussian_logprob
    logp = np.asarray(gaussian_logprob(jnp.asarray(mu), jnp.asarray(ls),
                                       jnp.asarray(action)))
    value = np.asarray(jtr.state.value_norm.denormalize(v)) + 0.3 * f(S)
    ds = dict(obs=obs, action=action.astype(np.float32), logp=logp,
              value=value.astype(np.float32), mu=mu.astype(np.float32),
              log_std=ls.astype(np.float32), adv=2.0 * f(S),
              ret=(value + 2.0 * f(S)).astype(np.float32))
    if n_states:
        ds["states"] = f(S, n_states)
    return ds


def _t(ds):
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in ds.items()}


def _j(ds):
    return {k: jnp.asarray(v) for k, v in ds.items()}


def _assert_update_rule(port: dict, ref: dict, init: dict, lr_max: float,
                        n_updates: int):
    """The whole-_update rule of the module docstring, leaf by leaf."""
    for k in ref:
        p, r = np_(port[k]), ref[k]
        d = np.abs(p - r)
        assert d.max() <= 2.0 * lr_max * n_updates, (k, d.max())
        assert (d <= 1e-5).mean() >= 0.999, (k, (d <= 1e-5).mean())
        moved = np.linalg.norm(r - init[k])
        assert moved > 0.0, k
        assert np.linalg.norm(p - r) <= 1e-3 * moved, (k, np.linalg.norm(p - r), moved)


def _params_np(module):
    return {k: np_(v).copy() for k, v in module.named_parameters()}


def test_gae_with_dones():
    T, N = 9, 6
    rng = np.random.default_rng(0)
    traj = dict(reward=rng.standard_normal((T, N)).astype(np.float32),
                value=rng.standard_normal((T, N)).astype(np.float32),
                done=rng.random((T, N)) < 0.2)
    last = rng.standard_normal(N).astype(np.float32)
    kw = dict(gamma=0.97, tau=0.9)
    jtr, tr = _pair(kw)
    jadv, jret = jtr._gae(_j(traj), jnp.asarray(last))
    adv, ret = tr._gae(_t(traj), torch.as_tensor(last))
    assert traj["done"].any()
    np.testing.assert_allclose(np_(adv), np.asarray(jadv), **FWD)
    np.testing.assert_allclose(np_(ret), np.asarray(jret), **FWD)


@pytest.mark.parametrize("central_value", [False, True])
@pytest.mark.parametrize("normalize_advantage", [True, False])
def test_loss_and_gradients(central_value, normalize_advantage):
    n_obs, n_states, n_act, units = 24, 30, 6, (64, 32)
    kw = dict(units=units, normalize_advantage=normalize_advantage,
              central_value=central_value, cv_units=(48, 32),
              actor_aux_value_loss=central_value, entropy_coef=0.01,
              bounds_loss_coef=0.1)
    jtr, tr = _pair(kw, n_obs=n_obs, n_states=n_states if central_value else 0,
                    n_act=n_act)
    ds = _dataset(jtr, 128, n_obs, n_states if central_value else 0, n_act)
    am, asd = float(ds["adv"].mean()), float(ds["adv"].std())
    (jl, jaux), jg = jax.value_and_grad(jtr._loss, has_aux=True)(
        jtr.state.params, _j(ds), jtr.state, am, asd)
    params = dict(tr.state.ac.named_parameters())
    loss, aux = tr._loss(tr.state, _t(ds), torch.tensor(am), torch.tensor(asd))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss), float(jl), **FWD)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(jaux[k]), err_msg=k, **FWD)
    jgrads = _named_from_jax(to_numpy_tree(jg["ac"]), len(units))
    scale = max(np.abs(g).max() for g in jgrads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(np_(g), jgrads[name], rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)
    if central_value:
        jcl, jcg = jax.value_and_grad(jtr._cv_loss)(jtr.state.cv_params, _j(ds),
                                                    jtr.state)
        cparams = dict(tr.state.cv.named_parameters())
        cl = tr._cv_loss(tr.state, _t(ds))
        cg = dict(zip(cparams, torch.autograd.grad(cl, list(cparams.values()))))
        np.testing.assert_allclose(float(cl), float(jcl), **FWD)
        jcg = _named_from_jax(to_numpy_tree(jcg), 2, actor=False)
        scale = max(np.abs(g).max() for g in jcg.values())
        for name, g in cg.items():
            np.testing.assert_allclose(np_(g), jcg[name], rtol=1e-4,
                                       atol=1e-6 * scale, err_msg=name)


def test_clip_adam_step_matches_optax():
    """Three steps on identical gradients: one under the clip norm, one
    clipped (norm 40 against 1), one non-finite (zeroed, and Adam still
    steps)."""
    rng = np.random.default_rng(3)
    shapes = [(5, 3), (3,), (7,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes],
             [10.0 * rng.standard_normal(s).astype(np.float32) for s in shapes],
             [rng.standard_normal(s).astype(np.float32) for s in shapes]]
    grads[2][1][0] = np.nan
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.scale_by_adam(eps=1e-8))
    jp = [jnp.asarray(x) for x in p0]
    jst = opt.init(jp)
    tp = [torch.tensor(x, requires_grad=True) for x in p0]
    tst = AdamState.create(tp)
    lr = 3e-3
    for g in grads:
        jg = [jnp.asarray(x) for x in g]
        gok = jnp.isfinite(optax.global_norm(jg))
        jg = [jnp.where(gok, x, jnp.zeros_like(x)) for x in jg]
        upd, jst = opt.update(jg, jst, jp)
        jp = [p - lr * u for p, u in zip(jp, upd)]
        ok = clip_adam_step(tp, [torch.as_tensor(x) for x in g], tst,
                            torch.tensor(lr), 1.0)
        assert bool(ok) == bool(gok)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(np_(a), np.asarray(b), **ADAM)
    assert float(tst.count) == 3.0
    for a, b in zip(tst.nu, jst[1].nu):
        np.testing.assert_allclose(np_(a), np.asarray(b), **ADAM)


def _jax_perms(key, rounds, n):
    keys = jax.random.split(key, rounds + 1)[1:]
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))


@pytest.mark.parametrize("schedule_type", ["legacy", "standard"])
def test_update_on_jax_permutations(schedule_type):
    n_obs, n_act, units = 16, 5, (64, 32)
    S, mb, mini_epochs = 256, 64, 3
    kw = dict(units=units, schedule_type=schedule_type, mini_epochs=mini_epochs,
              minibatch_size=mb, learning_rate=1e-3, kl_threshold=0.008,
              bounds_loss_coef=0.1)
    jtr, tr = _pair(kw, n_obs=n_obs, n_act=n_act)
    ds = _dataset(jtr, S, n_obs, 0, n_act, seed=5)
    perms = _jax_perms(jtr.state.rng, mini_epochs, S)
    init = _params_np(tr.state.ac)
    # one row's advantage is NaN: its minibatch's gradient is not finite
    # and is skipped (Adam steps on zeros) in both
    bad = int(perms[1, 70])
    ds["adv"][bad] = np.nan
    am = float(np.nanmean(ds["adv"]))
    asd = float(np.nanstd(ds["adv"]))
    jts, jaux = jtr._update(jtr.state, _j(ds), am, asd, S, mb)
    aux = tr._update(tr.state, _t(ds), torch.tensor(am), torch.tensor(asd),
                     S, mb, perms=torch.as_tensor(perms))
    n_updates = mini_epochs * (S // mb)
    assert float(tr.state.opt_state.count) == float(jts.opt_state[1].count) == n_updates
    np.testing.assert_allclose(float(tr.state.lr), float(jts.lr), rtol=1e-6)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(jaux[k]), rtol=1e-3, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    assert np.isnan(float(aux["loss"]))  # the skipped minibatch's loss
    assert np.isfinite(float(aux["kl"]))
    lr_max = max(kw["learning_rate"], float(jts.lr)) * 1.5 ** n_updates
    lr_max = min(lr_max, PPOConfig().lr_max)
    ref = _named_from_jax(to_numpy_tree(jts.params["ac"]), len(units))
    _assert_update_rule(dict(tr.state.ac.named_parameters()), ref, init,
                        lr_max, n_updates)


def test_cv_update_on_jax_permutations():
    n_obs, n_states, n_act = 10, 20, 3
    S = 192
    kw = dict(units=(32,), central_value=True, cv_units=(64, 32),
              cv_minibatch_size=64, cv_mini_epochs=2, cv_learning_rate=5e-4)
    jtr, tr = _pair(kw, n_obs=n_obs, n_states=n_states, n_act=n_act)
    ds = _dataset(jtr, S, n_obs, n_states, n_act, seed=6)
    cv_ds = {k: ds[k] for k in ("states", "value", "ret")}
    perms = _jax_perms(jtr.state.rng, 2, S)
    init = _params_np(tr.state.cv)
    jts, jloss = jtr._cv_update(jtr.state, _j(cv_ds), S)
    loss = tr._cv_update(tr.state, _t(cv_ds), S, perms=torch.as_tensor(perms))
    np.testing.assert_allclose(float(loss), float(jloss), **FWD)
    ref = _named_from_jax(to_numpy_tree(jts.cv_params), 2, actor=False)
    _assert_update_rule(dict(tr.state.cv.named_parameters()), ref, init, 5e-4, 6)
    assert float(tr.state.cv_opt_state.count) == 6.0


def test_adapt_lr():
    kw = dict(kl_threshold=0.01, lr_min=1e-4, lr_max=5e-3)
    jtr, tr = _pair(kw)
    for lr in (5e-5, 1e-4, 1e-3, 4e-3, 5e-3):
        for kl in (0.0, 0.0049, 0.005, 0.01, 0.02, 0.0201, 1.0):
            got = tr._adapt_lr(torch.tensor(lr), torch.tensor(kl))
            want = jtr._adapt_lr(jnp.float32(lr), jnp.float32(kl))
            assert float(got) == float(want), (lr, kl)


# ---- with a task: Cartpole, whose port matches the JAX task to float32
# rounding over a few steps

N = 16
# four steps: no env of the reset ends its episode by falling (a pole starts
# up to 22.5 degrees off and turning)
EPOCH_KW = dict(horizon_length=4, minibatch_size=16, mini_epochs=3,
                units=(32, 32), value_bootstrap=True, reward_shaper_scale=0.1,
                learning_rate=3e-4, critic_coef=4.0)
# trajectory of 4 Cartpole steps: float32 physics in another operation order
TRAJ = dict(rtol=1e-4, atol=1e-5)


def _task_pair(kw, seed=0):
    jtr = JPPOTrainer(JVecEnv(jget_task("Cartpole"), N), JPPOConfig(**kw), seed)
    tr = PPOTrainer(VecEnv(get_task("Cartpole", device="cpu"), N, seed=seed),
                    PPOConfig(**kw, **F32), seed)
    f = {k: to_numpy_tree(getattr(jtr.state.es, k))
         for k in ("phys", "carry", "obs", "states", "reward", "done",
                   "timeout", "progress", "metrics")}
    tr.state.es = convert.env_state_from_arrays(f, device="cpu")
    _sync_trainers(jtr, tr)
    return jtr, tr


def _jax_draws(jtr, T, A, mini_epochs, n=None):
    """JAX's action noise (T, n, A) (n: N unless given) and the key its
    _update permutations come from, rebuilt from the trainer's key splits."""
    rng, k = jax.random.split(jtr.state.rng)
    noise = []
    for _ in range(T):
        k, kt = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(kt, (n or N, A))))
    return np.stack(noise), rng


def test_rollout_across_timeouts_with_value_bootstrap():
    """Envs 0-3 reach their time limit at the second step: the shaped reward
    gains gamma * value there, the episode counters fold them in, and they
    restart (from different draws in the two packages, so they are compared
    only up to their timeout)."""
    jtr, tr = _task_pair(EPOCH_KW)
    t_out = tr.env.task.timeout_progress
    prog = np.zeros(N, np.int32)
    prog[:4] = t_out - 2
    jtr.state = jtr.state.replace(es=jtr.state.es.replace(progress=jnp.asarray(prog)))
    tr.state.es.progress = torch.as_tensor(prog)
    noise, _ = _jax_draws(jtr, EPOCH_KW["horizon_length"], tr.env.num_actions, 3)
    jts, jtraj, jlast, jstats = jax.jit(jtr._rollout)(jtr.state)
    traj, last, stats = tr._rollout(tr.state, torch.as_tensor(noise))
    jd = np.asarray(jtraj["done"])
    assert jd[1, :4].all() and not jd[:, 4:].any() and not jd[0].any()
    np.testing.assert_array_equal(np_(traj["done"]), jd)
    for k in ("obs", "action", "logp", "value", "mu", "reward"):
        np.testing.assert_allclose(np_(traj[k])[:2], np.asarray(jtraj[k])[:2],
                                   err_msg=k, **TRAJ)
        np.testing.assert_allclose(np_(traj[k])[:, 4:], np.asarray(jtraj[k])[:, 4:],
                                   err_msg=k, **TRAJ)
    # the bootstrap term is in the timed-out step's reward: what is left is
    # the shaped Cartpole reward, 0.1 x (1 - small terms)
    rew, val = np_(traj["reward"])[1, :4], np_(traj["value"])[1, :4]
    left = rew - 0.99 * val
    assert ((left > 0.0) & (left <= 0.1)).all() and np.abs(val).max() > 0.1, (rew, val)
    for k in ("fin_ret", "fin_len", "fin_cnt"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), err_msg=k, **TRAJ)
    assert float(stats["fin_cnt"]) == 4.0
    np.testing.assert_allclose(np_(tr.state.ep_len)[4:], np.asarray(jts.ep_len)[4:])


def test_epoch_matches_jax_epoch():
    """The slice as a whole: one Cartpole _epoch of both learners, with JAX's
    action noise and permutations handed to the port, on a horizon where no
    env ends its episode. Trajectory, metrics, norms and parameters."""
    T, mini_epochs = EPOCH_KW["horizon_length"], EPOCH_KW["mini_epochs"]
    jtr, tr = _task_pair(EPOCH_KW)
    A = tr.env.num_actions
    noise, rng_after = _jax_draws(jtr, T, A, mini_epochs)
    perms = _jax_perms(rng_after, mini_epochs, T * N)
    init = _params_np(tr.state.ac)
    # the trajectories, from copies of the states
    _, jtraj, _, _ = jax.jit(jtr._rollout)(jtr.state)
    traj, _, _ = tr._rollout(copy.deepcopy(tr.state), torch.as_tensor(noise))
    assert not np.asarray(jtraj["done"]).any(), "an env ended its episode"
    for k in ("obs", "action", "logp", "value", "mu", "log_std", "reward"):
        np.testing.assert_allclose(np_(traj[k]), np.asarray(jtraj[k]), err_msg=k,
                                   **TRAJ)
    jts, jm = jtr._epoch_jit(jtr.state)
    m = tr._epoch(tr.state, noise=torch.as_tensor(noise),
                  perms=torch.as_tensor(perms))
    assert sorted(m) == sorted(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert tr.state.epoch == int(jts.epoch) == 1
    for name in ("obs_norm", "value_norm"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                np_(getattr(getattr(tr.state, name), f)),
                np.asarray(getattr(getattr(jts, name), f)), rtol=1e-4, atol=1e-6,
                err_msg=f"{name}.{f}")
    n_updates = mini_epochs * (T * N // EPOCH_KW["minibatch_size"])
    lr_max = min(EPOCH_KW["learning_rate"] * 1.5 ** n_updates, PPOConfig().lr_max)
    ref = _named_from_jax(to_numpy_tree(jts.params["ac"]), 2)
    _assert_update_rule(dict(tr.state.ac.named_parameters()), ref, init, lr_max,
                        n_updates)
    np.testing.assert_allclose(np_(tr.state.es.obs), np.asarray(jts.es.obs), **TRAJ)

