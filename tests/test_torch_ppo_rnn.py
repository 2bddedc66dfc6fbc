"""Port parity of the recurrent PPO learner against the JAX learner on the
CPU: the LSTM rollout on JAX's action noise across mid-chunk timeouts, with
the chunk-start LSTM states and the dataset's layout (sequences env-major,
`done` per step, the start states) equal to JAX's; `_loss` and `_cv_loss`
over sequences (values and gradients); `_update` and `_cv_update` on JAX's
permutations; one whole Cartpole `_epoch` with `rnn="lstm"` (and with an
LSTM central value on states equal to the observations); and the PPO ratio
starting at 1 when episodes end inside the sequences. The networks' weights
cross from the JAX trainer through convert.py; the data is made from a
numpy seed.

Tolerances (float32), those of tests/test_torch_ppo.py:
- forward values, losses and gradients: rtol 1e-4, atol 1e-6 (gradients:
  atol 1e-6 of the largest);
- a trajectory of Cartpole steps: rtol 1e-4, atol 1e-5;
- a whole `_update` / `_cv_update` / epoch: per parameter tensor, 99.9% of
  the elements within 1e-5, all within 2 * lr_max * n_updates, and the
  difference at most 1e-3 of the reference's change;
- an epoch's metrics: rtol 1e-3, atol 1e-5; the running norms rtol 1e-4,
  atol 1e-6;
- the replay's KL at a learning rate of 1e-15: below 1e-3 (JAX's own
  test's bound; the replay evaluates sequences, the rollout single steps).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.learn import PPOConfig as JPPOConfig
from omniisaacgymenvs_tpu.learn import PPOTrainer as JPPOTrainer
from omniisaacgymenvs_tpu.learn.networks import gaussian_logprob as jlogprob
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from test_torch_ppo import StubEnv, _assert_update_rule, _jax_perms, _params_np
from torch_parity import lstm_named_arrays, np_, to_numpy_tree

FWD = dict(rtol=1e-4, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-5)
UNITS = 16


def _sync(jtr, tr, norm_seed=None):
    """The port trainer's networks (and, with norm_seed, non-trivial running
    norms fed to both) set to the JAX trainer's."""
    convert.lstm_actor_critic_from_arrays(to_numpy_tree(jtr.state.params["ac"]),
                                          tr.state.ac)
    if tr.is_cv_rnn:
        convert.lstm_central_value_from_arrays(to_numpy_tree(jtr.state.cv_params),
                                               tr.state.cv)
    if norm_seed is not None:
        rng = np.random.default_rng(norm_seed)
        js = jtr.state
        n_obs, n_states = tr.env.num_obs, tr.env.num_states
        js = js.replace(
            obs_norm=js.obs_norm.update(jnp.asarray(
                2.0 * rng.standard_normal((256, n_obs)) + 0.5, jnp.float32)),
            value_norm=js.value_norm.update(jnp.asarray(
                3.0 * rng.standard_normal(256) + 1.0, jnp.float32)))
        if n_states:
            js = js.replace(states_norm=js.states_norm.update(jnp.asarray(
                rng.standard_normal((256, n_states)), jnp.float32)))
        jtr.state = js
    for name in ("obs_norm", "value_norm", "states_norm"):
        jn = getattr(jtr.state, name)
        setattr(tr.state, name, RunningNorm(
            *(torch.as_tensor(np.array(getattr(jn, f)))
              for f in ("mean", "var", "count"))))


def _kw(cv, **kw):
    out = dict(units=(24, 16), rnn="lstm", rnn_units=UNITS, seq_len=4,
               horizon_length=8, minibatch_size=32, mini_epochs=2,
               bounds_loss_coef=0.1)
    if cv:
        out.update(central_value=True, cv_units=(24,), cv_rnn="lstm",
                   cv_rnn_units=UNITS, cv_minibatch_size=32, cv_mini_epochs=2,
                   actor_aux_value_loss=True)
    out.update(kw)
    return out


def _stub_pair(kw, n_obs=10, n_states=14, n_act=4, seed=0):
    n_states = n_states if kw.get("central_value") else 0
    jtr = JPPOTrainer(StubEnv(16, n_obs, n_states, n_act), JPPOConfig(**kw), seed)
    tr = PPOTrainer(StubEnv(16, n_obs, n_states, n_act), PPOConfig(**kw), seed)
    _sync(jtr, tr, norm_seed=1)
    return jtr, tr


def _seq_dataset(jtr, B, T, n_obs, n_states, n_act, seed):
    """B sequences of T steps whose behaviour policy is near the current
    one, with random start states and dones inside the sequences."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    obs = 2.0 * f(B, T, n_obs) + 0.5
    done = rng.random((B, T)) < 0.25
    hid = (0.5 * f(B, UNITS), 0.5 * f(B, UNITS))
    js = jtr.state
    x = js.obs_norm.normalize(jnp.asarray(obs))
    mu, log_std, v = jtr.net.apply(js.params["ac"], x, tuple(map(jnp.asarray, hid)),
                                   jnp.asarray(done), method=type(jtr.net).seq)
    mu = np.asarray(mu) + 0.05 * f(B, T, n_act)
    ls = np.broadcast_to(np.asarray(log_std), mu.shape) + 0.05 * f(B, T, n_act)
    action = mu + np.exp(ls) * f(B, T, n_act)
    logp = np.asarray(jlogprob(jnp.asarray(mu), jnp.asarray(ls), jnp.asarray(action)))
    value = np.asarray(js.value_norm.denormalize(v)) + 0.3 * f(B, T)
    ds = dict(obs=obs, action=action.astype(np.float32), logp=logp,
              value=value.astype(np.float32), mu=mu.astype(np.float32),
              log_std=ls.astype(np.float32), adv=2.0 * f(B, T),
              ret=(value + 2.0 * f(B, T)).astype(np.float32), done=done,
              hidden_h=hid[0], hidden_c=hid[1])
    if n_states:
        ds.update(states=f(B, T, n_states), cv_hidden_h=0.5 * f(B, UNITS),
                  cv_hidden_c=0.5 * f(B, UNITS))
    return ds


def _t(ds):
    return {k: torch.as_tensor(np.array(v)) for k, v in ds.items()}


def _j(ds):
    return {k: jnp.asarray(v) for k, v in ds.items()}


def _assert_grads(grads: dict, ref: dict):
    assert sorted(grads) == sorted(ref)
    scale = max(np.abs(g).max() for g in ref.values())
    for name, g in grads.items():
        np.testing.assert_allclose(np_(g), ref[name], rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("normalize_advantage", [True, False])
def test_rnn_loss_and_cv_loss_with_gradients(normalize_advantage):
    kw = _kw(True, normalize_advantage=normalize_advantage, entropy_coef=0.01)
    jtr, tr = _stub_pair(kw)
    ds = _seq_dataset(jtr, 12, 4, 10, 14, 4, seed=2)
    am, asd = float(ds["adv"].mean()), float(ds["adv"].std())
    (jl, jaux), jg = jax.value_and_grad(jtr._loss, has_aux=True)(
        jtr.state.params, _j(ds), jtr.state, am, asd)
    params = dict(tr.state.ac.named_parameters())
    loss, aux = tr._loss(tr.state, _t(ds), torch.tensor(am), torch.tensor(asd))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    for k, v in aux.items():
        np.testing.assert_allclose(v.item(), float(jaux[k]), err_msg=k, **FWD)
    _assert_grads(grads, lstm_named_arrays(to_numpy_tree(jg["ac"]), 2))
    jcl, jcg = jax.value_and_grad(jtr._cv_loss)(jtr.state.cv_params, _j(ds),
                                                jtr.state)
    cparams = dict(tr.state.cv.named_parameters())
    cl = tr._cv_loss(tr.state, _t(ds))
    cg = dict(zip(cparams, torch.autograd.grad(cl, list(cparams.values()))))
    np.testing.assert_allclose(cl.item(), float(jcl), **FWD)
    _assert_grads(cg, lstm_named_arrays(to_numpy_tree(jcg), 1, actor=False))


@pytest.mark.parametrize("schedule_type", ["legacy", "standard"])
def test_rnn_update_on_jax_permutations(schedule_type):
    kw = _kw(False, schedule_type=schedule_type, mini_epochs=3, minibatch_size=32,
             learning_rate=1e-3)
    jtr, tr = _stub_pair(kw)
    S, mb = 24, 8   # sequences; minibatch_size 32 steps / seq_len 4
    ds = _seq_dataset(jtr, S, 4, 10, 0, 4, seed=3)
    perms = _jax_perms(jtr.state.rng, 3, S)
    init = _params_np(tr.state.ac)
    am, asd = float(ds["adv"].mean()), float(ds["adv"].std())
    jts, jaux = jtr._update(jtr.state, _j(ds), am, asd, S, mb)
    aux = tr._update(tr.state, _t(ds), torch.tensor(am), torch.tensor(asd), S, mb,
                     perms=torch.as_tensor(perms))
    n_updates = 3 * (S // mb)
    assert float(tr.state.opt_state.count) == n_updates
    np.testing.assert_allclose(float(tr.state.lr), float(jts.lr), rtol=1e-6)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(jaux[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    lr_max = min(max(1e-3, float(jts.lr)) * 1.5 ** n_updates, PPOConfig().lr_max)
    _assert_update_rule(dict(tr.state.ac.named_parameters()),
                        lstm_named_arrays(to_numpy_tree(jts.params["ac"]), 2),
                        init, lr_max, n_updates)


def test_rnn_cv_update_on_jax_permutations():
    """The LSTM central value's own SGD: cv_minibatch_size counts steps, so
    a minibatch takes cv_minibatch_size / seq_len sequences."""
    kw = _kw(True, cv_minibatch_size=16, cv_mini_epochs=2, cv_learning_rate=5e-4)
    jtr, tr = _stub_pair(kw)
    S = 20
    ds = _seq_dataset(jtr, S, 4, 10, 14, 4, seed=4)
    cv_ds = {k: ds[k] for k in ("states", "value", "ret", "done", "cv_hidden_h",
                                "cv_hidden_c")}
    perms = _jax_perms(jtr.state.rng, 2, S)
    init = _params_np(tr.state.cv)
    jts, jloss = jtr._cv_update(jtr.state, _j(cv_ds), S)
    loss = tr._cv_update(tr.state, _t(cv_ds), S, perms=torch.as_tensor(perms))
    np.testing.assert_allclose(float(loss), float(jloss), **FWD)
    n_updates = 2 * (S // 4)
    assert float(tr.state.cv_opt_state.count) == float(jts.cv_opt_state[1].count) \
        == n_updates
    _assert_update_rule(dict(tr.state.cv.named_parameters()),
                        lstm_named_arrays(to_numpy_tree(jts.cv_params), 1, actor=False),
                        init, 5e-4, n_updates)


# ---- with a task: Cartpole (its observations also as the states of an
# asymmetric critic)

N = 16


def _with_states(task):
    task.num_states = 4
    observe = task.observe

    def with_states(phys, carry, action):
        obs, _, carry = observe(phys, carry, action)
        return obs, obs, carry

    task.observe = with_states
    return task


def _task_pair(kw, seed=0):
    jtask, task = jget_task("Cartpole"), get_task("Cartpole", device="cpu")
    if kw.get("central_value"):
        jtask, task = _with_states(jtask), _with_states(task)
    jtr = JPPOTrainer(JVecEnv(jtask, N), JPPOConfig(**kw), seed)
    tr = PPOTrainer(VecEnv(task, N, seed=seed), PPOConfig(**kw), seed)
    f = {k: to_numpy_tree(getattr(jtr.state.es, k))
         for k in ("phys", "carry", "obs", "states", "reward", "done",
                   "timeout", "progress", "metrics")}
    tr.state.es = convert.env_state_from_arrays(f, device="cpu")
    _sync(jtr, tr, norm_seed=3)
    # non-zero LSTM states at the start of the rollout, in both
    rng = np.random.default_rng(5)
    hid = [(0.3 * rng.standard_normal((N, UNITS))).astype(np.float32)
           for _ in range(4 if tr.is_cv_rnn else 2)]
    jtr.state = jtr.state.replace(
        hidden=tuple(map(jnp.asarray, hid[:2])),
        cv_hidden=tuple(map(jnp.asarray, hid[2:])))
    tr.state.hidden = tuple(map(torch.as_tensor, hid[:2]))
    tr.state.cv_hidden = tuple(map(torch.as_tensor, hid[2:]))
    return jtr, tr


def _jax_noise(jtr, T, A):
    """JAX's action noise (T, N, A) and the key after the rollout."""
    rng, k = jax.random.split(jtr.state.rng)
    noise = []
    for _ in range(T):
        k, kt = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(kt, (N, A))))
    return np.stack(noise), rng


def _to_seq(x, seq):
    """JAX `_epoch`'s layout of a (T, N, ...) field: (nch, seq, N) ->
    (N, nch, seq) -> (N * nch, seq)."""
    T, n = x.shape[:2]
    x = np.moveaxis(x.reshape((T // seq, seq, n) + x.shape[2:]), 2, 0)
    return x.reshape((n * (T // seq), seq) + x.shape[3:])


@pytest.mark.parametrize("cv", [False, True], ids=["lstm", "lstm_cv_lstm"])
def test_rnn_rollout_and_dataset_layout(cv):
    """Envs 0-3 reach their time limit at the second step, inside the first
    chunk: their LSTM states restart from zeros there. An env's next episode
    starts from other draws in the two packages, so each env is compared up
    to its first episode end: its steps, the chunk-start states before it,
    and the dataset's sequences that lie before it."""
    kw = _kw(cv)
    jtr, tr = _task_pair(kw)
    T, seq = kw["horizon_length"], kw["seq_len"]
    nch = T // seq
    prog = np.zeros(N, np.int32)
    prog[:4] = tr.env.task.timeout_progress - 2
    jtr.state = jtr.state.replace(es=jtr.state.es.replace(progress=jnp.asarray(prog)))
    tr.state.es.progress = torch.as_tensor(prog)
    noise, _ = _jax_noise(jtr, T, tr.env.num_actions)
    jts, jtraj, jlast, _ = jax.jit(jtr._rollout)(jtr.state)
    traj, last, _ = tr._rollout(tr.state, torch.as_tensor(noise))
    jd = np.asarray(jtraj["done"])
    first = np.where(jd.any(0), jd.argmax(0), T)   # each env's first end
    assert (first[:4] == 1).all() and (first[4:] > 1).all()
    whole = first == T   # envs that run the whole horizon
    assert whole.sum() >= N // 2
    valid = np.arange(T)[:, None] <= first[None, :]   # (T, N)
    np.testing.assert_array_equal(np_(traj["done"])[valid], jd[valid])
    for k in ("obs", "action", "logp", "value", "mu", "reward"):
        np.testing.assert_allclose(np_(traj[k])[valid], np.asarray(jtraj[k])[valid],
                                   err_msg=k, **TRAJ)
    hid_keys = ("hidden_h", "hidden_c") + (("cv_hidden_h", "cv_hidden_c") if cv else ())
    assert sorted(k for k in traj if "hidden" in k) == sorted(hid_keys)
    starts = np.arange(nch)[:, None] * seq <= first[None, :]   # (nch, N)
    for k in hid_keys:
        assert traj[k].shape == (nch, N, UNITS)
        np.testing.assert_allclose(np_(traj[k])[starts], np.asarray(jtraj[k])[starts],
                                   err_msg=k, **TRAJ)
    np.testing.assert_allclose(np_(last)[whole], np.asarray(jlast)[whole], **TRAJ)
    for k in ("hidden", "cv_hidden"):
        for a, b in zip(getattr(tr.state, k), getattr(jts, k)):
            np.testing.assert_allclose(np_(a)[whole], np.asarray(b)[whole], **TRAJ)
    # the dataset: sequences env-major, the per-step done, the start states;
    # row n * nch + k is env n's chunk k
    advs, rets = tr._gae(traj, last)
    ds, cv_ds, num_slices, mb_slices = tr._datasets(dict(traj, adv=advs, ret=rets))
    assert (num_slices, mb_slices) == (N * nch, kw["minibatch_size"] // seq)
    rows = (np.arange(nch)[None, :] + 1) * seq - 1 <= first[:, None]   # (N, nch)
    rows = rows.reshape(-1)
    assert rows.sum() > N
    for k in ("obs", "action", "logp", "value", "mu", "log_std", "done"):
        np.testing.assert_allclose(np_(ds[k])[rows],
                                   _to_seq(np.asarray(jtraj[k]), seq)[rows],
                                   err_msg=k, **TRAJ)
    for k in hid_keys:
        ref = np.moveaxis(np.asarray(jtraj[k]), 1, 0).reshape(N * nch, UNITS)
        got = np_((cv_ds if k.startswith("cv") else ds)[k])
        np.testing.assert_allclose(got[rows], ref[rows], err_msg=k, **TRAJ)
    assert ds["done"].dtype == torch.bool and ds["done"].shape == (N * nch, seq)
    if cv:
        assert cv_ds["done"] is ds["done"]
        np.testing.assert_allclose(np_(cv_ds["states"])[rows],
                                   _to_seq(np.asarray(jtraj["states"]), seq)[rows],
                                   **TRAJ)


@pytest.mark.parametrize("cv", [False, True], ids=["lstm", "lstm_cv_lstm"])
def test_rnn_epoch_matches_jax_epoch(cv):
    """The slice as a whole: one Cartpole _epoch of both learners with JAX's
    noise and permutations, two chunks of two steps on a horizon where no
    env ends its episode. Trajectory, metrics, norms, LSTM states and
    parameters."""
    kw = _kw(cv, horizon_length=4, seq_len=2, minibatch_size=16, mini_epochs=3,
             value_bootstrap=True, reward_shaper_scale=0.1, learning_rate=3e-4,
             cv_minibatch_size=8, cv_mini_epochs=2, cv_learning_rate=5e-4)
    jtr, tr = _task_pair(kw)
    T, A = kw["horizon_length"], tr.env.num_actions
    S = N * T // kw["seq_len"]
    noise, rng = _jax_noise(jtr, T, A)
    cv_perms = None
    if cv:
        cv_perms = _jax_perms(rng, kw["cv_mini_epochs"], S)
        rng = jax.random.split(rng, kw["cv_mini_epochs"] + 1)[0]
    perms = _jax_perms(rng, kw["mini_epochs"], S)
    init = _params_np(tr.state.ac)
    cv_init = _params_np(tr.state.cv) if cv else None
    _, jtraj, _, _ = jax.jit(jtr._rollout)(jtr.state)
    traj, _, _ = tr._rollout(copy.deepcopy(tr.state), torch.as_tensor(noise))
    assert not np.asarray(jtraj["done"]).any(), "an env ended its episode"
    for k in ("obs", "action", "logp", "value", "mu", "reward", "hidden_h"):
        np.testing.assert_allclose(np_(traj[k]), np.asarray(jtraj[k]), err_msg=k,
                                   **TRAJ)
    jts, jm = jtr._epoch_jit(jtr.state)
    m = tr._epoch(tr.state, noise=torch.as_tensor(noise), perms=torch.as_tensor(perms),
                  cv_perms=None if cv_perms is None else torch.as_tensor(cv_perms))
    assert sorted(m) == sorted(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert tr.state.epoch == int(jts.epoch) == 1
    for name in ("obs_norm", "value_norm", "states_norm"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                np_(getattr(getattr(tr.state, name), f)),
                np.asarray(getattr(getattr(jts, name), f)), rtol=1e-4, atol=1e-6,
                err_msg=f"{name}.{f}")
    for k in ("hidden", "cv_hidden"):
        for a, b in zip(getattr(tr.state, k), getattr(jts, k)):
            np.testing.assert_allclose(np_(a), np.asarray(b), err_msg=k, **TRAJ)
    n_updates = kw["mini_epochs"] * (S // (kw["minibatch_size"] // kw["seq_len"]))
    lr_max = min(kw["learning_rate"] * 1.5 ** n_updates, PPOConfig().lr_max)
    _assert_update_rule(dict(tr.state.ac.named_parameters()),
                        lstm_named_arrays(to_numpy_tree(jts.params["ac"]), 2),
                        init, lr_max, n_updates)
    if cv:
        n_cv = kw["cv_mini_epochs"] * (S // (kw["cv_minibatch_size"] // kw["seq_len"]))
        assert float(tr.state.cv_opt_state.count) == n_cv
        _assert_update_rule(dict(tr.state.cv.named_parameters()),
                            lstm_named_arrays(to_numpy_tree(jts.cv_params), 1,
                                              actor=False),
                            cv_init, kw["cv_learning_rate"], n_cv)


def test_rnn_ratio_starts_at_one_with_mid_chunk_dones():
    """At a learning rate of 1e-15 the policy does not move, so the epoch's
    KL measures how far the replay's mu is from the rollout's. Episodes of
    five steps end inside most chunks of four: the replay must zero the
    LSTM states where the rollout did. It reads below JAX's bound of 1e-3
    (0.0 on the CPU); with the dataset's done cleared, so that the replay
    carries the states across the episode ends, the same epochs read above
    1e-5 (about 1e-4 with these 16-unit networks), at least 1000 times
    more."""
    kw = dict(horizon_length=16, minibatch_size=64, mini_epochs=2, units=(16,),
              rnn="lstm", rnn_units=UNITS, seq_len=4, normalize_input=True,
              learning_rate=1e-15, lr_schedule="fixed", central_value=True,
              cv_units=(16,), cv_rnn="lstm", cv_rnn_units=UNITS,
              cv_minibatch_size=64, cv_mini_epochs=2)

    def trainer():
        task = _with_states(get_task("Cartpole", device="cpu"))
        task.max_episode_length = 5
        return PPOTrainer(VecEnv(task, N, seed=0), PPOConfig(**kw), seed=0)

    tr = trainer()
    kls = []
    for _ in range(3):
        m = tr._epoch(tr.state)
        assert float(m["episodes"]) > 0
        kls.append(float(m["kl"]))
    assert max(kls) < 1e-3, kls
    blind = trainer()
    datasets = blind._datasets

    def without_resets(traj):
        ds, cv_ds, *sizes = datasets(traj)
        ds["done"] = torch.zeros_like(ds["done"])
        return (ds, cv_ds, *sizes)

    blind._datasets = without_resets
    blind_kls = [float(blind._epoch(blind.state)["kl"]) for _ in range(3)]
    assert min(blind_kls) > 1e-5, blind_kls
    assert max(kls) <= 1e-3 * min(blind_kls), (kls, blind_kls)
