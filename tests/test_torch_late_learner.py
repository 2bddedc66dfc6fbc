"""Late-training learner parity (fault C3, ROADMAP §C3): one whole PPO epoch
of each package from a trained policy's state, at the hands' widths, on
the CPU.

- ShadowHand: the JAX package's trained state (`results/ShadowHand/nn-best`,
  epoch 9980: networks [512, 512, 256, 128], Adam state, norms, lr) read by
  the JAX trainer's `load`, and the port's converted file
  (`results_torch/ShadowHand_jax_final`, tests/torch_jax_checkpoint.py) read
  by the port's, through the CLI's `checkpoint=`.
- AllegroHand: networks at init ([512, 256, 128], kl_threshold 0.02), the
  norms updated from one rollout, and `log_std` set in both packages to
  -2.33, where the JAX run ended (entropy -14.5 over 16 actions).

64 envs under the train yaml, minibatch_size 256 (the yaml's four
minibatches a mini-epoch at 8192 envs), JAX's action noise and
permutations handed to the port (`_jax_draws`, `_jax_perms`).

The rollout: the port's `_rollout` against the JAX one, step by step on
the envs that have neither reset nor re-drawn a goal (each package draws
its own). tests/test_torch_tasks.py holds three ShadowHand steps within
2e-3 (float32 contact physics in another operation order); over 16 steps
of 8 substeps a contact event amplifies that rounding, so the rule is
wider: 99.99% of the elements of obs, mu, value, reward, action and logp
within rtol 1e-2, atol 1e-2, and every one within 5e-2 (measured: 2 of
160,297 obs elements past 1e-2, at most 0.0245, both in ShadowHand's
last two steps; every step before within 3e-3). The learner: the port's
`_learn` on JAX's trajectory (the same inputs, so that the physics'
rounding does not reach it) against the JAX trainer's `_epoch_jit`:
- every minibatch's KL: rtol 1e-3, atol 1e-6; the learning rate before
  and after each minibatch (x1.5, /1.5 or kept): within rtol 1e-6, the
  same steps;
- the epoch's metrics: `test_epoch_matches_jax_epoch`'s rtol 1e-3,
  atol 1e-5;
- parameters: `_assert_update_rule`; Adam's count equal, its moments
  within rtol 1e-3 of the largest element of each tensor (the first
  moment is a sum of gradients that agree to 1e-4; the second squares
  them);
- the norms: rtol 1e-4, atol 1e-6.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.learn import ppo
from omniisaacgymenvs_torch.learn.ppo import CheckpointMismatch
from omniisaacgymenvs_torch.scripts import train as ttrain
from test_torch_ppo import _assert_update_rule, _jax_draws, _jax_perms, _params_np
import torch_checkpoint_set as checkpoint_set
from torch_jax_checkpoint import ROOT, carry_state, jax_trainer
from torch_parity import np_, to_numpy_tree

N = 64
MB = ["train.params.config.minibatch_size=256"]
# the JAX learner on the CPU computes its networks in exact f32; the port's
# default for f32 feed-forward networks is the TPU's rule
F32 = "train.params.config.net_matmul=f32"
CKPT = "results_torch/ShadowHand_jax_final"
ROLL = dict(rtol=1e-2, atol=1e-2)
ROLL_SHARE, ROLL_MAX = 0.9999, 5e-2
KL = dict(rtol=1e-3, atol=1e-6)
METRICS = dict(rtol=1e-3, atol=1e-5)
NORM = dict(rtol=1e-4, atol=1e-6)
LOG_STD = -2.33


def _record_lr_steps(jtr, tr):
    """Both trainers' `_adapt_lr` wrapped to record (kl, lr before, lr
    after) of every minibatch: JAX's through a debug callback from inside
    its scan (the test checks the order: each lr before is the lr after
    of the minibatch before)."""
    jrec, rec = [], []
    jorig, orig = jtr._adapt_lr, tr._adapt_lr

    def jadapt(lr, kl):
        new = jorig(lr, kl)
        jax.debug.callback(lambda *a: jrec.append(tuple(float(x) for x in a)),
                           kl, lr, new)
        return new

    def adapt(lr, kl):
        new = orig(lr, kl)
        rec.append((float(kl), float(lr), float(new)))
        return new

    jtr._adapt_lr, tr._adapt_lr = jadapt, adapt
    return jrec, rec


def _sync_env(jts, tr):
    """The port trainer's env state and episode counters set to the JAX
    trainer state `jts`'s."""
    ts = tr.state
    f = {k: to_numpy_tree(getattr(jts.es, k))
         for k in ("phys", "carry", "obs", "states", "reward", "done",
                   "timeout", "progress", "metrics")}
    ts.es = convert.env_state_from_arrays(f, device="cpu")
    for k in ("ep_ret", "ep_len", "score_mean", "len_mean", "games"):
        setattr(ts, k, torch.as_tensor(np.array(getattr(jts, k)), dtype=torch.float32))
    ts.task_stats = {k: torch.as_tensor(np.array(v))
                     for k, v in to_numpy_tree(jts.task_stats).items()}


def _shadow_hand_pair():
    jtr = jax_trainer("ShadowHand", N, "results/ShadowHand/nn-best", MB)
    _, _, tr = ttrain.build_trainer(["task=ShadowHand", f"num_envs={N}",
                                     "device=cpu", f"checkpoint={CKPT}", *MB, F32])
    _sync_env(jtr.state, tr)
    return jtr, tr


def _allegro_hand_pair():
    jtr = jax_trainer("AllegroHand", N, None, MB)
    _, _, tr = ttrain.build_trainer(["task=AllegroHand", f"num_envs={N}",
                                     "device=cpu", *MB, F32])
    # the norms of one rollout of the initial policy
    js, traj, last, _ = jax.jit(jtr._rollout)(jtr.state)
    _, returns = jtr._gae(traj, last)
    params = jax.tree.map(lambda x: x, js.params)
    params["ac"]["params"]["log_std"] = jnp.full_like(
        params["ac"]["params"]["log_std"], LOG_STD)
    jtr.state = js.replace(params=params,
                           obs_norm=js.obs_norm.update(traj["obs"]),
                           value_norm=js.value_norm.update(returns))
    carry_state(jtr, tr)
    _sync_env(jtr.state, tr)
    return jtr, tr


def _moments(jadam, module):
    return [convert.actor_critic_arrays(to_numpy_tree(t["ac"]), module)
            for t in (jadam.mu, jadam.nu)]


@pytest.mark.parametrize("task", ["ShadowHand", "AllegroHand"])
def test_late_epoch_matches_jax(task):
    jtr, tr = _shadow_hand_pair() if task == "ShadowHand" else _allegro_hand_pair()
    cfg = tr.cfg
    T, A = cfg.horizon_length, tr.env.num_actions
    assert (T, cfg.minibatch_size) == (16, 256) and jtr.cfg.minibatch_size == 256
    if task == "ShadowHand":
        assert tr.state.epoch == int(jtr.state.epoch) == 9980
        assert float(tr.state.opt_state.count) == 199600.0
    np.testing.assert_allclose(np_(tr.state.ac.log_std),
                               np.asarray(jtr.state.params["ac"]["params"]["log_std"]))
    if task == "AllegroHand":
        assert (np_(tr.state.ac.log_std) == np.float32(LOG_STD)).all()
    assert cfg.kl_threshold == jtr.cfg.kl_threshold == (
        0.016 if task == "ShadowHand" else 0.02)
    noise, rng_after = _jax_draws(jtr, T, A, cfg.mini_epochs, n=N)
    perms = _jax_perms(rng_after, cfg.mini_epochs, T * N)
    init = _params_np(tr.state.ac)
    jadam0 = _moments(jtr.state.opt_state[1], tr.state.ac)

    # the rollout, until each env resets or re-draws its goal
    _, jtraj, jlast, jstats = jax.jit(jtr._rollout)(jtr.state)
    ts = copy.deepcopy(tr.state)
    traj, _, _ = tr._rollout(ts, torch.as_tensor(noise))
    jd = np.asarray(jtraj["done"])
    # AllegroHand's step is ill conditioned in 1-2% of its states (ROADMAP
    # §C, properties): an env whose episode ends in one package and not in
    # the other is left out, at most 5% of them, the cap of the end-to-end
    # rollout's check (ops/parity.py, well_conditioned); measured 2 of 64
    split = (np_(traj["done"]) != jd).any(axis=0)
    assert split.mean() <= (0.05 if task == "AllegroHand" else 0.0), split.sum()
    # a step that ends an episode or hits the goal (its shaped reward holds
    # the reach bonus, 0.01 x 250) re-draws that env from each package's
    # own draws: the env is compared up to that step and not after
    event = jd | (np.asarray(jtraj["reward"]) > 1.0)
    keep = np.ones_like(event)
    keep[1:] = ~np.logical_or.accumulate(event, axis=0)[:-1]
    keep[:, split] = False
    assert keep[-1].sum() >= N // 2, keep.sum(axis=1)
    for k in ("obs", "mu", "value", "reward", "action", "logp"):
        a, b = np_(traj[k])[keep], np.asarray(jtraj[k])[keep]
        near = np.isclose(a, b, **ROLL)
        assert near.mean() >= ROLL_SHARE, (k, near.mean())
        assert np.abs(a - b).max() <= ROLL_MAX, (k, np.abs(a - b).max())

    # the learner, on JAX's trajectory
    jrec, rec = _record_lr_steps(jtr, tr)
    jts, jm = jtr._epoch_jit(jtr.state)
    jax.effects_barrier()
    ttraj = {k: torch.as_tensor(np.array(v)) for k, v in to_numpy_tree(jtraj).items()}
    tstats = {k: torch.as_tensor(np.array(v)) for k, v in to_numpy_tree(jstats).items()}
    _sync_env(jts, tr)
    m = tr._learn(tr.state, ttraj, torch.as_tensor(np.array(jlast)), tstats,
                  perms=torch.as_tensor(np.array(perms)))
    n_updates = cfg.mini_epochs * (T * N // cfg.minibatch_size)
    assert len(rec) == len(jrec) == n_updates == 20
    for r in (rec, jrec):
        assert all(a[2] == b[1] for a, b in zip(r[:-1], r[1:])), r
    for i, ((kl, lr0, lr1), (jkl, jlr0, jlr1)) in enumerate(zip(rec, jrec)):
        np.testing.assert_allclose(kl, jkl, err_msg=f"minibatch {i} kl", **KL)
        np.testing.assert_allclose([lr0, lr1], [jlr0, jlr1], rtol=1e-6,
                                   err_msg=f"minibatch {i} lr")
    assert sorted(m) == sorted(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, **METRICS)
    for name in ("obs_norm", "value_norm"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                np_(getattr(getattr(tr.state, name), f)),
                np.asarray(getattr(getattr(jts, name), f)), err_msg=f"{name}.{f}",
                **NORM)
    st, jadam = tr.state.opt_state, jts.opt_state[1]
    assert float(st.count) == float(jadam.count)
    names = [k for k, _ in tr.state.ac.named_parameters()]
    for which, port, ref, ref0 in zip(("mu", "nu"), (st.mu, st.nu),
                                      _moments(jadam, tr.state.ac), jadam0):
        for k, p in zip(names, port):
            scale = np.abs(ref[k]).max()
            np.testing.assert_allclose(np_(p), ref[k], rtol=0, atol=1e-3 * scale,
                                       err_msg=f"{which}.{k}")
            assert not np.array_equal(ref[k], ref0[k]), f"{which}.{k} did not move"
    lr_max = max(lr1 for _, _, lr1 in jrec + [(0, 0, float(jtr.state.lr))])
    ref = convert.actor_critic_arrays(to_numpy_tree(jts.params["ac"]), tr.state.ac)
    _assert_update_rule(dict(tr.state.ac.named_parameters()), ref, init, lr_max,
                        n_updates)


def test_converted_checkpoint_refused_at_another_width():
    """The carried file does not load into a trainer of other widths."""
    with pytest.raises(CheckpointMismatch, match="trunk.layers"):
        ttrain.build_trainer(["task=ShadowHand", "num_envs=8", "device=cpu",
                              f"checkpoint={CKPT}",
                              "train.params.network.mlp.units=[256,128]"])


def _main_file(path):
    return torch.load(os.path.join(path, ppo.MAIN_FILE), map_location="cpu",
                      weights_only=True)


def test_committed_file_is_the_converters_output():
    """The carried file holds what the converter writes from the JAX
    checkpoint today, leaf for leaf and bit for bit: the networks, both
    Adam moments under the parameters' names with the step count, the
    norms, lr and epoch."""
    jtr = jax_trainer("ShadowHand", 8, "results/ShadowHand/nn-best")
    _, _, tr = ttrain.build_trainer(["task=ShadowHand", "num_envs=8", "device=cpu"])
    carry_state(jtr, tr)
    want = ppo._flatten(tr._main_tree())
    got = _main_file(os.path.join(ROOT, CKPT))
    assert sorted(got) == sorted(want)
    assert {k.split(".")[0] for k in got} == {
        "ac", "opt", "obs_norm", "value_norm", "states_norm", "lr", "epoch"}
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert got["epoch"] == 9980 and float(got["opt.count"]) == 199600.0


def test_checkpoint_set_freezes_the_learning_rate(tmp_path):
    """`tests/torch_checkpoint_set.py SRC DST lr=0`: the F arm's start.
    Every other leaf is the carried file's; a key that is no scalar leaf is
    refused before anything is written."""
    src, dst = os.path.join(ROOT, CKPT), str(tmp_path / "frozen")
    assert checkpoint_set.main([src, dst, "lr=0"]) == 0
    a, b = _main_file(src), _main_file(dst)
    assert float(a["lr"]) > 0.0 and float(b["lr"]) == 0.0
    assert b["lr"].dtype == a["lr"].dtype and b["lr"].ndim == 0
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else a[k] == b[k] for k in a if k != "lr")
    assert not os.path.exists(os.path.join(dst, ppo.ENV_FILE))
    for bad in ("obs_norm.mean=0", "nothing=1"):
        with pytest.raises(KeyError):
            checkpoint_set.main([src, str(tmp_path / "bad"), bad])
        assert not os.path.exists(tmp_path / "bad")
