"""Checkpoints of the port's learner on the CPU (Cartpole, 16 envs): a save
and load that restore every leaf bit for bit; a run that is saved, loaded
into a fresh trainer and continued, equal bit for bit to an uninterrupted
run, for the FF and the LSTM learner; the sidecar's fallbacks (missing, of
another num_envs, stale), each leaving fresh envs; a main file that does
not fit the trainer; the `last` / `best` cadence of `train(save_dir=)` and
the best watermark across a resume. Exact equality throughout: the same
operations on the same data in one process give the same bits."""

import json
import os
import shutil

import pytest
import torch

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.ppo import (
    ENV_FILE,
    MAIN_FILE,
    CheckpointMismatch,
    _flatten,
)
from omniisaacgymenvs_torch.tasks import get_task

BASE = dict(horizon_length=8, minibatch_size=64, mini_epochs=2, units=(16,),
            reward_shaper_scale=0.1)
CONFIGS = {
    "ff": {},
    "ff_cv": dict(central_value=True, cv_units=(16,), cv_minibatch_size=32,
                  cv_mini_epochs=2),
    "lstm": dict(rnn="lstm", rnn_units=16, seq_len=4),
    "lstm_cv_lstm": dict(rnn="lstm", rnn_units=16, seq_len=4, central_value=True,
                         cv_units=(16,), cv_rnn="lstm", cv_rnn_units=16,
                         cv_minibatch_size=32, cv_mini_epochs=2),
}


def _trainer(name="ff", n=16, seed=3, **kw):
    task = get_task("Cartpole", device="cpu")
    if CONFIGS[name].get("central_value"):
        # the observations also as the states of an asymmetric critic
        task.num_states = 4
        observe = task.observe

        def with_states(phys, carry, action):
            obs, _, carry = observe(phys, carry, action)
            return obs, obs, carry

        task.observe = with_states
    cfg = PPOConfig(**{**BASE, **CONFIGS[name], **kw})
    return PPOTrainer(VecEnv(task, n, seed=seed), cfg, seed=seed)


def _leaves(tr) -> dict:
    """Every leaf a checkpoint holds, and both generators' states."""
    out = _flatten({"main": tr._main_tree(), "env": tr._env_state_tree()})
    out.update({f"rng.{k}": g.get_state() for k, g in tr._generators().items()})
    return out


def _assert_equal_leaves(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _messages():
    msgs = []
    return msgs, msgs.append


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_save_load_round_trip_is_bitwise(name, tmp_path):
    tr = _trainer(name)
    tr.train(max_epochs=1, log_fn=None)
    path = str(tmp_path / "ckpt")
    tr.save(path)
    assert sorted(os.listdir(path)) == sorted([MAIN_FILE, ENV_FILE])  # no .part
    fresh = _trainer(name, seed=11)
    msgs, log = _messages()
    fresh.load(path, log_fn=log)
    assert fresh.state.epoch == 1 and "restored" in msgs[-1]
    _assert_equal_leaves(_leaves(fresh), _leaves(tr))
    if tr.is_rnn:
        assert any(float(h.abs().sum()) > 0 for h in tr.state.hidden)


@pytest.mark.parametrize("name", ["ff", "lstm_cv_lstm"])
def test_resumed_run_equals_uninterrupted_run(name, tmp_path):
    """2 epochs, save; a fresh trainer loads and trains 1 more: the same
    bits as 3 epochs in one run (metrics, parameters, optimizer, env)."""
    whole = _trainer(name)
    hist = whole.train(max_epochs=3, log_every=1, log_fn=None)
    first = _trainer(name)
    first.train(max_epochs=2, log_fn=None, save_dir=str(tmp_path), save_frequency=2)
    resumed = _trainer(name, seed=11)
    resumed.load(str(tmp_path / "last"), log_fn=lambda s: None)
    hist2 = resumed.train(max_epochs=3, log_every=1, log_fn=None)
    assert [m["epoch"] for m in hist2] == [2]
    for k, v in hist[-1].items():
        if k != "steps_per_sec":
            assert v == hist2[-1][k], (k, v, hist2[-1][k])
    _assert_equal_leaves(_leaves(resumed), _leaves(whole))


def test_missing_sidecar_leaves_fresh_envs(tmp_path):
    tr = _trainer("lstm")
    tr.train(max_epochs=1, log_fn=None)
    tr.save(str(tmp_path))
    os.remove(tmp_path / ENV_FILE)
    fresh, ref = _trainer("lstm", seed=11), _trainer("lstm", seed=11)
    msgs, log = _messages()
    fresh.load(str(tmp_path), log_fn=log)
    assert msgs == ["no env-state sidecar: envs restart fresh"]
    _assert_equal_leaves(_flatten(fresh._env_state_tree()),
                         {**_flatten(ref._env_state_tree()), "epoch": 1})
    for a, b in zip(fresh.state.ac.parameters(), tr.state.ac.parameters()):
        assert torch.equal(a, b)


def test_sidecar_of_other_num_envs_names_its_first_leaf(tmp_path):
    tr = _trainer("lstm", n=16)
    tr.train(max_epochs=1, log_fn=None)
    tr.save(str(tmp_path))
    small, ref = _trainer("lstm", n=8, seed=11), _trainer("lstm", n=8, seed=11)
    msgs, log = _messages()
    small.load(str(tmp_path), log_fn=log)
    assert msgs == ["env-state sidecar ignored (es.phys.q: saved torch.float32 "
                    "(16, 2), expected torch.float32 (8, 2)); envs restart fresh"]
    assert small.state.epoch == 1
    _assert_equal_leaves(_flatten(small._env_state_tree()),
                         {**_flatten(ref._env_state_tree()), "epoch": 1})


def test_stale_sidecar_is_ignored(tmp_path):
    """A save cut between the sidecar and the main file leaves a sidecar of
    a later epoch beside the earlier main file: it is not grafted on."""
    tr = _trainer("ff")
    tr.train(max_epochs=1, log_fn=None)
    tr.save(str(tmp_path / "a"))
    tr.train(max_epochs=2, log_fn=None)
    tr.save(str(tmp_path / "b"))
    shutil.copy(tmp_path / "b" / ENV_FILE, tmp_path / "a" / ENV_FILE)
    fresh, ref = _trainer("ff", seed=11), _trainer("ff", seed=11)
    msgs, log = _messages()
    fresh.load(str(tmp_path / "a"), log_fn=log)
    assert msgs == ["env-state sidecar ignored: it is of epoch 2, the checkpoint "
                    "of epoch 1; envs restart fresh"]
    assert fresh.state.epoch == 1
    _assert_equal_leaves(_flatten(fresh._env_state_tree()),
                         {**_flatten(ref._env_state_tree()), "epoch": 1})


def test_main_file_of_another_network_raises_naming_its_leaf(tmp_path):
    tr = _trainer("ff")
    tr.save(str(tmp_path))
    with pytest.raises(CheckpointMismatch, match=r"^ac\.trunk\.layers\.0\.weight: "
                       r"saved torch.float32 \(16, 4\), expected torch.float32 "
                       r"\(32, 4\)$"):
        _trainer("ff", units=(32,)).load(str(tmp_path), log_fn=None)
    with pytest.raises(CheckpointMismatch, match=r"^ac\.lstm\.wx\.weight: missing"):
        _trainer("lstm").load(str(tmp_path), log_fn=None)


def test_train_saves_last_and_best_on_their_cadence(tmp_path):
    tr = _trainer("ff")
    tr.train(max_epochs=5, log_every=1, log_fn=None, save_dir=str(tmp_path),
             save_frequency=2, save_best_after=1)
    last = torch.load(tmp_path / "last" / MAIN_FILE, weights_only=True)
    assert last["epoch"] == 4   # saved after epochs 1 and 3 (0-based)
    meta = json.loads((tmp_path / "best_meta.json").read_text())
    best = torch.load(tmp_path / "best" / MAIN_FILE, weights_only=True)
    assert meta["epoch"] >= 1 and best["epoch"] == meta["epoch"] + 1


def test_resume_keeps_the_best_watermark(tmp_path):
    """nn/best is guarded by best_meta.json: a resumed run does not
    overwrite it with a policy worse than the best one seen before the
    interruption, whose epoch need not be in history.json."""
    save_dir, hist_path = str(tmp_path / "nn"), str(tmp_path / "history.json")
    tr = _trainer("ff")
    tr.train(max_epochs=6, log_every=5, log_fn=None, save_dir=save_dir,
             save_frequency=2, save_best_after=0, history_path=hist_path)
    meta_path = os.path.join(save_dir, "best_meta.json")
    meta = json.loads(open(meta_path).read())
    with open(meta_path, "w") as f:   # the killed run had seen a better policy
        json.dump({"best_reward": 1e9, "epoch": meta["epoch"]}, f)
    best = open(os.path.join(save_dir, "best", MAIN_FILE), "rb").read()
    tr2 = _trainer("ff")
    tr2.load(os.path.join(save_dir, "last"), log_fn=lambda s: None)
    hist = tr2.train(max_epochs=10, log_every=5, log_fn=None, save_dir=save_dir,
                     save_frequency=2, save_best_after=0, history_path=hist_path)
    assert [m["epoch"] for m in hist] == [0, 5, 9]
    assert open(os.path.join(save_dir, "best", MAIN_FILE), "rb").read() == best
