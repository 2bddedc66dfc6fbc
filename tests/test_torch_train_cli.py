"""The learner's entry points on the CPU: scripts/train.py (Cartpole, 64
envs, a few epochs: finite history.json and config.json under
runs/<experiment>/, checkpoints under nn/, `checkpoint=` resuming at the
saved epoch, `test=True` evaluating), `evaluate` against a step loop of the
port (with the LSTM states reset where episodes end), scripts/play.py's
recording, bench_torch.py at a few envs (bench.py's JSON keys and the train
keys), VecEnv.step_rl and the metrics writers."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.ppo import MAIN_FILE
from omniisaacgymenvs_torch.scripts import play, train
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils import metrics

ROOT = Path(__file__).resolve().parents[1]
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "train_envs",
              "epochs_per_jit", "train_steps_per_s", "train_steps_per_s_bf16",
              "learner_mfu", "learner_mfu_bf16")


def test_train_cartpole_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    hist = train.main(["task=Cartpole", "num_envs=64", "max_iterations=3",
                       "device=cpu", "experiment=smoke", "seed=1"])
    run = tmp_path / "runs" / "smoke"
    rows = json.loads((run / "history.json").read_text())
    assert [r["epoch"] for r in rows] == [0, 1, 2] == [h["epoch"] for h in hist]
    for r in rows:
        assert all(math.isfinite(v) for v in r.values()), r
        assert 1e-6 <= r["lr"] <= 1e-2
    assert rows[-1]["env_steps"] == 3 * 16 * 64
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["task_name"] == "Cartpole" and cfg["train"]["params"]["config"]
    assert (run / "summaries").is_dir()


CLI = ["task=Cartpole", "num_envs=64", "device=cpu", "seed=1",
       "train.params.config.save_frequency=2", "train.params.config.save_best_after=1"]


def test_train_writes_last_and_best(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train.main(CLI + ["max_iterations=3", "experiment=ck"])
    nn = tmp_path / "runs" / "ck" / "nn"
    assert sorted(os.listdir(nn)) == ["best", "best_meta.json", "last"]
    for d in ("last", "best"):
        assert sorted(os.listdir(nn / d)) == ["env.pt", "model.pt"]
    assert torch.load(nn / "last" / MAIN_FILE, weights_only=True)["epoch"] == 2
    assert json.loads((nn / "best_meta.json").read_text())["epoch"] >= 1


def test_checkpoint_resumes_at_the_saved_epoch(tmp_path, monkeypatch, capsys):
    """A run killed after its save at epoch 2 (history up to epoch 2) and
    resumed from nn/last: history.json holds epochs 0-4 once each."""
    monkeypatch.chdir(tmp_path)
    train.main(CLI + ["max_iterations=3", "experiment=ck"])
    capsys.readouterr()
    hist = train.main(CLI + ["max_iterations=5", "experiment=ck",
                             "checkpoint=runs/ck/nn/last"])
    out = capsys.readouterr().out
    assert "loaded checkpoint runs/ck/nn/last (epoch 2)" in out
    assert "resuming at epoch 2 (2 prior rows)" in out
    assert "trained 3 epochs (2 to 5)" in out
    rows = json.loads((tmp_path / "runs" / "ck" / "history.json").read_text())
    assert [r["epoch"] for r in rows] == [h["epoch"] for h in hist] == [0, 1, 2, 3, 4]
    assert torch.load(tmp_path / "runs" / "ck" / "nn" / "last" / MAIN_FILE,
                      weights_only=True)["epoch"] == 4


def test_test_mode_prints_the_eval_line(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    train.main(CLI + ["max_iterations=2", "experiment=ck"])
    capsys.readouterr()
    mean_ret, n = train.main(CLI + ["test=True", "checkpoint=runs/ck/nn/last"])
    out = capsys.readouterr().out
    # one episode length and the reset step: every env ends an episode
    assert f"eval: mean episode reward {mean_ret:.2f} over {n} episodes (501 steps)" in out
    assert n >= 64 and math.isfinite(mean_ret)


def test_play_records_the_jax_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train.main(CLI + ["max_iterations=2", "experiment=ck"])
    out = play.main(["task=Cartpole", "num_envs=8", "device=cpu",
                     "checkpoint=runs/ck/nn/last", "record=traj.npz",
                     "max_iterations=12"])
    assert out == "traj.npz"
    rec = np.load(tmp_path / "traj.npz")
    assert sorted(rec.files) == sorted(["q", "body_pos", "parents", "rewards", "task",
                                        "body_names", "dof_names"])
    assert rec["q"].shape == (12, 2) and rec["body_pos"].shape == (12, 3, 3)
    assert rec["rewards"].shape == (12,) and str(rec["task"]) == "Cartpole"
    assert list(rec["parents"]) == [-1, 0, 1] and len(rec["dof_names"]) == 2
    assert np.isfinite(rec["q"]).all()


def test_viewer_renders_the_jax_viewers_frames(tmp_path, monkeypatch):
    """A Cartpole recording of the port's play.py rendered by the port's
    viewer and by the JAX package's (which imports no JAX): the decoded GIF
    frames are equal, pixel for pixel."""
    from PIL import Image, ImageSequence

    from omniisaacgymenvs_torch.scripts import viewer
    from omniisaacgymenvs_tpu.scripts import viewer as jviewer

    monkeypatch.chdir(tmp_path)
    play.main(["task=Cartpole", "num_envs=4", "device=cpu", "record=traj.npz",
               "max_iterations=8"])
    viewer.main(["traj.npz", "port.gif", "fps=10", "stride=2", "azim=30"])
    jviewer.main(["traj.npz", "jax.gif", "fps=10", "stride=2", "azim=30"])
    frames = []
    for name in ("port.gif", "jax.gif"):
        with Image.open(tmp_path / name) as im:
            frames.append([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])
    port, ref = frames
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    assert len({a.tobytes() for a in port}) > 1  # the figure moves


@pytest.mark.parametrize("rnn", [None, "lstm"])
def test_evaluate_equals_a_step_loop(rnn):
    """`evaluate` against the port's own loop: a fresh reset of seed 123,
    the mean action clipped, the LSTM states zeroed where an episode ends;
    episodes of 5 steps end inside the 12."""
    def trainer():
        task = get_task("Cartpole", device="cpu")
        task.max_episode_length = 5
        return PPOTrainer(VecEnv(task, 16, seed=0),
                          PPOConfig(units=(16,), rnn=rnn, rnn_units=8), seed=0)

    tr = trainer()
    if rnn:
        tr.state.hidden = tuple(0.5 * torch.ones(16, 8) for _ in range(2))
    mean_ret, n = train.evaluate(tr, steps=12, log_fn=lambda s: None)

    ref = trainer()
    ts, env = ref.state, ref.env
    es = env.reset(seed=123)
    h = tuple(0.5 * torch.ones(16, 8) for _ in range(2)) if rnn else ()
    ep_ret, finished, count, zeroed = torch.zeros(16), [], 0, 0
    for _ in range(12):
        x = ts.obs_norm.normalize(es.obs)
        if rnn:
            mu, _, _, h = ts.ac(x, h)
        else:
            mu, _, _ = ts.ac(x)
        es = env.step(es, torch.clamp(mu, -1.0, 1.0))
        if rnn:
            h = tuple(x * (~es.done[:, None]) for x in h)
            zeroed += int(es.done.sum())
        ep_ret += es.reward
        finished += ep_ret[es.done].tolist()
        count += int(es.done.sum())
        ep_ret[es.done] = 0.0
    assert count == n and count >= 16
    np.testing.assert_allclose(mean_ret, sum(finished) / count, rtol=1e-6)
    if rnn:
        assert zeroed > 0


def _bench(extra_env, timeout=600):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(extra_env)
    return subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_bench_torch_on_cpu_prints_the_keys():
    res = _bench({"BENCH_DEVICE": "cpu", "BENCH_NUM_ENVS": "8", "BENCH_STEPS": "4",
                  "BENCH_TRAIN_ENVS": "8"})
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(BENCH_KEYS) <= set(row)
    assert row["metric"] == "humanoid_env_steps_per_s" and row["value"] > 0
    assert row["train_envs"] == 8 and row["train_steps_per_s_bf16"] > 0
    assert "device=cpu num_envs=8 steps=4" in res.stderr


def test_bench_torch_times_the_named_matmul_rule():
    res = _bench({"BENCH_DEVICE": "cpu", "BENCH_NUM_ENVS": "8", "BENCH_STEPS": "4",
                  "BENCH_TRAIN_ENVS": "8", "BENCH_NET_MATMUL": "bf16_operands"})
    assert res.returncode == 0, res.stderr[-2000:]
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["net_matmul"] == "bf16_operands" and row["train_steps_per_s"] > 0
    res = _bench({"BENCH_DEVICE": "cpu", "BENCH_NUM_ENVS": "8", "BENCH_STEPS": "4",
                  "BENCH_TRAIN_ENVS": "8", "BENCH_NET_MATMUL": "tf32"})
    assert res.returncode != 0 and "matmul must be" in res.stderr


def test_bench_torch_needs_the_card_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _bench({"BENCH_TRAIN": "0", "BENCH_NUM_ENVS": "8", "BENCH_STEPS": "2"},
                 timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
    assert "CUDA is not available" in res.stderr


def test_step_rl_is_step():
    env = VecEnv(get_task("Cartpole", device="cpu"), 4, seed=0)
    es = env.reset(seed=0)
    a = torch.full((4, env.num_actions), 0.3)
    gen = env.generator.get_state()
    es1, obs, rew, done, extras = env.step_rl(es, a)
    env.generator.set_state(gen)
    es2 = env.step(es, a)
    assert torch.equal(obs["obs"], es2.obs) and torch.equal(rew, es2.reward)
    assert torch.equal(done, es2.done) and obs["states"].shape == (4, 0)
    assert extras == dict(es1.metrics)


def test_jsonl_writer_and_episode_observer(tmp_path):
    w = metrics.JsonlWriter(str(tmp_path))
    metrics.EpisodeObserver(w).log({"rew": torch.tensor(1.5), "a/b": 2.0}, 7)
    w.add_scalar("train/kl", 0.01, 8)
    w.close()
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("Episode/rew", 1.5, 7), ("a/b", 2.0, 7), ("train/kl", 0.01, 8)]
    assert metrics.maybe_init_wandb({"wandb_activate": False}) is None
