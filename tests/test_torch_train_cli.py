"""The learner's entry points on the CPU: scripts/train.py (Cartpole, 64
envs, a few epochs: finite history.json and config.json under
runs/<experiment>/), its refusal of checkpoint= and test=True (not ported
yet), bench_torch.py at a few envs (bench.py's JSON keys and the train
keys), VecEnv.step_rl and the metrics writers."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.scripts import train
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


@pytest.mark.parametrize("arg", ["checkpoint=runs/x/nn/last", "test=True"])
def test_train_refuses_what_is_not_ported(arg, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="A10"):
        train.main(["task=Cartpole", "num_envs=8", "device=cpu", arg])
    assert not (tmp_path / "runs").exists()


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
