"""Where a PPO training epoch spends its time on the card, by phase.

    python -m omniisaacgymenvs_torch.scripts.profile_epoch \
        task=Humanoid [num_envs=4096] [epochs=3] [warmup=2] \
        [train.params.config.mixed_precision=False]

Builds the trainer as `scripts/train.py` does (the task's train yaml), runs
`warmup` epochs, then `epochs` epochs untraced with a synchronize around
every phase (wall ms per phase, host clock), then `epochs` more with each
phase under its own torch.profiler window (device ms and kernel launches
per phase). The phases, in `PPOTrainer._epoch`'s order: rollout (the
policy, with the LSTMs' steps on the recurrent learner, the task's step
with K1 and K2, the episode counters), GAE, the value norm's update, the
central value's SGD (where there is one; BPTT over sequences with an LSTM
central value), the actor's SGD (BPTT on the recurrent learner), the obs
and states norms' update; `other` is the rest of the epoch (the dataset's
reshapes into sequences, the metrics). Prints a table per epoch
mean, the K1 / K2 launches per epoch from the kernel counters, the device
busy share of the traced epochs, and the card's name and power limit; the
last line is the table as JSON. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn import running_norm
from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
from omniisaacgymenvs_torch.scripts.profile_rollout import _device_us, settle
from omniisaacgymenvs_torch.utils.config import ppo_config_kwargs

PHASES = ("rollout", "gae", "norms", "cv_sgd", "sgd", "other")


class _PhaseClock:
    """Wraps the trainer's phase methods; in `wall` mode times each call
    between synchronizes, in `trace` mode runs it under its own profiler
    and keeps its kernels' device time and count."""

    def __init__(self):
        self.mode = None
        self.wall = defaultdict(float)
        self.device = defaultdict(float)
        self.launches = defaultdict(int)

    def wrap(self, name, fn):
        def run(*a, **kw):
            if self.mode is None:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            if self.mode == "wall":
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.wall[name] += (time.perf_counter() - t0) * 1e3
                return out
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                settle()
                out = fn(*a, **kw)
                settle()
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    self.device[name] += _device_us(e) / 1e3
                    self.launches[name] += e.count
            return out
        return run


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(a.split("=", 1) for a in argv if a.split("=", 1)[0] in
                ("epochs", "warmup"))
    argv = [a for a in argv if a.split("=", 1)[0] not in ("epochs", "warmup")]
    epochs, warmup = int(opts.get("epochs", 3)), int(opts.get("warmup", 2))
    cfg, task, env = build_env_from_cli(argv, default_task="Humanoid")
    if env.device.type != "cuda":
        raise SystemExit("profile_epoch measures the card: needs device=cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    ppo = PPOConfig(**ppo_config_kwargs(cfg["train"]))
    trainer = PPOTrainer(env, ppo, seed=int(cfg["seed"]))
    clock = _PhaseClock()
    for name, attr in (("rollout", "_rollout"), ("gae", "_gae"),
                       ("cv_sgd", "_cv_update"), ("sgd", "_update")):
        setattr(trainer, attr, clock.wrap(name, getattr(trainer, attr)))
    norm_update = running_norm.RunningNorm.update
    running_norm.RunningNorm.update = clock.wrap("norms", norm_update)
    kern = task.engine.kernels
    try:
        for _ in range(warmup):
            trainer._epoch(trainer.state)
        torch.cuda.synchronize()
        # wall per phase, untraced
        clock.mode = "wall"
        kern.reset_counts()
        t0 = time.perf_counter()
        for _ in range(epochs):
            trainer._epoch(trainer.state)
        torch.cuda.synchronize()
        epoch_wall = (time.perf_counter() - t0) * 1e3 / epochs
        counts = dict(kern.launches)
        # device time and launches per phase, each under its own profiler
        clock.mode = "trace"
        for _ in range(epochs):
            trainer._epoch(trainer.state)
        # the whole epoch under one profiler: device busy and all launches
        clock.mode = None
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle()
            t1 = time.perf_counter()
            trainer._epoch(trainer.state)
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t1) * 1e3
            settle()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_device_us(e) for e in kernels) / 1e3
        total_launches = sum(e.count for e in kernels)
    finally:
        running_norm.RunningNorm.update = norm_update
    rows = {}
    for name in PHASES[:-1]:
        rows[name] = dict(wall_ms=clock.wall[name] / epochs,
                          device_ms=clock.device[name] / epochs,
                          launches=clock.launches[name] / epochs)
    rows["other"] = dict(
        wall_ms=epoch_wall - sum(r["wall_ms"] for r in rows.values()),
        device_ms=busy - sum(r["device_ms"] for r in rows.values()),
        launches=total_launches - sum(r["launches"] for r in rows.values()))
    steps = ppo.horizon_length * env.num_envs
    num_slices, mb_slices = trainer._slices()
    rows_of = (f"sequences of {ppo.seq_len} steps (LSTM {ppo.rnn_units} units"
               f"{', central value LSTM' if trainer.is_cv_rnn else ''})"
               if trainer.is_rnn else "transitions")
    print(f"card: {card} | {cfg['task_name']} {env.num_envs} envs, horizon "
          f"{ppo.horizon_length}, {ppo.mini_epochs} mini-epochs of "
          f"{num_slices // mb_slices} minibatches of {mb_slices} {rows_of}, "
          f"central value {trainer.use_cv}, bf16 networks "
          f"{ppo.mixed_precision}; {epochs} epochs after {warmup}")
    print(f"{'phase':8s} {'wall ms':>10s} {'device ms':>10s} {'launches':>10s}")
    for name, r in rows.items():
        print(f"{name:8s} {r['wall_ms']:10.3f} {r['device_ms']:10.3f} "
              f"{r['launches']:10.1f}")
    print(f"epoch: {epoch_wall:.3f} ms wall untraced (synchronized at every "
          f"phase), {steps / epoch_wall * 1e3:,.1f} train-steps/s; traced "
          f"{traced_wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / traced_wall:.4f}, {total_launches} launches; K1 / K2 "
          f"launches per epoch {counts['step'] / epochs:.1f} / "
          f"{counts['fk'] / epochs:.1f}")
    print(card)
    print(json.dumps({"card": card, "task": cfg["task_name"],
                      "num_envs": env.num_envs, "phases": rows,
                      "epoch_wall_ms": epoch_wall, "traced_wall_ms": traced_wall,
                      "device_busy_ms": busy, "launches": total_launches,
                      "k1_per_epoch": counts["step"] / epochs,
                      "k2_per_epoch": counts["fk"] / epochs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
