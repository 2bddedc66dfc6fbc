"""Training entry point: PPO on one task, on one card.

    python -m omniisaacgymenvs_torch.scripts.train task=Humanoid seed=42 \
        [num_envs=4096] [max_iterations=1000] [experiment=NAME] [device=cpu] \
        [checkpoint=runs/Humanoid/nn/last] [test=True] [profile=N] \
        [train.params.config.horizon_length=32]

    torchrun --standalone --nproc_per_node=NGPU \
        -m omniisaacgymenvs_torch.scripts.train task=Humanoid distributed=True

`distributed=True` runs one process per GPU (parallel/mesh.py): num_envs
counts every rank's envs, the learner's reductions and gradients are
global, rank 0 alone logs and writes.

Any nested config key can be overridden with dotted syntax. Writes
runs/<experiment>/ (experiment defaults to the task's name): config.json,
history.json (every epoch's metrics), nn/ (checkpoints: `last` every
`save_frequency` epochs, `best` after `save_best_after`, as the train yaml
sets them), summaries/ (TensorBoard, or a JSONL file where TensorBoard does
not import) and, with profile=N, trace/ (a torch.profiler trace of N epochs
after three). On the card it ends by logging the kernels' launches over the
training loop (`kernel launches over the training {...}`: K1 `step`, K2
`fk`, K3 `substep`). The task defaults to Cartpole, as in the JAX package.
`checkpoint=` (a local directory or an http(s) archive, see
utils/paths.py) resumes training at the checkpoint's epoch; with
`test=True` it is evaluated instead: the mean action over one episode
length (or `max_iterations` steps), printing the mean episode reward. Runs
on CUDA unless device=cpu is given (under distributed=True on the CPU:
gloo).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.ppo import reset_where_done
from omniisaacgymenvs_torch.parallel import mesh
from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
from omniisaacgymenvs_torch.utils.config import ppo_config_kwargs
from omniisaacgymenvs_torch.utils.metrics import log, make_writer, maybe_init_wandb
from omniisaacgymenvs_torch.utils.paths import retrieve_checkpoint_path


@torch.no_grad()
def evaluate(trainer: PPOTrainer, steps: int = 1000, log_fn=log, seed: int = 123):
    """The deterministic (mean-action, clipped to [-1, 1]) policy on envs
    freshly reset from `seed` for `steps` control steps, the LSTM states
    carried from the trainer's and zeroed where an episode ends. Returns
    (mean reward of the finished episodes, their count), over every rank's
    envs; with none finished, the mean running reward and 0. Prints the
    task's statistics and, for a task that counts successes, the mean
    successes of a finished episode."""
    env, ts = trainer.env, trainer.state
    es = env.reset(seed=seed)
    hidden, cv_hidden = ts.hidden, ts.cv_hidden
    ep_ret = torch.zeros(env.num_envs, device=trainer.device)
    total = torch.zeros_like(ep_ret)
    count = torch.zeros_like(ep_ret)
    successes = torch.zeros_like(ep_ret)
    stats = env.task.episode_stats_init()
    for _ in range(steps):
        mu, _, _, hidden, cv_hidden = trainer._policy(ts, es.obs, es.states,
                                                      hidden, cv_hidden)
        es = env.step(es, mu.clamp(-1.0, 1.0))
        if trainer.is_rnn:
            hidden = reset_where_done(hidden, es.done)
            cv_hidden = reset_where_done(cv_hidden, es.done)
        ep_ret = ep_ret + es.reward
        total = total + torch.where(es.done, ep_ret, 0.0)
        count = count + es.done
        if "successes" in es.metrics:
            successes = successes + torch.where(es.done, es.metrics["successes"], 0.0)
        ep_ret = torch.where(es.done, 0.0, ep_ret)
        stats = env.task.episode_stats_update(stats, es)
    for k, v in stats.items():
        log_fn(f"eval: {k} = {float(v):.2f}")
    n = float(mesh.env_sum(count))
    if "successes" in es.metrics and n:
        log_fn(f"eval: successes per finished episode = "
               f"{float(mesh.env_sum(successes)) / n:.4f}")
    if n == 0:
        return float(mesh.env_mean(ep_ret)), 0
    return float(mesh.env_sum(total)) / n, int(n)


def build_trainer(argv):
    """(cfg, task, trainer) of the CLI's arguments, the trainer loaded from
    `checkpoint=` where one is given."""
    cfg, task, env = build_env_from_cli(argv)
    kw = ppo_config_kwargs(cfg["train"])
    if cfg.get("max_iterations"):
        kw["max_epochs"] = int(cfg["max_iterations"])
    trainer = PPOTrainer(env, PPOConfig(**kw), seed=int(cfg["seed"]))
    if cfg.get("checkpoint"):
        # an evaluation needs the main file only, at any world size
        trainer.load(retrieve_checkpoint_path(cfg["checkpoint"]), log_fn=log,
                     resume=not cfg.get("test"))
        log(f"loaded checkpoint {cfg['checkpoint']} (epoch {trainer.state.epoch})")
    return cfg, task, trainer


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    try:
        return _main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(argv):
    cfg, task, trainer = build_trainer(argv)
    env = trainer.env
    if cfg.get("test"):
        # one whole episode of the task (and the reset step), unless
        # max_iterations says otherwise
        steps = int(cfg.get("max_iterations")
                    or getattr(task, "max_episode_length", 1000) + 1)
        mean_ret, n = evaluate(trainer, steps=steps)
        log(f"eval: mean episode reward {mean_ret:.2f} over {n} episodes "
            f"({steps} steps)")
        return mean_ret, n

    experiment = cfg.get("experiment") or cfg["task_name"]
    run_dir = os.path.join("runs", experiment)
    main_rank = mesh.is_main()
    if main_rank:
        os.makedirs(os.path.join(run_dir, "nn"), exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
    train_c = cfg["train"].get("params", {}).get("config", {})
    writer = make_writer(os.path.join(run_dir, "summaries"))
    wandb_run = maybe_init_wandb(cfg)
    num_envs = env.num_envs * trainer.world
    log(f"task={cfg['task_name']} num_envs={num_envs} device={env.device} "
        f"seed={cfg['seed']}" + (f" ranks={trainer.world}" if trainer.world > 1 else "")
        + f" networks: {'bf16 (autocast)' if trainer.cfg.mixed_precision else trainer.net_matmul}")
    profile_epochs = int(cfg.get("profile", 0) or 0)
    kernels = task.engine.kernels           # None on the CPU
    if kernels is not None:
        kernels.reset_counts()
    start = trainer.state.epoch
    history = []
    t0 = time.perf_counter()
    try:
        history = trainer.train(
            log_every=1,
            log_fn=log,
            save_dir=os.path.join(run_dir, "nn"),
            save_frequency=int(train_c.get("save_frequency", 50)),
            save_best_after=int(train_c.get("save_best_after", 100)),
            writer=writer,
            profile_dir=(os.path.join(run_dir, "trace")
                         if profile_epochs else None),
            profile_epochs=profile_epochs,
            history_path=os.path.join(run_dir, "history.json"),
        )
    finally:
        writer.close()
        if wandb_run is not None:
            wandb_run.finish()
        if history and main_rank:
            with open(os.path.join(run_dir, "history.json"), "w") as f:
                json.dump(history, f)
    wall = time.perf_counter() - t0
    epochs = trainer.state.epoch - start
    steps = epochs * trainer.cfg.horizon_length * num_envs
    log(f"trained {epochs} epochs ({start} to {trainer.state.epoch}), {steps} "
        f"env-steps in {wall:.1f} s: {steps / wall:,.1f} train-steps/s")
    if kernels is not None:
        log("kernel launches over the training " + json.dumps(dict(
            kernels.launches, step_overlay=kernels.overlay_launches["step"],
            step_thread=kernels.thread_launches["step"])))
    return history


if __name__ == "__main__":
    main()
