"""Training entry point: PPO on one task, on one card.

    python -m omniisaacgymenvs_torch.scripts.train task=Humanoid seed=42 \
        [num_envs=4096] [max_iterations=1000] [experiment=NAME] [device=cpu] \
        [profile=N] [train.params.config.horizon_length=32]

Any nested config key can be overridden with dotted syntax. Writes
runs/<experiment>/ (experiment defaults to the task's name): config.json,
history.json (every epoch's metrics), summaries/ (TensorBoard, or a JSONL
file where TensorBoard does not import) and, with profile=N, trace/ (a
torch.profiler trace of N epochs after three). Runs on CUDA unless
device=cpu is given. Checkpoints are not ported yet (ROADMAP A10), so
`checkpoint=` and `test=True` exit with an error.
"""

from __future__ import annotations

import json
import os
import sys
import time

from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
from omniisaacgymenvs_torch.utils.config import parse_cli, ppo_config_kwargs
from omniisaacgymenvs_torch.utils.metrics import make_writer, maybe_init_wandb


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    # refuse what is not ported before building anything
    wanted = parse_cli(argv)
    if wanted.get("checkpoint") or wanted.get("test"):
        raise SystemExit(
            "checkpoint= and test=True need checkpoints, which are not ported "
            "yet (ROADMAP A10)")
    cfg, task, env = build_env_from_cli(argv)
    kw = ppo_config_kwargs(cfg["train"])
    if cfg.get("max_iterations"):
        kw["max_epochs"] = int(cfg["max_iterations"])
    trainer = PPOTrainer(env, PPOConfig(**kw), seed=int(cfg["seed"]))

    experiment = cfg.get("experiment") or cfg["task_name"]
    run_dir = os.path.join("runs", experiment)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)
    writer = make_writer(os.path.join(run_dir, "summaries"))
    wandb_run = maybe_init_wandb(cfg)
    print(f"task={cfg['task_name']} num_envs={env.num_envs} "
          f"device={env.device} seed={cfg['seed']}", flush=True)
    profile_epochs = int(cfg.get("profile", 0) or 0)
    history = []
    t0 = time.perf_counter()
    try:
        history = trainer.train(
            log_every=1,
            log_fn=lambda s: print(s, flush=True),
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
        if history:
            with open(os.path.join(run_dir, "history.json"), "w") as f:
                json.dump(history, f)
    wall = time.perf_counter() - t0
    steps = history[-1]["env_steps"] if history else 0
    print(f"trained {len(history)} epochs, {steps} env-steps in {wall:.1f} s: "
          f"{steps / wall:,.1f} train-steps/s", flush=True)
    return history


if __name__ == "__main__":
    main()
