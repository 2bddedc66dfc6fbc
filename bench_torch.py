"""Benchmark of the PyTorch port: Humanoid simulation and PPO training
throughput on one card.

    python3 bench_torch.py

Prints ONE JSON line on stdout with `bench.py`'s keys ("metric", "value",
"unit", "vs_baseline"): the headline is random-policy env-steps/s through
`VecEnv.rollout` (BENCH_NUM_ENVS envs, default 32768, BENCH_STEPS steps,
default 256; a warm-up rollout, then the best of three), plus the train
keys "train_envs", "epochs_per_jit", "train_steps_per_s" /
"train_steps_per_s_bf16" (whole PPO epochs of the task's train yaml:
rollout, GAE, minibatch SGD; f32 and bf16 networks) and "learner_mfu" /
"learner_mfu_bf16" (the actor-critic's FLOPs over the card's peak for the
networks' dtype: H100 SXM 67 TFLOP/s FP32 for the f32 learner, TF32 off,
and 989 TFLOP/s dense BF16; BENCH_PEAK_FLOPS overrides both). A line on
stderr gives the card's name and power limit, the env count and the steps.

Env vars: BENCH_TASK (default Humanoid), BENCH_NUM_ENVS, BENCH_STEPS,
BENCH_TRAIN=0 (skip the train half), BENCH_TRAIN_ENVS (default 8192),
BENCH_PEAK_FLOPS, BENCH_NET_MATMUL (the f32 networks' matmul rule, default
the learner's, `PPOConfig.net_matmul`: the TPU's rule `bf16_operands`;
`f32` times exact f32; recorded as "net_matmul"),
BENCH_DEVICE (default cuda; `cpu` is the only way to run on the CPU, for a
smoke run). The baseline of vs_baseline is bench.py's:
600k Humanoid env-steps/s on one GPU.
"""

import json
import os
import subprocess
import sys
import time

# H100 SXM dense peaks (NVIDIA data sheet)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
BASELINE = 600_000.0


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[device.index or 0].strip()


def _mlp_flops(sizes):
    """2 * MACs of a dense chain [in, h1, ..., out] per sample."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def main():
    import torch

    from omniisaacgymenvs_torch.envs import VecEnv
    from omniisaacgymenvs_torch.scripts.random_policy import uniform_policy
    from omniisaacgymenvs_torch.tasks import get_task
    from omniisaacgymenvs_torch.utils.config import load_config
    from omniisaacgymenvs_torch.utils.device import resolve_device

    task_name = os.environ.get("BENCH_TASK", "Humanoid")
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", "32768"))
    steps = int(os.environ.get("BENCH_STEPS", "256"))
    device = resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    cfg = load_config({"task": task_name})
    env = VecEnv(get_task(task_name, cfg["task"], device=device), num_envs)
    es = env.reset(seed=0)
    policy = uniform_policy(env.num_actions)
    t0 = time.perf_counter()
    es, _ = env.rollout(es, policy, steps)
    sync()
    warmup_s = time.perf_counter() - t0
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        es, _ = env.rollout(es, policy, steps)
        sync()
        best = max(best, num_envs * steps / (time.perf_counter() - t0))
    del es, env
    row = {
        "metric": f"{task_name.lower()}_env_steps_per_s",
        "value": round(best, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(best / BASELINE, 3),
    }
    if os.environ.get("BENCH_TRAIN", "1") != "0":
        row.update(train_bench(task_name, device, cfg))
    print(json.dumps(row))
    print(f"# device={card_line(device)} num_envs={num_envs} steps={steps} "
          f"warmup={warmup_s:.1f}s", file=sys.stderr)


def train_bench(task_name: str, device, cfg: dict, epochs: int = 16) -> dict:
    """Whole PPO epochs on the task's train yaml, f32 networks (their
    matmul rule BENCH_NET_MATMUL, `PPOConfig.net_matmul`) and bf16 networks:
    one warm-up epoch, then `epochs` timed. Learner FLOPs per
    env-step: one policy forward in the rollout and mini_epochs x (forward +
    2 x backward) over the dataset; the physics is not counted."""
    import torch

    from omniisaacgymenvs_torch.envs import VecEnv
    from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
    from omniisaacgymenvs_torch.tasks import get_task
    from omniisaacgymenvs_torch.utils.config import ppo_config_kwargs

    n = int(os.environ.get("BENCH_TRAIN_ENVS", "8192"))
    peak_env = os.environ.get("BENCH_PEAK_FLOPS")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    env = VecEnv(get_task(task_name, cfg["task"], device=device), n)
    kw = ppo_config_kwargs(cfg["train"])
    # there is no multi-epoch compiled program: one epoch per call
    matmul = os.environ.get("BENCH_NET_MATMUL", PPOConfig.net_matmul)
    out = {"train_envs": n, "epochs_per_jit": 1, "net_matmul": matmul}
    for mixed in (False, True):
        ppo = PPOConfig(**{**kw, "mixed_precision": mixed,
                           "net_matmul": "f32" if mixed else matmul})
        trainer = PPOTrainer(env, ppo, seed=0)
        trainer._epoch(trainer.state)
        sync()
        t0 = time.perf_counter()
        for _ in range(epochs):
            trainer._epoch(trainer.state)
        sync()
        train_sps = epochs * ppo.horizon_length * n / (time.perf_counter() - t0)
        fwd = _mlp_flops([env.num_obs, *ppo.units, env.num_actions + 1])
        per_step = fwd * (1 + 3 * ppo.mini_epochs)
        peak = float(peak_env) if peak_env else (PEAK_BF16 if mixed else PEAK_FP32)
        tag = "_bf16" if mixed else ""
        out["train_steps_per_s" + tag] = round(train_sps, 1)
        out["learner_mfu" + tag] = round(train_sps * per_step / peak, 6)
        del trainer
    return out


if __name__ == "__main__":
    main()
