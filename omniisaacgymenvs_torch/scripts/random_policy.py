"""Random-policy runner: step a task with uniform actions in [-1, 1], no
learning in the loop, and print reward statistics and throughput.

    python -m omniisaacgymenvs_torch.scripts.random_policy \
        task=Humanoid num_envs=32768 max_iterations=64 [device=cpu]

Tasks: Humanoid, Ant, Cartpole (the default), BallBalance, ShadowHand,
Anymal, AnymalTerrain, ShadowHandOpenAI_FF and ShadowHandOpenAI_LSTM (the
hand under its yaml's domain randomization; ShadowHand takes
`task.domain_randomization.randomize=True`), FrankaCabinet, AllegroHand,
Ingenuity, Quadcopter, Crazyflie and Custom (an imported robot:
`task.env.robot=<.urdf|.xml|.mjcf>`): every reference task. Runs on CUDA
unless `device=cpu` is given.
"""

from __future__ import annotations

import time

import torch

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.scripts.common import build_env_from_cli


def uniform_policy(num_actions: int):
    def policy(obs, generator):
        u = torch.rand((obs.shape[0], num_actions), generator=generator,
                       device=obs.device)
        return 2.0 * u - 1.0
    return policy


def drive(cfg: dict, env: VecEnv) -> dict:
    """Reset, then one rollout of max_iterations steps. Returns the stats,
    the final state and the trajectory."""
    steps = int(cfg.get("max_iterations") or 100)
    es = env.reset(seed=int(cfg["seed"]))
    sync = torch.cuda.synchronize if env.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    es, (obs, rew, done) = env.rollout(es, uniform_policy(env.num_actions), steps)
    sync()
    dt = time.perf_counter() - t0
    return dict(
        task=cfg["task_name"], num_envs=env.num_envs, steps=steps,
        device=str(env.device), mean_reward=float(rew.mean()),
        done_rate=float(done.float().mean()),
        env_steps_per_s=env.num_envs * steps / dt, seconds=dt,
        state=es, trajectory=(obs, rew, done),
    )


def run(argv=None) -> dict:
    cfg, _, env = build_env_from_cli(argv)
    return drive(cfg, env)


def main(argv=None):
    r = run(argv)
    print(
        f"task={r['task']} num_envs={r['num_envs']} steps={r['steps']} "
        f"device={r['device']} | mean reward {r['mean_reward']:.4f} | "
        f"done rate {r['done_rate']:.4f} | "
        f"{r['env_steps_per_s']:,.0f} env-steps/s"
    )


if __name__ == "__main__":
    main()
