"""Where a random-policy control step spends its time on the card.

    python -m omniisaacgymenvs_torch.scripts.profile_rollout \
        task=Humanoid num_envs=32768 max_iterations=8
    python -m omniisaacgymenvs_torch.scripts.profile_rollout \
        task=ShadowHand num_envs=8192 max_iterations=8
    python -m omniisaacgymenvs_torch.scripts.profile_rollout \
        task=AnymalTerrain num_envs=2048 max_iterations=8
    python -m omniisaacgymenvs_torch.scripts.profile_rollout \
        task=ShadowHandOpenAI_FF num_envs=8192 max_iterations=8

Builds the same VecEnv as `random_policy` (`scripts/common.py`), resets and warms up for two
steps, times `max_iterations` steps without the profiler, then traces as
many with `torch.profiler`. Prints the wall time per control step
untraced and traced (the profiler's host-side recording adds to the
latter), the device-busy share of the traced window
(kernel time summed over one stream, over wall time), and the kernels by
device time. A task under domain randomization (ShadowHandOpenAI_FF, or
ShadowHand with `task.domain_randomization.randomize=True`) is traced with
its sampling and merging of the overlays in the step. For a task on terrain it then traces the sampling of the
contact planes alone (`engine._contact_planes`, the task's plane function
as small PyTorch ops) and prints its share of the step. Needs a CUDA
device.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
from omniisaacgymenvs_torch.scripts.random_policy import uniform_policy


def _device_us(evt) -> float:
    # renamed from self_cuda_time_total in newer PyTorch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# A trace whose launches started as it started lost up to 11 of 20 kernel
# records; one that waited this long on an idle card first kept them all
# (NVIDIA H100 80GB HBM3, chip_smoke.py). A trace waits so at both ends.
SETTLE_S = 0.1


def settle(seconds: float = SETTLE_S) -> None:
    """Wait for the card, then `seconds` more: at each end of a trace."""
    torch.cuda.synchronize()
    time.sleep(seconds)


def _trace(fn, reps: int):
    """(wall us, kernel events) of `reps` calls of fn under the profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        settle()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        settle()
    return wall_us, [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> int:
    cfg, task, env = build_env_from_cli(argv, default_task="Humanoid")
    if env.device.type != "cuda":
        raise SystemExit("profile_rollout measures the card: needs device=cuda")
    steps = int(cfg.get("max_iterations") or 8)
    policy = uniform_policy(env.num_actions)
    es = env.reset(seed=int(cfg["seed"]))
    for _ in range(2):
        es = env.step(es, policy(es.obs, env.generator))
    torch.cuda.synchronize()
    state = [es]

    def one_step():
        state[0] = env.step(state[0], policy(state[0].obs, env.generator))

    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / steps
    wall_us, kernels = _trace(one_step, steps)
    busy_us = sum(_device_us(e) for e in kernels)
    print(f"{cfg['task_name']} {env.num_envs} envs, {steps} steps: "
          f"{untraced_ms:.4f} ms per control step untraced, "
          f"{wall_us / steps / 1e3:.4f} ms per control step (wall, traced), "
          f"device busy {busy_us / steps / 1e3:.4f} ms per step, "
          f"idle share {1.0 - busy_us / wall_us:.4f}, "
          f"{sum(e.count for e in kernels) / steps:.1f} kernel launches "
          f"per step")
    kernels.sort(key=_device_us, reverse=True)
    print("device time per step by kernel (ms, share of busy, calls per step):")
    for e in kernels[:15]:
        us = _device_us(e)
        print(f"  {us / steps / 1e3:10.4f}  {us / max(busy_us, 1e-9):7.4f}  "
              f"{e.count / steps:6.1f}  {e.key[:90]}")
    eng = task.engine
    if eng.has_terrain:
        per_step = eng.k1_launches(task.decimation)
        phys = state[0].phys
        eng._contact_planes(phys)
        torch.cuda.synchronize()
        p_wall, p_kern = _trace(lambda: eng._contact_planes(phys), steps)
        p_busy = sum(_device_us(e) for e in p_kern)
        print(f"contact planes alone, {per_step} samplings per control step: "
              f"{p_busy / steps / 1e3:.4f} ms of device time and "
              f"{p_wall / steps / 1e3:.4f} ms of wall per sampling, "
              f"{sum(e.count for e in p_kern) / steps:.1f} kernel launches; "
              f"per control step {per_step * p_busy / busy_us:.4f} of the "
              f"device-busy time, {per_step * p_wall / wall_us:.4f} of the "
              f"wall time, {per_step * sum(e.count for e in p_kern) / steps:.1f} "
              f"launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
