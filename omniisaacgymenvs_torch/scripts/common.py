"""Shared CLI plumbing of the entry scripts."""

from __future__ import annotations

import sys

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.parallel import init_distributed
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config, parse_cli


def build_env_from_cli(argv=None, default_task=None):
    """Parse key=value overrides and build (cfg, task, env) on `device=`
    (default cuda; raises without a card unless device=cpu is given); the
    task is `task=`, else `default_task`, else the config's default
    (Cartpole, as in the JAX package).
    `distributed=True` (one process per GPU under torchrun) joins the
    process group first: the task is built on the rank's device
    (`cuda:LOCAL_RANK`, or the CPU under gloo) and the env holds the rank's
    share of num_envs."""
    overrides = parse_cli(sys.argv[1:] if argv is None else argv)
    distributed = bool(overrides.pop("distributed", False))
    if default_task:
        overrides.setdefault("task", default_task)
    cfg = load_config(overrides)
    if distributed:
        cfg["device"] = str(init_distributed(cfg["device"]))
    task = get_task(cfg["task_name"], cfg["task"], device=cfg["device"])
    num_envs = int(cfg["task"].get("env", {}).get("numEnvs", 512))
    return cfg, task, VecEnv(task, num_envs, seed=int(cfg["seed"]))
