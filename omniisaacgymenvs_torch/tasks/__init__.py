"""Task registry: string name -> task class (the names of the JAX
package's registry)."""

from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask


def _registry():
    from omniisaacgymenvs_torch.tasks.ant import AntLocomotionTask
    from omniisaacgymenvs_torch.tasks.anymal import AnymalTask
    from omniisaacgymenvs_torch.tasks.anymal_terrain import AnymalTerrainTask
    from omniisaacgymenvs_torch.tasks.ball_balance import BallBalanceTask
    from omniisaacgymenvs_torch.tasks.cartpole import CartpoleTask
    from omniisaacgymenvs_torch.tasks.humanoid import HumanoidLocomotionTask
    from omniisaacgymenvs_torch.tasks.shadow_hand import ShadowHandTask

    return {"Ant": AntLocomotionTask, "Anymal": AnymalTask,
            "AnymalTerrain": AnymalTerrainTask,
            "BallBalance": BallBalanceTask,
            "Cartpole": CartpoleTask, "Humanoid": HumanoidLocomotionTask,
            "ShadowHand": ShadowHandTask}


def get_task(name: str, cfg: dict | None = None, device=None) -> RLTask:
    """Build task `name` on `device` (default CUDA; raises without it)."""
    task_map = _registry()
    if name not in task_map:
        raise KeyError(
            f"unknown task {name!r}; ported so far: {sorted(task_map)}"
        )
    if (cfg or {}).get("domain_randomization", {}).get("randomize"):
        raise NotImplementedError("domain randomization is not ported yet")
    return task_map[name](cfg, device=device)


__all__ = ["EnvState", "RLTask", "get_task"]
