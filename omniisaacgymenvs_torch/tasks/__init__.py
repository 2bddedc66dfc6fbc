"""Task registry: string name -> task class (the JAX package's 15 names:
the 14 reference tasks and `Custom`, a robot from a URDF or MJCF file)."""

from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask


def _registry():
    from omniisaacgymenvs_torch.tasks.allegro_hand import AllegroHandTask
    from omniisaacgymenvs_torch.tasks.ant import AntLocomotionTask
    from omniisaacgymenvs_torch.tasks.anymal import AnymalTask
    from omniisaacgymenvs_torch.tasks.anymal_terrain import AnymalTerrainTask
    from omniisaacgymenvs_torch.tasks.ball_balance import BallBalanceTask
    from omniisaacgymenvs_torch.tasks.cartpole import CartpoleTask
    from omniisaacgymenvs_torch.tasks.crazyflie import CrazyflieTask
    from omniisaacgymenvs_torch.tasks.custom import CustomRobotTask
    from omniisaacgymenvs_torch.tasks.franka_cabinet import FrankaCabinetTask
    from omniisaacgymenvs_torch.tasks.humanoid import HumanoidLocomotionTask
    from omniisaacgymenvs_torch.tasks.ingenuity import IngenuityTask
    from omniisaacgymenvs_torch.tasks.quadcopter import QuadcopterTask
    from omniisaacgymenvs_torch.tasks.shadow_hand import ShadowHandTask

    def openai_variant(cfg, device=None):
        """ShadowHand with openai observations and asymmetric states, the
        defaults of the two OpenAI configurations (feed-forward and LSTM
        build the same task: they differ in the train config)."""
        cfg = dict(cfg or {})
        env = dict(cfg.get("env", {}))
        env.setdefault("observationType", "openai")
        env.setdefault("asymmetric_observations", True)
        cfg["env"] = env
        return ShadowHandTask(cfg, device=device)

    return {"AllegroHand": AllegroHandTask, "Ant": AntLocomotionTask,
            "Anymal": AnymalTask, "AnymalTerrain": AnymalTerrainTask,
            "BallBalance": BallBalanceTask, "Cartpole": CartpoleTask,
            "Crazyflie": CrazyflieTask, "Custom": CustomRobotTask,
            "FrankaCabinet": FrankaCabinetTask,
            "Humanoid": HumanoidLocomotionTask, "Ingenuity": IngenuityTask,
            "Quadcopter": QuadcopterTask, "ShadowHand": ShadowHandTask,
            "ShadowHandOpenAI_FF": openai_variant,
            "ShadowHandOpenAI_LSTM": openai_variant}


def get_task(name: str, cfg: dict | None = None, device=None) -> RLTask:
    """Build task `name` on `device` (default CUDA; raises without it)."""
    task_map = _registry()
    if name not in task_map:
        raise KeyError(f"unknown task {name!r}; known: {sorted(task_map)}")
    from omniisaacgymenvs_torch.utils.domain_randomization import Randomizer

    task = task_map[name](cfg, device=device)
    # the randomization block stands at the root of the task yaml
    task.randomizer = Randomizer((cfg or {}).get("domain_randomization"))
    return task


__all__ = ["EnvState", "RLTask", "get_task"]
