"""The port's CLI defaults are the JAX package's: `load_config({})` gives
the same root keys (task Cartpole, seed 42, ...) and accepts `headless`;
the train CLI with no `task=` trains Cartpole; the kernel and profiling
tools, which measure the bench's main path, keep Humanoid by setting it
themselves."""

import importlib
import json

import pytest

from omniisaacgymenvs_torch.scripts import common, train
from omniisaacgymenvs_torch.utils.config import load_config
from omniisaacgymenvs_tpu.utils.config import load_config as jload_config

ROOT_KEYS = ("task_name", "seed", "test", "checkpoint", "max_iterations",
             "experiment", "num_envs", "headless")


@pytest.mark.parametrize("key", ROOT_KEYS)
def test_root_defaults_are_the_jax_packages(key):
    cfg, jcfg = load_config({}), jload_config({})
    assert cfg[key] == jcfg[key], (key, cfg[key], jcfg[key])


def test_default_task_is_cartpole_with_its_yamls():
    cfg, jcfg = load_config({}), jload_config({})
    assert cfg["task_name"] == "Cartpole"
    assert cfg["task"] == jcfg["task"] and cfg["train"] == jcfg["train"]
    assert cfg["device"] == "cuda"


def test_headless_is_accepted_and_ignored():
    cfg = load_config({"headless": False, "task": "Ant"})
    ref = load_config({"task": "Ant"})
    assert "headless" not in cfg["task"] and "headless" not in cfg["train"]
    assert cfg["task"] == ref["task"] and cfg["train"] == ref["train"]
    assert cfg["headless"] is False and ref["headless"] is True


def test_train_cli_without_task_trains_cartpole(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    hist = train.main(["device=cpu", "num_envs=64", "max_iterations=1",
                       "headless=True"])
    assert len(hist) == 1
    cfg = json.loads((tmp_path / "runs" / "Cartpole" / "config.json").read_text())
    assert cfg["task_name"] == "Cartpole"


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", ["time_kernels", "profile_kernel"])
def test_kernel_tools_default_to_humanoid(name, monkeypatch):
    mod = importlib.import_module(f"omniisaacgymenvs_torch.scripts.{name}")
    seen = {}

    def load(args):
        seen.update(load_config(args))
        raise _Stop

    monkeypatch.setattr(mod, "load_config", load)
    with pytest.raises(_Stop):
        mod.main([])
    assert seen["task_name"] == "Humanoid"
    assert seen["task"]["env"]["numEnvs"] == 32768
    seen.clear()
    with pytest.raises(_Stop):
        mod.main(["task=Ant"])
    assert seen["task_name"] == "Ant"


@pytest.mark.parametrize("name", ["profile_rollout", "profile_epoch"])
def test_profiling_tools_default_to_humanoid(name, monkeypatch):
    mod = importlib.import_module(f"omniisaacgymenvs_torch.scripts.{name}")
    seen = []

    def load(overrides):
        seen.append(load_config(overrides)["task_name"])
        raise _Stop

    monkeypatch.setattr(common, "load_config", load)
    for argv, want in (([], "Humanoid"), (["task=ShadowHand"], "ShadowHand")):
        with pytest.raises(_Stop):
            mod.main(argv)
        assert seen[-1] == want


def test_build_env_from_cli_default_task():
    cfg, task, env = common.build_env_from_cli(["device=cpu", "num_envs=4"])
    assert cfg["task_name"] == "Cartpole" and env.num_envs == 4
    cfg, _, _ = common.build_env_from_cli(["device=cpu", "num_envs=4"],
                                          default_task="Ant")
    assert cfg["task_name"] == "Ant"
    cfg, _, _ = common.build_env_from_cli(["device=cpu", "num_envs=4", "task=Cartpole"],
                                          default_task="Ant")
    assert cfg["task_name"] == "Cartpole"
