"""Config system: YAML task and train configs + dotted CLI overrides
(PyTorch port of the JAX package's `utils/config.py`).

`task=Humanoid num_envs=4096 task.env.episodeLength=500 device=cpu
train.params.config.horizon_length=32`. Yamls are read from this package's
own `cfg/task/` and `cfg/train/`. The root keys and their defaults are the
JAX package's (task Cartpole, seed 42, `headless` accepted and ignored),
and `device` (cuda).
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Optional, Sequence

import yaml

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "cfg")


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml_with_defaults(path: str) -> dict:
    """A yaml with `defaults: [Parent, _self_]` inheritance: the parents
    (files beside it) merged in order, then the file's own keys
    (ShadowHandOpenAI_LSTM inherits ShadowHandOpenAI_FF)."""
    d = _load_yaml(path)
    bases = d.pop("defaults", None)
    if not bases:
        return d
    merged: dict = {}
    for b in bases:
        if b != "_self_":
            merged = _deep_merge(merged, _load_yaml_with_defaults(
                os.path.join(os.path.dirname(path), f"{b}.yaml")))
    return _deep_merge(merged, d)


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        if v.lower() in ("null", "none", ""):
            return None
        return v


def parse_cli(argv: Sequence[str]) -> Dict[str, Any]:
    """key=value args -> {dotted_key: parsed_value}."""
    out: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"arguments must be key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        out[k] = _parse_value(v)
    return out


def _set_dotted(cfg: dict, key: str, value: Any) -> None:
    parts = key.split(".")
    d = cfg
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def load_config(overrides: Optional[Dict[str, Any]] = None) -> dict:
    """Root keys + cfg/task/<T>.yaml + cfg/train/<T>PPO.yaml + CLI
    overrides."""
    overrides = dict(overrides or {})
    root = dict(
        task_name=overrides.pop("task", "Cartpole"),
        num_envs=overrides.pop("num_envs", None),
        seed=overrides.pop("seed", 42),
        test=overrides.pop("test", False),
        checkpoint=overrides.pop("checkpoint", ""),
        max_iterations=overrides.pop("max_iterations", None),
        headless=overrides.pop("headless", True),  # accepted, no-op
        experiment=overrides.pop("experiment", ""),
        device=overrides.pop("device", "cuda"),
    )
    name = root["task_name"]
    task_path = os.path.join(CFG_DIR, "task", f"{name}.yaml")
    train_path = os.path.join(CFG_DIR, "train", f"{name}PPO.yaml")
    cfg = dict(root)
    cfg["task"] = (_load_yaml_with_defaults(task_path)
                   if os.path.exists(task_path) else {})
    cfg["train"] = (_load_yaml_with_defaults(train_path)
                    if os.path.exists(train_path) else {})
    if root["num_envs"]:
        _set_dotted(cfg, "task.env.numEnvs", root["num_envs"])
    for k, v in overrides.items():
        _set_dotted(cfg, k, v)
    return cfg


def ppo_config_kwargs(train_cfg: dict) -> dict:
    """Map a train yaml (params.network / params.config, cfg/train/*PPO.yaml)
    onto PPOConfig kwargs."""
    params = train_cfg.get("params", {})
    net = params.get("network", {})
    c = params.get("config", {})
    mlp = net.get("mlp", net)
    sigma_init = (
        net.get("space", {}).get("continuous", {}).get("sigma_init", {})
    )
    kw = dict(
        units=tuple(mlp.get("units", (256, 128, 64))),
        activation=mlp.get("activation", "elu"),
        sigma_init=float(sigma_init.get("val", 0.0))
        if isinstance(sigma_init, dict) else 0.0,
        horizon_length=c.get("horizon_length", 16),
        minibatch_size=c.get("minibatch_size", 8192),
        mini_epochs=c.get("mini_epochs", 4),
        gamma=c.get("gamma", 0.99),
        tau=c.get("tau", 0.95),
        learning_rate=float(c.get("learning_rate", 3e-4)),
        lr_schedule=c.get("lr_schedule", "adaptive"),
        schedule_type=c.get("schedule_type", "legacy"),
        actor_aux_value_loss=c.get("actor_aux_value_loss", False),
        kl_threshold=float(c.get("kl_threshold", 0.008)),
        e_clip=c.get("e_clip", 0.2),
        clip_value=c.get("clip_value", True),
        critic_coef=c.get("critic_coef", 2.0),
        entropy_coef=c.get("entropy_coef", 0.0),
        bounds_loss_coef=float(c.get("bounds_loss_coef", 1e-4)),
        grad_norm=c.get("grad_norm", 1.0),
        normalize_input=c.get("normalize_input", True),
        normalize_value=c.get("normalize_value", True),
        normalize_advantage=c.get("normalize_advantage", True),
        reward_shaper_scale=float(
            c.get("reward_shaper", {}).get("scale_value", 1.0)
        ),
        value_bootstrap=c.get("value_bootstrap", False),
        mixed_precision=c.get("mixed_precision", False),
        max_epochs=c.get("max_epochs", 100),
    )
    # the port's own key (no yaml sets it): the networks' matmul rule
    if "net_matmul" in c:
        kw["net_matmul"] = str(c["net_matmul"])
    # an asymmetric central value with its own optimizer schedule
    cv = c.get("central_value_config")
    if cv:
        cv_net = cv.get("network", {})
        cv_mlp = cv_net.get("mlp", {})
        kw["central_value"] = True
        kw["cv_units"] = tuple(cv_mlp.get("units", (512, 512, 256, 128)))
        kw["cv_activation"] = cv_mlp.get("activation", "elu")
        kw["cv_minibatch_size"] = cv.get(
            "minibatch_size", c.get("minibatch_size", 8192)
        )
        kw["cv_mini_epochs"] = cv.get("mini_epochs", 8)
        kw["cv_learning_rate"] = float(cv.get("learning_rate", 5e-4))
        cv_rnn = cv_net.get("rnn", {})
        if cv_rnn:
            kw["cv_rnn"] = cv_rnn.get("name", "lstm")
            kw["cv_rnn_units"] = cv_rnn.get("units", 1024)
    # a recurrent policy (rl_games rnn block under network)
    rnn = net.get("rnn", {})
    if rnn:
        kw["rnn"] = rnn.get("name", "lstm")
        kw["rnn_units"] = rnn.get("units", 1024)
        kw["seq_len"] = c.get("seq_len", c.get("seq_length", 4))
    return kw
