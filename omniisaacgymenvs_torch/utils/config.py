"""Config system: YAML task configs + dotted CLI overrides (the part of the
JAX package's `utils/config.py` that `load_config` / `parse_cli` need).

`task=Humanoid num_envs=4096 task.env.episodeLength=500 device=cpu`.
Task yamls are read from this package's own `cfg/task/`.
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
    """Root keys + cfg/task/<T>.yaml + CLI overrides."""
    overrides = dict(overrides or {})
    root = dict(
        task_name=overrides.pop("task", "Humanoid"),
        num_envs=overrides.pop("num_envs", None),
        seed=overrides.pop("seed", 42),
        max_iterations=overrides.pop("max_iterations", None),
        device=overrides.pop("device", "cuda"),
    )
    task_path = os.path.join(CFG_DIR, "task", f"{root['task_name']}.yaml")
    cfg = dict(root)
    cfg["task"] = (_load_yaml_with_defaults(task_path)
                   if os.path.exists(task_path) else {})
    if root["num_envs"]:
        _set_dotted(cfg, "task.env.numEnvs", root["num_envs"])
    for k, v in overrides.items():
        _set_dotted(cfg, k, v)
    return cfg
