"""Metrics writers and the episode-stats observer (PyTorch port of the JAX
package's `utils/metrics.py`).

The writer is TensorBoard's SummaryWriter where it imports, else a JSONL
file; W&B is off unless `wandb_activate` is set and the module imports.
Under a process group only rank 0 logs: the other ranks get a writer that
writes nothing, no W&B run, and `log` prints nothing there.
"""

from __future__ import annotations

import json
import os
import time

from omniisaacgymenvs_torch.parallel import mesh


def log(*args):
    """print, flushed, on rank 0 only."""
    if mesh.is_main():
        print(*args, flush=True)


class NullWriter:
    """The writer of a rank other than 0."""

    def add_scalar(self, tag: str, value, step):
        pass

    def close(self):
        pass


class JsonlWriter:
    """Fallback writer: one JSON line per scalar."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "ts": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def make_writer(logdir: str):
    """TensorBoard SummaryWriter if it imports, else JSONL; a NullWriter on
    a rank other than 0."""
    if not mesh.is_main():
        return NullWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return JsonlWriter(logdir)
    return SummaryWriter(log_dir=logdir)


def maybe_init_wandb(cfg: dict):
    """W&B run if `wandb_activate` is set and wandb imports (rank 0 only),
    else None."""
    if not cfg.get("wandb_activate", False) or not mesh.is_main():
        return None
    try:
        import wandb
    except ImportError:
        print("wandb not installed; skipping W&B logging")
        return None
    return wandb.init(
        project=cfg.get("wandb_project", "omniisaacgymenvs_torch"),
        group=cfg.get("wandb_group", ""),
        entity=cfg.get("wandb_entity", None),
        config=cfg,
        sync_tensorboard=True,
        name=cfg.get("experiment") or cfg.get("task_name", "run"),
        resume="allow",
    )


class EpisodeObserver:
    """Per-env task metrics (EnvState.metrics) to the writer as
    `Episode/<key>` means."""

    def __init__(self, writer):
        self.writer = writer

    def log(self, task_metrics: dict, step: int):
        for k, v in task_metrics.items():
            tag = k if "/" in k else f"Episode/{k}"
            self.writer.add_scalar(tag, float(v), step)
