"""AnymalTerrain demo: a scripted command sequence over rough terrain,
recorded to .npz (PyTorch port of the JAX package's
`demos/anymal_terrain.py`).

Four robots are driven through a timed velocity-command script (the
reference demo's W/A/S/D bindings); env 0's joint coordinates are recorded
for offline viewing.

Usage:
    python -m omniisaacgymenvs_torch.demos.anymal_terrain \
        [checkpoint=runs/AnymalTerrain/nn/best] [out=anymal_demo.npz] [device=cpu]

Runs on CUDA unless device=cpu is given.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from omniisaacgymenvs_torch.demos.interactive import demo_step
from omniisaacgymenvs_torch.scripts.train import build_trainer
from omniisaacgymenvs_torch.utils.config import parse_cli

# the reference demo's key bindings as a timed command script:
# (seconds, [vx, vy, yaw_rate]) — forward, turn left, forward, turn right...
COMMAND_SCRIPT = [
    (3.0, [1.0, 0.0, 0.0]),    # UP: forward
    (2.0, [0.0, 0.0, 1.0]),    # LEFT: spin left
    (3.0, [1.0, 0.0, 0.0]),
    (2.0, [0.0, 0.0, -1.0]),   # RIGHT: spin right
    (2.0, [-1.0, 0.0, 0.0]),   # DOWN: backward
    (2.0, [0.0, 0.0, 0.0]),    # stop
]
DEMO_ENVS = 4


def main(argv=None) -> dict:
    """Run the script and write the .npz; returns {"out", "steps",
    "displacement", "task"}."""
    overrides = parse_cli(sys.argv[1:] if argv is None else argv)
    out = overrides.pop("out", "anymal_demo.npz")
    overrides.update(task="AnymalTerrain", num_envs=DEMO_ENVS, test=True)
    _, task, trainer = build_trainer([f"{k}={v}" for k, v in overrides.items()])
    env = trainer.env
    es = env.reset(seed=0)
    dt = task.dt
    traj, commands = [], []
    for seconds, cmd in COMMAND_SCRIPT:
        command = torch.tensor(cmd, dtype=torch.float32)
        for _ in range(int(seconds / dt)):
            es = demo_step(trainer, env, es, command)
            traj.append(es.phys.q[0])
            commands.append(cmd)
    traj = torch.stack(traj).cpu().numpy()
    np.savez(out, q=traj, commands=np.asarray(commands),
             dof_names=np.asarray(task.model.dof_names))
    d = float(np.linalg.norm(traj[-1, 0:2] - traj[0, 0:2]))
    print(
        f"demo: {len(traj)} steps recorded to {out}; net base displacement "
        f"{d:.2f} m, final height {traj[-1, 2]:.2f} m"
    )
    return dict(out=out, steps=len(traj), displacement=d, task=task)


if __name__ == "__main__":
    main()
