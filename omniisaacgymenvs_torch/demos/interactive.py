"""Interactive terminal demo: drive a trained Anymal with the keyboard
(PyTorch port of the JAX package's `demos/interactive.py`).

WASD sets the velocity command fed to the policy each control step, and an
ANSI top-down map (robot trail, heading arrow, telemetry) is redrawn in
place, so the robot is driven live rather than scripted.

Keys: w/s forward/backward, a/d yaw left/right (steps of 0.1, clamped to
+-1), x stop, q quit.

Usage:
    python -m omniisaacgymenvs_torch.demos.interactive \
        [task=Anymal|AnymalTerrain] [checkpoint=runs/Anymal/nn/best] \
        [steps=2000] [device=cpu]

`selftest=1` replays a fixed key script without a tty (used by tests and
headless smoke runs) and prints `selftest ok: <n> steps, displacement <d>
m` and the base's height over the script. The checkpoint loads as
scripts/play.py loads it (the main file only). Runs on CUDA unless
device=cpu is given.
"""

from __future__ import annotations

import dataclasses
import select
import sys
import time

import numpy as np
import torch

from omniisaacgymenvs_torch.scripts.train import build_trainer
from omniisaacgymenvs_torch.utils.config import parse_cli

W, H = 49, 21                    # map cells (odd: robot-centered)
SCALE = 0.35                     # metres per cell
HEADING = "→↗↑↖←↙↓↘"             # arrow per 45° of yaw
# selftest: (key, control steps it is pressed)
SELFTEST_SCRIPT = [("w", 40), ("a", 40), ("w", 40), ("d", 40), ("x", 40)]
TRAIL = 400                      # base positions kept for the map


class _RawKeys:
    """Nonblocking single-key reads from a raw tty."""

    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def poll(self):
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return keys


class _NoTty:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def poll(self):
        return []


def _draw(base_xy, yaw, trail, cmd, height, vel, step_i, hz):
    grid = [[" "] * W for _ in range(H)]
    cx, cy = W // 2, H // 2
    for tx, ty in trail:
        dx = int(round((tx - base_xy[0]) / SCALE))
        dy = int(round((ty - base_xy[1]) / SCALE))
        if abs(dx) < cx and abs(dy) < cy:
            grid[cy - dy][cx + dx] = "·"
    grid[cy][cx] = HEADING[int(((yaw + np.pi / 8) % (2 * np.pi)) // (np.pi / 4)) % 8]
    border = "+" + "-" * W + "+"
    rows = [border] + ["|" + "".join(r) + "|" for r in grid] + [border]
    status = (
        f" cmd vx={cmd[0]:+.1f} yaw={cmd[2]:+.1f} | "
        f"h={height:.2f} m  v={vel:.2f} m/s | step {step_i} @ {hz:.0f} Hz "
        f"| w/s a/d x q"
    )
    sys.stdout.write("\x1b[H\x1b[J" + "\n".join(rows) + "\n" + status + "\n")
    sys.stdout.flush()


def apply_keys(cmd: np.ndarray, pressed) -> bool:
    """Apply key presses to the command [vx, vy, yaw] in place; False on q
    (quit)."""
    for k in pressed:
        if k == "w":
            cmd[0] = min(1.0, cmd[0] + 0.1)
        elif k == "s":
            cmd[0] = max(-1.0, cmd[0] - 0.1)
        elif k == "a":
            cmd[2] = min(1.0, cmd[2] + 0.1)
        elif k == "d":
            cmd[2] = max(-1.0, cmd[2] - 0.1)
        elif k == "x":
            cmd[:] = 0.0
        elif k == "q":
            return False
    return True


def pin_commands(commands: torch.Tensor, command: torch.Tensor) -> torch.Tensor:
    """A new (N, w) command block holding `command` [vx, vy, yaw] in every
    env: Anymal's [vx, vy, yaw_rate] (w 3), AnymalTerrain's [vx, vy, 0,
    heading] (w 4: the task computes the yaw rate from the heading)."""
    command = command.to(commands.device, commands.dtype)
    w = commands.shape[1]
    if w == 4:
        full = torch.cat([command[:2], command.new_zeros(1), command[2:3]])
    else:
        full = command[:w]
    return full.expand(commands.shape).clone()


@torch.no_grad()
def demo_step(trainer, env, es, command: torch.Tensor):
    """One control step under a keyboard command: `command` [vx, vy, yaw]
    pinned into every env's carry (it overrides the task's command
    sampler), then the policy's mean action, clipped to [-1, 1]. Returns the
    next EnvState; `es` and its carry are not written."""
    carry = dict(es.carry)
    if "commands" in carry:
        carry["commands"] = pin_commands(carry["commands"], command)
    es = dataclasses.replace(es, carry=carry)
    mu, *_ = trainer._policy(trainer.state, es.obs, es.states)
    return env.step(es, mu.clamp(-1.0, 1.0))


def drive(trainer, env, es, keys, max_steps: int, selftest: bool = False):
    """The demo loop over at most `max_steps` control steps, the keys read
    from `keys.poll()` (or the selftest script). Returns (final state, the
    base's xy trail, its height at each step)."""
    cmd = np.zeros(3, np.float32)
    trail: list = []
    heights: list = []
    script = iter(SELFTEST_SCRIPT if selftest else [])
    pending = next(script, None)
    t0 = time.time()
    for i in range(max_steps):
        if selftest:
            if pending is None:
                break
            k, left = pending
            pressed = [k]
            pending = (k, left - 1) if left > 1 else next(script, None)
        else:
            pressed = keys.poll()
        if not apply_keys(cmd, pressed):
            break
        es = demo_step(trainer, env, es, torch.as_tensor(cmd))
        q = es.phys.q[0].cpu().numpy()
        quat = es.phys.body_quat[0, 0].cpu().numpy()
        # yaw from base quaternion (wxyz)
        yaw = np.arctan2(
            2 * (quat[0] * quat[3] + quat[1] * quat[2]),
            1 - 2 * (quat[2] ** 2 + quat[3] ** 2),
        )
        trail.append((float(q[0]), float(q[1])))
        trail = trail[-TRAIL:]
        heights.append(float(q[2]))
        if i % 2 == 0 and not selftest:
            vel = float(torch.linalg.norm(es.phys.body_lvel[0, 0, :2]))
            _draw(q[:2], yaw, trail, cmd, float(q[2]), vel, i,
                  (i + 1) / (time.time() - t0))
    return es, trail, heights


def main(argv=None) -> dict:
    """Run the demo; returns {"steps", "displacement" (m, the trail's first
    to last point), "heights" (base z per step), "state", "task"}."""
    overrides = parse_cli(sys.argv[1:] if argv is None else argv)
    selftest = bool(int(overrides.pop("selftest", 0)))
    max_steps = int(overrides.pop("steps", 2000))
    overrides.setdefault("task", "Anymal")
    overrides.setdefault("num_envs", 1)
    overrides["test"] = True
    _, task, trainer = build_trainer([f"{k}={v}" for k, v in overrides.items()])
    env = trainer.env
    es = env.reset(seed=0)
    with (_RawKeys() if not selftest else _NoTty()) as keys:
        es, trail, heights = drive(trainer, env, es, keys, max_steps, selftest)
    d = (float(np.linalg.norm(np.asarray(trail[-1]) - np.asarray(trail[0])))
         if trail else 0.0)
    if selftest:
        print(f"selftest ok: {len(trail)} steps, displacement {d:.2f} m")
        if heights:
            print(f"base height over the script: min {min(heights):.3f} m, mean "
                  f"{np.mean(heights):.3f} m, final {heights[-1]:.3f} m")
    return dict(steps=len(heights), displacement=d, heights=heights, state=es,
                task=task)


if __name__ == "__main__":
    main()
