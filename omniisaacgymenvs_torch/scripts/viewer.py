"""Offline trajectory viewer: render a `play.py record=...` .npz to a GIF
(the port's own copy of the JAX package's `scripts/viewer.py`).

The recorded world body positions are drawn as a 3D stick figure
(parent -> child segments of the kinematic tree) animated over the rollout,
with a follow camera. Host-only: it touches no device, and matplotlib is
imported inside `render` only.

Usage:
    python -m omniisaacgymenvs_torch.scripts.play task=Anymal \
        checkpoint=runs/Anymal/nn/best record=traj.npz
    python -m omniisaacgymenvs_torch.scripts.viewer traj.npz out.gif \
        [fps=25] [stride=2] [elev=20] [azim=45]
"""

from __future__ import annotations

import sys

import numpy as np


def render(npz_path: str, out_path: str, fps: int = 25, stride: int = 2,
           elev: float = 20.0, azim: float = 45.0):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    data = np.load(npz_path, allow_pickle=False)
    if "body_pos" not in data:
        raise SystemExit(
            f"{npz_path} has no body_pos — re-record with the current "
            "play.py (older recordings stored joint coords only)"
        )
    pos = data["body_pos"][::stride]          # (T, nb, 3)
    parents = data["parents"]                 # (nb,)
    task = str(data["task"]) if "task" in data else "?"
    rews = data["rewards"][::stride]
    T, nb, _ = pos.shape

    fig = plt.figure(figsize=(4.5, 4.5))
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))

    # follow camera (reference demo's camera tracks the selected robot):
    # a fixed-size cube sized to the BODY extent, re-centered each frame on
    # the smoothed base position — a locomoting robot stays in frame
    # instead of shrinking to a dot inside its whole-trajectory bounds
    ext = pos - pos[:, :1]                      # body extent about base
    r = max(0.5, float(np.abs(ext).max()) * 1.6)
    center = pos[:, 0].copy()                   # base trace
    for t in range(1, T):                       # smoothed, lag-clamped
        c = 0.7 * center[t - 1] + 0.3 * pos[t, 0]
        lag = pos[t, 0] - c
        d = float(np.linalg.norm(lag))
        if d > 0.3 * r:                         # never let the body near
            c = pos[t, 0] - lag * (0.3 * r / d)  # the frame edge
        center[t] = c

    def set_cam(t):
        c = center[t]
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[1] - r, c[1] + r)
        ax.set_zlim(max(0.0, c[2] - r), c[2] + r)

    segs = [(int(parents[i]), i) for i in range(nb) if parents[i] >= 0]
    lines = [ax.plot([], [], [], "-", lw=2, color="tab:blue")[0]
             for _ in segs]
    pts = ax.plot([], [], [], "o", ms=3, color="tab:red")[0]
    title = ax.set_title("")

    def frame(t):
        p = pos[t]
        set_cam(t)
        for ln, (a, b) in zip(lines, segs):
            ln.set_data([p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]])
            ln.set_3d_properties([p[a, 2], p[b, 2]])
        pts.set_data(p[:, 0], p[:, 1])
        pts.set_3d_properties(p[:, 2])
        title.set_text(f"{task}  step {t * stride}  r={rews[t]:+.2f}")
        return lines + [pts, title]

    ani = animation.FuncAnimation(fig, frame, frames=T, blit=False)
    ani.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    print(f"wrote {out_path}: {T} frames, {nb} bodies, task={task}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pos_args = [a for a in argv if "=" not in a]
    kw = dict(a.split("=", 1) for a in argv if "=" in a)
    if len(pos_args) < 1:
        raise SystemExit(__doc__)
    npz = pos_args[0]
    out = pos_args[1] if len(pos_args) > 1 else npz.rsplit(".", 1)[0] + ".gif"
    render(
        npz, out,
        fps=int(kw.get("fps", 25)),
        stride=int(kw.get("stride", 2)),
        elev=float(kw.get("elev", 20)),
        azim=float(kw.get("azim", 45)),
    )


if __name__ == "__main__":
    main()
