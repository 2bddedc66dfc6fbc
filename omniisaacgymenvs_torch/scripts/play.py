"""Play a trained policy: `test=True` with a checkpoint.

    python -m omniisaacgymenvs_torch.scripts.play task=Ant \
        checkpoint=runs/Ant/nn/best [record=traj.npz] [max_iterations=500] \
        [device=cpu]

Without `record`, evaluates the mean action over `max_iterations` steps
(500 by default) and prints the mean episode reward. With
`record=<path>.npz`, steps the mean action from a fresh reset and writes
env 0's joint coordinates `q`, world body positions `body_pos` and
`rewards` per step, with the model's `parents`, `body_names`,
`dof_names` and the `task` name, for offline viewing. Runs on CUDA unless
device=cpu is given.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from omniisaacgymenvs_torch.learn.ppo import reset_where_done
from omniisaacgymenvs_torch.scripts.train import build_trainer, evaluate
from omniisaacgymenvs_torch.utils.config import parse_cli


@torch.no_grad()
def record_rollout(trainer, steps: int, seed: int):
    """env 0's (q, body_pos, reward) over `steps` mean-action steps from a
    fresh reset, as numpy arrays (steps, ...)."""
    env, ts = trainer.env, trainer.state
    es = env.reset(seed=seed)
    hidden, cv_hidden = ts.hidden, ts.cv_hidden
    qs, body_pos, rews = [], [], []
    for _ in range(steps):
        mu, _, _, hidden, cv_hidden = trainer._policy(ts, es.obs, es.states,
                                                      hidden, cv_hidden)
        es = env.step(es, mu.clamp(-1.0, 1.0))
        if trainer.is_rnn:
            hidden = reset_where_done(hidden, es.done)
            cv_hidden = reset_where_done(cv_hidden, es.done)
        qs.append(es.phys.q[0])
        body_pos.append(es.phys.body_pos[0])
        rews.append(es.reward[0])
    return tuple(torch.stack(x).cpu().numpy() for x in (qs, body_pos, rews))


def main(argv=None):
    overrides = parse_cli(sys.argv[1:] if argv is None else argv)
    record = overrides.pop("record", None)
    overrides["test"] = True
    cfg, task, trainer = build_trainer([f"{k}={v}" for k, v in overrides.items()])
    if not cfg.get("checkpoint"):
        print("no checkpoint given: playing the untrained policy")
    steps = int(cfg.get("max_iterations") or 500)
    if not record:
        mean_ret, n = evaluate(trainer, steps=steps)
        print(f"eval: mean episode reward {mean_ret:.2f} over {n} episodes")
        return mean_ret, n
    q, body_pos, rews = record_rollout(trainer, steps, int(cfg["seed"]))
    m = task.model
    np.savez(record, q=q, body_pos=body_pos, parents=np.asarray(m.parents),
             rewards=rews, task=np.asarray(cfg["task_name"]),
             body_names=np.asarray(m.body_names), dof_names=np.asarray(m.dof_names))
    print(f"recorded {steps} steps of env 0 to {record} (mean reward "
          f"{float(np.mean(rews)):.3f})")
    return record


if __name__ == "__main__":
    main()
