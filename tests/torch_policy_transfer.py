"""A policy the JAX package trained, evaluated in both packages' envs on
the CPU: the JAX checkpoint's networks and norms are loaded into the JAX
trainer and, through `convert.py`, into the port's; each package's
`scripts/train.evaluate` then runs the deterministic policy from a reset.
The two envs draw their own random numbers, so their episodes differ; a
policy that scores alike in both says the envs agree where it acts, and a
lower score in one says that env differs.

    python tests/torch_policy_transfer.py [task=ShadowHand] \
        [checkpoint=results/ShadowHand/nn-best] [num_envs=128] [steps=601]
    python tests/torch_policy_transfer.py only=port [seed=123] [num_envs=1024] \
        [checkpoint=results_torch/ShadowHand_jax_final]

`port_checkpoint=DIR` goes the other way: the policy is a port checkpoint's
(its `model.pt`), carried into the JAX trainer (flax kernels are the
weights transposed), and both packages evaluate it, e.g. a policy the port
trained on the card, for a task with no JAX checkpoint (AllegroHand).

`only=port` evaluates the port alone (no JAX), from the JAX policy carried
into a port checkpoint (tests/torch_jax_checkpoint.py), its envs reset from
`seed` (the JAX evaluation's is 123): the spread of a few seeds is the
band `chip_smoke.py` holds the same evaluation on the card to.

Prints one JSON object: each package's mean episode reward, finished
episodes and task statistics. For a task that counts successes, the
statistics add the episodes that ended (`episodes_ended`) and the sum of
their successes (`their_successes`): their ratio is the mean successes of
a finished episode, which the consecutive-success average (an average
over the steps where episodes ended, each weighted by 0.1 against the
ones before) follows only loosely.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the port's networks compute in exact f32, as the JAX package's do on the CPU
F32 = "train.params.config.net_matmul=f32"
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _stats(printed: str) -> dict:
    """The `eval: <key> = <value>` lines evaluate printed."""
    out = {}
    for line in printed.splitlines():
        if line.startswith("eval: ") and " = " in line:
            k, v = line[len("eval: "):].split(" = ", 1)
            out[k] = float(v)
    return out


def count_episodes(task, xp):
    """Wrap `task`'s episode statistics (xp: jax.numpy or torch) with the
    episodes that ended and their successes summed."""
    init, update = task.episode_stats_init, task.episode_stats_update
    if "consecutive_successes" not in init():
        return

    def init_():
        return dict(init(), episodes_ended=xp.zeros(()), their_successes=xp.zeros(()))

    def update_(stats, es):
        ended = es.done * 1.0
        return dict(update(stats, es), episodes_ended=stats["episodes_ended"] + ended.sum(),
                    their_successes=stats["their_successes"]
                    + (es.metrics["successes"] * ended).sum())

    task.episode_stats_init, task.episode_stats_update = init_, update_


def jax_state_from_port(tr, jtr) -> dict:
    """The port trainer `tr`'s actor-critic and norms as fields of the JAX
    trainer `jtr`'s state (a feed-forward actor-critic)."""
    import jax.numpy as jnp
    import numpy as np

    p = {k: v.detach().cpu().numpy() for k, v in tr.state.ac.named_parameters()}
    n_trunk = len(tr.state.ac.trunk.layers)
    names = [f"trunk.layers.{i}" for i in range(n_trunk)] + ["mu", "value"]
    flax = {f"Dense_{i}": {"kernel": jnp.asarray(p[f"{k}.weight"].T),
                           "bias": jnp.asarray(p[f"{k}.bias"])}
            for i, k in enumerate(names)}
    flax["log_std"] = jnp.asarray(p["log_std"])
    params = dict(jtr.state.params, ac={"params": flax})
    out = dict(params=params)
    for name in ("obs_norm", "value_norm", "states_norm"):
        tn, jn = getattr(tr.state, name), getattr(jtr.state, name)
        out[name] = jn.replace(**{f: jnp.asarray(np.asarray(getattr(tn, f).cpu()))
                                  for f in ("mean", "var", "count")})
    return out


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    task = args.get("task", "ShadowHand")
    n, steps = int(args.get("num_envs", 128)), int(args.get("steps", 601))
    seed = int(args.get("seed", 123))

    import torch

    from omniisaacgymenvs_torch.scripts import train as ttrain

    if args.get("only") == "port":
        ckpt = args.get("checkpoint", f"results_torch/{task}_jax_final")
        _, _, tr = ttrain.build_trainer([f"task={task}", f"num_envs={n}", "device=cpu",
                                         "test=True", f"checkpoint={os.path.join(ROOT, ckpt)}",
                                         F32])
        count_episodes(tr.env.task, torch)
        lines = []
        tret, tn = ttrain.evaluate(tr, steps=steps, log_fn=lines.append, seed=seed)
        print(json.dumps(dict(task=task, checkpoint=ckpt, num_envs=n, steps=steps, seed=seed,
                              port=dict(mean_episode_reward=tret, episodes=tn,
                                        **_stats("\n".join(lines))))))
        return 0
    ckpt = os.path.join(ROOT, args.get("checkpoint", f"results/{task}/nn-best"))

    import jax.numpy as jnp
    import numpy as np

    from omniisaacgymenvs_torch import convert
    from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
    from omniisaacgymenvs_tpu.learn import PPOConfig, PPOTrainer
    from omniisaacgymenvs_tpu.scripts import train as jtrain
    from omniisaacgymenvs_tpu.scripts.common import build_env_from_cli
    from omniisaacgymenvs_tpu.utils.config import ppo_config_kwargs
    from torch_parity import to_numpy_tree

    cfg, _, env = build_env_from_cli([f"task={task}", f"num_envs={n}", "pipeline=cpu",
                                      "test=True"])
    jtr = PPOTrainer(env, PPOConfig(**ppo_config_kwargs(cfg["train"])),
                     seed=int(cfg["seed"]))
    if args.get("port_checkpoint"):
        ckpt = os.path.join(ROOT, args["port_checkpoint"])
        _, _, src = ttrain.build_trainer([f"task={task}", "num_envs=8", "device=cpu",
                                          "test=True", f"checkpoint={ckpt}"])
        jtr.state = jtr.state.replace(**jax_state_from_port(src, jtr))
    else:
        jtr.load(ckpt)
    count_episodes(env.task, jnp)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jret, jn = jtrain.evaluate(jtr, steps=steps)
    out = dict(task=task, checkpoint=os.path.relpath(ckpt, ROOT), num_envs=n, steps=steps,
               jax=dict(mean_episode_reward=jret, episodes=jn, **_stats(buf.getvalue())))

    _, _, tr = ttrain.build_trainer([f"task={task}", f"num_envs={n}", "device=cpu",
                                     "test=True", F32])
    count_episodes(tr.env.task, torch)
    convert.actor_critic_from_arrays(to_numpy_tree(jtr.state.params["ac"]), tr.state.ac)
    for name in ("obs_norm", "value_norm", "states_norm"):
        jn_ = getattr(jtr.state, name)
        setattr(tr.state, name, RunningNorm(
            *(torch.as_tensor(np.array(getattr(jn_, f)))
              for f in ("mean", "var", "count"))))
    lines = []
    tret, tn = ttrain.evaluate(tr, steps=steps, log_fn=lines.append, seed=seed)
    out["port"] = dict(mean_episode_reward=tret, episodes=tn, **_stats("\n".join(lines)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
