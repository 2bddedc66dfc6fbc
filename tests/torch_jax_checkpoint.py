"""Carry the JAX package's trained state into a port checkpoint, on the CPU:
the JAX trainer's `load` reads an orbax checkpoint (networks, Adam state,
running norms, learning rate, epoch); `carry_state` sets a port trainer of
the same task to it through `convert.py`, and the port's `model.pt` is
written in the format of `PPOTrainer._main_tree`, with no `env.pt`
sidecar (a run from it starts its envs fresh at the checkpoint's epoch).
`carry_state_to_jax` goes the other way: a port trainer's state (a port
`model.pt` read through the CLI's `checkpoint=`) into a JAX trainer of the
same task, so that both learners start from a state the port trained.
The JAX ShadowHand run's latest state is its `nn-best`: epoch 9980 of
10,000 (Adam count 199,600); its `nn-last` is an epoch-100 state of
another run (lr 1.73e-4, where the run's history reads 2.60e-4).

    python tests/torch_jax_checkpoint.py [task=ShadowHand] \
        [checkpoint=results/ShadowHand/nn-best] \
        [out=results_torch/ShadowHand_jax_final]

The port trains from the written directory as from its own checkpoints
(`scripts/train.py checkpoint=DIR`, or a campaign whose `nn/last` it is);
a trainer of another width refuses it (`CheckpointMismatch`). Prints one
JSON object: the file, its epoch, learning rate and Adam step count.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def jax_trainer(task: str, num_envs: int, checkpoint=None, overrides=()):
    """The JAX package's trainer of `task` under its train yaml on the CPU,
    loaded from `checkpoint` (relative to the repo) where one is given."""
    from omniisaacgymenvs_tpu.learn import PPOConfig, PPOTrainer
    from omniisaacgymenvs_tpu.scripts.common import build_env_from_cli
    from omniisaacgymenvs_tpu.utils.config import ppo_config_kwargs

    cfg, _, env = build_env_from_cli([f"task={task}", f"num_envs={num_envs}",
                                      "pipeline=cpu", *overrides])
    jtr = PPOTrainer(env, PPOConfig(**ppo_config_kwargs(cfg["train"])),
                     seed=int(cfg["seed"]))
    if checkpoint:
        jtr.load(os.path.join(ROOT, checkpoint))
    return jtr


def carry_state(jtr, tr):
    """The port trainer `tr`'s networks, Adam state, norms, learning rate
    and epoch set to the JAX trainer `jtr`'s (an actor-critic without a
    central value)."""
    import numpy as np
    import torch

    from omniisaacgymenvs_torch import convert
    from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
    from torch_parity import to_numpy_tree

    if tr.use_cv or tr.is_rnn:
        raise ValueError("only a feed-forward actor-critic without a central "
                         "value is carried")
    js, ts = jtr.state, tr.state
    convert.actor_critic_from_arrays(to_numpy_tree(js.params["ac"]), ts.ac)
    adam = js.opt_state[1]
    ts.opt_state = convert.adam_state_from_arrays(
        to_numpy_tree(adam.mu["ac"]), to_numpy_tree(adam.nu["ac"]),
        np.asarray(adam.count), ts.ac)
    for name in ("obs_norm", "value_norm", "states_norm"):
        jn = getattr(js, name)
        setattr(ts, name, RunningNorm(
            *(torch.as_tensor(np.array(getattr(jn, f)), device=tr.device)
              for f in ("mean", "var", "count"))))
    ts.lr = torch.tensor(float(np.asarray(js.lr)), device=tr.device)
    ts.epoch = int(np.asarray(js.epoch))


def carry_state_to_jax(tr, jtr):
    """The way back: the JAX trainer `jtr`'s networks, Adam state (both
    moments and the count), norms, learning rate and epoch set to the port
    trainer `tr`'s (a feed-forward actor-critic without a central value;
    `tr` holds, say, a port `model.pt` read through the CLI's
    `checkpoint=`). The JAX trainer keeps its own env state and key."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from omniisaacgymenvs_torch import convert
    from omniisaacgymenvs_tpu.learn.running_norm import RunningNorm as JNorm
    from torch_parity import np_

    if tr.use_cv or tr.is_rnn:
        raise ValueError("only a feed-forward actor-critic without a central "
                         "value is carried")
    ts, js = tr.state, jtr.state
    names = [k for k, _ in ts.ac.named_parameters()]

    def tree(tensors):
        return {"ac": jax.tree.map(jnp.asarray, convert.actor_critic_tree(
            {k: np_(t) for k, t in zip(names, tensors)}, ts.ac))}

    st = ts.opt_state
    count = float(st.count)
    if count != int(count):
        raise ValueError(f"Adam's count {count} is not a whole number of steps")
    adam = js.opt_state[1]._replace(
        count=jnp.asarray(int(count), js.opt_state[1].count.dtype),
        mu=tree(st.mu), nu=tree(st.nu))
    norms = {name: JNorm(*(jnp.asarray(np_(getattr(getattr(ts, name), f)))
                           for f in ("mean", "var", "count")))
             for name in ("obs_norm", "value_norm", "states_norm")}
    jtr.state = js.replace(
        params=tree([p for _, p in ts.ac.named_parameters()]),
        opt_state=(js.opt_state[0], adam, *js.opt_state[2:]),
        lr=jnp.asarray(np.float32(np_(ts.lr))),
        epoch=jnp.asarray(ts.epoch, js.epoch.dtype), **norms)


def write_main_file(tr, out_dir: str) -> str:
    """`tr`'s main checkpoint file alone, as `PPOTrainer.save` writes it."""
    from omniisaacgymenvs_torch.learn import ppo

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ppo.MAIN_FILE)
    ppo._save_atomic(ppo._flatten(tr._main_tree()), path)
    return path


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    task = args.get("task", "ShadowHand")
    ckpt = args.get("checkpoint", f"results/{task}/nn-best")
    out = os.path.join(ROOT, args.get("out", f"results_torch/{task}_jax_final"))

    from omniisaacgymenvs_torch.scripts import train as ttrain

    # the norms, networks and optimizer do not depend on the env count
    jtr = jax_trainer(task, 64, ckpt)
    _, _, tr = ttrain.build_trainer([f"task={task}", "num_envs=64", "device=cpu"])
    carry_state(jtr, tr)
    path = write_main_file(tr, out)
    print(json.dumps(dict(file=os.path.relpath(path, ROOT), task=task,
                          checkpoint=ckpt, epoch=tr.state.epoch,
                          lr=float(tr.state.lr),
                          adam_count=float(tr.state.opt_state.count))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
