"""PPO learner on the same device as the simulation (PyTorch port of the JAX
package's `learn/ppo.py`).

An epoch is a rollout of horizon_length control steps through the task's
batched step (K1 once per control step, K2 at each reset merge on CUDA),
GAE, then mini_epochs x minibatch SGD on the trajectory, with the clipped
surrogate, the clipped value loss, the bounds loss, gradient clipping by
global norm, Adam and the adaptive-KL learning rate. The learning rate,
the non-finite-gradient guard and every metric stay on the device; an
epoch's metrics come to the host once, in `train`.

The recurrent learner (`rnn="lstm"`, and `cv_rnn="lstm"` for the central
value) carries each env's LSTM state through the rollout, zeroes it where
an episode ends, and stores it only at the start of each chunk of seq_len
steps; its SGD replays (N * horizon / seq_len) sequences of seq_len steps
from those states through `LSTMCore.seq`, with the same resets.

Random draws (action noise, minibatch permutations) come from one
`torch.Generator` on the device, seeded from `seed`. `_rollout` takes an
optional `noise` (T, N, A) and `_update` / `_cv_update` an optional
`perms` (mini_epochs, num_slices), so that a test can hand in the JAX
learner's draws.

Checkpoints (`save` / `load`) are directories: `model.pt` holds the
networks, both Adam states, the running norms, the learning rate and the
epoch; `env.pt`, the sidecar, holds what a resume needs to continue
rather than restart: the env state, the LSTM states, the episode counters
and means, the task's statistics, the states of both random generators,
and the epoch it belongs to. Both are flat dicts of tensors and numbers
under dotted leaf paths, read with `torch.load(weights_only=True)` onto the
trainer's device, so a checkpoint written on the card loads on the CPU and
the other way round.

Under a process group of W ranks (`parallel/mesh.py`, one process per GPU)
each rank rolls out its own envs and holds the whole learner, its initial
parameters broadcast from rank 0. Every reduction over the env axis is
global: the window's episode sums, the norms' moments, the advantages'
mean and deviation, the metrics. A minibatch is rank-local: each rank
permutes its own rows with its own generator (seeded from (seed, rank))
and takes minibatch_size / W of them; the ranks' gradients and loss terms
are averaged before the clipping and Adam, so every rank takes the same
step, the step the 1-rank learner takes on the union of the ranks'
minibatches. Only rank 0 writes files: `model.pt` as at one rank, and
`env.pt` with the per-env state gathered along the env axis, every rank's
generator states and the world size, which a resume must share.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from omniisaacgymenvs_torch.learn.networks import (
    ActorCritic,
    CentralValue,
    LSTMActorCritic,
    LSTMCentralValue,
    _check_matmul,
    gaussian_entropy,
    gaussian_kl,
    gaussian_logprob,
)
from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
from omniisaacgymenvs_torch.parallel import mesh

# `train(profile_dir=...)` skips this many epochs (allocation, cuBLAS
# heuristics, the kernels' first builds) before it starts tracing
PROFILE_START = 3
# a checkpoint directory's files
MAIN_FILE, ENV_FILE = "model.pt", "env.pt"
HIDDEN_KEYS = ("hidden_h", "hidden_c", "cv_hidden_h", "cv_hidden_c")
# the sidecar's subtrees with a leading env axis, gathered over the ranks
ENV_AXIS_KEYS = ("es", "hidden", "cv_hidden", "ep_ret", "ep_len")


def _pack_dataset(dataset: Dict[str, torch.Tensor]):
    """Pack a flat f32 dataset of (S,) / (S, D) fields into ONE (S, D_total)
    matrix and an unpack fn, so that a minibatch is one wide-row gather
    instead of one gather per field. Fields go in sorted order; the same
    rows land in the same order, columns are sliced back out."""
    names = sorted(dataset)
    cols, parts, off = {}, [], 0
    for k in names:
        v = dataset[k]
        if v.dtype != torch.float32 or v.ndim > 2:
            raise ValueError(f"field {k}: only flat float32 fields pack")
        v2 = v[:, None] if v.ndim == 1 else v
        cols[k] = (off, off + v2.shape[1], v.ndim == 1)
        off += v2.shape[1]
        parts.append(v2)
    packed = torch.cat(parts, dim=1)

    def unpack(rows):
        return {k: rows[:, a] if was1d else rows[:, a:b]
                for k, (a, b, was1d) in cols.items()}

    return packed, unpack


def _minibatch_taker(dataset: Dict[str, torch.Tensor]) -> Callable:
    """idx -> minibatch: one wide-row gather of the packed dataset where
    every field is flat f32 (the FF path), else one gather per field (the
    recurrent path's (B, seq, ...) fields, bool dones and stored states)."""
    if all(v.dtype == torch.float32 and v.ndim <= 2 for v in dataset.values()):
        packed, unpack = _pack_dataset(dataset)
        return lambda idx: unpack(packed[idx])
    return lambda idx: {k: v[idx] for k, v in dataset.items()}


def reset_where_done(hidden: tuple, done: torch.Tensor) -> tuple:
    """LSTM states zeroed for the envs whose episode just ended."""
    return tuple(torch.where(done[:, None], 0.0, x) for x in hidden)


def _divisor_at_most(size: int, num_slices: int) -> int:
    """The minibatch size: `size` slices, at most num_slices, shrunk to a
    divisor of num_slices."""
    mb = min(size, num_slices)
    while num_slices % mb:
        mb -= 1
    return mb


class CheckpointMismatch(ValueError):
    """A checkpoint leaf that is missing, extra, or of another shape or
    type than the trainer's; the message names its dotted path."""


def _flatten(tree, prefix: str = "", out: Optional[dict] = None) -> dict:
    """A nested tree (dicts, dataclasses, tuples, lists) as {dotted leaf
    path: leaf}; tensors are detached copies, so a view does not drag its
    whole storage into the file. Parameter names keep their dots."""
    out = {} if out is None else out
    join = lambda k: f"{prefix}.{k}" if prefix else str(k)  # noqa: E731
    leaf = isinstance(tree, (torch.Tensor, bool, int, float))
    if leaf and prefix in out:
        raise ValueError(f"two leaves at {prefix!r}")
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().clone()
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), join(f.name), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, join(k), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, join(i), out)
    elif leaf:
        out[prefix] = tree
    else:
        raise TypeError(f"{prefix}: cannot checkpoint a {type(tree).__name__}")
    return out


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{x.dtype} {tuple(x.shape)}"
    return type(x).__name__


def _restore_like(template, flat: dict, prefix: str = "", used=None):
    """`template`'s tree with every leaf taken from `flat` (from _flatten)
    and moved to the template leaf's device. Raises CheckpointMismatch
    naming the first leaf, in the template's order, that is missing or
    differs in shape or type; then the first saved leaf left over."""
    top = used is None
    used = set() if top else used
    join = lambda k: f"{prefix}.{k}" if prefix else str(k)  # noqa: E731
    if dataclasses.is_dataclass(template):
        out = dataclasses.replace(template, **{
            f.name: _restore_like(getattr(template, f.name), flat,
                                  join(f.name), used)
            for f in dataclasses.fields(template)})
    elif isinstance(template, dict):
        out = {k: _restore_like(v, flat, join(k), used) for k, v in template.items()}
    elif isinstance(template, (tuple, list)):
        out = type(template)(_restore_like(v, flat, join(i), used)
                             for i, v in enumerate(template))
    else:
        if prefix not in flat:
            raise CheckpointMismatch(
                f"{prefix}: missing from the checkpoint (expected "
                f"{_describe(template)})")
        saved = flat[prefix]
        same = (saved.shape == template.shape and saved.dtype == template.dtype
                if isinstance(template, torch.Tensor) and isinstance(saved, torch.Tensor)
                else type(saved) is type(template))
        if not same:
            raise CheckpointMismatch(f"{prefix}: saved {_describe(saved)}, "
                                     f"expected {_describe(template)}")
        used.add(prefix)
        out = (saved.to(template.device) if isinstance(template, torch.Tensor)
               else saved)
    if top:
        extra = [k for k in flat if k not in used]
        if extra:
            raise CheckpointMismatch(f"{extra[0]}: in the checkpoint, not in "
                                     f"this trainer")
    return out


def _save_atomic(obj, path: str):
    """torch.save to a temporary name, then rename into place: a write cut
    short leaves the previous file."""
    tmp = path + ".part"
    torch.save(obj, tmp)
    os.replace(tmp, path)


@dataclasses.dataclass
class PPOConfig:
    """Mirrors the rl_games config block of cfg/train/*PPO.yaml."""

    horizon_length: int = 16
    minibatch_size: int = 8192
    mini_epochs: int = 8
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    lr_schedule: str = "adaptive"
    # "legacy" adapts the learning rate after every minibatch, "standard"
    # once per mini-epoch on the mini-epoch's mean KL
    schedule_type: str = "legacy"
    kl_threshold: float = 0.008
    e_clip: float = 0.2
    clip_value: bool = True
    critic_coef: float = 4.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 1e-4
    grad_norm: float = 1.0
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    reward_shaper_scale: float = 1.0
    value_bootstrap: bool = False
    max_epochs: int = 100
    units: Sequence[int] = (32, 32)
    activation: str = "elu"
    sigma_init: float = 0.0
    lr_min: float = 1e-6
    lr_max: float = 1e-2
    # asymmetric actor-critic: a separate critic on the privileged states
    # with its own optimizer, minibatch size, mini-epochs and learning rate
    central_value: bool = False
    cv_units: Sequence[int] = (512, 512, 256, 128)
    cv_activation: str = "elu"
    cv_minibatch_size: int = 8192
    cv_mini_epochs: int = 8
    cv_learning_rate: float = 5e-4
    cv_rnn: Optional[str] = None
    cv_rnn_units: int = 1024
    rnn: Optional[str] = None
    rnn_units: int = 1024
    seq_len: int = 4
    # bf16 network compute over f32 parameters; losses and norms stay f32
    mixed_precision: bool = False
    # the matrix products of f32 feed-forward networks (networks.MATMULS):
    # "bf16_operands", the TPU's default precision, which the JAX package's
    # networks trained at on its chip (ROADMAP §C3, §C4), or exact "f32".
    # LSTM and autocast (mixed_precision) networks compute as their dtype
    # says, whatever this reads
    net_matmul: str = "bf16_operands"
    # asymmetric mode only: also train the actor's own value head on returns
    actor_aux_value_loss: bool = False


@dataclasses.dataclass
class AdamState:
    """optax `scale_by_adam` state: first and second moments, step count."""
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor   # () f32 on the device

    @classmethod
    def create(cls, params: Sequence[torch.Tensor]) -> "AdamState":
        return cls(mu=[torch.zeros_like(p) for p in params],
                   nu=[torch.zeros_like(p) for p in params],
                   count=torch.zeros((), device=params[0].device))


# optax scale_by_adam's defaults, with eps as the JAX learner sets it
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def clip_adam_step(params: Sequence[torch.Tensor], grads: List[torch.Tensor],
                   state: AdamState, lr: torch.Tensor, max_norm: float):
    """In place, with no host sync: the non-finite guard (a gradient with a
    non-finite global norm becomes zero, and Adam still steps, so its
    moments decay and its count advances), then optax's
    `chain(clip_by_global_norm(max_norm), scale_by_adam(eps=1e-8))` and
    `p - lr * u`, in optax's arithmetic."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    ok = torch.isfinite(norm)
    grads = [torch.where(ok, g, torch.zeros_like(g)) for g in grads]
    g_norm = torch.where(ok, norm, torch.zeros_like(norm))
    # clip_by_global_norm: t if norm < max_norm else (t / norm) * max_norm
    keep = g_norm < max_norm
    clipped = [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]
    torch._foreach_mul_(state.mu, ADAM_B1)
    torch._foreach_add_(state.mu, torch._foreach_mul(clipped, 1.0 - ADAM_B1))
    torch._foreach_mul_(state.nu, ADAM_B2)
    torch._foreach_add_(state.nu, torch._foreach_mul(
        torch._foreach_mul(clipped, clipped), 1.0 - ADAM_B2))
    state.count += 1.0
    bc1 = 1.0 - torch.pow(ADAM_B1, state.count)
    bc2 = 1.0 - torch.pow(ADAM_B2, state.count)
    with torch.no_grad():
        for p, m, v in zip(params, state.mu, state.nu):
            u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
            p.sub_(lr * u)
    return ok


@dataclasses.dataclass
class TrainState:
    ac: torch.nn.Module         # ActorCritic or LSTMActorCritic
    opt_state: AdamState
    lr: torch.Tensor            # () f32 on the device
    obs_norm: RunningNorm
    value_norm: RunningNorm
    states_norm: RunningNorm    # for the central-value critic input
    es: Any                     # batched EnvState
    cv: Optional[torch.nn.Module]   # CentralValue or LSTMCentralValue
    cv_opt_state: Optional[AdamState]
    ep_ret: torch.Tensor        # (N,) running episode reward (raw)
    ep_len: torch.Tensor        # (N,)
    # running means over the last ~100 completed episodes (rl_games
    # AverageMeter games_to_track=100)
    score_mean: torch.Tensor    # ()
    len_mean: torch.Tensor      # ()
    games: torch.Tensor         # () episodes inside the tracking window
    epoch: int
    # task-defined cross-env statistics (RLTask.episode_stats_*)
    task_stats: Any = dataclasses.field(default_factory=dict)
    # the LSTM states (h, c), each (N, units) f32, of the actor and the
    # central value; () without one
    hidden: tuple = ()
    cv_hidden: tuple = ()


class PPOTrainer:
    def __init__(self, env, cfg: PPOConfig, seed: int = 42):
        self.env = env
        self.cfg = cfg
        self.device = torch.device(env.device)
        # this process's rank among `world` (parallel/mesh.py); env holds
        # this rank's envs
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.use_cv = cfg.central_value and env.num_states > 0
        self.is_rnn = cfg.rnn == "lstm"
        self.is_cv_rnn = self.use_cv and cfg.cv_rnn == "lstm"
        if self.is_cv_rnn and not self.is_rnn:
            raise ValueError("an LSTM central value needs an LSTM actor")
        if self.is_rnn and cfg.horizon_length % cfg.seq_len:
            raise ValueError("horizon_length must be divisible by seq_len")
        net_dtype = torch.bfloat16 if cfg.mixed_precision else None
        self.net_matmul = self._net_matmul()
        # parameters are drawn on the CPU, so every device starts from the
        # same ones
        init_gen = torch.Generator().manual_seed(seed)
        if self.is_rnn:
            ac = LSTMActorCritic(env.num_obs, env.num_actions, cfg.rnn_units,
                                 tuple(cfg.units), cfg.activation, cfg.sigma_init,
                                 dtype=net_dtype, generator=init_gen)
        else:
            ac = ActorCritic(env.num_obs, env.num_actions, tuple(cfg.units),
                             cfg.activation, cfg.sigma_init, net_dtype, init_gen,
                             self.net_matmul)
        if self.is_cv_rnn:
            cv = LSTMCentralValue(env.num_states, cfg.cv_rnn_units,
                                  tuple(cfg.cv_units), cfg.cv_activation,
                                  dtype=net_dtype, generator=init_gen)
        elif self.use_cv:
            cv = CentralValue(env.num_states, tuple(cfg.cv_units),
                              cfg.cv_activation, net_dtype, init_gen,
                              self.net_matmul)
        else:
            cv = None
        ac = ac.to(self.device)
        cv = cv.to(self.device) if cv is not None else None
        mesh.broadcast_([p.data for net in (ac, cv) if net is not None
                         for p in net.parameters()])
        self.generator = torch.Generator(device=self.device).manual_seed(
            mesh.rank_seed(seed, self.rank))
        n, dev = env.num_envs, self.device
        es = env.reset(seed=seed)
        zero = lambda: torch.zeros((), device=dev)  # noqa: E731
        carry = lambda u: (torch.zeros((n, u), device=dev),  # noqa: E731
                           torch.zeros((n, u), device=dev))
        self.state = TrainState(
            ac=ac,
            opt_state=AdamState.create(list(ac.parameters())),
            lr=torch.tensor(float(cfg.learning_rate), device=dev),
            obs_norm=RunningNorm.create((env.num_obs,), dev),
            value_norm=RunningNorm.create((), dev),
            states_norm=RunningNorm.create((env.num_states,), dev),
            es=es,
            cv=cv,
            cv_opt_state=AdamState.create(list(cv.parameters())) if cv else None,
            ep_ret=torch.zeros(n, device=dev),
            ep_len=torch.zeros(n, device=dev),
            score_mean=zero(), len_mean=zero(), games=zero(),
            epoch=0,
            task_stats=env.task.episode_stats_init(),
            hidden=carry(cfg.rnn_units) if self.is_rnn else (),
            cv_hidden=carry(cfg.cv_rnn_units) if self.is_cv_rnn else (),
        )

    def _net_matmul(self) -> str:
        """The networks' matmul rule: `net_matmul` for f32 feed-forward
        networks (the networks check its value); "f32" for the LSTM
        networks, which compute in f32 or, with `mixed_precision`, under
        autocast, and for autocast feed-forward networks, whose products
        are bf16."""
        rule = self.cfg.net_matmul
        if self.is_rnn or self.cfg.mixed_precision:
            _check_matmul(rule, None)   # an unknown name still raises
            return "f32"
        return rule

    # ------------------------------------------------------------------
    def _policy(self, ts: TrainState, obs, states, hidden=(), cv_hidden=()):
        """Actor forward and the value estimate (from the central value on
        the privileged states where there is one); the LSTMs step from
        `hidden` / `cv_hidden`. Returns (mu, log_std, value, hidden,
        cv_hidden)."""
        x = ts.obs_norm.normalize(obs) if self.cfg.normalize_input else obs
        if self.is_rnn:
            mu, log_std, v, hidden = ts.ac(x, hidden)
        else:
            mu, log_std, v = ts.ac(x)
        if self.use_cv:
            sx = (ts.states_norm.normalize(states) if self.cfg.normalize_input
                  else states)
            if self.is_cv_rnn:
                v, cv_hidden = ts.cv(sx, cv_hidden)
            else:
                v = ts.cv(sx)
        if self.cfg.normalize_value:
            v = ts.value_norm.denormalize(v)
        return mu, log_std, v, hidden, cv_hidden

    @torch.no_grad()
    def _rollout(self, ts: TrainState, noise: Optional[torch.Tensor] = None):
        """horizon_length control steps under the current policy. Returns
        the trajectory (T, N, ...), the bootstrap value of the final state
        and the window's finished-episode sums; ts's env state, LSTM states
        and episode counters move on. The recurrent trajectory also holds
        the LSTM states at the start of each chunk of seq_len steps,
        `hidden_h` / `hidden_c` (and `cv_hidden_*`), (T / seq_len, N, units):
        what the BPTT replay starts from."""
        cfg = self.cfg
        es = ts.es
        hidden, cv_hidden = ts.hidden, ts.cv_hidden
        ep_ret, ep_len, task_stats = ts.ep_ret, ts.ep_len, ts.task_stats
        fin_ret = torch.zeros((), device=self.device)
        fin_len = torch.zeros((), device=self.device)
        fin_cnt = torch.zeros((), device=self.device)
        steps, starts = [], []
        for t in range(cfg.horizon_length):
            if self.is_rnn and t % cfg.seq_len == 0:
                starts.append((*hidden, *cv_hidden))
            mu, log_std, value, hidden, cv_hidden = self._policy(
                ts, es.obs, es.states, hidden, cv_hidden)
            eps = (noise[t] if noise is not None else torch.randn(
                mu.shape, generator=self.generator, device=self.device))
            action = mu + torch.exp(log_std) * eps
            logp = gaussian_logprob(mu, log_std, action)
            es2 = self.env.step(es, action)
            raw_rew = es2.reward
            shaped = cfg.reward_shaper_scale * raw_rew
            if cfg.value_bootstrap:
                # rl_games: rewards += gamma * values * time_outs
                shaped = shaped + cfg.gamma * value * es2.timeout.float()
            d = es2.done
            if self.is_rnn:
                # an env whose episode ended starts the next from zeros
                hidden = reset_where_done(hidden, d)
                cv_hidden = reset_where_done(cv_hidden, d)
            ep_ret = ep_ret + raw_rew
            ep_len = ep_len + 1.0
            fin_ret = fin_ret + torch.where(d, ep_ret, 0.0).sum()
            fin_len = fin_len + torch.where(d, ep_len, 0.0).sum()
            fin_cnt = fin_cnt + d.sum()
            ep_ret = torch.where(d, 0.0, ep_ret)
            ep_len = torch.where(d, 0.0, ep_len)
            task_stats = self.env.task.episode_stats_update(task_stats, es2)
            steps.append(dict(
                obs=es.obs, states=es.states, action=action, logp=logp,
                value=value, mu=mu, log_std=log_std.expand_as(mu),
                reward=shaped, done=d))
            es = es2
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        if starts:
            for i, k in enumerate(HIDDEN_KEYS[:len(starts[0])]):
                traj[k] = torch.stack([s[i] for s in starts])
        # the bootstrap value, from the states after the last resets
        _, _, last_value, _, _ = self._policy(ts, es.obs, es.states, hidden,
                                              cv_hidden)
        ts.es, ts.ep_ret, ts.ep_len, ts.task_stats = es, ep_ret, ep_len, task_stats
        ts.hidden, ts.cv_hidden = hidden, cv_hidden
        # the window's episode sums over every rank's envs
        fin = mesh.all_reduce_sum(torch.stack([fin_ret, fin_len, fin_cnt]))
        stats = dict(fin_ret=fin[0], fin_len=fin[1], fin_cnt=fin[2])
        return traj, last_value, stats

    def _gae(self, traj, last_value):
        cfg = self.cfg
        adv_next = torch.zeros_like(last_value)
        v_next = last_value
        advs = []
        for t in reversed(range(traj["reward"].shape[0])):
            not_done = 1.0 - traj["done"][t].float()
            value = traj["value"][t]
            delta = traj["reward"][t] + cfg.gamma * v_next * not_done - value
            adv_next = delta + cfg.gamma * cfg.tau * not_done * adv_next
            v_next = value
            advs.append(adv_next)
        advs = torch.stack(advs[::-1])
        return advs, advs + traj["value"]

    def _value_loss(self, v_pred_n, v_old, ret, ts: TrainState):
        """Per-sample clipped value loss in normalized-value space (shared
        by the actor's critic head and the central value)."""
        cfg = self.cfg
        if cfg.normalize_value:
            target_n = ts.value_norm.normalize(ret, clip=float("inf"))
            v_old_n = ts.value_norm.normalize(v_old, clip=float("inf"))
        else:
            target_n, v_old_n = ret, v_old
        if cfg.clip_value:
            v_clipped = v_old_n + torch.clamp(v_pred_n - v_old_n,
                                              -cfg.e_clip, cfg.e_clip)
            return torch.maximum((v_pred_n - target_n) ** 2,
                                 (v_clipped - target_n) ** 2)
        return (v_pred_n - target_n) ** 2

    def _loss(self, ts: TrainState, mb, advs_mean, advs_std):
        """PPO loss over a minibatch: (total, aux). Recurrent: the fields
        are (B, seq_len, ...) sequences, replayed through the LSTM from
        their stored start states with the rollout's resets at mb["done"]."""
        cfg = self.cfg
        x = ts.obs_norm.normalize(mb["obs"]) if cfg.normalize_input else mb["obs"]
        if self.is_rnn:
            mu, log_std, v_pred_n = ts.ac.seq(
                x, (mb["hidden_h"], mb["hidden_c"]), mb["done"])
            log_std = log_std.expand_as(mu)
        else:
            mu, log_std, v_pred_n = ts.ac(x)
        logp = gaussian_logprob(mu, log_std, mb["action"])
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        if cfg.normalize_advantage:
            adv = (adv - advs_mean) / (advs_std + 1e-8)
        surr1 = adv * ratio
        surr2 = adv * torch.clamp(ratio, 1 - cfg.e_clip, 1 + cfg.e_clip)
        actor_loss = -torch.mean(torch.minimum(surr1, surr2))
        if self.use_cv:
            # the critic is the central value, trained by _cv_update; the
            # actor's own head learns the returns only as an auxiliary task
            if cfg.actor_aux_value_loss:
                tgt_n = (ts.value_norm.normalize(mb["ret"], clip=float("inf"))
                         if cfg.normalize_value else mb["ret"])
                critic_loss = 0.5 * torch.mean((v_pred_n - tgt_n) ** 2)
            else:
                critic_loss = torch.zeros((), device=mu.device)
        else:
            critic_loss = 0.5 * torch.mean(
                self._value_loss(v_pred_n, mb["value"], mb["ret"], ts))
        entropy = torch.mean(gaussian_entropy(log_std))
        b_high = torch.clamp(mu - 1.1, min=0.0) ** 2
        b_low = torch.clamp(mu + 1.1, max=0.0) ** 2
        bounds_loss = torch.mean(torch.sum(b_high + b_low, dim=-1))
        total = (actor_loss + cfg.critic_coef * critic_loss
                 - cfg.entropy_coef * entropy
                 + cfg.bounds_loss_coef * bounds_loss)
        kl = torch.mean(gaussian_kl(mb["mu"], mb["log_std"], mu, log_std))
        aux = dict(actor_loss=actor_loss, critic_loss=critic_loss,
                   entropy=entropy, bounds_loss=bounds_loss, kl=kl)
        return total, aux

    def _cv_loss(self, ts: TrainState, mb):
        cfg = self.cfg
        sx = (ts.states_norm.normalize(mb["states"]) if cfg.normalize_input
              else mb["states"])
        if self.is_cv_rnn:
            v_pred_n = ts.cv.seq(sx, (mb["cv_hidden_h"], mb["cv_hidden_c"]),
                                 mb["done"])
        else:
            v_pred_n = ts.cv(sx)
        return 0.5 * torch.mean(
            self._value_loss(v_pred_n, mb["value"], mb["ret"], ts))

    @staticmethod
    def _mean_over_ranks(grads: List[torch.Tensor], terms: dict):
        """The ranks' gradients and loss terms (0-dim) averaged, in one
        all_reduce of one flat buffer: each rank's are means over its local
        minibatch, and the ranks' minibatches are of equal size, so the
        average is the union minibatch's. Without a group: as they are."""
        if not mesh.active():
            return grads, terms
        keys = list(terms)
        flat = mesh.mean_(torch.cat([g.reshape(-1) for g in grads] + [
            torch.stack([terms[k].detach().float() for k in keys])]))
        out, off = [], 0
        for g in grads:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return out, dict(zip(keys, flat[off:].unbind()))

    def _perms(self, rounds: int, num_slices: int) -> torch.Tensor:
        return torch.stack([
            torch.randperm(num_slices, generator=self.generator,
                           device=self.device) for _ in range(rounds)])

    def _cv_update(self, ts: TrainState, dataset, num_slices: int,
                   perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cv_mini_epochs x cv_minibatch SGD on the central value with its
        own optimizer and a fixed cv_learning_rate (cv_minibatch_size counts
        steps: cv_minibatch_size / seq_len sequences for the LSTM). Returns
        the mean loss."""
        cfg = self.cfg
        lr = torch.tensor(float(cfg.cv_learning_rate), device=self.device)
        _, mb_slices = self._split(
            num_slices * self.world,
            max(cfg.cv_minibatch_size // cfg.seq_len, 1) if self.is_cv_rnn
            else cfg.cv_minibatch_size)
        num_mb = num_slices // mb_slices
        take = _minibatch_taker(dataset)
        if perms is None:
            perms = self._perms(cfg.cv_mini_epochs, num_slices)
        idxs = perms[:, :num_mb * mb_slices].reshape(
            cfg.cv_mini_epochs, num_mb, mb_slices)
        params = list(ts.cv.parameters())
        losses = []
        for e in range(cfg.cv_mini_epochs):
            for b in range(num_mb):
                loss = self._cv_loss(ts, take(idxs[e, b]))
                grads, red = self._mean_over_ranks(
                    list(torch.autograd.grad(loss, params)), {"loss": loss})
                clip_adam_step(params, grads, ts.cv_opt_state, lr, cfg.grad_norm)
                losses.append(torch.nan_to_num(red["loss"].detach()))
        return torch.stack(losses).mean()

    def _adapt_lr(self, lr, kl):
        cfg = self.cfg
        return torch.where(
            kl > 2.0 * cfg.kl_threshold,
            torch.clamp(lr / 1.5, min=cfg.lr_min),
            torch.where(kl < 0.5 * cfg.kl_threshold,
                        torch.clamp(lr * 1.5, max=cfg.lr_max), lr))

    def _update(self, ts: TrainState, dataset, advs_mean, advs_std,
                num_slices: int, mb_slices: int,
                perms: Optional[torch.Tensor] = None) -> dict:
        """mini_epochs x minibatch SGD with the adaptive-KL learning rate
        ("legacy": after every minibatch; "standard": once per mini-epoch on
        its mean KL). Returns the means of the losses and the KL.
        num_slices and mb_slices count this rank's rows (`_slices`)."""
        cfg = self.cfg
        take = _minibatch_taker(dataset)
        num_mb = num_slices // mb_slices
        if perms is None:
            perms = self._perms(cfg.mini_epochs, num_slices)
        idxs = perms[:, :num_mb * mb_slices].reshape(
            cfg.mini_epochs, num_mb, mb_slices)
        params = list(ts.ac.parameters())
        adaptive = cfg.lr_schedule == "adaptive"
        lr = ts.lr
        auxes = []
        for e in range(cfg.mini_epochs):
            kls = []
            for b in range(num_mb):
                loss, aux = self._loss(ts, take(idxs[e, b]), advs_mean,
                                       advs_std)
                # with a central value and no auxiliary value loss the
                # actor's value head takes no gradient: zeros, as in JAX
                grads = list(torch.autograd.grad(loss, params, allow_unused=True,
                                                 materialize_grads=True))
                grads, aux = self._mean_over_ranks(grads, dict(aux, loss=loss))
                loss = aux.pop("loss")
                aux = {k: torch.nan_to_num(v.detach()) for k, v in aux.items()}
                clip_adam_step(params, grads, ts.opt_state, lr, cfg.grad_norm)
                if adaptive and cfg.schedule_type == "legacy":
                    lr = self._adapt_lr(lr, aux["kl"])
                aux["loss"] = loss.detach()
                kls.append(aux["kl"])
                auxes.append(aux)
            if adaptive and cfg.schedule_type == "standard":
                lr = self._adapt_lr(lr, torch.stack(kls).mean())
        ts.lr = lr
        return {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}

    def _datasets(self, traj: dict):
        """(actor dataset, central-value dataset or None, num_slices,
        mb_slices) of a trajectory with its advantages and returns. FF: the
        (T * N) transitions. Recurrent: (N * T / seq_len) sequences of
        seq_len steps, env-major ((nch, seq, N) -> (N, nch, seq)), with the
        per-step done and the LSTM states at each sequence's start; the
        minibatch takes minibatch_size / seq_len sequences."""
        cfg = self.cfg
        T, N = cfg.horizon_length, self.env.num_envs
        skip = {"reward", "done", "states", *HIDDEN_KEYS}
        if self.is_rnn:
            seq = cfg.seq_len
            nch = T // seq

            def to_slices(x):
                x = x.reshape((nch, seq, N) + x.shape[2:]).movedim(2, 0)
                return x.reshape((N * nch, seq) + x.shape[3:])

            def hid_start(x):   # (nch, N, H) -> (N * nch, H)
                return x.movedim(1, 0).reshape(N * nch, -1)
        else:
            def to_slices(x):
                return x.reshape((T * N,) + x.shape[2:])
        dataset = {k: to_slices(v) for k, v in traj.items() if k not in skip}
        cv_dataset = None
        if self.use_cv:
            cv_dataset = {k: to_slices(traj[k]) for k in ("states", "value", "ret")}
        if self.is_rnn:
            # the replay resets the LSTM states where the rollout did
            dataset["done"] = to_slices(traj["done"])
            for k in ("hidden_h", "hidden_c"):
                dataset[k] = hid_start(traj[k])
            if self.is_cv_rnn:
                cv_dataset["done"] = dataset["done"]
                for k in ("cv_hidden_h", "cv_hidden_c"):
                    cv_dataset[k] = hid_start(traj[k])
        return (dataset, cv_dataset, *self._slices())

    def _slices(self):
        """(num_slices, mb_slices): this rank's rows of the SGD dataset
        (transitions, or sequences of seq_len steps) and of a minibatch."""
        cfg = self.cfg
        steps = cfg.horizon_length * self.env.num_envs * self.world
        if self.is_rnn:
            return self._split(steps // cfg.seq_len,
                               max(cfg.minibatch_size // cfg.seq_len, 1))
        return self._split(steps, cfg.minibatch_size)

    def _split(self, num_slices: int, mb_size: int):
        """(this rank's rows, this rank's minibatch rows) of a dataset of
        num_slices rows over all ranks whose minibatch takes mb_size rows:
        the 1-rank minibatch (`_divisor_at_most`) split evenly over the
        ranks; refuses a minibatch that does not split."""
        mb = _divisor_at_most(mb_size, num_slices)
        world = self.world
        if mb % world:
            raise ValueError(f"a minibatch of {mb} rows (minibatch_size "
                             f"{mb_size}) does not split over {world} ranks")
        return num_slices // world, mb // world

    # ------------------------------------------------------------------
    def _epoch(self, ts: TrainState, noise: Optional[torch.Tensor] = None,
               perms: Optional[torch.Tensor] = None,
               cv_perms: Optional[torch.Tensor] = None) -> dict:
        """One epoch in place on ts; returns its metrics as 0-dim device
        tensors."""
        traj, last_value, stats = self._rollout(ts, noise)
        return self._learn(ts, traj, last_value, stats, perms, cv_perms)

    def _learn(self, ts: TrainState, traj: dict, last_value, stats: dict,
               perms: Optional[torch.Tensor] = None,
               cv_perms: Optional[torch.Tensor] = None) -> dict:
        """The epoch after its rollout: GAE, the norms, the SGD phases and
        the metrics, in place on ts."""
        cfg = self.cfg
        advs, returns = self._gae(traj, last_value)
        traj = dict(traj, adv=advs, ret=returns)
        # the value norm updates BEFORE the SGD phase (it normalizes the
        # value targets); the obs/states norms update AFTER it, so the
        # replay normalizes with the statistics the rollout used and the PPO
        # ratio starts at exactly 1
        if cfg.normalize_value:
            ts.value_norm = ts.value_norm.update(returns)
        dataset, cv_dataset, num_slices, mb_slices = self._datasets(traj)
        advs_mean, advs_var = mesh.moments(advs.reshape(-1))
        advs_std = torch.sqrt(advs_var)
        if self.use_cv:
            # central value first (rl_games train_epoch order), then actor
            cv_loss = self._cv_update(ts, cv_dataset, num_slices, cv_perms)
        aux = self._update(ts, dataset, advs_mean, advs_std, num_slices,
                           mb_slices, perms)
        if self.use_cv:
            aux["cv_loss"] = cv_loss
        if cfg.normalize_input:
            ts.obs_norm = ts.obs_norm.update(traj["obs"])
            if self.use_cv:
                ts.states_norm = ts.states_norm.update(traj["states"])
        ts.epoch += 1
        # fold the window's finished episodes into the ~100-episode running
        # means; w capped at 1 (more than 100 episode ends in one window
        # would otherwise over-relax the incremental mean into a blow-up)
        cnt = stats["fin_cnt"]
        tracked = torch.clamp(ts.games + cnt, max=100.0)
        w = torch.where(cnt > 0,
                        torch.clamp(cnt / torch.clamp(tracked, min=1.0), max=1.0),
                        torch.zeros_like(cnt))
        batch_ret = stats["fin_ret"] / torch.clamp(cnt, min=1.0)
        batch_len = stats["fin_len"] / torch.clamp(cnt, min=1.0)
        ts.score_mean = ts.score_mean + w * (batch_ret - ts.score_mean)
        ts.len_mean = ts.len_mean + w * (batch_len - ts.len_mean)
        ts.games = tracked
        metrics = dict(
            mean_ep_reward=ts.score_mean,
            mean_ep_length=ts.len_mean,
            episodes=cnt,
            mean_step_reward=mesh.env_mean(traj["reward"]),
            # critic quality: EV of the rollout values against the returns
            explained_variance=1.0 - mesh.moments(
                (traj["ret"] - traj["value"]).reshape(-1))[1]
            / (mesh.moments(traj["ret"].reshape(-1))[1] + 1e-8),
            lr=ts.lr,
            **aux,
        )
        # the task's episode metrics (mean over envs), and its cross-env
        # statistics
        for k, v in ts.es.metrics.items():
            metrics[k if "/" in k else "Episode/" + k] = mesh.env_mean(v.float())
        if isinstance(ts.task_stats, dict):
            for k, v in ts.task_stats.items():
                metrics[k if "/" in k else "Episode/" + k] = v
        return metrics

    # ------------------------------------------------------------------
    def _main_tree(self) -> dict:
        """What `model.pt` holds: the networks, both Adam states (moments
        under the parameters' names, and the count), the running norms,
        the learning rate and the epoch."""
        ts = self.state

        def adam(net, st):
            names = [k for k, _ in net.named_parameters()]
            return dict(mu=dict(zip(names, st.mu)), nu=dict(zip(names, st.nu)),
                        count=st.count)

        tree = dict(ac=dict(ts.ac.named_parameters()),
                    opt=adam(ts.ac, ts.opt_state), obs_norm=ts.obs_norm,
                    value_norm=ts.value_norm, states_norm=ts.states_norm,
                    lr=ts.lr, epoch=ts.epoch)
        if self.use_cv:
            tree["cv"] = dict(ts.cv.named_parameters())
            tree["cv_opt"] = adam(ts.cv, ts.cv_opt_state)
        return tree

    def _env_state_tree(self) -> dict:
        """What the sidecar `env.pt` holds besides the generators: the
        per-env state a resume needs to continue its episodes (mid-episode
        physics, the task's carry with its randomization draws, the LSTM
        states, the episode counters and means, the task's statistics), and
        the epoch it belongs to."""
        ts = self.state
        return dict(epoch=ts.epoch, es=ts.es, hidden=ts.hidden,
                    cv_hidden=ts.cv_hidden, ep_ret=ts.ep_ret, ep_len=ts.ep_len,
                    score_mean=ts.score_mean, len_mean=ts.len_mean,
                    games=ts.games, task_stats=ts.task_stats)

    def _generators(self) -> dict:
        return {"trainer": self.generator, "env": self.env.generator}

    def _sidecar(self) -> dict:
        """The sidecar's flat dict: the env-state tree with its per-env
        leaves gathered along the env axis over the ranks, the world size,
        and every rank's generator states stacked, (world, state bytes).
        A collective: every rank calls it."""
        side = _flatten(self._env_state_tree())
        n = self.env.num_envs
        if mesh.active():
            for k, v in side.items():
                if k.split(".")[0] in ENV_AXIS_KEYS and isinstance(v, torch.Tensor):
                    if v.ndim == 0 or v.shape[0] != n:
                        raise ValueError(f"{k}: {tuple(v.shape)} has no env axis "
                                         f"of {n}")
                    side[k] = mesh.gather_envs(v)
        side["world_size"] = self.world
        side.update({f"rng.{k}": mesh.gather_envs(g.get_state()[None])
                     for k, g in self._generators().items()})
        return side

    def save(self, path: str):
        """Write the checkpoint directory `path`: the sidecar first, then
        the main file, each renamed into place, so a save cut short leaves
        either the old pair or a sidecar whose epoch the old main file
        does not share (which `load` ignores). Every rank calls it (the
        sidecar gathers the ranks' envs); rank 0 writes."""
        side = self._sidecar()
        if not mesh.is_main():
            return
        os.makedirs(path, exist_ok=True)
        _save_atomic(side, os.path.join(path, ENV_FILE))
        _save_atomic(_flatten(self._main_tree()), os.path.join(path, MAIN_FILE))

    def load(self, path: str, log_fn=print, resume: bool = True):
        """Resume from the checkpoint directory `path` (`checkpoint=` of the
        CLIs), on this trainer's device whatever device wrote it. A main
        file that does not fit this trainer raises CheckpointMismatch; the
        sidecar is taken when it fits and shares the main file's epoch,
        else the envs keep their fresh state. A sidecar of another world
        size raises CheckpointMismatch naming both sizes, unless `resume`
        is False (an evaluation, which needs the main file only): then it
        is skipped."""
        flat = torch.load(os.path.join(path, MAIN_FILE), map_location=self.device,
                          weights_only=True)
        tree = _restore_like(self._main_tree(), flat)
        ts = self.state
        with torch.no_grad():
            for net, key, opt in ((ts.ac, "ac", "opt"), (ts.cv, "cv", "cv_opt")):
                if net is None:
                    continue
                names = [k for k, _ in net.named_parameters()]
                for k, p in net.named_parameters():
                    p.copy_(tree[key][k])
                st = AdamState(mu=[tree[opt]["mu"][k] for k in names],
                               nu=[tree[opt]["nu"][k] for k in names],
                               count=tree[opt]["count"])
                if key == "ac":
                    ts.opt_state = st
                else:
                    ts.cv_opt_state = st
        for k in ("obs_norm", "value_norm", "states_norm", "lr", "epoch"):
            setattr(ts, k, tree[k])
        self._load_env_state(os.path.join(path, ENV_FILE), log_fn, resume)

    def _load_env_state(self, path: str, log_fn, resume: bool):
        if not os.path.exists(path):
            log_fn("no env-state sidecar: envs restart fresh")
            return
        flat = torch.load(path, map_location=self.device, weights_only=True)
        saved_world, world = flat.pop("world_size", 1), self.world
        if saved_world != world:
            msg = (f"env-state sidecar of world size {saved_world}, this run has "
                   f"world size {world}")
            if resume:
                raise CheckpointMismatch(msg)
            log_fn(f"{msg}: skipped, envs start fresh")
            return
        if flat.get("epoch") != self.state.epoch:
            log_fn(f"env-state sidecar ignored: it is of epoch {flat.get('epoch')}, "
                   f"the checkpoint of epoch {self.state.epoch}; envs restart fresh")
            return
        rng = {k: flat.pop(f"rng.{k}", None) for k in self._generators()}
        if world > 1:
            # this rank's envs of the gathered leaves (a leaf of another
            # env count is left whole, and _restore_like names it)
            n = self.env.num_envs
            sl = slice(self.rank * n, (self.rank + 1) * n)
            for k, v in flat.items():
                if (k.split(".")[0] in ENV_AXIS_KEYS and isinstance(v, torch.Tensor)
                        and v.ndim > 0 and v.shape[0] == n * world):
                    flat[k] = v[sl]
        try:
            tree = _restore_like(self._env_state_tree(), flat)
        except CheckpointMismatch as e:
            log_fn(f"env-state sidecar ignored ({e}); envs restart fresh")
            return
        for k, v in tree.items():
            setattr(self.state, k, v)
        kept = []
        for k, g in self._generators().items():
            # a row of the stacked states, copied: set_state reads its
            # storage from the start
            st = None if rng[k] is None else rng[k][self.rank].clone()
            if st is not None and st.shape == g.get_state().shape:
                g.set_state(st.cpu())
                kept.append(k)
        log_fn(f"env state restored (episodes continue); random generators "
               f"restored: {kept or 'none, saved on another device type'}")

    # ------------------------------------------------------------------
    def train(
        self,
        max_epochs: Optional[int] = None,
        log_every: int = 10,
        log_fn=print,
        save_dir: Optional[str] = None,
        save_frequency: int = 50,
        save_best_after: int = 100,
        writer=None,
        profile_dir: Optional[str] = None,
        profile_epochs: int = 2,
        epochs_per_jit: int = 1,
        history_path: Optional[str] = None,
    ):
        """The epoch loop, from the state's epoch (a loaded checkpoint's)
        to max_epochs. Each epoch's metrics come to the host in one
        transfer. `save_dir` takes the rl_games checkpoints: `last` at every
        `save_frequency` epochs, `best` (with `best_meta.json`) when an
        epoch from `save_best_after` on beats the best mean episode reward.
        A resumed run keeps `history_path`'s rows before its epoch and the
        best so far, from those rows and from `best_meta.json`.
        `profile_dir` traces `profile_epochs` epochs after the first
        PROFILE_START with torch.profiler (one Chrome trace).
        `epochs_per_jit` is accepted for the JAX CLI's sake and ignored:
        there is no compiled multi-epoch program here, every epoch is its
        own loop of launches. Under a process group every rank runs the
        loop (its metrics are global, so every rank decides alike when to
        save); rank 0 alone logs, traces and writes files."""
        del epochs_per_jit
        max_epochs = max_epochs or self.cfg.max_epochs
        start_epoch = self.state.epoch
        history, best_reward = [], -float("inf")
        if start_epoch > 0 and history_path and os.path.exists(history_path):
            try:
                with open(history_path) as f:
                    history = [m for m in json.load(f)
                               if m.get("epoch", 0) < start_epoch]
            except (json.JSONDecodeError, OSError):
                history = []
            best_reward = max([m["mean_ep_reward"] for m in history
                               if m.get("epoch", 0) >= save_best_after
                               and m.get("episodes", 1) > 0], default=best_reward)
        if start_epoch > 0 and save_dir:
            # the authoritative best so far: the epochs that were candidates
            # are not all in history.json when log_every > 1
            try:
                with open(os.path.join(save_dir, "best_meta.json")) as f:
                    best_reward = max(best_reward, float(json.load(f)["best_reward"]))
            except (OSError, json.JSONDecodeError, KeyError, ValueError):
                pass
        main = mesh.is_main()
        if mesh.active():
            # rank 0's files decide when `best` is saved, on every rank
            best = torch.tensor(best_reward, dtype=torch.float64, device=self.device)
            mesh.broadcast_([best])
            best_reward = float(best)
        log_fn = log_fn if main else None
        if not main:
            writer = profile_dir = history_path = None
        if start_epoch > 0 and log_fn:
            log_fn(f"resuming at epoch {start_epoch} ({len(history)} prior rows)")
        steps_per_epoch = self.cfg.horizon_length * self.env.num_envs * self.world
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        prof = None
        t_log = time.time()
        epoch = start_epoch
        while epoch < max_epochs:
            if profile_dir is not None and prof is None and epoch >= PROFILE_START:
                sync()
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            metrics = self._epoch(self.state)
            if prof is not None and profile_dir is not None \
                    and epoch + 1 >= PROFILE_START + profile_epochs:
                sync()
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                profile_dir = None
            keys = list(metrics)
            vals = torch.stack([metrics[k].float() for k in keys]).tolist()
            m = dict(zip(keys, vals))
            now = time.time()
            rate = steps_per_epoch / (now - t_log)
            t_log = now
            m["epoch"] = epoch
            m["env_steps"] = (epoch + 1) * steps_per_epoch
            m["steps_per_sec"] = rate
            last = epoch == max_epochs - 1
            if epoch % log_every == 0 or last:
                history.append(m)
                if log_fn:
                    log_fn(f"epoch {epoch:5d} | ep_rew {m['mean_ep_reward']:9.2f} "
                           f"| ep_len {m['mean_ep_length']:6.1f} "
                           f"| kl {m['kl']:.4f} | lr {m['lr']:.2e} "
                           f"| {m['steps_per_sec']:,.0f} steps/s")
            if writer is not None:
                for tag, val in m.items():
                    if isinstance(val, float):
                        writer.add_scalar(tag if "/" in tag else "train/" + tag,
                                          val, m["env_steps"])
            if history_path:
                with open(history_path, "w") as f:
                    json.dump(history, f)
            if save_dir:
                if (epoch + 1) % save_frequency == 0:
                    self.save(os.path.join(save_dir, "last"))
                if (epoch >= save_best_after and m["episodes"] > 0
                        and m["mean_ep_reward"] > best_reward):
                    best_reward = m["mean_ep_reward"]
                    self.save(os.path.join(save_dir, "best"))
                    if main:
                        with open(os.path.join(save_dir, "best_meta.json"), "w") as f:
                            json.dump({"best_reward": best_reward, "epoch": epoch}, f)
            epoch += 1
        return history
