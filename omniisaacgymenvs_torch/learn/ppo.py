"""PPO learner on the same device as the simulation (PyTorch port of the FF
path of the JAX package's `learn/ppo.py`).

An epoch is a rollout of horizon_length control steps through the task's
batched step (K1 once per control step, K2 at each reset merge on CUDA),
GAE, then mini_epochs x minibatch SGD on the flattened trajectory, with
the clipped surrogate, the clipped value loss, the bounds loss, gradient
clipping by global norm, Adam and the adaptive-KL learning rate. The
learning rate, the non-finite-gradient guard and every metric stay on the
device; an epoch's metrics come to the host once, in `train`.

Random draws (action noise, minibatch permutations) come from one
`torch.Generator` on the device, seeded from `seed`. `_rollout` takes an
optional `noise` (T, N, A) and `_update` / `_cv_update` an optional
`perms` (mini_epochs, num_slices), so that a test can hand in the JAX
learner's draws.

Not ported yet: the recurrent policy and central value (`rnn`, `cv_rnn`:
ROADMAP A15) and checkpoints (`save` / `load`: ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from omniisaacgymenvs_torch.learn.networks import (
    ActorCritic,
    CentralValue,
    gaussian_entropy,
    gaussian_kl,
    gaussian_logprob,
)
from omniisaacgymenvs_torch.learn.running_norm import RunningNorm

# `train(profile_dir=...)` skips this many epochs (allocation, cuBLAS
# heuristics, the kernels' first builds) before it starts tracing
PROFILE_START = 3

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
    ac: ActorCritic
    opt_state: AdamState
    lr: torch.Tensor            # () f32 on the device
    obs_norm: RunningNorm
    value_norm: RunningNorm
    states_norm: RunningNorm    # for the central-value critic input
    es: Any                     # batched EnvState
    cv: Optional[CentralValue]
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


class PPOTrainer:
    def __init__(self, env, cfg: PPOConfig, seed: int = 42):
        if cfg.rnn is not None or cfg.cv_rnn is not None:
            raise NotImplementedError(
                "the recurrent learner (rnn / cv_rnn) is not ported yet: "
                "ROADMAP A15")
        self.env = env
        self.cfg = cfg
        self.device = torch.device(env.device)
        self.use_cv = cfg.central_value and env.num_states > 0
        net_dtype = torch.bfloat16 if cfg.mixed_precision else None
        # parameters are drawn on the CPU, so every device starts from the
        # same ones
        init_gen = torch.Generator().manual_seed(seed)
        ac = ActorCritic(env.num_obs, env.num_actions, tuple(cfg.units),
                         cfg.activation, cfg.sigma_init, net_dtype,
                         init_gen).to(self.device)
        cv = (CentralValue(env.num_states, tuple(cfg.cv_units),
                           cfg.cv_activation, net_dtype, init_gen).to(self.device)
              if self.use_cv else None)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        n, dev = env.num_envs, self.device
        es = env.reset(seed=seed)
        zero = lambda: torch.zeros((), device=dev)  # noqa: E731
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
        )

    # ------------------------------------------------------------------
    def _policy(self, ts: TrainState, obs, states):
        """Actor forward and the value estimate (from the central value on
        the privileged states where there is one). Returns (mu, log_std,
        value)."""
        x = ts.obs_norm.normalize(obs) if self.cfg.normalize_input else obs
        mu, log_std, v = ts.ac(x)
        if self.use_cv:
            sx = (ts.states_norm.normalize(states) if self.cfg.normalize_input
                  else states)
            v = ts.cv(sx)
        if self.cfg.normalize_value:
            v = ts.value_norm.denormalize(v)
        return mu, log_std, v

    @torch.no_grad()
    def _rollout(self, ts: TrainState, noise: Optional[torch.Tensor] = None):
        """horizon_length control steps under the current policy. Returns
        the trajectory (T, N, ...), the bootstrap value of the final state
        and the window's finished-episode sums; ts's env state and episode
        counters move on."""
        cfg = self.cfg
        es = ts.es
        ep_ret, ep_len, task_stats = ts.ep_ret, ts.ep_len, ts.task_stats
        fin_ret = torch.zeros((), device=self.device)
        fin_len = torch.zeros((), device=self.device)
        fin_cnt = torch.zeros((), device=self.device)
        steps = []
        for t in range(cfg.horizon_length):
            mu, log_std, value = self._policy(ts, es.obs, es.states)
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
            ep_ret = ep_ret + raw_rew
            ep_len = ep_len + 1.0
            d = es2.done
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
        _, _, last_value = self._policy(ts, es.obs, es.states)
        ts.es, ts.ep_ret, ts.ep_len, ts.task_stats = es, ep_ret, ep_len, task_stats
        stats = dict(fin_ret=fin_ret, fin_len=fin_len, fin_cnt=fin_cnt)
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
        """PPO loss over a minibatch: (total, aux)."""
        cfg = self.cfg
        x = ts.obs_norm.normalize(mb["obs"]) if cfg.normalize_input else mb["obs"]
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
        v_pred_n = ts.cv(sx)
        return 0.5 * torch.mean(
            self._value_loss(v_pred_n, mb["value"], mb["ret"], ts))

    def _perms(self, rounds: int, num_slices: int) -> torch.Tensor:
        return torch.stack([
            torch.randperm(num_slices, generator=self.generator,
                           device=self.device) for _ in range(rounds)])

    def _cv_update(self, ts: TrainState, dataset, num_slices: int,
                   perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cv_mini_epochs x cv_minibatch SGD on the central value with its
        own optimizer and a fixed cv_learning_rate. Returns the mean loss."""
        cfg = self.cfg
        lr = torch.tensor(float(cfg.cv_learning_rate), device=self.device)
        mb_slices = min(cfg.cv_minibatch_size, num_slices)
        while num_slices % mb_slices:
            mb_slices -= 1
        num_mb = num_slices // mb_slices
        packed, unpack = _pack_dataset(dataset)
        if perms is None:
            perms = self._perms(cfg.cv_mini_epochs, num_slices)
        idxs = perms[:, :num_mb * mb_slices].reshape(
            cfg.cv_mini_epochs, num_mb, mb_slices)
        params = list(ts.cv.parameters())
        losses = []
        for e in range(cfg.cv_mini_epochs):
            for b in range(num_mb):
                mb = unpack(packed[idxs[e, b]])
                loss = self._cv_loss(ts, mb)
                grads = list(torch.autograd.grad(loss, params))
                clip_adam_step(params, grads, ts.cv_opt_state, lr, cfg.grad_norm)
                losses.append(torch.nan_to_num(loss.detach()))
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
        its mean KL). Returns the means of the losses and the KL."""
        cfg = self.cfg
        packed, unpack = _pack_dataset(dataset)
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
                mb = unpack(packed[idxs[e, b]])
                loss, aux = self._loss(ts, mb, advs_mean, advs_std)
                grads = list(torch.autograd.grad(loss, params))
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
        T, N = cfg.horizon_length, self.env.num_envs
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])  # noqa: E731
        skip = {"reward", "done", "states"}
        dataset = {k: flat(v) for k, v in traj.items() if k not in skip}
        num_slices = T * N
        mb_slices = min(cfg.minibatch_size, num_slices)
        while num_slices % mb_slices:
            mb_slices -= 1
        advs_mean = advs.mean()
        advs_std = advs.std(correction=0)
        if self.use_cv:
            # central value first (rl_games train_epoch order), then actor
            cv_dataset = {k: flat(traj[k]) for k in ("states", "value", "ret")}
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
            mean_step_reward=traj["reward"].mean(),
            # critic quality: EV of the rollout values against the returns
            explained_variance=1.0 - (traj["ret"] - traj["value"]).var(correction=0)
            / (traj["ret"].var(correction=0) + 1e-8),
            lr=ts.lr,
            **aux,
        )
        # the task's episode metrics (mean over envs), and its cross-env
        # statistics
        for k, v in ts.es.metrics.items():
            metrics[k if "/" in k else "Episode/" + k] = v.float().mean()
        if isinstance(ts.task_stats, dict):
            for k, v in ts.task_stats.items():
                metrics[k if "/" in k else "Episode/" + k] = v
        return metrics

    # ------------------------------------------------------------------
    def train(
        self,
        max_epochs: Optional[int] = None,
        log_every: int = 10,
        log_fn=print,
        save_dir: Optional[str] = None,
        writer=None,
        profile_dir: Optional[str] = None,
        profile_epochs: int = 2,
        epochs_per_jit: int = 1,
        history_path: Optional[str] = None,
    ):
        """The epoch loop. Each epoch's metrics come to the host in one
        transfer. `profile_dir` traces `profile_epochs` epochs after the
        first PROFILE_START with torch.profiler (one Chrome trace).
        `epochs_per_jit` is accepted for the JAX CLI's sake and ignored:
        there is no compiled multi-epoch program here, every epoch is its
        own loop of launches. `save_dir` (checkpoints) is not ported yet."""
        del epochs_per_jit
        if save_dir is not None:
            raise NotImplementedError(
                "checkpoints (save_dir) are not ported yet: ROADMAP A10")
        max_epochs = max_epochs or self.cfg.max_epochs
        history = []
        steps_per_epoch = self.cfg.horizon_length * self.env.num_envs
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        prof = None
        t_log = time.time()
        epoch = self.state.epoch
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
            epoch += 1
        return history
