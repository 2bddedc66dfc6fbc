"""Task base: the RLTask contract over batched tensors (PyTorch port of the
JAX package's `tasks/base.py`).

A task is a set of batched hooks (sample_reset, control, observe,
reward_done) over an `EnvState` whose fields carry a leading env axis.
`step` auto-resets on entry: it computes a fresh reset for every env and
merges it with `torch.where` on the previous step's done flag, so no env
index ever reaches the host.

With a `Randomizer` attached and switched on, a task whose carry is a dict
keeps its domain randomization there under `_dr`: the episode's correlated
observation and action noise, the episode's physics overlay (`overlay`,
with the on_interval keys updated in place) and the env's once-only
overlay (`startup`), which survives the auto-reset merge.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from omniisaacgymenvs_torch.physics.engine import PhysicsEngine
from omniisaacgymenvs_torch.physics.state import Control, State
from omniisaacgymenvs_torch.utils.domain_randomization import combine_overlays


@dataclasses.dataclass
class EnvState:
    """Task state of a batch of envs (obs/reward/done/progress buffers,
    the physics state and the task's carry)."""

    phys: State
    carry: Any
    obs: torch.Tensor          # (N, num_obs)
    states: torch.Tensor       # (N, num_states)
    reward: torch.Tensor       # (N,) f32
    done: torch.Tensor         # (N,) bool
    timeout: torch.Tensor      # (N,) bool: episode ended by time limit
    progress: torch.Tensor     # (N,) int32
    metrics: Dict[str, torch.Tensor]


def tree_where(cond: torch.Tensor, new, old):
    """Per-env select between two equally shaped states: `new` where
    cond (N,) is true. Walks dataclasses, dicts, tuples and tensors."""
    if isinstance(new, torch.Tensor):
        c = cond.reshape(cond.shape + (1,) * (new.ndim - 1))
        return torch.where(c, new, old)
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: tree_where(cond, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
        })
    if isinstance(new, dict):
        return {k: tree_where(cond, new[k], old[k]) for k in new}
    if isinstance(new, (tuple, list)):
        return type(new)(tree_where(cond, a, b) for a, b in zip(new, old))
    raise TypeError(f"cannot merge {type(new)}")


class RLTask:
    """Base of all tasks. Subclasses define the model and engine and the
    batched hooks:
      initial_carry(n) -> carry
      sample_reset(n, generator) -> (q, qd, carry)
      control(action, es, generator) -> Control (may update es.carry, which
          is this step's own dict)
      observe(phys, carry, action) -> (obs, states, carry)
      reward_done(obs, action, phys, carry, progress)
          -> (reward, done, carry, metrics)
    and may override resample_reset(es, generator) and
    pre_physics(es, generator).
    """

    name: str = "RLTask"
    num_obs: int = 0
    num_states: int = 0
    num_actions: int = 0
    max_episode_length: int = 500
    clip_obs: float = math.inf
    clip_actions: float = math.inf
    decimation: int = 1
    # utils/domain_randomization.Randomizer, attached by the registry from
    # the task yaml's domain_randomization block
    randomizer = None
    # view name of the yaml -> {dofs, bodies, tendons} index sets of the
    # model, so that a view's block randomizes its own part of the scene
    dr_views = None

    engine: PhysicsEngine

    @property
    def _dr_on(self) -> bool:
        return self.randomizer is not None and self.randomizer.randomize

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def timeout_progress(self) -> int:
        """Progress at which an episode ends by time limit."""
        return self.max_episode_length - 1

    def initial_metrics(self, n: int) -> Dict[str, torch.Tensor]:
        return {}

    def sample_reset(self, n: int, generator: torch.Generator):
        raise NotImplementedError

    def control(self, action: torch.Tensor, es: EnvState,
                generator: torch.Generator | None = None) -> Control:
        raise NotImplementedError

    def observe(self, phys: State, carry, action: torch.Tensor):
        raise NotImplementedError

    def reward_done(self, obs, action, phys, carry, progress):
        raise NotImplementedError

    def adjust_progress(self, carry, progress):
        """Progress after the reward: in-hand tasks with
        maxConsecutiveSuccesses > 0 zero the counter on a goal hit, and the
        time-limit check must see the adjusted value."""
        return progress

    def resample_reset(self, es: EnvState,
                       generator: torch.Generator) -> EnvState:
        """Fresh state of every env for the auto-reset merge. A task whose
        reset depends on the state of the episode that ends (the terrain
        curriculum: walked distance -> next level) overrides this."""
        return self.reset(es.done.shape[0], generator)

    def pre_physics(self, es: EnvState,
                    generator: torch.Generator) -> EnvState:
        """Perturbation of the merged state before the actions apply (random
        pushes of the robot). Default: none."""
        return es

    # -- statistics across envs ----------------------------------------
    # Per-env metrics cannot express a reduction over the batch (the
    # in-hand tasks' consecutive-success average over finished episodes).
    # A learner carries a stats dict and calls episode_stats_update(stats,
    # es) after every env step.
    def episode_stats_init(self) -> Dict[str, torch.Tensor]:
        return {}

    def episode_stats_update(self, stats, es: EnvState):
        return stats

    # ------------------------------------------------------------------
    def reset(self, n: int, generator: torch.Generator) -> EnvState:
        """Fresh state of n envs."""
        return self.fresh_state(*self.sample_reset(n, generator), generator)

    def fresh_state(self, q, qd, carry,
                    generator: torch.Generator) -> EnvState:
        """The EnvState of an episode that starts at (q, qd, carry); with
        randomization on, the episode's draws go into the carry's `_dr`."""
        n = q.shape[0]
        if self._dr_on and isinstance(carry, dict):
            rz = self.randomizer
            dr = rz.sample_correlated(generator, n, self.num_obs,
                                      self.num_actions, self.device)
            overlay = rz.sample_overlay(generator, n, self.model,
                                        self.dr_views)
            if overlay is not None:
                dr["overlay"] = overlay
            # drawn at every reset, kept only from an env's first: `step`
            # puts the old values back after the auto-reset merge
            startup = rz.sample_startup_overlay(generator, n, self.model,
                                                self.dr_views)
            if startup is not None:
                dr["startup"] = startup
            carry["_dr"] = dr
        phys = self.engine.init_state(q, qd)
        zero_action = torch.zeros((n, self.num_actions), device=self.device)
        obs, states, carry = self.observe(phys, carry, zero_action)
        z = torch.zeros(n, dtype=torch.bool, device=self.device)
        return EnvState(
            phys=phys,
            carry=carry,
            obs=obs,
            states=states,
            reward=torch.zeros(n, device=self.device),
            done=z,
            timeout=z.clone(),
            progress=torch.zeros(n, dtype=torch.int32, device=self.device),
            metrics=self.initial_metrics(n),
        )

    def physics_steps(self, phys: State, ctrl: Control,
                      overlay=None) -> State:
        """decimation x engine.step under the step's randomization overlay:
        one K1 launch on CUDA."""
        return self.engine.step_n(phys, ctrl, self.decimation, overlay)

    def step(self, es: EnvState, action: torch.Tensor,
             generator: torch.Generator) -> EnvState:
        """One control step. Envs flagged done on the previous step are
        re-sampled before the actions apply: a fresh state of every env
        (`resample_reset`, which sees the ending state) is merged with
        `where` on the done flag, then `pre_physics` runs on the merged
        state."""
        carry_is_dict = isinstance(es.carry, dict)
        old_startup = (es.carry.get("_dr", {}).get("startup")
                       if carry_is_dict else None)
        fresh = self.resample_reset(es, generator)
        es = tree_where(es.done, fresh, es)
        es = self.pre_physics(es, generator)
        if old_startup is not None:
            # an on_startup draw holds for the env's whole run: undo the
            # merge's fresh sample
            es.carry["_dr"] = dict(es.carry["_dr"], startup=old_startup)

        action = torch.clamp(action, -self.clip_actions, self.clip_actions)
        dr = es.carry.get("_dr", {}) if carry_is_dict else {}
        if self._dr_on:
            if carry_is_dict and self.randomizer.has_interval_overlays():
                dr = dict(dr, overlay=self.randomizer.update_interval_overlay(
                    dr.get("overlay"), generator, self.model, es.progress,
                    self.dr_views))
                es.carry["_dr"] = dr
            # actions are randomized after the clamp, before the control
            action = self.randomizer.randomize_actions(
                action, generator, dr, es.progress)
        ctrl = self.control(action, es, generator)
        overlay = combine_overlays(dr.get("startup"), dr.get("overlay"))
        phys = self.physics_steps(es.phys, ctrl, overlay)
        progress = es.progress + 1
        obs, states, carry = self.observe(phys, es.carry, action)
        reward, done, carry, metrics = self.reward_done(
            obs, action, phys, carry, progress
        )
        progress = self.adjust_progress(carry, progress)
        if self._dr_on:
            # observations are randomized before the clip
            obs = self.randomizer.randomize_observations(
                obs, generator, dr, progress)
        # physics-explosion guard: a non-finite state ends the episode with
        # zero reward instead of poisoning the batch
        finite = torch.isfinite(
            phys.q.sum(-1) + phys.qd.sum(-1) + reward
        )
        done = done | ~finite
        reward = torch.where(finite, reward, torch.zeros_like(reward))
        obs = torch.nan_to_num(
            torch.clamp(obs, -self.clip_obs, self.clip_obs),
            posinf=1e6, neginf=-1e6,
        )
        states = torch.nan_to_num(
            torch.clamp(states, -self.clip_obs, self.clip_obs),
            posinf=1e6, neginf=-1e6,
        )
        return EnvState(
            phys=phys,
            carry=carry,
            obs=obs,
            states=states,
            reward=reward,
            done=done,
            timeout=progress >= self.timeout_progress,
            progress=progress,
            metrics=metrics,
        )
