"""Vectorized environment: batched reset/step/rollout over all envs
(PyTorch port of the JAX package's `envs/vec_env.py`).

Every env lives on the task's device; one `torch.Generator` on that device
per VecEnv draws the reset noise and, in `rollout`, is handed to the
policy.

Under a process group of W ranks (`parallel/mesh.py`) the `num_envs`
argument counts the envs of all ranks: this process holds its rank's
contiguous `num_envs / W` of them (`mesh.env_range`; `self.num_envs`
counts those), and its generator is seeded from (seed, rank). The JAX
package draws from one key per env, so its 8-device run equals its
1-device run; the port draws from one generator per VecEnv, so a W-rank
run draws other resets than a 1-rank run. The learner's reductions over
the env axis are global and exact.
"""

from __future__ import annotations

import torch

from omniisaacgymenvs_torch.parallel import mesh
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask


class VecEnv:
    def __init__(self, task: RLTask, num_envs: int, seed: int = 0):
        self.task = task
        self.rank, world = mesh.rank(), mesh.world_size()
        mesh.env_range(num_envs, self.rank, world)   # refuses an uneven split
        self.num_envs = num_envs // world
        self.device = task.device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(mesh.rank_seed(seed, self.rank))

    @property
    def num_obs(self) -> int:
        return self.task.num_obs

    @property
    def num_states(self) -> int:
        return self.task.num_states

    @property
    def num_actions(self) -> int:
        return self.task.num_actions

    # ------------------------------------------------------------------
    def reset(self, seed: int = 0) -> EnvState:
        self.generator.manual_seed(mesh.rank_seed(seed, self.rank))
        return self.task.reset(self.num_envs, self.generator)

    def step(self, es: EnvState, actions: torch.Tensor) -> EnvState:
        """actions: (num_envs, num_actions) -> next EnvState."""
        return self.task.step(es, actions, self.generator)

    def step_rl(self, es: EnvState, actions: torch.Tensor):
        """The rl_games-shaped return: (es, {"obs", "states"}, reward, done,
        extras)."""
        es = self.step(es, actions)
        obs_dict = {"obs": es.obs, "states": es.states}
        return es, obs_dict, es.reward, es.done, dict(es.metrics)

    # ------------------------------------------------------------------
    def rollout(self, es: EnvState, policy_fn, horizon: int):
        """`horizon` steps; policy_fn(obs, generator) -> actions. Returns the
        final state and the stacked (obs, reward, done) of every step."""
        obs, rew, done = [], [], []
        for _ in range(horizon):
            actions = policy_fn(es.obs, self.generator)
            es = self.step(es, actions)
            obs.append(es.obs)
            rew.append(es.reward)
            done.append(es.done)
        return es, (torch.stack(obs), torch.stack(rew), torch.stack(done))
