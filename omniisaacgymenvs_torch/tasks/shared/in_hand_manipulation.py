"""Shared in-hand manipulation task (PyTorch port of the JAX package's
`tasks/shared/in_hand_manipulation.py`), batched.

Hand + free block object + goal orientation. Position-target control over
the actuated dofs with moving-average smoothing or relative mode; a goal
hit re-draws the goal without resetting the env; a full reset randomizes
the object pose (position noise and a random orientation) and the hand
dofs; reward = dist * scale + 1 / (|rot_dist| + eps) * rot_scale + action
penalty, with a reach-goal bonus, a fall penalty, success counting and a
consecutive-success average over finished episodes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from omniisaacgymenvs_torch.envs.views import RigidPrimView
from omniisaacgymenvs_torch.parallel import mesh
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask


def randomize_rotation(rand0: torch.Tensor, rand1: torch.Tensor) -> torch.Tensor:
    """Rotation by rand0 * pi about x after rand1 * pi about y."""
    x = rand0.new_tensor([1.0, 0.0, 0.0])
    y = rand0.new_tensor([0.0, 1.0, 0.0])
    return rot.quat_mul(rot.quat_from_angle_axis(rand0 * math.pi, x),
                        rot.quat_from_angle_axis(rand1 * math.pi, y))


class InHandManipulationTask(RLTask):
    """Subclasses set: model, engine, actuated dof indices, coupled-joint
    map, fingertip bodies, goal position, the obs builder."""

    actuated_dof_indices: torch.Tensor     # (num_actions,) long
    coupled_pairs: tuple = ()              # ((follower_dof, leader_dof), ...)
    fingertip_bodies: tuple = ()
    goal_pos: torch.Tensor
    # the yaml's name of the hand's articulation view
    dr_view_name: str = "shadow_hand_view"

    def __init__(self, cfg: dict | None = None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        self.dist_reward_scale = env_cfg.get("distRewardScale", -10.0)
        self.rot_reward_scale = env_cfg.get("rotRewardScale", 1.0)
        self.action_penalty_scale = env_cfg.get("actionPenaltyScale", -0.0002)
        self.success_tolerance = env_cfg.get("successTolerance", 0.1)
        self.reach_goal_bonus = env_cfg.get("reachGoalBonus", 250.0)
        self.fall_dist = env_cfg.get("fallDistance", 0.24)
        self.fall_penalty = env_cfg.get("fallPenalty", 0.0)
        self.rot_eps = env_cfg.get("rotEps", 0.1)
        self.vel_obs_scale = env_cfg.get("velObsScale", 0.2)
        self.reset_position_noise = env_cfg.get("resetPositionNoise", 0.01)
        self.reset_dof_pos_noise = env_cfg.get("resetDofPosRandomInterval", 0.2)
        self.reset_dof_vel_noise = env_cfg.get("resetDofVelRandomInterval", 0.0)
        self.hand_dof_speed_scale = env_cfg.get("dofSpeedScale", 20.0)
        self.use_relative_control = env_cfg.get("useRelativeControl", False)
        self.act_moving_average = env_cfg.get("actionsMovingAverage", 1.0)
        self.max_episode_length = env_cfg.get("episodeLength", 600)
        self.max_consecutive_successes = env_cfg.get("maxConsecutiveSuccesses", 0)
        self.av_factor = env_cfg.get("averFactor", 0.1)
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.decimation = env_cfg.get("controlFrequencyInv", 2)
        self.dt = 1.0 / 60.0
        # random force perturbations on the object: exponential decay every
        # step, re-kicked with a per-env probability
        self.force_scale = env_cfg.get("forceScale", 0.0)
        self.force_prob_range = tuple(
            env_cfg.get("forceProbRange", (0.001, 0.1))
        )
        self.force_decay = env_cfg.get("forceDecay", 0.99)
        self.force_decay_interval = env_cfg.get("forceDecayInterval", 0.08)

    # ------------------------------------------------------------------
    def _post_model_init(self):
        """Call once the subclass has built self.model and self.engine."""
        m = self.model
        self._obj_q = m.root_q_adr("object")
        self._obj_v = m.root_v_adr("object")
        self._obj_body = m.body_index("object")
        self.tips_view = RigidPrimView(m, list(self.fingertip_bodies))
        self._obj_mass = float(m.body_mass[self._obj_body])
        idx = lambda x: torch.as_tensor(  # noqa: E731
            x, dtype=torch.long, device=self.device)
        self._jq, self._jv = idx(m.jq_idx), idx(m.jv_idx)
        # randomization views: the hand's view covers all dofs, the hand's
        # bodies and all tendons, the object's view the cube's body
        self.dr_views = {
            self.dr_view_name: dict(
                dofs=np.arange(m.njd),
                bodies=np.array([i for i in range(m.nb)
                                 if i != self._obj_body]),
                tendons=np.arange(m.nt),
            ),
            "object_view": dict(bodies=np.array([self._obj_body])),
        }

    def initial_carry(self, n: int):
        dev = self.device
        carry = dict(
            goal_rot=rot.quat_identity((n,), device=dev),
            cur_targets=torch.zeros((n, self.model.njd), device=dev),
            successes=torch.zeros(n, device=dev),
            reset_goal=torch.zeros(n, dtype=torch.bool, device=dev),
        )
        if self.force_scale > 0:
            carry["rb_force"] = torch.zeros((n, 3), device=dev)
            carry["force_prob"] = torch.full(
                (n,), self.force_prob_range[0], device=dev)
        return carry

    def initial_metrics(self, n: int):
        return dict(successes=torch.zeros(n, device=self.device))

    # -- statistics across envs (for a learner) -------------------------
    def episode_stats_init(self):
        return dict(consecutive_successes=torch.zeros((), device=self.device))

    def episode_stats_update(self, stats, es: EnvState):
        """Average of the successes of the episodes that ended this step,
        blended into the running value with `averFactor`: a reduction over
        all envs of the post-step state, every rank's under a process group
        (one collective for both sums)."""
        resets = es.done.float()
        num_resets, finished = mesh.all_reduce_sum(torch.stack(
            [resets.sum(), (es.metrics["successes"] * resets).sum()])).unbind()
        cons = stats["consecutive_successes"]
        cons = torch.where(
            num_resets > 0,
            self.av_factor * finished / torch.clamp(num_resets, min=1.0)
            + (1.0 - self.av_factor) * cons,
            cons,
        )
        return dict(stats, consecutive_successes=cons)

    def adjust_progress(self, carry, progress):
        if self.max_consecutive_successes > 0:
            # a goal hit zeroes the progress counter before the time limit
            return torch.where(carry["reset_goal"],
                               torch.zeros_like(progress), progress)
        return progress

    def sample_reset(self, n: int, generator: torch.Generator):
        m = self.model
        dev = self.device

        def uniform(*shape):
            return 2.0 * torch.rand(shape, generator=generator, device=dev) - 1.0

        rand2 = uniform(n, 2)
        new_rot = randomize_rotation(rand2[:, 0], rand2[:, 1])
        pos_noise = self.reset_position_noise * uniform(n, 3)
        goal_rand = uniform(n, 2)
        goal_rot = randomize_rotation(goal_rand[:, 0], goal_rand[:, 1])

        # hand dofs: default + noise * a random delta inside [delta_min,
        # delta_max], both measured from the default pose
        rand_dofs = uniform(n, m.njd)
        dof_default = m.default_q[self._jq]
        delta_max = m.dof_limit_upper - dof_default
        delta_min = m.dof_limit_lower - dof_default
        rand_delta = delta_min + (delta_max - delta_min) * 0.5 * (rand_dofs + 1.0)
        dof_pos = torch.minimum(
            torch.maximum(dof_default + self.reset_dof_pos_noise * rand_delta,
                          m.dof_limit_lower),
            m.dof_limit_upper,
        )
        dof_vel = self.reset_dof_vel_noise * uniform(n, m.njd)

        q = m.default_q.expand(n, -1).clone()
        q[:, self._jq] = dof_pos
        qa = self._obj_q
        q[:, qa: qa + 3] += pos_noise
        q[:, qa + 3: qa + 7] = new_rot
        qd = torch.zeros((n, m.nv), device=dev)
        qd[:, self._jv] = dof_vel

        carry = self.initial_carry(n)
        carry["goal_rot"] = goal_rot
        carry["cur_targets"] = dof_pos
        if self.force_scale > 0:
            # per-env force probability, log-uniform over forceProbRange
            lo, hi = (math.log(x) for x in self.force_prob_range)
            u = torch.rand(n, generator=generator, device=dev)
            carry["force_prob"] = torch.exp(lo + (hi - lo) * u)
        return q, qd, carry

    # ------------------------------------------------------------------
    def control(self, action, es: EnvState, generator=None):
        m = self.model
        dev = self.device
        n = action.shape[0]
        carry = es.carry
        # a goal hit on the previous step re-draws the goal only
        gr = 2.0 * torch.rand((n, 2), generator=generator, device=dev) - 1.0
        new_goal = randomize_rotation(gr[:, 0], gr[:, 1])
        carry["goal_rot"] = torch.where(
            carry["reset_goal"][:, None], new_goal, carry["goal_rot"]
        )
        carry["reset_goal"] = torch.zeros_like(carry["reset_goal"])

        act_idx = self.actuated_dof_indices
        prev = carry["cur_targets"]
        lo = m.dof_limit_lower[act_idx]
        hi = m.dof_limit_upper[act_idx]
        if self.use_relative_control:
            tgt = prev[:, act_idx] + self.hand_dof_speed_scale * self.dt * action
        else:
            tgt = rot.scale(action, lo, hi)
            tgt = (
                self.act_moving_average * tgt
                + (1.0 - self.act_moving_average) * prev[:, act_idx]
            )
        tgt = torch.minimum(torch.maximum(tgt, lo), hi)
        targets = prev.clone()
        targets[:, act_idx] = tgt
        for follower, leader in self.coupled_pairs:
            targets[:, follower] = targets[:, leader]
        carry["cur_targets"] = targets
        ctrl = self.engine.default_control(n)
        ctrl.pos_target = targets
        if self.force_scale > 0:
            decay = self.force_decay ** (self.dt / self.force_decay_interval)
            kick = (
                torch.randn((n, 3), generator=generator, device=dev)
                * self._obj_mass * self.force_scale
            )
            rekick = (torch.rand(n, generator=generator, device=dev)
                      < carry["force_prob"])
            force = torch.where(rekick[:, None], kick, carry["rb_force"] * decay)
            carry["rb_force"] = force
            ctrl.body_force[:, self._obj_body] = force
        return ctrl

    # ------------------------------------------------------------------
    def _object_goal_obs(self, phys, carry):
        qa = self._obj_q
        object_pos = phys.q[:, qa: qa + 3]
        object_rot = phys.q[:, qa + 3: qa + 7]
        object_linvel = phys.body_lvel[:, self._obj_body]
        object_angvel = phys.body_avel[:, self._obj_body]
        quat_diff = rot.quat_mul(object_rot, rot.quat_conjugate(carry["goal_rot"]))
        return object_pos, object_rot, object_linvel, object_angvel, quat_diff

    def reward_done(self, obs, action, phys, carry, progress):
        qa = self._obj_q
        object_pos = phys.q[:, qa: qa + 3]
        object_rot = phys.q[:, qa + 3: qa + 7]
        goal_dist = torch.linalg.norm(object_pos - self.goal_pos, dim=-1)
        quat_diff = rot.quat_mul(object_rot, rot.quat_conjugate(carry["goal_rot"]))
        rot_dist = 2.0 * torch.asin(
            torch.clamp(torch.linalg.norm(quat_diff[:, 1:4], dim=-1), max=1.0)
        )

        dist_rew = goal_dist * self.dist_reward_scale
        rot_rew = 1.0 / (torch.abs(rot_dist) + self.rot_eps) * self.rot_reward_scale
        action_penalty = torch.sum(action ** 2, dim=-1)
        reward = dist_rew + rot_rew + action_penalty * self.action_penalty_scale

        goal_reset = torch.abs(rot_dist) <= self.success_tolerance
        successes = carry["successes"] + goal_reset
        reward = torch.where(goal_reset, reward + self.reach_goal_bonus, reward)

        fell = goal_dist >= self.fall_dist
        reward = torch.where(fell, reward + self.fall_penalty, reward)

        done = fell
        if self.max_consecutive_successes > 0:
            progress = torch.where(goal_reset, torch.zeros_like(progress),
                                   progress)
            done = done | (successes >= self.max_consecutive_successes)
        timed_out = progress >= self.max_episode_length - 1
        done = done | timed_out
        if self.max_consecutive_successes > 0:
            reward = torch.where(timed_out, reward + 0.5 * self.fall_penalty,
                                 reward)

        carry = dict(carry, successes=successes, reset_goal=goal_reset)
        return reward, done, carry, dict(successes=successes)
