"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit, and the nvcc build of the kernels,
     both sources at once (registers and spills as ptxas reports them);
     K1 and K3 come in two forms, a group of lanes per env
     (ops/csrc/fused_step.cu, which also holds K2) and one thread per env
     (ops/csrc/fused_step_thread.cu), and `fused_step.launch_config` picks
     one by the envs per SM: the Humanoid's 32768 envs take the thread
     form, the other main paths and checks below it the group form;
  2. K1 (whole control step), K2 (report FK) and K3 (single substep)
     against their plain versions on the card: Humanoid at 32768 + 37 envs
     (the thread form's masked tail; K2's ragged last round of the
     persistent grid), ShadowHand at 8192 + 37, AnymalTerrain
     at 2048 + 37 (K1 and K3 on terrain planes: K1 as the main path
     launches it, one substep, and over four substeps on the same planes;
     treads, riser walls, step edges and wedge points all in contact),
     BallBalance, Cartpole, Anymal and the synthetic pair scene of
     ops/parity.py (sphere, capsule and box surfaces, a prismatic joint, a
     tendon), on check states that put contact points in the ground and
     pairs in contact; then K1 and K3 under a domain-randomization overlay
     (drawn with numpy over the ShadowHandOpenAI_FF yaml's ranges, on every
     body, joint and tendon): ShadowHandOpenAI_FF at 8192 + 37 envs and 12
     substeps (all ten keys), BallBalance (eight), the pair scene (every
     surface type under geom_scale) and AnymalTerrain (planes and overlay
     together), so all four variants of the step kernel are launched and
     held; and K1 under an all-neutral overlay against K1 without one on
     the Humanoid;
  3. the Humanoid main path: the random-policy entry point's VecEnv at
     32768 envs, reset and a 64-step rollout, with the launch counts read
     around it (K1 exactly once per control step, in the form
     `launch_config` picks, K2 at least as often);
     the rollout's rate over repeated runs; a short rollout on the card
     against the plain path on the CPU;
  4. the ShadowHand main path, the same at 8192 envs, with the cube still
     in the hand in most envs;
  5. the AnymalTerrain main path, the same at 2048 envs: K1 once per
     substep (four launches per control step), each on contact planes
     sampled from the launch before; the terrain level finite;
  6. the ShadowHandOpenAI_FF main path, the hand at 8192 envs under its
     yaml's whole randomization block: K1 once per control step, 12
     substeps, every launch with an overlay of all ten keys that differs
     from env to env; the once-only keys of an env unchanged by its resets;
     gravity_delta zero at the reset and drawn anew exactly where
     progress % 720 == 0;
  7. K1 / K2 / K3 against their plain versions again at the main paths'
     env counts, two launches of each bitwise equal, and their times there
     (CUDA events) with their launch configurations, beside the plain
     versions' and the roofline bound; AnymalTerrain's K1 also at 32768
     envs, a width that fills the card, and under planes and an overlay
     together; the hand's K1 with and without the overlay at 12 and at 8
     substeps;
  8. training on the card, through the learner's entry point
     (`PPOTrainer.train` on the CLI's env, `scripts/common.py`): Humanoid
     at 4096 envs under HumanoidPPO.yaml (bf16 networks), reset and 3
     epochs, with the launch counts read around them (K1 exactly once per
     control step of every rollout, in the form `launch_config` picks, K2
     at least as often, no plain physics), every metric finite and the
     learning rate within its bounds; then one learner epoch (GAE, norms,
     SGD) on a stored rollout on the card and on the CPU with the same
     permutations, f32 networks, held at the CPU parity tests' rule, and
     the same epoch under the TPU's matmul rule (net_matmul=bf16_operands)
     within RULE_ATOL, RULE_REL and RULE_METRIC_RTOL, bounds set from
     readings on an H100; and ShadowHandOpenAI_FF at 8192 envs, 2 epochs
     with the central value;
  9. the recurrent learner and its checkpoints on the card:
     ShadowHandOpenAI_LSTM at 8192 envs under ShadowHandOpenAI_LSTMPPO.yaml
     (bf16 networks, 1024-unit LSTMs for the actor and the central value),
     2 epochs through `PPOTrainer.train` with a checkpoint every epoch into
     a temporary directory, the launches counted as in phase 8 (K1 16 an
     epoch, every one with the overlay); `nn/last` loaded into a fresh
     trainer on the card, every leaf (parameters, Adam moments and counts,
     norms, lr, LSTM states, env state, both generators) bitwise equal to
     the saved trainer's; one more epoch from each, their parameters within
     LEARNER_ATOL (and whether bitwise); the same checkpoint loaded on the
     CPU (torch.load's map_location), every leaf but the generators'
     bitwise; `scripts/train.py test=True checkpoint=<nn/last>
     max_iterations=32` on the card, a finite mean reward; and one f32 LSTM
     learner epoch (central value and actor) on a stored rollout of 512
     envs at the yaml's widths, card against CPU, held as in phase 8;
 10. FrankaCabinet, AllegroHand and the three flyers, each at its yaml's numEnvs
     (FrankaCabinet, Crazyflie, Quadcopter and Ingenuity 4096, AllegroHand
     8192) under its yaml: K1 in both forms (forced with `design=`) and K2
     against their plain versions at numEnvs + N_PAD envs on check states
     (FrankaCabinet: the finger pads on the handle bar and the four FREE
     props on the drawer's tray; Quadcopter: 1 N on each rotor, whose
     centre of mass is off its origin; AllegroHand's K1 judged on its
     well-conditioned envs, `parity.check_keep`), and again at numEnvs, two launches
     of each bitwise equal, with their times (events and profiler device
     time, every launch in the trace) and launch configurations beside the plain version's and the
     bound; the random-policy main path of 64 steps as in phases 3-5 (K1
     once per control step, K2 at least as often, no plain physics), a
     3-step rollout on the card against the plain path on the CPU with the
     step's control draws shared (AllegroHand's judged where the plain
     rollout is well conditioned); and 2 epochs through `PPOTrainer.train`
     under the task's train yaml, as in phase 8;
 11. Custom on imported robots (Custom.yaml, 4 substeps per K1 launch):
     examples/double_pendulum.urdf with a FIXED and a FREE base (the FREE
     one lowered into the ground) and the MJCF chain carried below as a
     string (hinge and slide joints, a body with two joints, degree angles,
     a <default> class, sphere, capsule and box geoms; its foot in the
     ground): K1 in both forms and K2 against their plain versions at
     512 + N_PAD and at 32768 + N_PAD envs, then at 512 and 32768 two
     launches of each bitwise equal and their times (events and profiler
     device time) beside the plain version's, the bound and the launch
     configuration; for the FIXED example and the chain the random-policy
     main path of 64 steps at 512 envs (K1 once per control step, K2 at
     least as often, no plain physics), 3 steps against the CPU and 2
     epochs through `PPOTrainer.train` under CustomPPO.yaml; then the JAX
     package's learning bar through scripts/train.py: the double pendulum,
     120 epochs of 256 envs, seed 3, episodes of 100 steps,
     mean_ep_reward above 20;
 12. distributed training on the one card: (a) `torchrun --standalone
     --nproc_per_node=1 -m omniisaacgymenvs_torch.scripts.train
     task=Humanoid distributed=True num_envs=4096 max_iterations=2` (NCCL,
     world size 1) exits 0 with finite metrics; (b) two ranks on cuda:0
     under gloo (NCCL refuses two ranks on one card), Humanoid at 2 x 2048
     envs, the worker of tests/test_torch_distributed.py: one learner
     epoch of exact f32 networks (net_matmul=f32) on a stored rollout
     equals the 1-rank epoch with the ranks' permutations composed (every parameter within LEARNER_ATOL), then 2
     epochs through `PPOTrainer.train` with K1 once per control step in
     each rank and a checkpoint resumed at world size 2 bit for bit. Every
     child process has a timeout of its own, and its failure fails the run;
 13. the demos and the regression harness on the card: (a) `python -m
     omniisaacgymenvs_torch.scripts.gpu_regression` in a process of its own
     exits 0 with "ok" true, each check's numbers logged; (b) K1, K2 and K3
     against their plain versions at the demos' widths, never launched
     before: Anymal at 1 env, AnymalTerrain at 1 and 4 envs on terrain
     planes, with their launch configurations; (c) the interactive demo's
     selftest (200 control steps, 1 env) for task=Anymal and
     task=AnymalTerrain: K1 exactly once per control step (AnymalTerrain:
     four), K2 at least once, no plain physics, a finite displacement; and
     its first 3 steps from a reset held against the same steps on the CPU
     with the card's weights (exact f32 networks, net_matmul=f32, no
     observation noise); (d) the
     AnymalTerrain demo, 700 steps and 2800 K1 launches, its .npz with the
     JAX demo's keys and shapes; (e) `scripts/play.py record=` of Anymal and
     its keys (the viewer needs matplotlib: it is tested on the CPU); then K1
     and K2 at the demos' widths held again and timed beside their plain
     versions and bounds, their launches those of the demos' runs;
 14. the training campaign runner (`python -m
     omniisaacgymenvs_torch.scripts.campaign`), seed 42, on two cases:
     (a) AnymalTerrain at its yaml's 2048 envs and 10 x 20 terrain grid
     with riser walls, save_frequency 2: 4 epochs in one chunk, then the
     same 4 epochs in two chunks of 2; (b) ShadowHand_DR, the hand under its
     yaml's randomization block at 16384 envs (ShadowHand_DR's width, the
     thread form of K1 under an overlay), save_frequency 1: 2 epochs in one
     chunk, then in two chunks of 1. Between the chunks runs/<experiment>
     is deleted and restored from `out=` (what a new machine sees). Every
     history.json row equals the uninterrupted run's in every key but
     steps_per_sec (wall clock), and every leaf of the final nn/last
     (model.pt, env.pt) is bitwise equal. Each child runs
     scripts/train.py, which sets the kernels' counts to 0 before its
     training loop and logs them after it: (a) K1 four times per control
     step (one substep each, on terrain planes), no overlay; (b) K1 once
     per control step, every launch in the thread form and with the
     overlay (the reset draws of stiffness, damping and mass scales stay in
     every env's carry); both K2 at least once per control step and no K3.
     The ShadowHand_DR child's train-steps/s and nn/last size are printed.
     Each child has a timeout of its own, and its failure fails the run.
 15. the JAX package's trained ShadowHand policy on the card: the state
     tests/torch_jax_checkpoint.py carried into the port
     (results_torch/ShadowHand_jax_final, epoch 9980) loaded through
     `scripts/train.py`'s `build_trainer` (test=True, exact f32 networks:
     net_matmul=f32), its
     deterministic policy for 601 steps at 1024 envs from the reset of seed
     123 (`scripts/train.evaluate`) through K1 in the group form: K1 exactly
     once per control step, K2 at least as often, no plain physics; the
     mean reward and the successes of a finished episode within
     TRAINED_BAND, the band of the same evaluation on the CPU at three
     seeds (tests/torch_policy_transfer.py only=port). The first check of
     the env on the card at a trained policy's states.
 16. AllegroHand's falls on the card (tests/torch_fall_rates.py): the
     yaml's 8192 envs for 150 control steps under a held policy (+1 or -1
     in every action dimension, drawn with numpy from seed 0 and held 4
     steps), once through K1 in the form `launch_config` picks (the product
     path: K1 exactly once per control step, no plain physics) and once
     through `fused_step.step_plain` on the card's tensors (the task's
     physics replaced in the script), from the same resets: the resets by
     cause (fell, timeout, non-finite, other), each within FALLS_SD_MAX
     standard deviations of the difference of the two Poisson rates, the
     counts, goal hits, ejections and episode lengths printed. The check
     no kernel check makes: whether K1 drops the cube more often than the
     plain path, the ill-conditioned envs included.
 17. AllegroHand's learner from a trained state at its yaml's width: the
     port's state after 2000 epochs of seed 1 in f32
     (results_torch/AllegroHand_seed1/model.pt: networks, Adam moments,
     norms, lr) loaded through `scripts/train.py`'s `build_trainer` at 8192
     envs under AllegroHandPPO.yaml (minibatch 32768, 5 mini-epochs), one
     rollout of 16 steps through K1 in the group form (K1 exactly once per
     control step, K2 at least as often, no plain physics), then one
     learner epoch on that stored rollout held card against CPU step by
     step: the CPU runs the epoch and at each of its 20 minibatch steps the
     card takes the same step from the CPU's state of that moment; GAE and
     the norms' updates from the same inputs. Exact f32 networks: every
     parameter within LEARNER_ATOL and each tensor's step within
     LEARNER_STEP_REL of the CPU's; the TPU's matmul rule within RULE_ATOL
     and RULE_REL; under both, Adam's two moments after each step within
     that step bound of each tensor's largest element, the lr steps equal
     and the epoch's loss metrics within phase 8's rtol (1e-3 in f32,
     RULE_METRIC_RTOL under the rule). Every minibatch's loss terms (actor,
     critic, entropy, bounds, KL, total) and the lr after it logged for the
     card, with the largest gap from the CPU's, and the tensor and step of
     each worst reading. (Two epochs run apart from this trained state part
     by more: the epoch grows f32 rounding, and the CPU's own f32 epoch
     parts from its f64 epoch past these bounds, tools/learner_card_cpu.py.)
 18. models past the one-thread-per-env form's maxima, which the group
     form takes (`launch_config` never picks the thread form for them), and
     past a block's shared memory, which the group form's device-memory
     placement takes: (a) FrankaCabinet with task.env.numProps=16 (31
     bodies, 152 contact points, 402 pairs, 16 FREE roots) at the yaml's
     4096 envs: K1 in the group form and K2 against their plain versions
     at 4096 + N_PAD on phase 10's check states (the pads on the handle
     bar, the props on the tray, pairs in contact), again at 4096 with two
     launches of each bitwise equal and their times (events and profiler
     device time) beside the plain version's and the bound, the
     random-policy main path of 64 steps (K1 once per control step, K2 at
     least as often, no plain physics), 3 steps against the CPU with the
     control draws shared and 2 epochs through `PPOTrainer.train` under
     FrankaCabinetPPO.yaml; (b) Custom on `mjcf_legs`, an MJCF robot
     generated here (a FREE torso on 13 three-link legs: 40 bodies, 160
     contact points, its feet in the ground) at Custom.yaml's 512 envs,
     the same checks but training; (c) `parity.build_wide_tree`, a FREE
     base on 150 and on 375 two-link legs (301 and 751 bodies, one env's
     working set past a block's shared memory: `launch_config` reports
     working_set "global"; the 751-body tree's tables and K2 too): K1, K3
     and K2 against their plain versions at 512 + N_PAD envs (and the
     301-body tree at 4096), two launches of each bitwise equal and their
     times beside the plain version's and the bound.
Tolerances and check states come from omniisaacgymenvs_torch/ops/parity.py.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
# outside the tensor cores, FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

STEPS = 64
RATE_RUNS = 3  # untraced rollouts timed for the rate's spread
# the main paths: task, env count (the task yaml's numEnvs for ShadowHand
# and AnymalTerrain)
MAIN = {"Humanoid": 32768, "ShadowHand": 8192, "AnymalTerrain": 2048,
        "ShadowHandOpenAI_FF": 8192}
RANDOMIZED = "ShadowHandOpenAI_FF"  # the main path under domain randomization
# scenes whose K1 and K3 are also held under an overlay
OVERLAY_CHECKS = (RANDOMIZED, "BallBalance", "PairScene", "AnymalTerrain")
# smaller scenes that hold a FIXED root, a prismatic joint, a forest and
# every surface type on the card, and the flat-ground Anymal
SIDE = {"BallBalance": 4096, "Cartpole": 512, "PairScene": 4096,
        "Anymal": 4096}
WIDE = 32768  # AnymalTerrain's K1 is also timed at a width that fills the card
N_PAD = 37  # the checks' env counts are not a multiple of a block's envs
# end to end, kernel path on the card vs plain path on the CPU, 3 steps
E2E_TOL = (5e-3, 5e-3)
# on a model whose step is ill conditioned in some envs
# (parity.COND_MAX_EXCLUDED_BY_MODEL: the AllegroHand) the end-to-end
# rollout is judged where the plain rollout is well conditioned, and at most
# this share of its envs may fall out: the rollout starts from resets, the
# cube dropped in a random orientation onto the tilted palm, harsher than the
# kernel checks' states
E2E_COND_MAX_EXCLUDED = 0.05
# phase 8: task, envs, epochs (the Humanoid at its yaml's 4096 envs)
TRAIN = {"Humanoid": (4096, 3), "ShadowHandOpenAI_FF": (8192, 2)}
# phase 9: the recurrent learner (task, envs, epochs: the yaml's 8192), and
# the envs of the stored rollout its f32 learner epoch runs on, card vs CPU
TRAIN_LSTM = ("ShadowHandOpenAI_LSTM", 8192, 2)
LSTM_CPU_ENVS = 512
# phases 8 and 9: one f32 learner epoch, card vs CPU, every parameter (the
# two read within 3e-8 of each other on an H100 in phase 8)
LEARNER_ATOL = 1e-5
# phase 8: the same epoch under the TPU's matmul rule (net_matmul=
# bf16_operands: operands rounded to bf16, f32 sums), card against CPU. A
# sum that ends in another order can round an operand of the next product
# to another bf16 value, so the two sides part by more than under f32;
# the bounds stand some four times over the readings on an H100: every
# parameter 7.455e-05 apart at most, |card - cpu| over the CPU's change
# 1.391e-02 in the worst tensor, kl 1e-4 apart relative (the other metrics
# were not logged then: their bound is the kl reading's hundredfold)
RULE_ATOL, RULE_REL, RULE_METRIC_RTOL = 3e-4, 6e-2, 1e-2
# phase 17: the learner step from the CPU's state, card against CPU in f32:
# each tensor's step within LEARNER_STEP_REL of the CPU's (|card - cpu| over
# |cpu step|), and each of Adam's moments after the step within it of the
# tensor's largest element (Adam's step is one moment over the other's root,
# so a moment that parts by a share of its scale moves the step by as much).
# Read on an H100 at most 1.05e-2 in the step and 1.78e-2 in the first
# moment (5.1e-5 in the second), where the card's f32 gradients round
# otherwise than the CPU's (tools/learner_card_cpu.py: a step from an f64
# state stands up to 4.8 times farther from it on the card than on the CPU
# at 10 of 60 steps, the biases foremost); a gradient a few percent off
# moves the step by as much. The TPU's rule holds both to RULE_REL
LEARNER_STEP_REL = 3e-2
# phase 11: Custom.yaml's numEnvs, a width that fills the card, training
# epochs, and the learning bar of the JAX package's
# tests/test_custom_robot.py (the double pendulum, 120 epochs of 256 envs,
# seed 3, episodes of 100 steps: mean_ep_reward above 20)
CUSTOM_ENVS = 512
CUSTOM_WIDE = 32768
CUSTOM_EPOCHS = 2
CUSTOM_LEARN = dict(envs=256, seed=3, episode_length=100, epochs=120, bar=20.0)
# phase 12: the task and its envs over all ranks (2 ranks x 2048 under
# gloo), each child process's timeout
DIST_TASK = ("Humanoid", 4096)
DIST_TIMEOUT_S = 600
# phase 13: the regression harness's timeout; the demos' widths, held and
# timed (the interactive demo's 1 env, the AnymalTerrain demo's 4); the
# interactive selftest's control steps; the demo steps held card vs CPU, at
# tests/test_torch_anymal.py's tolerances (obs rtol, atol; rewards)
REGRESSION_TIMEOUT_S = 600
# phase 14: each case's experiment, task, envs, epochs in all and per
# chunk, the runner's checkpoint cadence, its overrides and the K1 launches
# a control step (AnymalTerrain's yaml width; ShadowHand_DR's 16384), and
# each child's timeout
CAMPAIGNS = (
    dict(exp="terrain", task="AnymalTerrain", envs=2048, epochs=4, chunk=2,
         save_frequency=2, overrides=("task.env.terrain.riserWalls=True",),
         k1_per_step=4, overlay=False, thread=False),
    dict(exp="dr", task="ShadowHand", envs=16384, epochs=2, chunk=1,
         save_frequency=1, overrides=("task.domain_randomization.randomize=True",),
         k1_per_step=1, overlay=True, thread=True),
)
CAMPAIGN_TIMEOUT_S = 300
# phase 15: the carried JAX policy's evaluation (envs, control steps, the
# reset's seed) and its band. The same evaluation on the CPU at seeds 123,
# 0 and 1 (tests/torch_policy_transfer.py only=port num_envs=1024; PERF.md
# §6) reads 3418.49, 3406.72, 3398.10 a finished episode and 12.7990,
# 12.7377, 12.7277 successes a finished episode; the card draws its resets
# from its own generator, so it is one more seed: the band is the three
# seeds' range widened by three times its width on each side
TRAINED_POLICY = dict(checkpoint="results_torch/ShadowHand_jax_final", envs=1024,
                      steps=601, seed=123)
TRAINED_BAND = dict(reward=(3336.93, 3479.66), successes=(12.5138, 13.0129))
# phase 16: AllegroHand's held-policy fall counts, K1 against step_plain
# (envs, control steps, steps an action is held, the numpy seed), and the
# bound on each reset cause's rate difference in standard deviations
FALLS = dict(envs=8192, steps=150, hold=4, seed=0)
FALLS_SD_MAX = 4.0
# phase 17: AllegroHand's learner from a trained state at the yaml's width:
# the port's state after 2000 epochs of seed 1 in f32 (networks, Adam
# moments at count 40,000, norms, lr), the yaml's 8192 envs, and the seed
# of the rollout's resets and noise
TRAINED_LEARNER = dict(checkpoint="results_torch/AllegroHand_seed1", envs=8192, seed=0)
DEMO_WIDTHS = (("Anymal", 1), ("AnymalTerrain", 1), ("AnymalTerrain", 4))
SELFTEST_STEPS = 200
DEMO_CPU_STEPS = 3
DEMO_OBS_TOL, DEMO_REW_TOL = (2e-3, 2e-3), 1e-3
# phase 10: the arm, the second hand and the flyers at their yamls' numEnvs
ARM_HAND_FLYERS = {"FrankaCabinet": 4096, "Crazyflie": 4096, "Quadcopter": 4096,
          "Ingenuity": 4096, "AllegroHand": 8192}
ARM_HAND_FLYERS_EPOCHS = 2
# phase 18: the models past the thread form's maxima at their yamls'
# numEnvs (FrankaCabinet with 16 props, Custom on mjcf_legs), and the wide
# trees of parity.build_wide_tree (key, legs, widths checked, width timed):
# 301 bodies, K1 / K3 in device memory with the tables in shared memory;
# 751, K1 / K3 and K2 in device memory with the tables there too
LARGE_ENVS = {"FrankaCabinet/16": 4096, "Custom/legs": 512}
WIDE_TREES = (("WideTree/301", 150, (512 + N_PAD, 4096), 4096),
              ("WideTree/751", 375, (512 + N_PAD,), 512 + N_PAD))
# the source of each form of the kernels
SOURCES = {"group": "omniisaacgymenvs_torch/ops/csrc/fused_step.cu",
           "thread": "omniisaacgymenvs_torch/ops/csrc/fused_step_thread.cu"}
TPU_FILE = "omniisaacgymenvs_tpu/ops/fused_substep.py"
# phase 11: the Custom task's robots. The URDF example with a FIXED and a
# FREE base, and an MJCF chain: hinge and slide joints, a body with two
# joints (expanded into a chain through a body of 1e-4 kg), degree angles,
# a <default> class, sphere, capsule and box geoms; its foot's sphere and box
# sit 1 cm in the ground (parity.CHECK_PROFILES "mjcf_chain")
URDF_EXAMPLE = "examples/double_pendulum.urdf"
MJCF_CHAIN = """<mujoco model="mjcf_chain">
  <compiler angle="degree"/>
  <default>
    <joint damping="0.1" armature="0.01"/>
    <geom density="600"/>
    <default class="slider">
      <joint type="slide" damping="2.0" range="-0.1 0.1"/>
    </default>
  </default>
  <worldbody>
    <body name="base" pos="0 0 0.64">
      <geom type="box" size="0.1 0.1 0.05"/>
      <body name="upper" pos="0 0 -0.05" euler="0 0 30">
        <joint name="hip" type="hinge" axis="0 1 0" range="-90 90"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.04"/>
        <body name="lower" pos="0 0 -0.3">
          <joint name="knee" axis="0 1 0" range="-120 0"/>
          <joint name="shin" class="slider" axis="0 0 1"/>
          <geom type="capsule" fromto="0 0 0 0 0 -0.25" size="0.03"/>
          <body name="foot" pos="0 0 -0.25">
            <joint name="ankle" axis="1 0 0" range="-45 45"/>
            <geom type="sphere" size="0.05"/>
            <geom type="box" pos="0.05 0 -0.03" size="0.08 0.04 0.02"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator><motor name="hip_motor" joint="hip" gear="50"/></actuator>
</mujoco>
"""

# phase 18(b): a robot past the thread form's maxima, generated as MJCF: a
# FREE torso (four spheres) on 13 legs of three hinged links each, 40
# bodies, four spheres of 2 cm down every 15 cm link (160 contact points);
# the legs hang from a ring of hips, each hinge within +-20 degrees, so the
# torso stays above Custom.yaml's terminationHeight; the feet's lowest
# spheres sit 5 mm in the ground at default_q (parity.CHECK_PROFILES
# "many_legs")
def mjcf_legs() -> str:
    """The MJCF of phase 18(b)'s robot, as a string."""
    n_legs, links, spheres, link, radius = 13, 3, 4, 0.15, 0.02

    def leg(k):
        a = 2 * math.pi * k / n_legs
        body = ""
        for j in reversed(range(links)):
            balls = "".join(
                f'<geom type="sphere" size="{radius}" pos="0 0 '
                f'{-link * (s + 1) / spheres:.6f}"/>' for s in range(spheres))
            pos = (f"{0.2 * math.cos(a):.6f} {0.2 * math.sin(a):.6f} 0" if j == 0
                   else f"0 0 {-link}")
            euler = f' euler="0 0 {math.degrees(a):.6f}"' if j == 0 else ""
            body = (f'<body name="leg{k}_{j}" pos="{pos}"{euler}>'
                    f'<joint name="leg{k}_j{j}" type="hinge" axis="0 1 0" '
                    f'range="-20 20"/>{balls}{body}</body>')
        return body

    torso = "".join(f'<geom type="sphere" size="0.05" pos="{x} {y} 0"/>'
                    for x, y in ((0.1, 0), (-0.1, 0), (0, 0.1), (0, -0.1)))
    z = links * link + radius - 0.005
    return (f'<mujoco model="many_legs"><compiler angle="degree"/><worldbody>'
            f'<body name="torso" pos="0 0 {z:.6f}"><freejoint/>{torso}'
            + "".join(leg(k) for k in range(n_legs))
            + "</body></worldbody></mujoco>")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from omniisaacgymenvs_torch.envs import VecEnv
    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
    from omniisaacgymenvs_torch.scripts import random_policy
    from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
    from omniisaacgymenvs_torch.scripts.time_kernels import TRACE_PAD_S, kernel_times
    from omniisaacgymenvs_torch.tasks import get_task
    from omniisaacgymenvs_torch.utils.config import load_config
    from omniisaacgymenvs_torch.utils.domain_randomization import combine_overlays

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib = fs.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"(both nvcc at once {lib.build_s:.2f} s) -> {lib.path.name}, "
        f"{lib.thread_path.name}")
    for line in lib.ptxas_log.splitlines():
        if any(k in line for k in ("registers", "spill", "stack frame",
                                   "Compiling entry")):
            log(f"  ptxas: {line.strip()}")

    # the engines the kernels are held on: each task as its yaml configures
    # it, the pair scene alone; n_sub: the substeps of the main path's K1
    # launch (a whole control step, or one substep where the terrain planes
    # are refreshed before each)
    tasks, engines, n_sub = {}, {}, {}
    for name in list(MAIN) + list(SIDE) + list(ARM_HAND_FLYERS):
        if name == "PairScene":
            engines[name] = PhysicsEngine(parity.build_pair_scene(dev),
                                          SimParams(dt=1.0 / 120.0, substeps=2))
            n_sub[name] = 4
        else:
            task = get_task(name, load_config({"task": name})["task"], device=dev)
            tasks[name], engines[name] = task, task.engine
            n_sub[name] = (task.decimation * task.engine.params.substeps
                           // task.engine.k1_launches(task.decimation))

    def check_states(name: str, n: int, seed: int, overlay=None):
        """(q, qd, eff, {planes} on terrain) of `name`'s check states, moved
        off the ties of two box faces under `overlay`'s geom_scale. Kernel
        and plain version get the same planes tensor, computed once here:
        which feature a point resolves to is a discontinuity of the plane
        function, not of the kernels."""
        eng = engines[name]
        if not eng.has_terrain:
            q, qd, eff = parity.check_inputs(eng.model, n, seed=seed, device=dev)
            return parity.clear_box_ties(eng, q, qd, overlay), qd, eff, {}
        q, qd, eff = parity.terrain_check_inputs(tasks[name], n, seed, dev)
        return q, qd, eff, {"planes": eng._contact_planes(eng.init_state(q, qd))}

    def check(name: str, n: int, seed: int, overlay: bool = False,
              cover: bool = True) -> dict:
        """K1, K2 and K3 of `name`'s engine against their plain versions on
        n check states; the largest abs error per kernel. With `overlay`,
        K1 and K3 under a randomization overlay of every key the model has
        a size for. `cover`: the states must put a point on every terrain
        feature (not asked of the demos' 1 and 4 envs)."""
        eng = engines[name]
        m = eng.model
        ov = parity.overlay_inputs(m, n, seed, dev) if overlay else None
        q, qd, eff, pl = check_states(name, n, seed, ov)
        if overlay:
            pl = {**pl, "overlay": ov}
        ptg = parity.check_targets(m, q, seed)
        z = torch.zeros((n, m.njd), device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        fa = 0.05 * torch.randn((n, m.nb, 6), device=dev, generator=gen)
        terrain = "planes" in pl
        active = (parity.terrain_contacts(tasks[name], eng, q, qd) if terrain
                  else parity.active_contacts(eng, q, qd))
        log(f"{name} check{' under an overlay of ' + str(sorted(pl['overlay'])) if overlay else ''}: "
            f"{n} envs, {n_sub[name]} substeps, active contacts {active}")
        if name == "Humanoid":
            assert active["ground"] > 0, "no contact point in the ground"
        if terrain and cover:
            assert min(active.values()) > 0, f"a terrain feature is not hit: {active}"
        if len(m.pair_surf):
            assert active["pairs"] > 0, "no pair in contact"
        if name == "PairScene":
            assert min(active[k] for k in ("sphere", "capsule", "box")) > 0, active

        tag = " overlay" if overlay else ""

        def k1(n_steps):
            return ("step", f"K1{tag} x{n_steps}", parity.STEP_NAMES, parity.step_tol(m),
                    lambda: fs.step(eng, q, qd, eff, ptg, z, fa, n_steps, **pl),
                    lambda q_=q, qd_=qd: fs.step_plain(eng, q_, qd_, eff, ptg, z, fa,
                                                       n_steps, **pl))

        errs = {}
        # on terrain also four substeps on the same planes (the launch of an
        # engine without the plane refresh)
        before = dict(eng.kernels.overlay_launches)
        for key, label, names, tol, run_k, run_p in (
            *([k1(4)] if terrain and n_sub[name] != 4 else []),
            k1(n_sub[name]),
            # no overlay reaches the report FK
            *([] if overlay else [
                ("fk", "K2", parity.FK_NAMES, parity.FK_TOL,
                 lambda: fs.fk(eng, q, qd), lambda: fs.fk_plain(m, q, qd))]),
            ("substep", f"K3{tag}", parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL,
             lambda: fs.substep(eng, q, qd, eff, ptg, z, fa, **pl),
             lambda q_=q, qd_=qd: fs.substep_plain(eng, q_, qd_, eff, ptg, z, fa,
                                                   **pl)),
        ):
            out, ref = run_k(), run_p()
            torch.cuda.synchronize()
            keep = None
            if overlay:
                # judged where the step is well conditioned (ops/parity.py)
                keep = parity.well_conditioned(run_p, q, qd, ref, names, tol)
                log(f"  {name} {label}: {int((~keep).sum())} of {n} envs left "
                    f"out as ill conditioned")
            err = parity.assert_within(
                f"{name} {label}", parity.compare(out, ref, names, tol, keep),
                tol, log)
            errs[key] = max(err, errs.get(key, 0.0))
        # the counters tell the launches that read an overlay apart
        grew = {k: v - before[k] for k, v in eng.kernels.overlay_launches.items()}
        want = {"step": 2 if terrain and n_sub[name] != 4 else 1, "substep": 1}
        assert grew == (want if overlay else {"step": 0, "substep": 0}), grew
        return errs

    # ---- 2. kernels against their plain versions ----
    errs, overlay_errs = {}, {}
    for name, n in {**MAIN, **SIDE}.items():
        errs[name] = check(name, n + N_PAD, seed=0)
    for name in OVERLAY_CHECKS:
        n = {**MAIN, **SIDE}[name] + N_PAD
        overlay_errs[name] = check(name, n, seed=0, overlay=True)
    # an all-neutral overlay against no overlay: the overlay variant of the
    # kernel computes x * 1 and x + 0 where the other computes x
    eng = engines["Humanoid"]
    m, n = eng.model, MAIN["Humanoid"] + N_PAD
    q, qd, eff, _ = check_states("Humanoid", n, seed=0)
    z = torch.zeros((n, m.njd), device=dev)
    fa = torch.zeros((n, m.nb, 6), device=dev)
    neutral = {k: torch.ones_like(v) if k.endswith("_scale")
               else torch.zeros_like(v)
               for k, v in parity.overlay_inputs(m, n, 0, dev).items()}
    a = fs.step(eng, q, qd, eff, z, z, fa, n_sub["Humanoid"], overlay=neutral)
    b = fs.step(eng, q, qd, eff, z, z, fa, n_sub["Humanoid"])
    torch.cuda.synchronize()
    diff = parity.assert_within(
        "Humanoid K1 neutral overlay vs none",
        parity.compare(a, b, parity.STEP_NAMES, parity.STEP_TOL),
        parity.STEP_TOL, log)
    log(f"Humanoid K1, all-neutral overlay against no overlay, {n} envs: "
        f"largest difference {diff:.3e}")

    # ---- 3./4./5. the main paths ----
    launches = {}

    def main_path(name: str, n: int, e2e_envs: int, e2e_cfg=None, extra=(),
                  key=None):
        """`name`'s random-policy main path at n envs (`extra`: more CLI
        overrides), its launches kept under launches[key or name]."""
        argv = [f"task={name}", f"num_envs={n}", f"max_iterations={STEPS}",
                "seed=0", "device=cuda", *extra]
        cfg, mtask, env = build_env_from_cli(argv)
        kern = mtask.engine.kernels
        form = kern.config(n, mtask.engine.has_terrain, mtask._dr_on)[0]["design"]
        kern.reset_counts()
        with plain_physics_counted() as plain:
            stats = random_policy.drive(cfg, env)
        assert plain["n"] == 0, "the main path ran the plain physics"
        key = key or name
        launches[key] = dict(kern.launches)
        # under randomization every K1 launch reads an overlay, else none;
        # every K1 launch takes the form launch_config picks for the path
        assert kern.overlay_launches == {
            "step": launches[key]["step"] if mtask._dr_on else 0,
            "substep": 0}, kern.overlay_launches
        assert kern.thread_launches == {
            "step": launches[key]["step"] if form == "thread" else 0,
            "substep": 0}, kern.thread_launches
        log(f"main path: {card} | {key} {n} envs x {STEPS} steps: "
            f"{stats['env_steps_per_s']:.1f} env-steps/s, "
            f"{stats['seconds'] * 1e3 / STEPS:.3f} ms per control step, "
            f"mean reward {stats['mean_reward']:.4f}, done rate "
            f"{stats['done_rate']:.4f}, launches {launches[key]}, K1 in the "
            f"{form} form")
        # K1 once per control step, or once per substep with the plane
        # refresh; K2 at every reset (each step computes one for the merge)
        per_step = mtask.engine.k1_launches(mtask.decimation)
        assert launches[key]["step"] == STEPS * per_step, launches
        assert launches[key]["fk"] >= STEPS, launches
        assert launches[key]["substep"] == 0, launches
        es = stats["state"]
        obs, rew, done = stats["trajectory"]
        assert obs.shape == (STEPS, n, mtask.num_obs), obs.shape
        assert rew.shape == (STEPS, n)
        for label, x in (("obs", obs), ("reward", rew), ("q", es.phys.q),
                         ("qd", es.phys.qd), ("body_pos", es.phys.body_pos)):
            assert torch.isfinite(x).all(), f"non-finite {label}"
        # Humanoid: most envs stay up; ShadowHand: the cube stays in the
        # hand in most envs (the plain path on the CPU shows a done rate of
        # the same size under the same policy, PERF.md)
        assert float(done.float().mean()) < 0.5, "most envs must not end"
        if "episode/terrain_level" in es.metrics:
            level = es.metrics["episode/terrain_level"]
            assert torch.isfinite(level).all(), "non-finite terrain level"
            log(f"  terrain level: mean {float(level.mean()):.4f}, max "
                f"{float(level.max()):.0f}")
        if mtask._dr_on:
            randomization_checks(mtask, env, es)
        del es, obs, rew, done, stats
        rates = []
        for _ in range(RATE_RUNS):
            r = random_policy.drive(cfg, env)
            rates.append(r["env_steps_per_s"])
            del r
        rs = sorted(rates)
        log(f"main path rate: {card} | {key} {RATE_RUNS} more rollouts of "
            f"{STEPS} steps: env-steps/s min {rs[0]:.1f}, median "
            f"{rs[len(rs) // 2]:.1f}, max {rs[-1]:.1f} "
            f"({', '.join(f'{x:.1f}' for x in rates)})")
        del env

        # a short rollout on the card vs the plain path on the CPU, same
        # start and actions; envs that reset, or hit their goal and have it
        # drawn anew, in either are left out (the two draw from different
        # generators)
        task_cfg = cfg["task"] if e2e_cfg is None else e2e_cfg(cfg["task"])
        genv = VecEnv(get_task(name, task_cfg, device=dev), e2e_envs, seed=5)
        cenv = VecEnv(get_task(name, task_cfg, device="cpu"), e2e_envs, seed=5)
        ges0 = genv.reset(seed=5)
        ces0 = state_to(ges0, "cpu")
        g = torch.Generator().manual_seed(7)
        # a task that draws in its control (a flyer's target or thrust
        # noise) takes the same draws on both sides
        has_draws = hasattr(cenv.task, "control_draws")
        draws, actions = [], []
        for _ in range(3):
            if has_draws:
                draws.append(cenv.task.control_draws(e2e_envs, g))
            actions.append(2 * torch.rand((e2e_envs, genv.num_actions), generator=g) - 1)

        def rollout(env, es, device):
            """3 steps of env from es; (final state, envs that reset or hit
            their goal and had it drawn anew: the two sides draw those from
            different generators)."""
            ended = torch.zeros(e2e_envs, dtype=torch.bool)
            for k in range(3):
                if has_draws:
                    env.task.control_draws = lambda n, _g, d=draws[k]: d.to(device)
                es = env.step(es, actions[k].to(device))
                ended |= es.done.cpu()
                if "reset_goal" in es.carry:
                    ended |= es.carry["reset_goal"].cpu()
            return es, ended

        ges, g_end = rollout(genv, ges0, dev)
        ces, c_end = rollout(cenv, ces0, "cpu")
        keep = ~(g_end | c_end)
        rtol, atol = E2E_TOL

        def obs_use(obs):
            """Per env, the largest |obs - CPU obs| over its limit."""
            return ((obs - ces.obs).abs() / (atol + rtol * ces.obs.abs())).amax(dim=1)

        left_out = ""
        if cenv.task.model.name in parity.COND_MAX_EXCLUDED_BY_MODEL:
            # judged where the plain rollout is well conditioned: the
            # 3 steps from the start's (q, qd), the envs left out above
            # held at the first rollout's observations
            def run_plain(q, qd):
                st = cenv.task.engine.init_state(q, qd)
                again, _ = rollout(cenv, dataclasses.replace(ces0, phys=st), "cpu")
                return (torch.where(keep[:, None], again.obs, ces.obs),)

            well = parity.well_conditioned(
                run_plain, ces0.phys.q, ces0.phys.qd, (ces.obs,), ("obs",),
                {"obs": (rtol, 0.0, atol)}, max_excluded=E2E_COND_MAX_EXCLUDED)
            left_out = f", {int((keep & ~well).sum())} more left out as ill conditioned"
            keep &= well
        err = (ges.obs.cpu()[keep] - ces.obs[keep]).abs()
        assert keep.sum() > e2e_envs // 2
        assert float(obs_use(ges.obs.cpu())[keep].max()) <= 1.0, float(err.max())
        log(f"end to end vs CPU plain path: {key} {int(keep.sum())} envs x 3 "
            f"steps{left_out}, obs max abs err {float(err.max()):.3e} (rtol "
            f"{rtol}, atol {atol})")

    def randomization_checks(task, env, es):
        """On the randomized main path: the final state's overlay, then a
        second rollout watched step by step."""
        dr = es.carry["_dr"]
        ov = combine_overlays(dr.get("startup"), dr.get("overlay"))
        assert set(ov) == set(fs.OVERLAY_KEYS), sorted(ov)
        for key, val in ov.items():
            assert torch.isfinite(val).all(), key
            assert bool((val != val[0]).any()), f"{key} is the same in every env"
        held = (torch.linalg.norm(
            es.phys.q[:, task._obj_q:task._obj_q + 3] - task.goal_pos, dim=-1)
            < task.fall_dist).float().mean()
        log(f"  overlay of {len(ov)} keys, each differing between envs; the "
            f"cube within {task.fall_dist} m of the goal in {float(held):.4f} of "
            f"the envs at the end")
        assert float(held) > 0.9
        assert torch.isfinite(es.states).all() and es.states.shape[1] == 187
        n = env.num_envs
        es = env.reset(seed=1)
        startup = {k: v.clone() for k, v in es.carry["_dr"]["startup"].items()}
        g = es.carry["_dr"]["overlay"]["gravity_delta"]
        assert not bool(g.any()), "gravity_delta must be zero at the reset"
        policy = random_policy.uniform_policy(env.num_actions)
        ever_done = torch.zeros(n, dtype=torch.bool, device=dev)
        redrawn = kept = 0
        for _ in range(32):
            # an env redraws its gravity where its progress is a multiple
            # of 720 as the step begins: at its first step, and after a
            # reset or a goal hit has zeroed its progress
            due = es.done | (es.progress % 720 == 0)
            ever_done |= es.done
            es = env.step(es, policy(es.obs, env.generator))
            g_new = es.carry["_dr"]["overlay"]["gravity_delta"]
            assert torch.equal(g_new[~due], g[~due]), "gravity moved off its interval"
            assert bool((g_new[due][:, 2] != g[due][:, 2]).all()), "gravity kept on its interval"
            redrawn, kept, g = redrawn + int(due.sum()), kept + int((~due).sum()), g_new
        for k, v in es.carry["_dr"]["startup"].items():
            assert torch.equal(v, startup[k]), f"startup {k} changed"
        assert int(ever_done.sum()) > 0, "no env was reset in the watched rollout"
        log(f"  32 watched steps: {int(ever_done.sum())} envs were reset and kept "
            f"their once-only geom_scale and mass_scale; gravity_delta redrawn in "
            f"{redrawn} env-steps (progress % 720 == 0), unchanged in {kept}")

    def quiet_randomization(task_cfg: dict) -> dict:
        """The card and the CPU draw from different generators, so the
        comparison runs without what a step draws: the per-step observation
        and action noise, the interval gravity and the random forces on the
        cube. The episode's overlays and correlated noise, drawn at the
        reset on the card and copied to the CPU, stay."""
        params = dict(task_cfg["domain_randomization"]["randomization_params"])
        for grp in ("observations", "actions"):
            params[grp] = {k: v for k, v in params[grp].items()
                           if k != "on_interval"}
        del params["simulation"]
        return {**task_cfg, "env": {**task_cfg["env"], "forceScale": 0.0},
                "domain_randomization": {**task_cfg["domain_randomization"],
                                         "randomization_params": params}}

    def without_noise(task_cfg: dict) -> dict:
        """The card and the CPU draw the observation noise from different
        generators, so the comparison runs without it."""
        env_cfg = task_cfg["env"]
        return {**task_cfg, "env": {
            **env_cfg, "learn": {**env_cfg["learn"], "addNoise": False}}}

    main_path("Humanoid", MAIN["Humanoid"], 256)
    main_path("ShadowHand", MAIN["ShadowHand"], 128)
    main_path("AnymalTerrain", MAIN["AnymalTerrain"], 128, without_noise)
    assert n_sub[RANDOMIZED] == 12, n_sub
    main_path(RANDOMIZED, MAIN[RANDOMIZED], 128, quiet_randomization)

    # ---- 7. kernels against plain again, and times, at the main paths'
    # shapes ----
    rows = []

    def bound(n, n_bytes, n_ops):
        """(ms, "bytes" | "operations"): the least time the card could take"""
        t_bytes = n * n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n * n_ops / PEAK_FP32_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def device_ms_of(run, ms):
        """The profiler's device time per launch of run (every launch in the
        trace, `kernel_times`), which must be positive and no more than the
        events time per call of the same launches in the same trace (within
        10%; `kernel_times` traces again, up to four times, while a trace
        is past that). The card's clocks may differ between the trace and the window
        that timed `ms`, the events time per call outside the profiler: a
        trace more than 10% slower is logged beside it."""
        d, w = kernel_times(run, 20)
        assert 0 < d <= 1.1 * w, (
            f"device time {d} ms against {w} ms by events in the same trace")
        if w > 1.1 * ms:
            log(f"  the traced launches took {w:.4f} ms a call by events against "
                f"{ms:.4f} ms outside the profiler")
        return d

    def deterministic(name, ins, kw):
        """Two launches of K1, K3 and K2 on the same inputs give
        bitwise-equal outputs."""
        eng = engines[name]
        runs = {"K1": lambda: fs.step(eng, *ins, n_sub[name], **kw),
                "K3": lambda: fs.substep(eng, *ins, **kw),
                "K2": lambda: fs.fk(eng, ins[0], ins[1])}
        for kname, run in runs.items():
            ref = run()
            for a, b in zip(run(), ref):
                assert torch.equal(a, b), (name, kname)
        log(f"{name}: K1, K3 and K2 bitwise equal over two launches")

    for name, n in MAIN.items():
        # the randomized main path launches K1 (and K3 would be) under an
        # overlay; K2 takes none
        randomized = name == RANDOMIZED
        again = check(name, n, seed=1)
        first = errs[name]
        if randomized:
            again = {**check(name, n, seed=1, overlay=True), "fk": again["fk"]}
            first = {**overlay_errs[name], "fk": first["fk"]}
        eng = engines[name]
        m = eng.model
        ov = parity.overlay_inputs(m, n, 1, dev) if randomized else None
        q, qd, eff, pl = check_states(name, n, seed=1, overlay=ov)
        terrain = bool(pl)
        if randomized:
            pl = {"overlay": ov}
        ptg = parity.check_targets(m, q, 1)
        z = torch.zeros((n, m.njd), device=dev)
        fa = torch.zeros((n, m.nb, 6), device=dev)
        deterministic(name, (q, qd, eff, ptg, z, fa), pl)
        ops = fs.op_count(m, n_sub[name], planes=terrain, overlay=randomized)
        nbytes = fs.io_bytes(m, planes=terrain, overlay=randomized)
        suffix = "" if name == "Humanoid" else "_" + name.lower()
        k_tag = "_overlay" if randomized else ""
        for key, kname, line, run_k, run_p in (
            ("step", "fused_step_k1" + k_tag, 1016,
             lambda: fs.step(eng, q, qd, eff, ptg, z, fa, n_sub[name], **pl),
             lambda: fs.step_plain(eng, q, qd, eff, ptg, z, fa, n_sub[name], **pl)),
            ("fk", "report_fk_k2", 943,
             lambda: fs.fk(eng, q, qd), lambda: fs.fk_plain(m, q, qd)),
            ("substep", "substep_k3" + k_tag, 898,
             lambda: fs.substep(eng, q, qd, eff, ptg, z, fa, **pl),
             lambda: fs.substep_plain(eng, q, qd, eff, ptg, z, fa, **pl)),
        ):
            ms = time_ms(run_k, 20)
            device_ms = device_ms_of(run_k, ms)
            plain_ms = time_ms(run_p, 2)
            lc = eng.kernels.config(n, terrain and key != "fk",
                                    randomized and key != "fk", key == "fk")[0]
            if key == "fk":
                bound_ms, bound_by = bound(n, fs.io_bytes(m)[key],
                                           fs.op_count(m, 1)[key])
            else:
                bound_ms, bound_by = bound(n, nbytes[key], ops[key])
            log(f"{kname} {name}: {card} | {n} envs: {ms:.4f} ms ({device_ms:.4f} "
                f"ms of device time per launch, profiler), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({ops[key]} FP32 ops and {nbytes[key]} bytes per env), "
                f"{bound_ms / ms * 100:.2f}% of roofline, "
                f"{launches[name][key]} launches on the main path; launch "
                f"{fs.describe_config(lc)}")
            rows.append(dict(
                name=kname + suffix, model=name, route="cuda",
                source=SOURCES[lc["design"]],
                replaces=f"{TPU_FILE}:{line}", launches=launches[name][key],
                max_abs_err=max(first[key], again[key]), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, device_ms=device_ms, launch={k: lc[k] for k in (
                    "design", "group", "envs_per_block", "blocks", "smem_bytes",
                    "env_bytes")},
            ))
        if n_sub[name] != 4 and not randomized:
            # beside the main path's depth, K1 at four substeps
            ms4 = time_ms(lambda: fs.step(eng, q, qd, eff, ptg, z, fa, 4, **pl), 20)
            log(f"fused_step_k1 {name}: {card} | {n} envs, 4 substeps "
                f"instead of the main path's {n_sub[name]}: {ms4:.4f} ms")
        if randomized:
            # the overlay's cost: K1 with and without it, at the main
            # path's 12 substeps and at the unrandomized hand's 8
            for depth in (n_sub[name], 8):
                with_ov = time_ms(lambda: fs.step(eng, q, qd, eff, ptg, z, fa,
                                                  depth, **pl), 20)
                without = time_ms(lambda: fs.step(eng, q, qd, eff, ptg, z, fa,
                                                  depth), 20)
                b_ms, b_by = bound(n, nbytes["step"],
                                   fs.op_count(m, depth, overlay=True)["step"])
                log(f"fused_step_k1 {name}: {card} | {n} envs, {depth} substeps: "
                    f"{with_ov:.4f} ms with the overlay of "
                    f"{sum(fs.overlay_sizes(m).values())} floats per env (bound "
                    f"{b_ms:.4f} ms by {b_by}), {without:.4f} ms without")
        if terrain:
            # the fourth variant of the step kernel, planes and an overlay
            # together: held against its plain version above, on no main
            # path (AnymalTerrain's yaml randomizes nothing)
            ov = parity.overlay_inputs(m, n, 1, dev)
            ms_po = time_ms(lambda: fs.step(eng, q, qd, eff, ptg, z, fa,
                                            n_sub[name], overlay=ov, **pl), 20)
            plain_po = time_ms(lambda: fs.step_plain(
                eng, q, qd, eff, ptg, z, fa, n_sub[name], overlay=ov, **pl), 2)
            b_ms, b_by = bound(
                n, fs.io_bytes(m, planes=True, overlay=True)["step"],
                fs.op_count(m, n_sub[name], planes=True, overlay=True)["step"])
            log(f"fused_step_k1_overlay {name}: {card} | {n} envs, planes and "
                f"overlay: {ms_po:.4f} ms, plain {plain_po:.3f} ms, bound "
                f"{b_ms:.4f} ms by {b_by}; on no main path")
            rows.append(dict(
                name="fused_step_k1_overlay" + suffix, model=name, route="cuda",
                source=SOURCES[eng.kernels.config(n, True, True)[0]["design"]],
                replaces=f"{TPU_FILE}:1016", launches=0,
                on_main_path=False, max_abs_err=overlay_errs[name]["step"],
                ms=ms_po, plain_ms=plain_po, bound_ms=b_ms, bound_by=b_by,
                library_ms=None))
            # the main path's 2048 envs are 16 blocks on 132 SMs: the same
            # launch at a width that fills the card, and the sampling of
            # its planes (the task's plane function as PyTorch ops)
            wq, wqd, weff, wpl = check_states(name, WIDE, seed=1)
            wz = torch.zeros((WIDE, m.njd), device=dev)
            wfa = torch.zeros((WIDE, m.nb, 6), device=dev)
            ms_w = time_ms(lambda: fs.step(eng, wq, wqd, weff, wz, wz, wfa,
                                           n_sub[name], **wpl), 20)
            b_ms, b_by = bound(WIDE, nbytes["step"], ops["step"])
            wide_form = eng.kernels.config(WIDE, True, False)[0]["design"]
            log(f"fused_step_k1 {name}: {card} | {WIDE} envs ({wide_form} "
                f"form): {ms_w:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
                f"{b_ms / ms_w * 100:.2f}% of roofline")
            for width, st in ((n, eng.init_state(q, qd)),
                              (WIDE, eng.init_state(wq, wqd))):
                ms_p = time_ms(lambda: eng._contact_planes(st), 20)
                log(f"contact planes {name}: {card} | {width} envs: "
                    f"{ms_p:.4f} ms per sampling (CUDA events over 20)")
            del wq, wqd, weff, wpl, wz, wfa
    torch.cuda.synchronize()
    train_phase(dev, card)
    lstm_phase(card)

    # ---- 10. the arm, the second hand and the flyers ----
    def phase10_inputs(name: str, n: int, seed: int):
        """(q, qd, eff, ptg, vtg, f_applied) of `name`'s check states; the
        Quadcopter's rotors pushed with 1 N each, in random directions."""
        m = engines[name].model
        q, qd, eff, _ = check_states(name, n, seed)
        ptg = parity.check_targets(m, q, seed)
        z = torch.zeros((n, m.njd), device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        fa = 0.05 * torch.randn((n, m.nb, 6), device=dev, generator=gen)
        if name == "Quadcopter":
            rotors = [m.body_index(f"rotor_{i}") for i in range(4)]
            f = torch.randn((n, 4, 3), device=dev, generator=gen)
            fa[:, rotors, 3:6] = f / f.norm(dim=-1, keepdim=True)
        return q, qd, eff, ptg, z, fa

    def designs(m):
        """The forms of K1 that take model m: both, or past the thread
        form's maxima the group form alone."""
        return [d for d in fs.DESIGNS if d == "group" or not fs.thread_scope_errors(m)]

    def phase10_check(name: str, n: int, seed: int) -> dict:
        """K1 in both forms and K2 against their plain versions on n check
        states: {"group" | "thread" | "fk": largest abs error}."""
        eng = engines[name]
        m = eng.model
        ins = phase10_inputs(name, n, seed)
        active = parity.active_contacts(eng, ins[0], ins[1])
        log(f"{name} check: {n} envs, {n_sub[name]} substeps, active contacts {active}")
        if len(m.pair_surf):
            assert active["pairs"] > 0, "no pair in contact"
        if name.startswith("FrankaCabinet"):
            # the pads on the handle bar (a capsule), the props on the tray
            assert active["capsule"] > 0 and active["box"] > 0, active
        tol = parity.step_tol(m)

        def run_plain(q_, qd_):
            return fs.step_plain(eng, q_, qd_, *ins[2:], n_sub[name])

        ref = run_plain(ins[0], ins[1])
        # the AllegroHand is judged where its step is well conditioned
        keep = parity.check_keep(m, run_plain, ins[0], ins[1], ref,
                                 parity.STEP_NAMES, tol)
        if keep is not None:
            log(f"  {name} K1: {int((~keep).sum())} of {n} envs left out as ill "
                f"conditioned")
        errs = {}
        for d in designs(m):
            out = fs.step(eng, *ins, n_sub[name], design=d)
            torch.cuda.synchronize()
            errs[d] = parity.assert_within(
                f"{name} K1 {d} form",
                parity.compare(out, ref, parity.STEP_NAMES, tol, keep), tol, log)
        errs["fk"] = parity.assert_within(
            f"{name} K2", parity.compare(fs.fk(eng, ins[0], ins[1]),
                                         fs.fk_plain(m, ins[0], ins[1]),
                                         parity.FK_NAMES, parity.FK_TOL),
            parity.FK_TOL, log)
        return errs

    def launch_keys(lc):
        return {k: lc[k] for k in ("design", "group", "envs_per_block", "blocks",
                                   "smem_bytes", "env_bytes", "working_set")}

    def kernel_rows(name: str, n: int, first: dict, label_tail: str = "",
                    on_path: bool = True):
        """Phase 10's and 11's timing: `name`'s K1 in both forms and K2 held
        against their plain versions again at n envs (seed 1), two launches
        of each bitwise equal, then each timed (events and profiler device
        time) beside its plain version and bound, one row each for the
        kernels line; `first`: the errors of the first check. Rows of the
        form launch_config picks carry the main path's launch counts, unless
        `on_path` is False (a width no main path runs)."""
        eng = engines[name]
        m = eng.model
        again = phase10_check(name, n, seed=1)
        ins = phase10_inputs(name, n, seed=1)
        runs = {d: (lambda d=d: fs.step(eng, *ins, n_sub[name], design=d))
                for d in designs(m)}
        runs["fk"] = lambda: fs.fk(eng, ins[0], ins[1])
        for key, run in runs.items():
            ref = run()
            assert all(torch.equal(a, b) for a, b in zip(run(), ref)), (name, key)
        log(f"{name}: K1 in both forms and K2 bitwise equal over two launches")
        picked = eng.kernels.config(n)[0]["design"]
        ops, nbytes = fs.op_count(m, n_sub[name]), fs.io_bytes(m)
        plain = {"step": time_ms(lambda: fs.step_plain(eng, *ins, n_sub[name]), 2),
                 "fk": time_ms(lambda: fs.fk_plain(m, ins[0], ins[1]), 2)}
        fk_ops = fs.op_count(m, 1)["fk"]
        for key in (*designs(m), "fk"):
            ms = time_ms(runs[key], 20)
            device_ms = device_ms_of(runs[key], ms)
            fk = key == "fk"
            lc = eng.kernels.config(n, fk=fk, design=None if fk else key)[0]
            kind = "fk" if fk else "step"
            bound_ms, bound_by = bound(n, nbytes[kind], fk_ops if fk else ops[kind])
            counted = on_path and (fk or key == picked)
            n_launch = launches[name][kind] if counted else 0
            label = ("report_fk_k2" if fk else
                     "fused_step_k1" + ("" if fk or key == picked else f"_{key}_form"))
            log(f"{label} {name}{'' if fk else f' ({key} form)'}: {card} | {n} envs"
                f"{'' if fk else f', {n_sub[name]} substeps'}: {ms:.4f} ms "
                f"({device_ms:.4f} ms of device time per launch, profiler), plain "
                f"{plain[kind]:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({fk_ops if fk else ops[kind]} FP32 ops and {nbytes[kind]} bytes "
                f"per env), {bound_ms / ms * 100:.2f}% of roofline, {n_launch} "
                f"launches on the main path; launch {fs.describe_config(lc)}")
            rows.append(dict(
                name=f"{label}_{name.lower().replace('/', '_')}{label_tail}",
                model=name, route="cuda", source=SOURCES["group" if fk else key],
                replaces=f"{TPU_FILE}:{943 if fk else 1016}", launches=n_launch,
                **({} if counted else {"on_main_path": False}),
                max_abs_err=max(first[key], again[key]), ms=ms,
                plain_ms=plain[kind], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, device_ms=device_ms, envs=n,
                launch=launch_keys(lc)))
        del ins, runs

    for name, n in ARM_HAND_FLYERS.items():
        first = phase10_check(name, n + N_PAD, seed=0)
        main_path(name, n, 128)
        kernel_rows(name, n, first)
        trainer, task, _ = train_on_card(name, n, ARM_HAND_FLYERS_EPOCHS, card)
        del trainer, task
        torch.cuda.synchronize()

    # ---- 11. Custom on imported robots ----
    with tempfile.TemporaryDirectory() as tmp:
        custom_phase(tmp, engines, n_sub, phase10_check, main_path, kernel_rows,
                     card)
    torch.cuda.synchronize()

    # ---- 12. distributed on the one card ----
    distributed_phase(card)

    # ---- 13. the demos and the regression harness ----
    with tempfile.TemporaryDirectory() as tmp:
        demos_phase(tmp, card, rows, check, check_states, bound, device_ms_of,
                    engines, n_sub)
    torch.cuda.synchronize()

    # ---- 14. the training campaign runner ----
    with tempfile.TemporaryDirectory() as tmp:
        campaign_phase(tmp, card)

    # ---- 15. the JAX package's trained policy on the card ----
    trained_policy_phase(card)

    # ---- 16. AllegroHand's falls, K1 against the plain path ----
    falls_phase(card)

    # ---- 17. AllegroHand's learner from a trained state, card vs CPU ----
    trained_learner_phase(card)

    # ---- 18. models past the thread form's maxima and past shared memory ----
    with tempfile.TemporaryDirectory() as tmp:
        large_models_phase(tmp, card, engines, n_sub, rows, check, check_states,
                           phase10_check, main_path, kernel_rows, bound, device_ms_of)
    torch.cuda.synchronize()

    # K1 and K2 carry each main path; K3 is a launch mode no product path
    # takes, held against its plain version above
    for r in rows:
        assert (r["launches"] > 0 or r["name"].startswith("substep_k3")
                or r.get("on_main_path") is False), r

    log(f"the profiler's traces waited {TRACE_PAD_S[0]} s at each end")
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def state_to(x, device, dtype=None):
    """A copy of a trainer's state (dataclasses, dicts, lists, tuples,
    modules, tensors) on `device`; floating tensors and modules cast to
    `dtype` where one is given."""
    if isinstance(x, torch.Tensor):
        if dtype is not None and x.is_floating_point():
            return x.to(device, dtype, copy=True)
        return x.to(device, copy=True)
    if isinstance(x, torch.nn.Module):
        x = copy.deepcopy(x).to(device)
        return x if dtype is None else x.to(dtype)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: state_to(getattr(x, f.name), device, dtype)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: state_to(v, device, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(state_to(v, device, dtype) for v in x)
    return x


@contextlib.contextmanager
def traced_learner(tr, before_step=None, after_step=None):
    """The trainer `tr`'s loss and lr step and the learner's Adam step
    (`ppo.clip_adam_step`) wrapped while open, to record every minibatch of
    a `_learn`: yields a list with a dict a minibatch, its loss terms
    (`aux`'s keys and "loss") and "lr_after" as floats. Around each Adam
    step `before_step(row, stash, params, state, lr, max_norm)` and
    `after_step(row, params, state)` are called; `stash` holds the loss's
    inputs of the step (ts, mb, am, asd) and the unwrapped Adam step
    ("adam_step")."""
    from omniisaacgymenvs_torch.learn import ppo

    rows, stash = [], {}
    loss_fn, adapt_fn, step_fn = tr._loss, tr._adapt_lr, ppo.clip_adam_step
    stash["adam_step"] = step_fn

    def loss(ts, mb, am, asd):
        total, aux = loss_fn(ts, mb, am, asd)
        stash.update(ts=ts, mb=mb, am=am, asd=asd)
        rows.append(dict({k: float(v.detach()) for k, v in aux.items()},
                         loss=float(total.detach())))
        return total, aux

    def step(params, grads, state, lr, max_norm):
        if before_step is not None:
            before_step(rows[-1], stash, params, state, lr, max_norm)
        ok = step_fn(params, grads, state, lr, max_norm)
        if after_step is not None:
            after_step(rows[-1], params, state)
        return ok

    def adapt(lr, kl):
        new = adapt_fn(lr, kl)
        rows[-1]["lr_after"] = float(new)
        return new

    tr._loss, tr._adapt_lr = loss, adapt
    ppo.clip_adam_step = step
    try:
        yield rows
    finally:
        ppo.clip_adam_step = step_fn
        tr._loss, tr._adapt_lr = loss_fn, adapt_fn


def learner_step_from(trainer, net, stash, params, state, lr, max_norm,
                      dtype=torch.float32):
    """The minibatch step that a traced `_learn` (`traced_learner`) is about
    to take, taken again on `trainer`'s device in `dtype` from that epoch's
    state of the moment: `net` (the trainer's network on its device, in
    `dtype`) set to `params`, the loss on the stashed minibatch and its
    gradient, then the Adam step on a copy of `state`, and `trainer`'s lr
    step on this side's KL. Returns (loss terms with "loss", the Adam state
    after the step, the lr after it); `net` holds the parameters after."""
    dev = trainer.device
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.no_grad():
            for p, q in zip(net.parameters(), params):
                p.copy_(q)
        ts = stash["ts"]
        side_ts = dataclasses.replace(ts, ac=net, obs_norm=state_to(ts.obs_norm, dev, dtype),
                                      value_norm=state_to(ts.value_norm, dev, dtype))
        total, aux = trainer._loss(side_ts, state_to(stash["mb"], dev, dtype),
                                   stash["am"].to(dev, dtype), stash["asd"].to(dev, dtype))
        side_params = list(net.parameters())
        grads = list(torch.autograd.grad(total, side_params, allow_unused=True,
                                         materialize_grads=True))
        side_state, side_lr = state_to(state, dev, dtype), lr.to(dev, dtype)
        stash["adam_step"](side_params, grads, side_state, side_lr, max_norm)
        lr_after = trainer._adapt_lr(side_lr, aux["kl"].detach())
        terms = dict({k: float(v.detach()) for k, v in aux.items()},
                     loss=float(total.detach()))
        return terms, side_state, float(lr_after)
    finally:
        torch.set_default_dtype(old)


@contextlib.contextmanager
def plain_physics_counted():
    """Counts every call of the plain physics (the kernels' plain versions
    and the engine's plain substep) while it is open: {"n": calls}."""
    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.physics.engine import PhysicsEngine

    calls = {"n": 0}
    originals = {(fs, "step_plain"): fs.step_plain, (fs, "fk_plain"): fs.fk_plain,
                 (fs, "substep_plain"): fs.substep_plain,
                 (PhysicsEngine, "_substep"): PhysicsEngine._substep}

    def counted(fn):
        def run(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return run

    for (owner, name), fn in originals.items():
        setattr(owner, name, counted(fn))
    try:
        yield calls
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)


def train_on_card(name, n, epochs, card, extra=(), **train_kw):
    """(trainer, task, history): `name` built as the CLI builds it, at n
    envs under its train yaml, trained `epochs` epochs through
    PPOTrainer.train; the launch counts read around the training (K1 once
    per control step of every rollout, in the form `launch_config` picks,
    with the overlay where the task randomizes, K2 at least as often, no
    plain physics), every metric finite, the learning rate within its
    bounds."""
    from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
    from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
    from omniisaacgymenvs_torch.utils.config import ppo_config_kwargs

    cfg, task, env = build_env_from_cli(
        [f"task={name}", f"num_envs={n}", "seed=0", "device=cuda", *extra])
    ppo = PPOConfig(**ppo_config_kwargs(cfg["train"]))
    trainer = PPOTrainer(env, ppo, seed=0)
    kern = task.engine.kernels
    form = kern.config(n, task.engine.has_terrain, task._dr_on)[0]["design"]
    kern.reset_counts()
    with plain_physics_counted() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = trainer.train(max_epochs=epochs, log_every=1, log_fn=log, **train_kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    got = dict(kern.launches)
    per_epoch = ppo.horizon_length * task.engine.k1_launches(task.decimation)
    assert got["step"] == epochs * per_epoch, got
    assert got["fk"] >= epochs * per_epoch, got
    assert got["substep"] == 0, got
    assert kern.thread_launches["step"] == (got["step"] if form == "thread"
                                            else 0), kern.thread_launches
    assert kern.overlay_launches["step"] == (got["step"] if task._dr_on
                                             else 0), kern.overlay_launches
    assert plain["n"] == 0, "the trainer ran the plain physics"
    assert len(hist) == epochs
    # the learning rate is a float32 tensor clamped to its bounds: they are
    # compared as float32 too (lr_min 1e-6 is 9.99999997e-07 there)
    lr_lo, lr_hi = (float(torch.tensor(x, dtype=torch.float32))
                    for x in (ppo.lr_min, ppo.lr_max))
    for m in hist:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        assert not bad, f"non-finite metrics {bad}"
        assert lr_lo <= m["lr"] <= lr_hi, m["lr"]
    if trainer.use_cv:
        assert all(math.isfinite(m["cv_loss"]) for m in hist)
    steps = epochs * ppo.horizon_length * n
    nets = (f"LSTM {ppo.rnn_units} units" + (", central value LSTM"
                                             if trainer.is_cv_rnn else "")
            if trainer.is_rnn else "FF")
    log(f"train path: {card} | {name} {n} envs, {epochs} epochs of "
        f"{ppo.horizon_length} steps ({nets}, bf16 networks {ppo.mixed_precision}, "
        f"central value {trainer.use_cv}): {steps / dt:.1f} train-steps/s, "
        f"{dt * 1e3 / epochs:.3f} ms per epoch (first epoch included), "
        f"launches {got} (K1 with the overlay {kern.overlay_launches['step']}), K1 "
        f"in the {form} form; last epoch mean_step_reward "
        f"{hist[-1]['mean_step_reward']:.4f}, kl {hist[-1]['kl']:.5f}, lr "
        f"{hist[-1]['lr']:.3e}")
    return trainer, task, hist


def train_phase(dev, card):
    """Phase 8: the FF learner on the card (module docstring)."""
    for name, (n, epochs) in TRAIN.items():
        trainer, task, _ = train_on_card(name, n, epochs, card)
        if name == "Humanoid":
            learner_card_vs_cpu(trainer, card)
            learner_card_vs_cpu(trainer, card, matmul="bf16_operands",
                                atol=RULE_ATOL, rel_max=RULE_REL,
                                metric_rtol=RULE_METRIC_RTOL)
        del trainer, task


def checkpoint_leaves(trainer) -> dict:
    """Every leaf a checkpoint holds (the main file's and the sidecar's),
    and both generators' states."""
    from omniisaacgymenvs_torch.learn.ppo import _flatten

    out = _flatten({"main": trainer._main_tree(), "env": trainer._env_state_tree()})
    out.update({f"rng.{k}": g.get_state() for k, g in trainer._generators().items()})
    return out


def unequal_leaves(a: dict, b: dict, skip=()) -> list:
    """The leaves of a and b (b's moved to a's device) that are not
    bitwise equal."""
    assert sorted(a) == sorted(b)
    bad = []
    for k, v in a.items():
        if k in skip:
            continue
        w = b[k]
        if isinstance(v, torch.Tensor):
            if v.dtype != w.dtype or not torch.equal(v, w.to(v.device)):
                bad.append(k)
        elif v != w:
            bad.append(k)
    return bad


def lstm_phase(card):
    """Phase 9: the recurrent learner and its checkpoints on the card
    (module docstring)."""
    from omniisaacgymenvs_torch.learn import PPOTrainer
    from omniisaacgymenvs_torch.scripts import train
    from omniisaacgymenvs_torch.scripts.common import build_env_from_cli

    name, n, epochs = TRAIN_LSTM

    def fresh_trainer(device, seed):
        _, _, env = build_env_from_cli(
            [f"task={name}", f"num_envs={n}", "seed=0", f"device={device}"])
        return PPOTrainer(env, trainer.cfg, seed=seed)

    with tempfile.TemporaryDirectory() as tmp:
        trainer, task, _ = train_on_card(name, n, epochs, card, save_dir=tmp,
                                         save_frequency=1)
        assert trainer.is_rnn and trainer.is_cv_rnn
        last = os.path.join(tmp, "last")
        # reload into a fresh trainer on the card: every leaf bitwise
        reloaded = fresh_trainer("cuda", seed=1)
        reloaded.load(last, log_fn=log)
        saved = checkpoint_leaves(trainer)
        bad = unequal_leaves(saved, checkpoint_leaves(reloaded))
        assert not bad, f"reload differs in {bad[:5]}"
        log(f"reload on the card: {card} | {len(saved)} leaves (parameters, Adam "
            f"moments and counts, norms, lr, LSTM states, env state, both "
            f"generators) bitwise equal to the saved trainer's")
        # one more epoch from each: the same metrics and parameters
        kern = task.engine.kernels
        with plain_physics_counted() as plain:
            m_a = trainer._epoch(trainer.state)
            m_b = reloaded._epoch(reloaded.state)
            torch.cuda.synchronize()
        assert plain["n"] == 0, "the trainer ran the plain physics"
        after = unequal_leaves(checkpoint_leaves(trainer), checkpoint_leaves(reloaded))
        worst = max(float((a - b).detach().abs().max()) for net in ("ac", "cv")
                    for a, b in zip(getattr(trainer.state, net).parameters(),
                                    getattr(reloaded.state, net).parameters()))
        metric_diff = max(abs(float(m_a[k]) - float(m_b[k])) for k in m_a)
        assert worst <= LEARNER_ATOL, (worst, after[:5])
        assert all(math.isfinite(float(v)) for v in m_a.values())
        log(f"one more epoch, original and reloaded: {card} | parameters max abs "
            f"diff {worst:.3e} (bound {LEARNER_ATOL:.0e}), metrics max abs diff "
            f"{metric_diff:.3e}; bitwise equal: {not after} "
            f"({len(after)} leaves differ{': ' + ', '.join(after[:5]) if after else ''})"
            f"; K1 launches {kern.launches['step']} over the phase")
        del reloaded
        # the same checkpoint on the CPU (torch.load's map_location)
        cpu = fresh_trainer("cpu", seed=1)
        msgs = []
        cpu.load(last, log_fn=msgs.append)
        bad = unequal_leaves(checkpoint_leaves(cpu), saved,
                             skip=("rng.trainer", "rng.env"))
        assert not bad, f"the CPU load differs in {bad[:5]}"
        assert "another device type" in msgs[-1], msgs
        log(f"the card's checkpoint on the CPU: {len(saved) - 2} leaves bitwise "
            f"equal, the generators left as they were ({msgs[-1]})")
        del cpu
        # scripts/train.py test=True from the checkpoint, on the card
        mean_ret, n_ep = train.main([f"task={name}", f"num_envs={n}", "seed=0",
                                     "device=cuda",
                                     "test=True", f"checkpoint={last}",
                                     "max_iterations=32"])
        assert math.isfinite(mean_ret), mean_ret
        log(f"test=True from nn/last: {card} | {name} {n} envs x 32 steps, mean "
            f"episode reward {mean_ret:.4f} over {n_ep} episodes")
    del trainer, task
    # one f32 LSTM learner epoch, card against CPU, on a stored rollout at
    # the yaml's widths
    small, _, _ = train_on_card(name, LSTM_CPU_ENVS, 1, card)
    learner_card_vs_cpu(small, card)


def learner_card_vs_cpu(trainer, card, matmul="f32", atol=LEARNER_ATOL,
                        rel_max=1e-3, metric_rtol=1e-3):
    """One learner epoch (GAE, value norm, SGD of the central value and the
    actor, obs and states norms) on one stored rollout, on the card and on
    the CPU, with the same permutations and f32 networks computing under
    the matmul rule `matmul` (exact f32 unless asked): every metric
    within `metric_rtol` (atol 1e-5) and the norms within rtol 1e-4, as
    tests/test_torch_ppo.py holds them; every parameter within `atol`; and
    each parameter tensor moved as the CPU's moved (the norm of the
    difference at most `rel_max` of the norm of the CPU's change)."""
    from omniisaacgymenvs_torch.learn.networks import set_matmul

    ppo = trainer.cfg
    ts = trainer.state
    traj, last_value, stats = trainer._rollout(ts)
    S, mb = trainer._slices()
    perms = trainer._perms(ppo.mini_epochs, S)
    cv_perms = trainer._perms(ppo.cv_mini_epochs, S) if trainer.use_cv else None
    cpu = torch.device("cpu")
    nets = ("ac", "cv") if trainer.use_cv else ("ac",)
    sides = {}
    for label, device in (("card", trainer.device), ("cpu", cpu)):
        tr = copy.copy(trainer)
        tr.device = device
        st = state_to(ts, device)
        for net in nets:
            module = getattr(st, net)
            module.dtype = None
            set_matmul(module, matmul)
        m = tr._learn(st, state_to(traj, device), last_value.to(device),
                      state_to(stats, device), perms=perms.to(device),
                      cv_perms=None if cv_perms is None else cv_perms.to(device))
        sides[label] = (st, {k: float(v) for k, v in m.items()})
    (g, gm), (c, cm) = sides["card"], sides["cpu"]
    worst_metric = 0.0
    for k in cm:
        assert abs(gm[k] - cm[k]) <= 1e-5 + metric_rtol * abs(cm[k]), (k, gm[k], cm[k])
        worst_metric = max(worst_metric, abs(gm[k] - cm[k]) / (1e-5 + abs(cm[k])))
    for name in ("obs_norm", "value_norm", "states_norm"):
        for f in ("mean", "var", "count"):
            a, b = getattr(getattr(g, name), f).cpu(), getattr(getattr(c, name), f)
            assert bool(((a - b).abs() <= 1e-6 + 1e-4 * b.abs()).all()), (name, f)
    n_updates = ppo.mini_epochs * (S // mb)
    worst, worst_rel = 0.0, 0.0
    for net in nets:
        init = {k: v.detach().cpu() for k, v in getattr(ts, net).named_parameters()}
        for (k, a), b in zip(getattr(g, net).named_parameters(),
                             getattr(c, net).parameters()):
            a, b = a.detach().cpu(), b.detach()
            diff = float((a - b).abs().max())
            moved = float((b - init[k]).norm())
            rel = float((a - b).norm()) / moved if moved > 0 else math.inf
            assert diff <= atol and rel <= rel_max, (matmul, net, k, diff, rel)
            worst, worst_rel = max(worst, diff), max(worst_rel, rel)
    rows = (f"{S} sequences of {ppo.seq_len} steps" if trainer.is_rnn
            else f"{S} samples")
    log(f"learner epoch, card vs CPU ({matmul} products): {card} | "
        f"{trainer.env.num_envs} envs, {rows}, "
        f"{n_updates} actor updates{' and the central value' if trainer.use_cv else ''}"
        f": parameters max abs diff {worst:.3e} (bound {atol:.0e} for every "
        f"element), largest per-tensor |card - cpu| / |cpu change| {worst_rel:.3e} "
        f"(bound {rel_max:.0e}); metrics' largest |card - cpu| / (1e-5 + |cpu|) "
        f"{worst_metric:.3e} (bound {metric_rtol:.0e}); lr {gm['lr']:.4e} / "
        f"{cm['lr']:.4e}; kl {gm['kl']:.6f} / {cm['kl']:.6f}")


def custom_phase(tmp, engines, n_sub, phase10_check, main_path, kernel_rows,
                 card):
    """Phase 11: Custom on imported robots (module docstring)."""
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.scripts import train
    from omniisaacgymenvs_torch.tasks import get_task
    from omniisaacgymenvs_torch.utils.config import load_config, parse_cli

    chain = os.path.join(tmp, "chain.xml")
    with open(chain, "w") as f:
        f.write(MJCF_CHAIN)
    urdf = os.path.join(ROOT, URDF_EXAMPLE)
    robots = {"Custom/fixed": [f"task.env.robot={urdf}"],
              "Custom/floating": [f"task.env.robot={urdf}",
                                  "task.env.floatingBase=True"],
              "Custom/mjcf": [f"task.env.robot={chain}"]}
    dev = torch.device("cuda")
    for key, extra in robots.items():
        task = get_task("Custom", load_config({"task": "Custom", **parse_cli(extra)})[
            "task"], device=dev)
        eng, m = task.engine, task.model
        engines[key] = eng
        n_sub[key] = task.decimation * eng.params.substeps
        q, qd, _ = parity.check_inputs(m, CUSTOM_ENVS, seed=0, device=dev)
        active = parity.active_contacts(eng, q, qd)
        log(f"{key}: {m.name}, {m.nb} bodies ({', '.join(m.body_names)}), "
            f"{m.njd} dofs, {m.ncp} contact points, root "
            f"{'FREE' if m.root_free else 'FIXED'}, {n_sub[key]} substeps per K1 "
            f"launch; check states' contacts {active}")
        if key != "Custom/fixed":
            assert active["ground"] > 0, "no contact point in the ground"
        del task
    for key, extra in robots.items():
        # the FREE example starts at z = 0, below terminationHeight: every
        # env ends at every step, so it runs no main path of its own
        on_path = key != "Custom/floating"
        first = phase10_check(key, CUSTOM_ENVS + N_PAD, seed=0)
        if on_path:
            main_path("Custom", CUSTOM_ENVS, 128, extra=extra, key=key)
        kernel_rows(key, CUSTOM_ENVS, first, on_path=on_path)
        wide = phase10_check(key, CUSTOM_WIDE + N_PAD, seed=0)
        kernel_rows(key, CUSTOM_WIDE, wide, label_tail=f"_{CUSTOM_WIDE}",
                    on_path=False)
        if on_path:
            trainer, task, _ = train_on_card("Custom", CUSTOM_ENVS, CUSTOM_EPOCHS,
                                             card, extra=extra)
            del trainer, task
        torch.cuda.synchronize()
    # the JAX package's learning bar, through the train CLI
    lr = CUSTOM_LEARN
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with plain_physics_counted() as plain:
            t0 = time.perf_counter()
            hist = train.main(["task=Custom", *robots["Custom/fixed"],
                               f"task.env.episodeLength={lr['episode_length']}",
                               f"num_envs={lr['envs']}", f"seed={lr['seed']}",
                               f"max_iterations={lr['epochs']}", "experiment=custom",
                               "device=cuda"])
            dt = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    assert plain["n"] == 0, "the trainer ran the plain physics"
    assert len(hist) == lr["epochs"], len(hist)
    final = hist[-1]["mean_ep_reward"]
    steps = hist[-1]["env_steps"]
    log(f"Custom learning: {card} | double pendulum, {lr['epochs']} epochs of "
        f"{lr['envs']} envs, seed {lr['seed']}, episodes of {lr['episode_length']} "
        f"steps: mean_ep_reward {hist[0]['mean_ep_reward']:.4f} at epoch 0, "
        f"{hist[len(hist) // 2]['mean_ep_reward']:.4f} at epoch {len(hist) // 2}, "
        f"{final:.4f} at epoch {len(hist) - 1} (bar {lr['bar']}); {dt:.1f} s, "
        f"{steps / dt:.1f} train-steps/s")
    assert final > lr["bar"], f"the imported robot did not learn: {final}"


def large_models_phase(tmp, card, engines, n_sub, rows, check, check_states,
                       phase10_check, main_path, kernel_rows, bound, device_ms_of):
    """Phase 18: models past the thread form's maxima, and past a block's
    shared memory (module docstring)."""
    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
    from omniisaacgymenvs_torch.tasks import get_task
    from omniisaacgymenvs_torch.utils.config import load_config, parse_cli

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    legs = os.path.join(tmp, "legs.xml")
    with open(legs, "w") as f:
        f.write(mjcf_legs())
    # (a) FrankaCabinet with 16 props, (b) Custom on the many-legged MJCF
    cases = {"FrankaCabinet/16": ("FrankaCabinet", LARGE_ENVS["FrankaCabinet/16"],
                                  ["task.env.numProps=16"]),
             "Custom/legs": ("Custom", LARGE_ENVS["Custom/legs"],
                             [f"task.env.robot={legs}"])}
    for key, (name, n, extra) in cases.items():
        task = get_task(name, load_config({"task": name, **parse_cli(extra)})["task"],
                        device=dev)
        eng, m = task.engine, task.model
        engines[key] = eng
        n_sub[key] = task.decimation * eng.params.substeps
        lc = eng.kernels.config(n)[0]
        log(f"{key}: {m.nb} bodies, {m.ncp} contact points, {len(m.pair_surf)} pairs, "
            f"{fs.n_free_roots(m)} FREE roots; past the thread form's maxima "
            f"({'; '.join(fs.thread_scope_errors(m))}); K1 at {n} envs: "
            f"{fs.describe_config(lc)}")
        assert fs.thread_scope_errors(m) and lc["design"] == "group"
        del task
        first = phase10_check(key, n + N_PAD, seed=0)
        main_path(name, n, 128, extra=extra, key=key)
        kernel_rows(key, n, first)
        if key == "FrankaCabinet/16":
            trainer, task, _ = train_on_card(name, n, ARM_HAND_FLYERS_EPOCHS, card,
                                             extra=extra)
            del trainer, task
        torch.cuda.synchronize()
    # (c) the wide trees, whose working set takes device memory
    for key, legs_n, widths, timed in WIDE_TREES:
        eng = PhysicsEngine(parity.build_wide_tree(legs_n, device=dev),
                            SimParams(dt=1.0 / 120.0, substeps=2))
        engines[key], n_sub[key] = eng, 4
        m = eng.model
        for n in widths:
            for fk in (False, True):
                lc = eng.kernels.config(n, fk=fk)[0]
                log(f"{key} ({m.nb} bodies, {m.ncp} contact points) {'K2' if fk else 'K1/K3'} "
                    f"at {n} envs: {fs.describe_config(lc)}")
                assert lc["design"] == "group"
                assert fk or lc["working_set"] == "global", lc
        errs = {}
        for n in widths:
            for k, v in check(key, n, seed=0).items():
                errs[k] = max(v, errs.get(k, 0.0))
        q, qd, eff, _ = check_states(key, timed, seed=1)
        assert parity.active_contacts(eng, q, qd)["ground"] > 0
        ptg = parity.check_targets(m, q, 1)
        z = torch.zeros((timed, m.njd), device=dev)
        fa = torch.zeros((timed, m.nb, 6), device=dev)
        runs = {"step": (lambda: fs.step(eng, q, qd, eff, ptg, z, fa, 4),
                         lambda: fs.step_plain(eng, q, qd, eff, ptg, z, fa, 4)),
                "fk": (lambda: fs.fk(eng, q, qd), lambda: fs.fk_plain(m, q, qd)),
                "substep": (lambda: fs.substep(eng, q, qd, eff, ptg, z, fa),
                            lambda: fs.substep_plain(eng, q, qd, eff, ptg, z, fa))}
        for kname, (run_k, _) in runs.items():
            ref = run_k()
            assert all(torch.equal(a, b) for a, b in zip(run_k(), ref)), (key, kname)
        log(f"{key}: K1, K3 and K2 bitwise equal over two launches at {timed} envs")
        ops, nbytes = fs.op_count(m, 4), fs.io_bytes(m)
        ops["fk"] = fs.op_count(m, 1)["fk"]
        for kname, (run_k, run_p) in runs.items():
            ms = time_ms(run_k, 10)
            device_ms = device_ms_of(run_k, ms)
            plain_ms = time_ms(run_p, 2)
            lc = eng.kernels.config(timed, fk=kname == "fk")[0]
            bound_ms, bound_by = bound(timed, nbytes[kname], ops[kname])
            label, line = {"step": ("fused_step_k1", 1016), "fk": ("report_fk_k2", 943),
                           "substep": ("substep_k3", 898)}[kname]
            log(f"{label} {key}: {card} | {timed} envs: {ms:.4f} ms ({device_ms:.4f} ms of "
                f"device time per launch, profiler), plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({ops[kname]} FP32 ops and "
                f"{nbytes[kname]} bytes per env), {bound_ms / ms * 100:.2f}% of "
                f"roofline, on no main path; launch {fs.describe_config(lc)}")
            rows.append(dict(
                name=f"{label}_{key.lower()}", model=key, route="cuda",
                source=SOURCES["group"], replaces=f"{TPU_FILE}:{line}", launches=0,
                on_main_path=False, max_abs_err=errs[kname], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                device_ms=device_ms, envs=timed, launch={k: lc[k] for k in (
                    "design", "envs_per_block", "blocks", "smem_bytes", "env_bytes",
                    "working_set")}))
        del q, qd, eff, ptg, z, fa, runs
        torch.cuda.synchronize()
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")


def run_child(cmd, cwd, timeout, env=None):
    """Run cmd in a session of its own; (exit code, output). Past `timeout`
    the whole session is killed and the call raises."""
    import signal

    p = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{cmd[:6]} outlived its {timeout} s")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return p.returncode, out


def distributed_phase(card, nccl_ranks=1, ranks=2, backend="gloo", device="cuda:0"):
    """Phase 12: distributed training (module docstring): torchrun with
    `nccl_ranks` processes, then `ranks` worker processes on `device` under
    `backend` (on the one card: 2 gloo ranks on cuda:0; on several cards,
    tools/multi_gpu_check.py: NCCL, cuda:LOCAL_RANK)."""
    from omniisaacgymenvs_torch.parallel import mesh
    from omniisaacgymenvs_torch.utils.config import load_config, ppo_config_kwargs

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_distributed as tdist

    name, n = DIST_TASK
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # (a) NCCL at world size 1, through torchrun and the train CLI
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nccl_ranks}", "-m", "omniisaacgymenvs_torch.scripts.train",
               f"task={name}", "distributed=True", f"num_envs={n}",
               "max_iterations=2"]
        t0 = time.perf_counter()
        rc, out = run_child(cmd, tmp, DIST_TIMEOUT_S, env)
        dt = time.perf_counter() - t0
        assert rc == 0, f"torchrun exited {rc}:\n{out[-4000:]}"
        with open(os.path.join(tmp, "runs", name, "history.json")) as f:
            hist = json.load(f)
        assert len(hist) == 2, len(hist)
        bad = [k for m in hist for k, v in m.items() if not math.isfinite(v)]
        assert not bad, f"non-finite metrics {bad}"
        log(f"torchrun NCCL world size {nccl_ranks}: {card} | {name} {n} envs, 2 epochs through "
            f"scripts/train.py distributed=True in {dt:.1f} s (process start "
            f"included), finite metrics; last epoch mean_step_reward "
            f"{hist[-1]['mean_step_reward']:.4f}, {hist[-1]['steps_per_sec']:.1f} "
            f"train-steps/s")
    # (b) worker ranks: on one card two under gloo (NCCL refuses two ranks
    # on one device)
    cfg = load_config({"task": name})
    spec = dict(task=name, task_cfg=cfg["task"], num_envs=n, seed=0,
                # exact f32 networks, so that the ranks' epoch equals one
                # rank's within LEARNER_ATOL (the default rule read 2.66e-04)
                ppo=dict(ppo_config_kwargs(cfg["train"]), mixed_precision=False,
                         net_matmul="f32"),
                device=device, backend=backend)
    if backend == "gloo":
        log(f"gloo on CUDA tensors: all_reduce and broadcast on the card, "
            f"{', '.join(mesh.GLOO_HOST_STAGED)} staged through host copies")
    label = f"{ranks} {backend or 'NCCL'} ranks"
    r_envs = n // ranks
    with tempfile.TemporaryDirectory() as tmp:
        spec_l = dict(spec, mode="learn")
        tr = tdist.make_trainer(spec_l, "cuda")
        traj, last_value, stats, _, _ = tdist.store_rollout(tr, tmp)
        t0 = time.perf_counter()
        results = tdist.run_ranks(tmp, spec_l, world=ranks, timeout=DIST_TIMEOUT_S)
        dt2 = time.perf_counter() - t0
        ref, dt1 = tdist.one_rank_reference(tr, traj, last_value, stats, results)
        worst = tdist.check_learner(tr, ref, results, LEARNER_ATOL)
        S, mb = tr._slices()
        per_rank = " / ".join(f"{r['learn_s'] * 1e3:.1f}" for r in results)
        log(f"learner epoch, {label} vs 1: {card} | {name} {n} envs ({ranks} x "
            f"{r_envs}), f32 networks, {S} samples in minibatches of {mb} ({ranks} x "
            f"{mb // ranks}): parameters max abs diff {worst:.3e} (bound "
            f"{LEARNER_ATOL:.0e}), the ranks bitwise equal; kl {ref['kl']:.6f}; "
            f"epoch {per_rank} ms per rank, {dt1 * 1e3:.1f} ms at 1 rank (each "
            f"after a first epoch on a copy of the state); "
            f"the {ranks}-rank run {dt2:.1f} s with process start")
        del tr, traj, last_value, stats
    with tempfile.TemporaryDirectory() as tmp:
        spec_c = dict(spec, mode="checkpoint")
        t0 = time.perf_counter()
        results = tdist.run_ranks(tmp, spec_c, world=ranks, timeout=DIST_TIMEOUT_S)
        dt = time.perf_counter() - t0
        T = spec["ppo"]["horizon_length"]
        for r, res in enumerate(results):
            got = res["launches"]
            assert got["step"] == 2 * T and got["fk"] >= 2 * T and got["substep"] == 0, (
                r, got)
            assert res["bad"] == [], (r, res["bad"][:5])
            assert res["num_envs"] == r_envs
        bad = [k for m in results[0]["history"] for k, v in m.items()
               if not math.isfinite(v)]
        assert not bad, f"non-finite metrics {bad}"
        log(f"{label} through PPOTrainer.train: {card} | {name} {ranks} x {r_envs} "
            f"envs, 2 epochs, K1 launches per rank "
            f"{[r['launches']['step'] for r in results]} (once per control step), K2 "
            f"{[r['launches']['fk'] for r in results]}; a checkpoint at epoch 2 resumed "
            f"at world size {ranks} and one more epoch: every leaf of every rank bitwise "
            f"equal to the uninterrupted run; {dt:.1f} s with process start")


def trained_policy_phase(card):
    """Phase 15 (module docstring): the JAX-trained ShadowHand policy's
    deterministic evaluation on the card, its launches counted around it,
    its reward and successes per finished episode within TRAINED_BAND."""
    from omniisaacgymenvs_torch.scripts.train import build_trainer, evaluate

    c = TRAINED_POLICY
    _, task, tr = build_trainer([
        "task=ShadowHand", f"num_envs={c['envs']}", "device=cuda", "test=True",
        f"checkpoint={os.path.join(ROOT, c['checkpoint'])}",
        # the band was read on the CPU with exact f32 networks
        "train.params.config.net_matmul=f32"])
    assert tr.state.epoch == 9980 and tr.net_matmul == "f32", tr.state.epoch
    kern = task.engine.kernels
    form = kern.config(c["envs"])[0]["design"]
    lines = []
    kern.reset_counts()
    with plain_physics_counted() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reward, episodes = evaluate(tr, steps=c["steps"], log_fn=lines.append,
                                    seed=c["seed"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    got = dict(kern.launches)
    assert plain["n"] == 0, "the evaluation ran the plain physics"
    assert form == "group" and kern.thread_launches["step"] == 0, kern.thread_launches
    assert got["step"] == c["steps"] and got["substep"] == 0, got
    assert got["fk"] >= c["steps"], got
    per_episode = [float(x.split(" = ")[1]) for x in lines
                   if x.startswith("eval: successes per finished episode = ")]
    assert len(per_episode) == 1, lines
    successes = per_episode[0]
    log(f"trained policy: {card} | ShadowHand, the JAX package's policy of epoch "
        f"9980, {c['envs']} envs x {c['steps']} steps (seed {c['seed']}) in "
        f"{dt:.1f} s: {reward:.2f} a finished episode over {episodes} episodes, "
        f"{successes:.4f} successes a finished episode; band {TRAINED_BAND}; "
        f"launches {got}, K1 in the {form} form; {' | '.join(lines)}")
    for key, value in (("reward", reward), ("successes", successes)):
        lo, hi = TRAINED_BAND[key]
        assert lo <= value <= hi, (key, value, TRAINED_BAND[key])


def falls_phase(card):
    """Phase 16 (module docstring): AllegroHand's resets by cause under a
    held policy, K1 (the product path, its launches counted) against
    step_plain on the card, each cause within FALLS_SD_MAX sd."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_fall_rates as fr

    c = FALLS
    t0 = time.perf_counter()
    with plain_physics_counted() as plain:
        k1 = fr.run_port(c["envs"], c["steps"], fr.HoldPolicy(
            c["envs"], 16, c["hold"], c["seed"]), c["seed"], "cuda", "k1")
    assert plain["n"] == 0, "the K1 run ran the plain physics"
    got = k1["launches"]
    assert got["step"] == c["steps"] and got["substep"] == 0, got
    assert k1["form"] == "group" and k1["thread_launches"] == 0, k1["form"]
    ref = fr.run_port(c["envs"], c["steps"], fr.HoldPolicy(
        c["envs"], 16, c["hold"], c["seed"]), c["seed"], "cuda", "plain")
    assert ref["launches"]["step"] == 0, ref["launches"]
    sd = fr.compare(k1, ref)

    def counts(r):
        return ", ".join(f"{k} {v['count']}" for k, v in r["rates"].items())

    log(f"falls: {card} | AllegroHand {c['envs']} envs x {c['steps']} steps, "
        f"hold:{c['hold']} (seed {c['seed']}), in {time.perf_counter() - t0:.1f} s | "
        f"K1 ({k1['form']}, launches {got}): {counts(k1)}; episode "
        f"{k1['episode_length']['mean']:.2f} steps, cube p99 {k1['cube_lin_speed']['p99']:.3f}"
        f" m/s | plain: {counts(ref)}; episode {ref['episode_length']['mean']:.2f} steps, "
        f"cube p99 {ref['cube_lin_speed']['p99']:.3f} m/s | K1 - plain in sd: {sd}")
    assert k1["rates"]["fell"]["count"] > 0 and ref["rates"]["fell"]["count"] > 0
    for cause in fr.CAUSES:
        assert abs(sd[cause]) <= FALLS_SD_MAX, (cause, sd, counts(k1), counts(ref))


def trained_learner_phase(card):
    """Phase 17 (module docstring): AllegroHand's learner epoch from the
    port's trained state at the yaml's width, card against CPU under both
    matmul rules, on one rollout through K1 whose launches are counted."""
    from omniisaacgymenvs_torch.scripts.train import build_trainer

    c = TRAINED_LEARNER
    t0 = time.perf_counter()
    _, task, tr = build_trainer([
        "task=AllegroHand", f"num_envs={c['envs']}", "device=cuda", f"seed={c['seed']}",
        f"checkpoint={os.path.join(ROOT, c['checkpoint'])}",
        "train.params.config.net_matmul=f32"])
    ppo = tr.cfg
    assert tr.state.epoch == 2000 and float(tr.state.opt_state.count) == 40000.0
    assert (ppo.horizon_length, ppo.minibatch_size, ppo.mini_epochs) == (16, 32768, 5), ppo
    kern = task.engine.kernels
    form = kern.config(c["envs"])[0]["design"]
    kern.reset_counts()
    with plain_physics_counted() as plain:
        rollout = tr._rollout(tr.state)
        torch.cuda.synchronize()
    got = dict(kern.launches)
    assert plain["n"] == 0, "the rollout ran the plain physics"
    assert form == "group" and kern.thread_launches["step"] == 0, kern.thread_launches
    assert got["step"] == ppo.horizon_length and got["substep"] == 0, got
    assert got["fk"] >= ppo.horizon_length, got
    traj = rollout[0]
    mu = traj["mu"]
    log(f"trained learner: {card} | AllegroHand {c['envs']} envs from "
        f"{c['checkpoint']} (epoch 2000, lr {float(tr.state.lr):.4e}): one rollout of "
        f"{ppo.horizon_length} steps, launches {got}, K1 in the {form} form; action "
        f"means past the bound {float((mu.abs() > 1.1).float().mean()):.4f} of them, "
        f"mean reward a step {float(traj['reward'].mean()):.5f}")
    learner_steps_card_vs_cpu(tr, card, rollout)
    learner_steps_card_vs_cpu(tr, card, rollout, matmul="bf16_operands", atol=RULE_ATOL,
                              rel_max=RULE_REL, metric_rtol=RULE_METRIC_RTOL)
    log(f"trained learner: both rules in {time.perf_counter() - t0:.1f} s")


def learner_steps_card_vs_cpu(trainer, card, rollout, matmul="f32", atol=LEARNER_ATOL,
                              rel_max=LEARNER_STEP_REL, metric_rtol=1e-3):
    """Phase 17's learner epoch on one stored rollout (a `_rollout` result on
    the card), held step by step: the CPU runs the epoch (`_learn`, f32
    networks under the matmul rule `matmul`), and at each of its minibatch
    steps the card takes the same step from the CPU's state of that moment
    (`learner_step_from`: parameters, Adam state, lr, the norms, the
    minibatch and the advantages' moments copied over). After each step
    the lr the same; every parameter within `atol`, and each tensor's step
    within `rel_max` of the CPU's (the norm of the difference over the norm
    of the CPU's step), and Adam's two moments within `rel_max` of each
    tensor's largest element; the epoch's loss metrics (the means of the
    steps' terms, as `_update` returns them) within `metric_rtol` (atol
    1e-5), as phase 8 holds them; GAE, the value norm's update and the obs
    norm's update card against CPU from the same inputs within rtol 1e-4
    (atol 1e-6). Each step's terms are logged, not held: a minibatch's actor
    loss is a mean that cancels to some 1e-3 of its terms. An epoch run
    apart on each side cannot be held so from a trained state: it grows the
    arithmetic's rounding, and the CPU's own f32 epoch parts from its f64
    epoch by more than these bounds (tools/learner_card_cpu.py)."""
    from omniisaacgymenvs_torch.learn.networks import set_matmul

    cfg = trainer.cfg
    dev, cpu = trainer.device, torch.device("cpu")
    traj, last_value, stats = rollout
    S, mb_rows = trainer._slices()
    perms = trainer._perms(cfg.mini_epochs, S)
    tr = copy.copy(trainer)
    tr.device = cpu
    st = state_to(trainer.state, cpu)
    st.ac.dtype = None
    set_matmul(st.ac, matmul)
    card_net = copy.deepcopy(st.ac).to(dev)
    names = [k for k, _ in card_net.named_parameters()]
    c_traj, c_last = state_to(traj, cpu), last_value.cpu()

    def close(a, b, what):
        a = a.cpu()
        assert bool(((a - b).abs() <= 1e-6 + 1e-4 * b.abs()).all()), (matmul, what)

    (g_adv, g_ret), (c_adv, c_ret) = trainer._gae(traj, last_value), tr._gae(c_traj, c_last)
    close(g_adv, c_adv, "advantages")
    close(g_ret, c_ret, "returns")
    for name, x, y in (("value_norm", g_ret, c_ret), ("obs_norm", traj["obs"], c_traj["obs"])):
        a, b = getattr(trainer.state, name).update(x), getattr(st, name).update(y)
        for f in ("mean", "var", "count"):
            close(getattr(a, f), getattr(b, f), f"{name}.{f}")

    side, worst = {}, {"abs": (0.0, ""), "rel": (0.0, ""), "mu": (0.0, ""), "nu": (0.0, "")}

    def before(row, stash, params, state, lr, max_norm):
        side["before"] = [p.detach().clone() for p in params]
        side["terms"], side["state"], side["lr"] = learner_step_from(
            trainer, card_net, stash, params, state, lr, max_norm)

    def after(row, params, state):
        i = len(rows) - 1
        row["card"] = side["terms"]
        for name, g, c, b in zip(names, card_net.parameters(), params, side["before"]):
            g, c = g.detach().cpu(), c.detach()
            diff = float((g - c).abs().max())
            moved, gap = float((c - b).norm()), float((g - c).norm())
            # at the lr's floor a tensor's step can round away on both sides
            rel = gap / moved if moved > 0 else (0.0 if gap == 0 else math.inf)
            assert diff <= atol and rel <= rel_max, (matmul, i, name, diff, rel)
            worst["abs"] = max(worst["abs"], (diff, f"{name} at step {i}"))
            worst["rel"] = max(worst["rel"], (rel, f"{name} at step {i}"))
        for which in ("mu", "nu"):
            for name, g, c in zip(names, getattr(side["state"], which), getattr(state, which)):
                gap = float((g.cpu() - c).abs().max() / c.abs().max().clamp_min(1e-30))
                assert gap <= rel_max, (matmul, i, which, name, gap)
                worst[which] = max(worst[which], (gap, f"{name} at step {i}"))
        assert float(side["state"].count) == float(state.count), (matmul, i, "count")
        row["card"]["lr_after"] = side["lr"]

    with traced_learner(tr, before, after) as rows:
        tr._learn(st, c_traj, c_last, state_to(stats, cpu), perms=perms.cpu())
    n_updates = cfg.mini_epochs * (S // mb_rows)
    assert len(rows) == n_updates, (len(rows), n_updates)
    for i, r in enumerate(rows):
        assert r["card"]["lr_after"] == r["lr_after"], (matmul, i, r["card"]["lr_after"],
                                                        r["lr_after"])
    # the epoch's loss metrics are the means of its steps' terms
    terms = [k for k in rows[0] if k not in ("card", "lr_after")]
    means = {k: [sum(r["card"][k] for r in rows) / n_updates,
                 sum(r[k] for r in rows) / n_updates] for k in terms}
    worst_metric = max(abs(g - c) / (1e-5 + abs(c)) for g, c in means.values())
    log(f"learner steps, card vs CPU ({matmul} products): {card} | "
        f"{trainer.env.num_envs} envs, {S} samples, {n_updates} steps, each from the "
        f"CPU's state: parameters max abs diff {worst['abs'][0]:.3e} ({worst['abs'][1]}; "
        f"bound {atol:.0e}), largest per-tensor |card - cpu| / |cpu step| "
        f"{worst['rel'][0]:.3e} ({worst['rel'][1]}; bound {rel_max:.0e}); Adam's moments' "
        f"largest |card - cpu| / max |cpu|: mu {worst['mu'][0]:.3e} ({worst['mu'][1]}), "
        f"nu {worst['nu'][0]:.3e} ({worst['nu'][1]}; bound {rel_max:.0e}); the epoch's "
        f"loss metrics' largest |card - cpu| / (1e-5 + |cpu|) {worst_metric:.3e} (bound "
        f"{metric_rtol:.0e}); lr after the epoch {rows[-1]['lr_after']:.4e}")
    for k in terms + ["lr_after"]:
        gap = max(abs(r["card"][k] - r[k]) for r in rows)
        log(f"  {matmul} {k} by minibatch, card: "
            + " ".join(f"{r['card'][k]:.6g}" for r in rows) + f" | largest |card - cpu| {gap:.3e}")
    for k, (g, c) in means.items():
        assert abs(g - c) <= 1e-5 + metric_rtol * abs(c), (matmul, k, g, c)


def campaign_phase(tmp, card, device="cuda", extra=None, timeout_s=CAMPAIGN_TIMEOUT_S,
                   cases=None):
    """Phase 14: the campaign runner, one chunk against two, on each case
    of CAMPAIGNS (module docstring), or those whose experiment is in
    `cases`. `device`, `extra` (overrides by case experiment) and
    `timeout_s` let the phase run at a small size on the CPU."""
    for c in CAMPAIGNS:
        if cases is not None and c["exp"] not in cases:
            continue
        campaign_case(tmp, card, c, device, tuple((extra or {}).get(c["exp"], ())),
                      timeout_s)


def campaign_case(tmp, card, c, device, extra, timeout_s):
    from omniisaacgymenvs_torch.scripts.campaign import RECORD, du, unequal_runs

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "omniisaacgymenvs_torch.scripts.campaign"]
    cli = [c["task"], f"num_envs={c['envs']}", "seed=42", f"device={device}",
           *c["overrides"], f"max_iterations={c['epochs']}",
           f"train.params.config.save_frequency={c['save_frequency']}",
           f"timeout_s={timeout_s}", "retries=0", *extra]
    chunked = [*cli, f"chunk={c['chunk']}", "out=carried"]
    whole_exp, chunked_exp = f"{c['exp']}_whole", f"{c['exp']}_chunked"
    runs = ((whole_exp, cli), (chunked_exp, chunked), (chunked_exp, chunked))
    children = []
    for i, (exp, args) in enumerate(runs):
        if i == 2:  # a new machine: the run directory is gone
            shutil.rmtree(os.path.join(tmp, "runs", exp))
        t0 = time.perf_counter()
        rc, out = run_child(base + [exp, *args], tmp, timeout_s + 60, env)
        dt = time.perf_counter() - t0
        assert rc == 0, f"campaign {exp} exited {rc}:\n{out[-4000:]}"
        if i == 2:
            assert "restored" in out, out[-2000:]
        with open(os.path.join(tmp, "runs", exp, RECORD)) as f:
            chunk = json.load(f)["chunks"][-1]
        children.append((exp, chunk, dt))
    whole, chunked_dir = (os.path.join(tmp, "runs", e) for e in (whole_exp, chunked_exp))
    diffs = unequal_runs(whole, chunked_dir)
    assert not diffs, diffs[:10]
    with open(os.path.join(chunked_dir, "history.json")) as f:
        hist = json.load(f)
    assert [m["epoch"] for m in hist] == list(range(c["epochs"])), hist
    bad = [k for m in hist for k, v in m.items() if not math.isfinite(v)]
    assert not bad, f"non-finite metrics {bad}"
    horizon = None
    for exp, chunk, dt in children:
        epochs = chunk["end"] - chunk["start"]
        got = chunk.get("launches")
        if device == "cuda":
            from omniisaacgymenvs_torch.utils.config import load_config

            horizon = horizon or load_config({"task": c["task"]})["train"]["params"][
                "config"]["horizon_length"]
            steps = epochs * horizon
            assert got and got["step"] == c["k1_per_step"] * steps, (exp, got)
            assert got["fk"] >= steps and got["substep"] == 0, (exp, got)
            assert got["step_overlay"] == (got["step"] if c["overlay"] else 0), (exp, got)
            assert got["step_thread"] == (got["step"] if c["thread"] else 0), (exp, got)
        log(f"campaign {exp} epochs {chunk['start']}-{chunk['end']}: {card} | "
            f"{chunk.get('device_line')}; {chunk.get('train_steps_per_sec')} "
            f"train-steps/s, {dt:.1f} s with the runner's and the child's start; "
            f"kernel launches {got}")
    last = os.path.join(whole, "nn", "last")
    log(f"campaign {c['exp']}: {card} | {children[0][1].get('device_line')} "
        f"{' '.join(c['overrides'])}: nn/last {du(last)} B (du -sb; model.pt "
        f"{du(os.path.join(last, 'model.pt'))} B, env.pt "
        f"{du(os.path.join(last, 'env.pt'))} B); uninterrupted run "
        f"{children[0][1].get('train_steps_per_sec')} train-steps/s")
    log(f"campaign {c['exp']}: {card} | {c['task']}, {c['epochs']} epochs in one "
        f"chunk and in {c['epochs'] // c['chunk']} chunks of {c['chunk']} with "
        f"runs/ deleted between them: {len(hist)} history rows equal but "
        f"steps_per_sec, every nn/last leaf bitwise equal; last epoch "
        f"mean_step_reward {hist[-1]['mean_step_reward']:.4f}"
        + (f", terrain level {hist[-1].get('episode/terrain_level')}"
           if "episode/terrain_level" in hist[-1] else ""))


def demos_phase(tmp, card, rows, check, check_states, bound, device_ms_of,
                engines, n_sub):
    """Phase 13: the demos and the regression harness (module docstring);
    appends the K1 and K2 rows of the demos' widths to `rows`."""
    import numpy as np

    from omniisaacgymenvs_torch.demos import anymal_terrain, interactive
    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.scripts import play
    from omniisaacgymenvs_torch.scripts.train import build_trainer

    dev = torch.device("cuda")
    # (a) the regression harness, as a user runs it after a kernel change
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    rc, out = run_child([sys.executable, "-m", "omniisaacgymenvs_torch.scripts.gpu_regression"],
                        ROOT, REGRESSION_TIMEOUT_S, env)
    lines = [ln for ln in out.splitlines() if ln.startswith('{"ok"')]
    assert rc == 0 and lines, f"gpu_regression exited {rc}:\n{out[-4000:]}"
    res = json.loads(lines[-1])
    assert res["ok"] is True and len(res["checks"]) == 5, res
    for name, c in res["checks"].items():
        log(f"gpu_regression {name}: {card} | {json.dumps(c)}")
    log(f"gpu_regression: ok, 5 checks in {time.perf_counter() - t0:.1f} s (process "
        f"start included)")

    # (b) the kernels at the demos' widths against their plain versions
    errs = {}
    for name, n in DEMO_WIDTHS:
        errs[(name, n)] = check(name, n, seed=0, cover=False)
        eng = engines[name]
        for key in ("step", "fk"):
            lc = eng.kernels.config(n, eng.has_terrain and key == "step", False,
                                    key == "fk")[0]
            log(f"  {name} {n} env(s), {'K1' if key == 'step' else 'K2'}: launch "
                f"{fs.describe_config(lc)}")

    # (c) the interactive demo's selftest, and its first steps against the CPU
    launches = {}
    cmds, cmd = [], np.zeros(3, np.float32)
    for key, n_press in interactive.SELFTEST_SCRIPT:
        for _ in range(n_press):
            interactive.apply_keys(cmd, [key])
            cmds.append(torch.as_tensor(cmd.copy()))
    for name in ("Anymal", "AnymalTerrain"):
        with plain_physics_counted() as plain:
            t0 = time.perf_counter()
            res = interactive.main(["selftest=1", f"task={name}", "device=cuda"])
            dt = time.perf_counter() - t0
        task = res["task"]
        got = dict(task.engine.kernels.launches)
        per_step = task.engine.k1_launches(task.decimation)
        assert plain["n"] == 0, "the demo ran the plain physics"
        assert res["steps"] == SELFTEST_STEPS, res["steps"]
        assert got["step"] == SELFTEST_STEPS * per_step and got["substep"] == 0, got
        assert got["fk"] >= 1, got
        assert math.isfinite(res["displacement"]) and np.isfinite(res["heights"]).all()
        launches[(name, 1)] = got
        log(f"interactive selftest: {card} | {name} 1 env, {res['steps']} steps in "
            f"{dt:.1f} s (task build included), launches {got} ({per_step} K1 a "
            f"step), displacement {res['displacement']:.4f} m, base height min "
            f"{min(res['heights']):.4f} mean {np.mean(res['heights']):.4f} final "
            f"{res['heights'][-1]:.4f} m (untrained policy)")
        del res, task
        # the same steps on the card and the CPU from one reset, with the
        # card's weights; exact f32 networks (the card's and the CPU's bf16
        # round apart) and no observation noise (two generators)
        argv = [f"task={name}", "num_envs=1", "test=True",
                "train.params.config.net_matmul=f32"]
        if name == "AnymalTerrain":
            argv.append("task.env.learn.addNoise=False")
        _, _, gtr = build_trainer(argv + ["device=cuda"])
        _, _, ctr = build_trainer(argv + ["device=cpu"])
        ctr.state = state_to(gtr.state, "cpu")
        gtr.state.ac.dtype = ctr.state.ac.dtype = None
        ges = gtr.env.reset(seed=0)
        ces = state_to(ges, "cpu")
        rtol, atol = DEMO_OBS_TOL
        worst = {"obs": 0.0, "reward": 0.0}
        for k in range(DEMO_CPU_STEPS):
            ges = interactive.demo_step(gtr, gtr.env, ges, cmds[k])
            ces = interactive.demo_step(ctr, ctr.env, ces, cmds[k])
            go, gr = ges.obs.cpu(), ges.reward.cpu()
            assert torch.equal(ges.done.cpu(), ces.done), k
            assert bool(((go - ces.obs).abs() <= atol + rtol * ces.obs.abs()).all()), k
            assert bool(((gr - ces.reward).abs()
                         <= DEMO_REW_TOL + DEMO_REW_TOL * ces.reward.abs()).all()), k
            worst["obs"] = max(worst["obs"], float((go - ces.obs).abs().max()))
            worst["reward"] = max(worst["reward"], float((gr - ces.reward).abs().max()))
        log(f"demo steps, card vs CPU: {card} | {name} 1 env x {DEMO_CPU_STEPS} steps "
            f"under the selftest's commands: obs max abs err {worst['obs']:.3e} (rtol "
            f"{rtol}, atol {atol}), reward {worst['reward']:.3e} (rtol, atol "
            f"{DEMO_REW_TOL}), dones equal")
        del gtr, ctr, ges, ces

    # (d) the AnymalTerrain demo
    path = os.path.join(tmp, "demo.npz")
    with plain_physics_counted() as plain:
        t0 = time.perf_counter()
        res = anymal_terrain.main([f"out={path}", "device=cuda"])
        dt = time.perf_counter() - t0
    task = res["task"]
    got = dict(task.engine.kernels.launches)
    steps = sum(int(sec / task.dt) for sec, _ in anymal_terrain.COMMAND_SCRIPT)
    assert plain["n"] == 0, "the demo ran the plain physics"
    assert res["steps"] == steps == 700, (res["steps"], steps)
    assert got["step"] == steps * task.engine.k1_launches(task.decimation) == 2800, got
    assert got["fk"] >= 1 and got["substep"] == 0, got
    rec = np.load(path)
    assert sorted(rec.files) == ["commands", "dof_names", "q"], rec.files
    assert rec["q"].shape == (steps, task.model.nq) and rec["q"].dtype == np.float32
    assert rec["commands"].shape == (steps, 3) and rec["commands"].dtype == np.float64
    assert list(rec["dof_names"]) == list(task.model.dof_names)
    assert np.isfinite(rec["q"]).all(), "non-finite q"
    launches[("AnymalTerrain", anymal_terrain.DEMO_ENVS)] = got
    log(f"AnymalTerrain demo: {card} | {anymal_terrain.DEMO_ENVS} envs, {steps} steps "
        f"in {dt:.1f} s (task build included), launches {got}; .npz q "
        f"{rec['q'].shape}, commands {rec['commands'].shape}, {len(rec['dof_names'])} "
        f"dof names; displacement {res['displacement']:.4f} m (untrained policy)")
    del res, task, rec

    # (e) a recording for the viewer
    path = os.path.join(tmp, "traj.npz")
    play.main(["task=Anymal", "num_envs=64", "device=cuda", f"record={path}",
               "max_iterations=32"])
    rec = np.load(path)
    assert sorted(rec.files) == sorted(["q", "body_pos", "parents", "rewards", "task",
                                        "body_names", "dof_names"]), rec.files
    assert rec["body_pos"].shape[:1] == rec["q"].shape[:1] == rec["rewards"].shape == (32,)
    assert str(rec["task"]) == "Anymal" and np.isfinite(rec["body_pos"]).all()
    log(f"play.py record=: {card} | Anymal, 32 steps of env 0, keys {sorted(rec.files)}")

    # K1 and K2 at the demos' widths again, and timed
    for name, n in DEMO_WIDTHS:
        again = check(name, n, seed=1, cover=False)
        eng = engines[name]
        m = eng.model
        terrain = eng.has_terrain
        q, qd, eff, pl = check_states(name, n, seed=1)
        ptg = parity.check_targets(m, q, 1)
        z = torch.zeros((n, m.njd), device=dev)
        fa = torch.zeros((n, m.nb, 6), device=dev)
        runs = {"step": (lambda: fs.step(eng, q, qd, eff, ptg, z, fa, n_sub[name], **pl),
                         lambda: fs.step_plain(eng, q, qd, eff, ptg, z, fa, n_sub[name],
                                               **pl)),
                "fk": (lambda: fs.fk(eng, q, qd), lambda: fs.fk_plain(m, q, qd))}
        for key, (run_k, run_p) in runs.items():
            fk = key == "fk"
            ms = time_ms(run_k, 20)
            device_ms = device_ms_of(run_k, ms)
            plain_ms = time_ms(run_p, 2)
            lc = eng.kernels.config(n, terrain and not fk, False, fk)[0]
            ops = (fs.op_count(m, 1)["fk"] if fk
                   else fs.op_count(m, n_sub[name], planes=terrain)["step"])
            bound_ms, bound_by = bound(n, fs.io_bytes(m, planes=terrain and not fk)[key],
                                       ops)
            n_launch = launches[(name, n)][key]
            label = "report_fk_k2" if fk else "fused_step_k1"
            log(f"{label} {name}: {card} | {n} env(s): {ms:.4f} ms ({device_ms:.4f} ms "
                f"of device time per launch, profiler), plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.6f} ms by {bound_by}, {n_launch} launches on the demo's "
                f"path; launch {fs.describe_config(lc)}")
            rows.append(dict(
                name=f"{label}_{name.lower()}_{n}env", model=name, route="cuda",
                source=SOURCES[lc["design"]],
                replaces=f"{TPU_FILE}:{943 if fk else 1016}", launches=n_launch,
                max_abs_err=max(errs[(name, n)][key], again[key]), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, device_ms=device_ms, envs=n,
                launch={k: lc[k] for k in ("design", "group", "envs_per_block",
                                           "blocks", "smem_bytes", "env_bytes")}))


if __name__ == "__main__":
    sys.exit(main())
