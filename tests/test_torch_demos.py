"""Port parity of the demos (omniisaacgymenvs_torch/demos/): `demo_step`
against the JAX demos' step rebuilt from its public pieces (the carry's
command override, `trainer._policy`, `env._step_fn`) on Anymal and
AnymalTerrain from the same state and weights, the key handling through a
fake key source, the AnymalTerrain demo's .npz against the JAX demo's, and
the selftest line against the JAX selftest's."""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.convert import env_state_from_arrays
from omniisaacgymenvs_torch.demos import anymal_terrain, interactive
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config, ppo_config_kwargs
from omniisaacgymenvs_tpu.demos import anymal_terrain as janymal_terrain
from omniisaacgymenvs_tpu.demos import interactive as jinteractive
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.learn import PPOConfig as JPPOConfig
from omniisaacgymenvs_tpu.learn import PPOTrainer as JPPOTrainer
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from omniisaacgymenvs_tpu.utils.config import load_config as jload_config
from omniisaacgymenvs_tpu.utils.config import ppo_config_kwargs as jppo_config_kwargs
from torch_parity import np_, to_numpy_tree

N = 4
TASKS = ("Anymal", "AnymalTerrain")
# a small terrain grid and no observation noise (the two packages draw it
# from different generators), as tests/test_torch_anymal.py runs them
SMALL_TERRAIN = {"numLevels": 3, "numTerrains": 5}
CFGS = {"Anymal": None,
        "AnymalTerrain": {"env": {"terrain": SMALL_TERRAIN,
                                  "learn": {"addNoise": False}}}}
TERRAIN_CLI = [f"task.env.terrain.{k}={v}" for k, v in SMALL_TERRAIN.items()]
# tests/test_torch_anymal.py::test_rollout_matches_jax: positions and angles
# to 1e-4, velocity terms with the step's float32 rounding; rewards 1e-3
OBS_TOL = dict(rtol=2e-3, atol=2e-3)
REW_TOL = dict(rtol=1e-3, atol=1e-3)
SELFTEST_LINE = re.compile(r"^selftest ok: (\d+) steps, displacement (-?\d+\.\d\d) m$",
                           re.M)


def selftest_commands():
    """The command of every step of the selftest's key script."""
    cmd, out = np.zeros(3, np.float32), []
    for key, n in interactive.SELFTEST_SCRIPT:
        for _ in range(n):
            interactive.apply_keys(cmd, [key])
            out.append(cmd.copy())
    return out


def jax_demo_step(jtr, jenv, jes, command):
    """The JAX demos' step (demos/interactive.py `step`, anymal_terrain.py
    `step`), composed from the same public pieces."""
    carry = dict(jes.carry)
    w = carry["commands"].shape[1]
    full = (jnp.concatenate([command[:2], jnp.zeros(1), command[2:3]]) if w == 4
            else command[:w])
    carry["commands"] = jnp.broadcast_to(full, carry["commands"].shape)
    jes = jes.replace(carry=carry)
    ts = jtr.state
    mu, *_ = jtr._policy(ts.params, ts, jes.obs, jes.states, ())
    return jenv._step_fn(jes, jnp.clip(mu, -1, 1))


def trainers(name):
    """(JAX trainer, JAX env, port trainer, port env) of `name` at N envs
    under its train yaml, trainer seed 42 as in the demos; the port's
    networks and running norms set to the JAX trainer's, the observation
    norm moved off its initial statistics."""
    jenv = JVecEnv(jget_task(name, CFGS[name]), N)
    env = VecEnv(get_task(name, CFGS[name], device="cpu"), N, seed=0)
    jtr = JPPOTrainer(jenv, JPPOConfig(**jppo_config_kwargs(
        jload_config({"task": name})["train"])), seed=42)
    tr = PPOTrainer(env, PPOConfig(**ppo_config_kwargs(
        load_config({"task": name})["train"])), seed=42)
    rng = np.random.default_rng(3)
    js = jtr.state
    jtr.state = js.replace(obs_norm=js.obs_norm.update(jnp.asarray(
        0.5 * rng.standard_normal((256, env.num_obs)) + 0.1, jnp.float32)))
    convert.actor_critic_from_arrays(to_numpy_tree(jtr.state.params["ac"]),
                                     tr.state.ac)
    for norm in ("obs_norm", "value_norm", "states_norm"):
        jn = getattr(jtr.state, norm)
        setattr(tr.state, norm, RunningNorm(
            *(torch.tensor(np.asarray(getattr(jn, f)))
              for f in ("mean", "var", "count"))))
    return jtr, jenv, tr, env


def start_states(jenv, seed):
    """A JAX reset and one step under random actions, and the same state in
    the port."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (N, jenv.num_actions)).astype(np.float32)
    jes = jenv.step(jenv.reset(seed=seed), jnp.asarray(a))
    fields = {f.name: to_numpy_tree(getattr(jes, f.name))
              for f in dataclasses.fields(jes) if f.name != "rng"}
    return jes, env_state_from_arrays(fields, device="cpu")


@pytest.mark.parametrize("name", TASKS)
def test_demo_step_matches_the_jax_demo(name):
    jtr, jenv, tr, env = trainers(name)
    jes, es = start_states(jenv, seed=2)
    cmds = selftest_commands()
    # forward at the clamp, then turning left and right at the clamp
    picked = [cmds[39], cmds[79], cmds[159]]
    assert [list(c) for c in picked] == [[1, 0, 0], [1, 0, 1], [1, 0, -1]]
    ever_done = np.zeros(N, bool)
    for k, cmd in enumerate(picked):
        before = es.carry["commands"].clone()
        es_in = es
        jes = jax_demo_step(jtr, jenv, jes, jnp.asarray(cmd))
        es = interactive.demo_step(tr, env, es, torch.as_tensor(cmd))
        # the step builds a new carry: the state it was given is unchanged
        assert torch.equal(es_in.carry["commands"], before)
        ever_done |= np.asarray(jes.done) | np_(es.done)
        keep = ~ever_done
        np.testing.assert_allclose(np_(es.obs)[keep], np.asarray(jes.obs)[keep],
                                   err_msg=f"step {k}", **OBS_TOL)
        np.testing.assert_allclose(np_(es.reward)[keep],
                                   np.asarray(jes.reward)[keep],
                                   err_msg=f"step {k}", **REW_TOL)
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
        np.testing.assert_allclose(np_(es.carry["commands"])[keep],
                                   np.asarray(jes.carry["commands"])[keep],
                                   **OBS_TOL)
        # the pinned command reaches every env (AnymalTerrain: the heading
        # target; its yaw rate comes from the heading)
        col = 3 if name == "AnymalTerrain" else 2
        np.testing.assert_array_equal(np_(es.carry["commands"])[:, [0, 1, col]],
                                      np.tile(cmd, (N, 1)))
    assert (~ever_done).sum() >= N // 2


def test_pin_commands_layouts():
    cmd = torch.tensor([0.5, -0.2, 0.7])
    three = interactive.pin_commands(torch.zeros(2, 3), cmd)
    four = interactive.pin_commands(torch.ones(2, 4), cmd)
    torch.testing.assert_close(three, cmd.expand(2, 3), rtol=0, atol=0)
    torch.testing.assert_close(four, torch.tensor([[0.5, -0.2, 0.0, 0.7]] * 2),
                               rtol=0, atol=0)
    four[0, 0] = 9.0  # a block of its own, not a view of one row
    assert four[1, 0] == 0.5


def test_keys_clamp_zero_and_quit():
    cmd = np.zeros(3, np.float32)
    assert interactive.apply_keys(cmd, ["w"] * 15)
    assert cmd[0] == 1.0
    assert interactive.apply_keys(cmd, ["s"] * 25)
    assert cmd[0] == -1.0
    assert interactive.apply_keys(cmd, ["a"] * 12)
    assert cmd[2] == 1.0
    assert interactive.apply_keys(cmd, ["d"] * 30)
    assert cmd[2] == -1.0
    assert interactive.apply_keys(cmd, ["x"])
    assert not cmd.any()
    assert not interactive.apply_keys(cmd, ["w", "q", "w"])
    np.testing.assert_allclose(cmd, [0.1, 0.0, 0.0])


class FakeKeys:
    """A key source: one list of keys per poll."""

    def __init__(self, polls):
        self.polls = list(polls)

    def poll(self):
        return self.polls.pop(0)


def test_drive_reads_a_key_source(monkeypatch, capsys):
    """The loop steps once per poll with the command the keys set, redraws
    the map, and returns at q."""
    task = get_task("Anymal", device="cpu")
    env = VecEnv(task, 1, seed=0)
    es = env.reset(seed=0)
    seen = []

    def fake_step(trainer, env_, es_, command):
        seen.append(command.numpy().copy())
        return es_

    monkeypatch.setattr(interactive, "demo_step", fake_step)
    keys = FakeKeys([["w"] * 12, [], ["a"] * 3, ["x"], ["q"], ["w"]])
    _, trail, heights = interactive.drive(None, env, es, keys, max_steps=10)
    np.testing.assert_allclose(seen, [[1, 0, 0], [1, 0, 0], [1, 0, 0.3], [0, 0, 0]],
                               atol=1e-6)
    assert len(trail) == len(heights) == 4 and keys.polls == [["w"]]
    out = capsys.readouterr().out
    assert out.count("\x1b[H\x1b[J") == 2 and "w/s a/d x q" in out


def test_anymal_terrain_demo_writes_the_jax_keys(tmp_path, monkeypatch, capsys):
    script = [(0.04, [1.0, 0.0, 0.0]), (0.06, [0.0, 0.0, 1.0])]
    monkeypatch.setattr(anymal_terrain, "COMMAND_SCRIPT", script)
    monkeypatch.setattr(janymal_terrain, "COMMAND_SCRIPT", script)
    out = anymal_terrain.main([f"out={tmp_path / 'port.npz'}", "device=cpu",
                               *TERRAIN_CLI])
    janymal_terrain.main([f"out={tmp_path / 'jax.npz'}", *TERRAIN_CLI])
    text = capsys.readouterr().out
    assert out["steps"] == 5 and out["out"] == str(tmp_path / "port.npz")
    assert re.search(r"demo: 5 steps recorded to .*port\.npz; net base displacement "
                     r"\d+\.\d\d m, final height -?\d+\.\d\d m", text)
    port, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(port.files) == sorted(ref.files) == ["commands", "dof_names", "q"]
    for k in ref.files:
        assert port[k].shape == ref[k].shape and port[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(port["commands"], ref["commands"])
    np.testing.assert_array_equal(port["dof_names"], ref["dof_names"])
    assert np.isfinite(port["q"]).all()


def test_selftest_prints_the_jax_line(capsys):
    res = interactive.main(["selftest=1", "device=cpu", "steps=6"])
    port = capsys.readouterr().out
    # the JAX demo in a process of its own: one env cannot shard over the
    # suite's 8 virtual devices (tests/test_interactive_demo.py)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.run(
        [sys.executable, "-m", jinteractive.__name__, "task=Anymal",
         "pipeline=cpu", "selftest=1", "steps=6"],
        capture_output=True, text=True, timeout=300, env=env)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref = ref.stdout
    (p,), (r,) = SELFTEST_LINE.findall(port), SELFTEST_LINE.findall(ref)
    assert p[0] == r[0] == "6" and res["steps"] == 6
    assert float(p[1]) == pytest.approx(res["displacement"], abs=5e-3)
    assert np.isfinite(res["heights"]).all() and res["state"].obs.shape[0] == 1
