"""The port's multi-process training (`parallel/mesh.py`) against one
process: two gloo ranks on the CPU, each holding half the envs.

- One learner epoch (`PPOTrainer._learn`) of 2 ranks on a stored rollout
  equals the 1-rank epoch on the same rollout with the ranks' permutations
  composed (each rank's local rows mapped to their global rows): every
  parameter within LEARNER_ATOL, FF on Cartpole, and the LSTM with an LSTM
  central value on ShadowHandOpenAI_LSTM at narrow widths.
- The global `RunningNorm.update` equals one update on the whole batch.
- A 2-rank checkpoint resumes bit for bit at 2 ranks and raises
  `CheckpointMismatch` at 1 rank (an evaluation at 1 rank skips its
  sidecar).

The worker is this file run as a script, in processes that the tests (or
`chip_smoke.py`, on the card) start with RANK, WORLD_SIZE and MASTER_PORT
set (`run_ranks`):

    python tests/test_torch_distributed.py <directory holding spec.json>

It imports no JAX. Every child process has a timeout of CHILD_TIMEOUT_S.
"""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.ppo import CheckpointMismatch, _flatten
from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
from omniisaacgymenvs_torch.parallel import mesh
from omniisaacgymenvs_torch.tasks import get_task

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120
# one learner epoch, W ranks against 1, every parameter
LEARNER_ATOL = 1e-5
WORLD = 2
FF_SPEC = dict(task="Cartpole", num_envs=32, seed=3,
               ppo=dict(horizon_length=8, minibatch_size=64, mini_epochs=2,
                        units=[16, 16], reward_shaper_scale=0.1))
LSTM_SPEC = dict(task="ShadowHandOpenAI_LSTM", num_envs=32, seed=4,
                 ppo=dict(horizon_length=8, minibatch_size=64, mini_epochs=2,
                          units=[16], rnn="lstm", rnn_units=16, seq_len=4,
                          central_value=True, cv_units=[16], cv_rnn="lstm",
                          cv_rnn_units=16, cv_minibatch_size=64,
                          cv_mini_epochs=2, schedule_type="standard"))
CKPT_SPEC = dict(task="Cartpole", num_envs=32, seed=5,
                 ppo=dict(horizon_length=8, minibatch_size=64, mini_epochs=2,
                          units=[16], rnn="lstm", rnn_units=8, seq_len=4))


# ---------------------------------------------------------------------------
# shared by the tests, the worker and chip_smoke.py
# ---------------------------------------------------------------------------

def make_trainer(spec: dict, device) -> PPOTrainer:
    task = get_task(spec["task"], spec.get("task_cfg"), device=device)
    env = VecEnv(task, spec["num_envs"], seed=spec["seed"])
    return PPOTrainer(env, PPOConfig(**spec["ppo"]), seed=spec["seed"])


def global_rows(local: torch.Tensor, rank: int, n_local: int, world: int,
                rnn_rows: int = 0) -> torch.Tensor:
    """The 1-rank dataset rows of rank `rank`'s local rows (rank r holds the
    envs [r n_local, (r + 1) n_local)). An FF dataset's rows are (step, env),
    env fastest; a recurrent one's are env-major sequences, `rnn_rows` of
    them per rank."""
    if rnn_rows:
        return rank * rnn_rows + local
    t, n = local // n_local, local % n_local
    return t * (n_local * world) + rank * n_local + n


def compose_perms(perms: list, mb_local: int, n_local: int,
                  rnn: bool) -> torch.Tensor:
    """The 1-rank permutations (rounds, world * rows) whose minibatch b is
    the union of the ranks' minibatches b: rank r's rows
    perms[r][e, b mb_local : (b + 1) mb_local], mapped to global rows."""
    world = len(perms)
    rounds, rows = perms[0].shape
    out = []
    for e in range(rounds):
        out.append(torch.cat([
            global_rows(perms[r][e, b * mb_local:(b + 1) * mb_local].cpu(), r,
                        n_local, world, rows if rnn else 0)
            for b in range(rows // mb_local) for r in range(world)]))
    return torch.stack(out)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(workdir, spec: dict, world: int = WORLD,
              timeout: float = CHILD_TIMEOUT_S) -> list:
    """Run the worker in `world` processes on `spec` (written to
    workdir/spec.json); each rank's result dict, read from workdir/rank<r>.pt.
    A rank that fails or outlives `timeout` fails the call; every process is
    ended."""
    workdir = Path(workdir)
    (workdir / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(workdir)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(workdir),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=True)
            for r in range(world)]


def timed_learn(tr: PPOTrainer, traj, last_value, stats, perms, cv_perms):
    """(metrics, seconds) of tr's learner epoch on tr.state, timed after the
    same epoch on a copy of the state: the first epoch of a process also
    pays its one-time setup (library handles, the allocator's growth)."""
    sync = torch.cuda.synchronize if tr.device.type == "cuda" else (lambda: None)
    tr._learn(copy.deepcopy(tr.state), traj, last_value, stats, perms, cv_perms)
    sync()
    t0 = time.perf_counter()
    m = tr._learn(tr.state, traj, last_value, stats, perms, cv_perms)
    sync()
    return m, time.perf_counter() - t0


def leaves(trainer: PPOTrainer) -> dict:
    """Every leaf of a trainer's checkpoint trees and its generators."""
    out = _flatten({"main": trainer._main_tree(), "env": trainer._env_state_tree()})
    out.update({f"rng.{k}": g.get_state() for k, g in trainer._generators().items()})
    return out


def unequal(a: dict, b: dict) -> list:
    assert sorted(a) == sorted(b)
    return [k for k in a if not (torch.equal(a[k], b[k].to(a[k].device))
                                 if isinstance(a[k], torch.Tensor) else a[k] == b[k])]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _learn_worker(spec, dev, workdir):
    """One learner epoch on this rank's share of the stored rollout, with
    permutations of this rank's own generator; then a norm update on this
    rank's share of a stored batch."""
    tr = make_trainer(spec, dev)
    data = torch.load(workdir / "rollout.pt", weights_only=True)
    n = tr.env.num_envs
    sl = slice(tr.rank * n, (tr.rank + 1) * n)
    traj = {k: v[:, sl].to(dev) for k, v in data["traj"].items()}
    stats = {k: v.to(dev) for k, v in data["stats"].items()}
    S, _ = tr._slices()
    cfg = tr.cfg
    perms = tr._perms(cfg.mini_epochs, S)
    cv_perms = tr._perms(cfg.cv_mini_epochs, S) if tr.use_cv else None
    m, learn_s = timed_learn(tr, traj, data["last_value"][sl].to(dev), stats,
                             perms, cv_perms)
    ts = tr.state
    batch = data["batch"]
    rows = batch.shape[0] // tr.world
    norm = RunningNorm(*(x.to(dev) for x in data["norm0"])).update(
        batch[tr.rank * rows:(tr.rank + 1) * rows].to(dev))
    return dict(
        metrics={k: float(v) for k, v in m.items()},
        params={f"{net}.{k}": p.detach().cpu()
                for net in ("ac", "cv") if getattr(ts, net) is not None
                for k, p in getattr(ts, net).named_parameters()},
        norms={f"{name}.{f}": getattr(getattr(ts, name), f).cpu()
               for name in ("obs_norm", "value_norm", "states_norm")
               for f in ("mean", "var", "count")},
        perms=perms.cpu(), cv_perms=None if cv_perms is None else cv_perms.cpu(),
        norm=[norm.mean.cpu(), norm.var.cpu(), norm.count.cpu()], learn_s=learn_s)


def _checkpoint_worker(spec, dev, workdir):
    """2 epochs through `train` with a checkpoint at the second, counting
    the kernel launches; one more epoch; a fresh trainer loaded from the
    checkpoint and trained the same epoch: the leaves that differ (none,
    for a bit-for-bit resume)."""
    save_dir = str(workdir / "nn")
    tr = make_trainer(spec, dev)
    kern = tr.env.task.engine.kernels
    if kern is not None:
        kern.reset_counts()
    hist = tr.train(max_epochs=2, log_fn=None, save_dir=save_dir, save_frequency=2)
    launches = dict(kern.launches) if kern is not None else None
    tr.train(max_epochs=3, log_fn=None)
    again = make_trainer(dict(spec, seed=spec["seed"] + 100), dev)
    msgs = []
    again.load(os.path.join(save_dir, "last"), log_fn=msgs.append)
    again.train(max_epochs=3, log_fn=None)
    return dict(bad=unequal(leaves(tr), leaves(again)), launches=launches,
                history=hist, messages=msgs, epoch=again.state.epoch,
                num_envs=tr.env.num_envs)


def worker(workdir: str):
    workdir = Path(workdir)
    spec = json.loads((workdir / "spec.json").read_text())
    dev = mesh.init_distributed(spec.get("device", "cpu"), spec.get("backend"))
    try:
        fn = {"learn": _learn_worker, "checkpoint": _checkpoint_worker}[spec["mode"]]
        out = fn(spec, dev, workdir)
        torch.save(out, workdir / f"rank{mesh.rank()}.pt")
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def store_rollout(tr: PPOTrainer, workdir, seed: int = 0):
    """A rollout of tr (and a batch for the norm check) in workdir/rollout.pt;
    returns (traj, last_value, stats, batch, norm0)."""
    traj, last_value, stats = tr._rollout(tr.state)
    g = torch.Generator().manual_seed(seed)
    batch = 3.0 * torch.randn((4 * WORLD * 8, 5), generator=g) + 1.0
    norm0 = RunningNorm(torch.randn(5, generator=g), torch.rand(5, generator=g) + 0.5,
                        torch.tensor(37.0))
    torch.save(dict(traj={k: v.cpu() for k, v in traj.items()},
                    last_value=last_value.cpu(),
                    stats={k: v.cpu() for k, v in stats.items()},
                    batch=batch, norm0=[norm0.mean, norm0.var, norm0.count]),
               Path(workdir) / "rollout.pt")
    return traj, last_value, stats, batch, norm0


def one_rank_reference(tr: PPOTrainer, traj, last_value, stats, ranks: list):
    """tr's learner epoch on the whole rollout with the ranks' permutations
    composed: (its metrics, its seconds, `timed_learn`)."""
    world = len(ranks)
    n_local = tr.env.num_envs // world
    S, mb = tr._slices()
    perms = compose_perms([r["perms"] for r in ranks], mb // world, n_local, tr.is_rnn)
    cv_perms = None
    if tr.use_cv:
        _, cv_mb = tr._split(S, max(tr.cfg.cv_minibatch_size // tr.cfg.seq_len, 1)
                             if tr.is_cv_rnn else tr.cfg.cv_minibatch_size)
        cv_perms = compose_perms([r["cv_perms"] for r in ranks], cv_mb // world,
                                 n_local, tr.is_rnn)
    assert sorted(perms[0].tolist()) == list(range(S))
    m, seconds = timed_learn(tr, traj, last_value, stats, perms.to(tr.device),
                             None if cv_perms is None else cv_perms.to(tr.device))
    return {k: float(v) for k, v in m.items()}, seconds


def check_learner(tr: PPOTrainer, ref_metrics: dict, ranks: list, atol=LEARNER_ATOL):
    """Every parameter of every rank within atol of the 1-rank epoch's (the
    ranks bitwise equal to each other), the norms and metrics at the learner
    parity tests' rule; returns the largest parameter difference."""
    ts = tr.state
    worst = 0.0
    for name, ref in ((f"{net}.{k}", p.detach().cpu())
                      for net in ("ac", "cv") if getattr(ts, net) is not None
                      for k, p in getattr(ts, net).named_parameters()):
        for r in ranks:
            diff = float((r["params"][name] - ref).abs().max())
            assert diff <= atol, (name, diff)
            worst = max(worst, diff)
        assert torch.equal(ranks[0]["params"][name], ranks[-1]["params"][name]), name
    for key, a in ranks[0]["norms"].items():
        name, f = key.split(".")
        b = getattr(getattr(ts, name), f).cpu()
        assert bool(((a - b).abs() <= 1e-6 + 1e-4 * b.abs()).all()), key
    for k, v in ref_metrics.items():
        if "/" in k:
            continue   # the task's metrics read the env state, not the rollout
        got = ranks[0]["metrics"][k]
        assert abs(got - v) <= 1e-5 + 1e-3 * abs(v), (k, got, v)
        assert ranks[-1]["metrics"][k] == got, k
    return worst


@pytest.mark.parametrize("spec", [FF_SPEC, LSTM_SPEC], ids=["ff", "lstm_cv"])
def test_two_rank_learner_epoch_equals_one_rank(spec, tmp_path):
    spec = dict(spec, mode="learn")
    tr = make_trainer(spec, "cpu")
    assert tr.world == 1 and tr.env.num_envs == spec["num_envs"]
    traj, last_value, stats, _, _ = store_rollout(tr, tmp_path)
    ranks = run_ranks(tmp_path, spec)
    ref, _ = one_rank_reference(tr, traj, last_value, stats, ranks)
    # the ranks drew different permutations of their own rows
    assert not torch.equal(ranks[0]["perms"], ranks[1]["perms"])
    check_learner(tr, ref, ranks)


def test_global_running_norm_update_equals_one_update(tmp_path):
    spec = dict(FF_SPEC, mode="learn")
    tr = make_trainer(spec, "cpu")
    _, _, _, batch, norm0 = store_rollout(tr, tmp_path, seed=1)
    ranks = run_ranks(tmp_path, spec)
    ref = norm0.update(batch)
    for r in ranks:
        for got, want in zip(r["norm"], (ref.mean, ref.var, ref.count)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the ranks' halves differ, so a local update would not pass
    local = norm0.update(batch[:batch.shape[0] // WORLD])
    assert not torch.allclose(local.mean, ref.mean, atol=1e-3)


def test_two_rank_checkpoint_resumes_bitwise_and_refuses_one_rank(tmp_path):
    spec = dict(CKPT_SPEC, mode="checkpoint")
    ranks = run_ranks(tmp_path, spec)
    for r in ranks:
        assert r["bad"] == [], r["bad"][:5]
        assert r["epoch"] == 3 and r["num_envs"] == spec["num_envs"] // WORLD
        assert "env state restored" in r["messages"][-1], r["messages"]
    # metrics are global: every rank logged the same history
    drop = lambda h: [{k: v for k, v in m.items() if k != "steps_per_sec"}  # noqa: E731
                      for m in h]
    assert drop(ranks[0]["history"]) == drop(ranks[1]["history"])
    last = tmp_path / "nn" / "last"
    side = torch.load(last / "env.pt", weights_only=True)
    assert side["world_size"] == WORLD and side["rng.env"].shape[0] == WORLD
    assert side["es.phys.q"].shape[0] == spec["num_envs"]
    one = make_trainer(spec, "cpu")
    with pytest.raises(CheckpointMismatch, match="world size 2.*world size 1"):
        one.load(str(last), log_fn=None)
    msgs = []
    one.load(str(last), log_fn=msgs.append, resume=False)
    assert msgs == ["env-state sidecar of world size 2, this run has world size "
                    "1: skipped, envs start fresh"]
    assert one.state.epoch == 2


def test_a_minibatch_that_does_not_split_over_the_ranks_is_refused():
    tr = make_trainer(FF_SPEC, "cpu")
    assert tr._slices() == (256, 64)
    tr.world = 3   # as if 3 ranks held 96 envs: minibatches of 64 rows
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        tr._split(3 * 256, 64)
    tr.world = 2
    assert tr._split(2 * 256, 64) == (256, 32)


def test_env_range_and_reductions_without_a_group():
    assert mesh.env_range(32, 1, 2) == slice(16, 32)
    with pytest.raises(ValueError, match="does not split"):
        mesh.env_range(33, 0, 2)
    x = torch.randn(7, 3)
    m, v = mesh.moments(x)
    assert torch.equal(m, x.mean(0)) and torch.equal(v, x.var(0, correction=0))
    assert torch.equal(mesh.env_sum(x), x.sum())
    assert mesh.rank_seed(5, 0) == 5 and mesh.rank_seed(5, 1) != 5


if __name__ == "__main__":
    worker(sys.argv[1])
