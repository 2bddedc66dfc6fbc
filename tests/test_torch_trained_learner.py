"""The learner from a trained AllegroHand state over consecutive epochs,
JAX against the port on the CPU (fault C4, ROADMAP §C4).

Both learners start from `results_torch/AllegroHand_seed1/model.pt`: the
port's own state after 2000 epochs at 8192 envs (networks [512, 256, 128],
both Adam moments at count 40,000, the norms after 2.6e8 samples, lr
5.1e-5), read by the port through the CLI's `checkpoint=` and carried into
the JAX trainer by `carry_state_to_jax` (tests/torch_jax_checkpoint.py).
Its action means lie past the bound, so `bounds_loss` is active (some 7-10).
64 envs, minibatch 256 (`test_torch_late_learner.py`'s `MB`), exact f32
networks in both packages.

Each epoch the JAX trainer rolls out with its own parameters and learns
(`_epoch`, with that rollout handed in), and the port's `_learn` takes the
same trajectory and JAX's permutations. On each epoch's trajectory:
- **A**: the port carrying its own parameters, Adam state, norms, lr and
  episode trackers from epoch to epoch;
- **P**: the JAX learner from A's state at the start of the epoch, carried
  in by `carry_state_to_jax` (at epoch 1 that is JAX's own epoch);
- **B**: the port from the JAX trainer's state at the start of the epoch,
  carried in by `carry_state`;
- **C**, the control: the JAX learner carrying its own state over epochs 2
  and 3 from A's state after epoch 1 (C at epoch 2 is P).

Tolerances (`test_torch_late_learner.py`'s single-epoch ones): every
minibatch's KL rtol 1e-3, atol 1e-6; lr before and after each minibatch
rtol 1e-6 (the same steps); the epoch's metrics rtol 1e-3, atol 1e-5;
parameters `_assert_update_rule`; Adam's count equal, its moments within
1e-3 of each tensor's largest element; the norms rtol 1e-4, atol 1e-6,
their counts equal; the epoch, the tracked episode count equal.
- B against JAX, A against P, every epoch, and A against C over epochs
  2-3: those tolerances, unwidened. A against P holds the state A carries
  from epoch to epoch: P starts from it.
- A against JAX's own chain at epochs 2 and 3: the carried state exact;
  each gap (`gaps`, in units the single-epoch bound holds to 1e-3) within
  1e-3 plus GROWTH times A's gap after epoch 1. Epoch 2 is unwidened; at
  epoch 3 the parameters, Adam's first and second moments are widened by
  120, 8000 and 2400 times, twice what the control measured when it grew
  most (60.1, 3981, 1202 times A's epoch-1 gap of 1.17e-4, 3.87e-5,
  2.37e-6; this file under `--noconftest`, JAX compiled for one host
  device). Where A's gap passes 1e-3, the control's must reach half of it:
  the JAX learner alone makes as much of the same drift. Measured there:
  A 7.04e-3, 0.154, 2.85e-3 against JAX at epoch 3, the control 7.05e-3,
  0.154, 2.85e-3, A against C 2.1e-4, 3.4e-5, 7.4e-6. Under the suite's
  settings (conftest.py: 8 host devices, the compile cache) the rollouts
  and rounding fall otherwise and the drift does not grow: A 1.9e-4 from
  JAX at epoch 3 with an epoch-1 gap of 4.2e-5.

One more epoch starts from the TPU's rule's state
(`results_torch/AllegroHand_T_seed1/model.pt`, trained under
`net_matmul=bf16_operands`) under exact f32, B's way: the carrier reads
both files (the JAX package on the CPU cannot compute the rule).

    PYTHONPATH=.:tests python tests/test_torch_trained_learner.py   # the gaps as JSON
"""

import copy
import functools
import json
import sys

import jax
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.scripts import train as ttrain
from test_torch_late_learner import (F32, KL, MB, METRICS, N, NORM, _moments,
                                     _record_lr_steps)
from test_torch_ppo import _assert_update_rule, _jax_perms, _params_np
from torch_jax_checkpoint import carry_state, carry_state_to_jax, jax_trainer
from torch_parity import np_, to_numpy_tree

F32_STATE = "results_torch/AllegroHand_seed1"
RULE_STATE = "results_torch/AllegroHand_T_seed1"
EPOCHS = 3
MOMENT_ATOL = 1e-3   # of each tensor's largest element
# A against JAX's own chain: the widening of a gap (`gaps`) at epoch 3, in
# multiples of A's gap in it after epoch 1; twice what the JAX learner alone
# makes of that gap (the control, module docstring); every other gap and
# epoch 2 unwidened
GROWTH = {2: {}, 3: dict(params=120.0, mu=8000.0, nu=2400.0)}
ENV_FIELDS = ("phys", "carry", "obs", "states", "reward", "done", "timeout",
              "progress", "metrics")


def port_trainer(state):
    _, _, tr = ttrain.build_trainer(["task=AllegroHand", f"num_envs={N}",
                                     "device=cpu", f"checkpoint={state}", *MB, F32])
    return tr


def jax_learner(jtr):
    """The JAX trainer's `_epoch` after a rollout handed in: (ts after the
    rollout, trajectory, bootstrap value, stats) -> (ts, metrics)."""
    def learn(ts, traj, last, stats):
        jtr._rollout = lambda _: (ts, traj, last, stats)
        try:
            return jtr._epoch(ts)
        finally:
            del jtr._rollout
    return jax.jit(learn)


def snapshot(ts, metrics, rec):
    """A port state after an epoch, as numpy."""
    names = [k for k, _ in ts.ac.named_parameters()]
    return dict(
        params=_params_np(ts.ac),
        mu={k: np_(m).copy() for k, m in zip(names, ts.opt_state.mu)},
        nu={k: np_(v).copy() for k, v in zip(names, ts.opt_state.nu)},
        count=float(ts.opt_state.count),
        norms={(n, f): np_(getattr(getattr(ts, n), f)).copy()
               for n in ("obs_norm", "value_norm") for f in ("mean", "var", "count")},
        lr=float(ts.lr), epoch=ts.epoch, games=float(ts.games),
        metrics={k: float(v) for k, v in metrics.items()}, rec=list(rec))


def jax_snapshot(jts, jm, jrec, module):
    mu, nu = _moments(jts.opt_state[1], module)
    return dict(
        params=convert.actor_critic_arrays(to_numpy_tree(jts.params["ac"]), module),
        mu=mu, nu=nu, count=float(jts.opt_state[1].count),
        norms={(n, f): np.asarray(getattr(getattr(jts, n), f))
               for n in ("obs_norm", "value_norm") for f in ("mean", "var", "count")},
        lr=float(jts.lr), epoch=int(jts.epoch), games=float(jts.games),
        metrics={k: float(v) for k, v in jm.items()}, rec=list(jrec))


def with_learner(jts, src):
    """The JAX state `jts` (after a rollout) with the learner state of the
    JAX state `src`: networks, Adam, lr, norms and epoch."""
    return jts.replace(params=src.params, opt_state=src.opt_state, lr=src.lr,
                       obs_norm=src.obs_norm, value_norm=src.value_norm,
                       states_norm=src.states_norm, epoch=src.epoch)


def port_into_jax(jtr, tr, ts, jts):
    """`jts` with its learner state set to the port TrainState `ts`'s, by
    `carry_state_to_jax`."""
    keep = tr.state, jtr.state
    tr.state, jtr.state = ts, jts
    try:
        carry_state_to_jax(tr, jtr)
        return jtr.state
    finally:
        tr.state, jtr.state = keep


def learn_epoch(jtr, tr, states, rollout, learn, jrec, rec, starts=()):
    """One epoch: JAX rolls out and learns; the port's `_learn` takes its
    trajectory and permutations once for each TrainState of `states`, and
    the JAX learner learns once more on it from each learner state of
    `starts` (JAX states). Returns (JAX snapshot, [port snapshots], the
    port's initial params, [(JAX state, snapshot) from each start])."""
    cfg = tr.cfg
    rng_after = jax.random.split(jtr.state.rng)[0]
    perms = torch.as_tensor(np.array(
        _jax_perms(rng_after, cfg.mini_epochs, cfg.horizon_length * N)))
    init = [_params_np(ts.ac) for ts in states]
    jts_r, jtraj, jlast, jstats = rollout(jtr.state)

    def jax_learn(ts):
        k = len(jrec)
        jts, jm = learn(ts, jtraj, jlast, jstats)
        jax.effects_barrier()
        return jts, jax_snapshot(jts, jm, jrec[k:], tr.state.ac)

    jts, jsnap = jax_learn(jts_r)
    others = [jax_learn(with_learner(jts_r, s)) for s in starts]
    traj = {key: torch.as_tensor(np.array(v)) for key, v in to_numpy_tree(jtraj).items()}
    stats = {key: torch.as_tensor(np.array(v)) for key, v in to_numpy_tree(jstats).items()}
    last = torch.as_tensor(np.array(jlast))
    env = {key: to_numpy_tree(getattr(jts.es, key)) for key in ENV_FIELDS}
    task_stats = {key: torch.as_tensor(np.array(v))
                  for key, v in to_numpy_tree(jts.task_stats).items()}
    snaps = []
    for ts in states:
        # the task's episode metrics read the env state after the rollout
        ts.es = convert.env_state_from_arrays(env, device="cpu")
        ts.task_stats = dict(task_stats)
        k = len(rec)
        m = tr._learn(ts, traj, last, stats, perms=perms)
        snaps.append(snapshot(ts, m, rec[k:]))
    jtr.state = jts
    return jsnap, snaps, init, others


def jax_start(jtr, tr):
    """A copy of the port TrainState set to the JAX trainer's learner state."""
    keep = tr.state
    tr.state = copy.deepcopy(keep)
    try:
        carry_state(jtr, tr)
        return tr.state
    finally:
        tr.state = keep


@functools.lru_cache(maxsize=None)
def runs():
    """{"f32": [dict(jax=, a=, b=, p=, c=, init_a=, init_b=) per epoch],
    "rule": (JAX, B, B's initial params)}; the port on two threads at most
    (on a loaded host more threads made its `_learn` 60 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        return _runs()
    finally:
        torch.set_num_threads(threads)


def _runs():
    tr = port_trainer(F32_STATE)
    jtr = jax_trainer("AllegroHand", N, None, MB)
    carry_state_to_jax(tr, jtr)
    jrec, rec = _record_lr_steps(jtr, tr)
    rollout, learn = jax.jit(jtr._rollout), jax_learner(jtr)
    out = {"f32": []}
    control = None     # the JAX learner's own chain from A's state after epoch 1
    for e in range(1, EPOCHS + 1):
        b = jax_start(jtr, tr)
        # JAX's epoch from A's carried state (after epoch 1, A's state is
        # also where the control chain starts)
        starts = [] if e == 1 else [port_into_jax(jtr, tr, tr.state, jtr.state)]
        if e > 2:
            starts.append(control)
        jsnap, (a_snap, b_snap), (init_a, init_b), others = learn_epoch(
            jtr, tr, [tr.state, b], rollout, learn, jrec, rec, starts)
        p = others[0] if others else (None, jsnap)
        control = others[-1][0] if others else None
        out["f32"].append(dict(jax=jsnap, a=a_snap, b=b_snap, p=p[1],
                               c=others[-1][1] if others else None,
                               init_a=init_a, init_b=init_b))
    rule = port_trainer(RULE_STATE)
    assert rule.cfg.net_matmul == "f32"
    carry_state_to_jax(rule, jtr)
    b = jax_start(jtr, tr)
    jsnap, (b_snap,), (init,), _ = learn_epoch(jtr, tr, [b], rollout, learn, jrec, rec)
    out["rule"] = (jsnap, b_snap, init)
    return out


def gaps(x, y, init=None):
    """Per-quantity gaps between two snapshots, each in units that the
    single-epoch tolerance holds to 1e-3 (the norms to 1e-4): parameters as
    |x - y| over the movement from `init` (worst tensor), moments over the
    tensor's largest element, KL over max(|KL|, 1e-3) (KL's atol 1e-6 and
    rtol 1e-3), metrics over max(|metric|, 1e-5), norms over max(|y|, 1e-6)."""
    g = {}
    if init is not None:
        g["params"] = max(np.linalg.norm(x["params"][k] - y["params"][k])
                          / np.linalg.norm(y["params"][k] - init[k]) for k in y["params"])
    for w in ("mu", "nu"):
        g[w] = max(float(np.abs(x[w][k] - y[w][k]).max() / np.abs(y[w][k]).max())
                   for k in y[w])
    g["kl"] = max(abs(a[0] - b[0]) / max(abs(b[0]), 1e-3)
                  for a, b in zip(x["rec"], y["rec"]))
    g["metrics"] = max(abs(x["metrics"][k] - y["metrics"][k])
                       / max(abs(y["metrics"][k]), 1e-5) for k in y["metrics"])
    g["norms"] = max(float(np.max(np.abs(x["norms"][k] - y["norms"][k])
                                  / np.maximum(np.abs(y["norms"][k]), 1e-6)))
                     for k in y["norms"])
    return {k: float(v) for k, v in g.items()}


def assert_carried_state(port, ref):
    """The learner state that carries over: exact, and the lr steps."""
    assert port["epoch"] == ref["epoch"]
    assert port["count"] == ref["count"]
    assert port["games"] == ref["games"]
    for (n, f), v in ref["norms"].items():
        if f == "count":
            assert float(port["norms"][(n, f)]) == float(v), n
    assert len(port["rec"]) == len(ref["rec"]) == 20
    for r in (port["rec"], ref["rec"]):
        assert all(a[2] == b[1] for a, b in zip(r[:-1], r[1:])), r
    for i, ((_, lr0, lr1), (_, jlr0, jlr1)) in enumerate(zip(port["rec"], ref["rec"])):
        np.testing.assert_allclose([lr0, lr1], [jlr0, jlr1], rtol=1e-6,
                                   err_msg=f"minibatch {i} lr")
    np.testing.assert_allclose(port["lr"], ref["lr"], rtol=1e-6)


def assert_epoch_close(port, ref, init):
    """The single-epoch tolerances of the module docstring."""
    for i, (a, b) in enumerate(zip(port["rec"], ref["rec"])):
        assert abs(a[0] - b[0]) <= KL["atol"] + KL["rtol"] * abs(b[0]), (i, a, b)
    assert sorted(port["metrics"]) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(port["metrics"][k] - v) <= METRICS["atol"] + METRICS["rtol"] * abs(v), k
    assert ref["metrics"]["bounds_loss"] > 1.0   # the means past the bound
    for key, v in ref["norms"].items():
        assert (np.abs(port["norms"][key] - v) <= NORM["atol"] + NORM["rtol"] * np.abs(v)).all(), key
    for which in ("mu", "nu"):
        for k, r in ref[which].items():
            assert np.abs(port[which][k] - r).max() <= MOMENT_ATOL * np.abs(r).max(), (which, k)
    lr_max = max(max(lr0, lr1) for _, lr0, lr1 in ref["rec"])
    _assert_update_rule(port["params"], ref["params"], init, lr_max, len(ref["rec"]))


@pytest.mark.parametrize("epoch", range(1, EPOCHS + 1))
def test_epoch_from_the_jax_state_matches_jax(epoch):
    """B: the port's learner from the JAX trainer's state at the start of
    the epoch, unwidened."""
    r = runs()["f32"][epoch - 1]
    ref = r["jax"]
    assert ref["epoch"] == 2000 + epoch and ref["count"] == 40000 + 20 * epoch
    assert_carried_state(r["b"], ref)
    assert_epoch_close(r["b"], ref, r["init_b"])


@pytest.mark.parametrize("epoch", range(1, EPOCHS + 1))
def test_carried_epoch_matches_jax(epoch):
    """A: the port's learner carrying its own state from epoch to epoch,
    each epoch against the JAX learner's epoch from that carried state,
    unwidened (epoch 1 starts both from the file)."""
    r = runs()["f32"][epoch - 1]
    assert r["p"]["epoch"] == 2000 + epoch and r["p"]["count"] == 40000 + 20 * epoch
    assert_carried_state(r["a"], r["p"])
    assert_epoch_close(r["a"], r["p"], r["init_a"])
    if epoch == 1:
        assert gaps(r["a"], r["b"], r["init_a"])["params"] == 0.0


def test_carried_epochs_match_jaxs_from_the_same_state():
    """A over epochs 2-3 against the JAX learner over the same two epochs
    from A's state after epoch 1 (the control), unwidened."""
    r = runs()["f32"][2]
    assert_carried_state(r["a"], r["c"])
    assert_epoch_close(r["a"], r["c"], runs()["f32"][1]["c"]["params"])


@pytest.mark.parametrize("epoch", range(2, EPOCHS + 1))
def test_carried_chain_against_jaxs_own_chain(epoch):
    """A against the JAX learner's own chain: the carried state exact, each
    gap within the single-epoch bound plus GROWTH times A's gap after
    epoch 1; where A's gap passes the single-epoch bound, the control (the
    JAX learner from A's state after epoch 1) parts from JAX's own chain by
    at least half as much."""
    f32 = runs()["f32"]
    d1 = gaps(f32[0]["a"], f32[0]["jax"], f32[0]["init_b"])
    r = f32[epoch - 1]
    assert_carried_state(r["a"], r["jax"])
    a, c = (gaps(r[k], r["jax"], r["init_b"]) for k in ("a", "c"))
    for q in ("params", "mu", "nu", "kl", "metrics"):
        assert a[q] <= 1e-3 + GROWTH[epoch].get(q, 0.0) * d1[q], (q, a[q], d1[q])
    assert a["norms"] <= NORM["rtol"], a["norms"]
    for q in ("params", "mu", "nu", "kl", "metrics"):
        if a[q] > 1e-3:
            assert c[q] >= a[q] / 2, (q, a[q], c[q])


def test_rule_state_epoch_matches_jax():
    """One epoch from the rule's trained state under exact f32, from the
    state the carrier took into the JAX trainer."""
    ref, b, init = runs()["rule"]
    assert ref["epoch"] == 2001 and ref["count"] == 40020
    assert_carried_state(b, ref)
    assert_epoch_close(b, ref, init)


def main() -> int:
    out = {}
    for e, r in enumerate(runs()["f32"], 1):
        ref, init = r["jax"], r["init_b"]
        row = dict(B_JAX=gaps(r["b"], ref, init), A_P=gaps(r["a"], r["p"], r["init_a"]),
                   A_JAX=gaps(r["a"], ref, init), lr=ref["lr"],
                   bounds_loss=ref["metrics"]["bounds_loss"],
                   kl=[round(x[0], 6) for x in ref["rec"]],
                   moved=max(float(np.linalg.norm(ref["params"][k] - init[k]))
                             for k in init),
                   A_JAX_abs=max(float(np.linalg.norm(r["a"]["params"][k] - ref["params"][k]))
                                 for k in init))
        if r["c"] is not None:
            row.update(C_JAX=gaps(r["c"], ref, init), A_C=gaps(r["a"], r["c"], init),
                       C_JAX_abs=max(float(np.linalg.norm(r["c"]["params"][k]
                                                          - ref["params"][k]))
                                     for k in init))
        out[f"epoch {e}"] = row
    ref, b, init = runs()["rule"]
    out["rule epoch"] = dict(B_JAX=gaps(b, ref, init), lr=ref["lr"],
                             bounds_loss=ref["metrics"]["bounds_loss"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
