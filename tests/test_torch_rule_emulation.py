"""The port's matmul rule against the JAX learner under the same rule, on
the CPU (fault C6, ROADMAP §C6).

The rule, `net_matmul="bf16_operands"` (learn/networks.py), is the TPU's
default precision for an f32 dot: both operands rounded to bf16 (ties to
even), the products summed in f32, and in the backward pass
dx = round(g) round(W)^T and dW = round(x)^T round(g). On the CPU the JAX
package computes an f32 dot in exact f32 whatever
`jax.default_matmul_precision` says, but its networks take every product
from `lax.dot_general` as `flax.linen.linear` looks it up at call time
(`nn.Dense`, omniisaacgymenvs_tpu/learn/networks.py). So the rule is
emulated on the JAX side here: `rule_dot` is a `jax.custom_vjp` product
computing the three products above, and `_Lax` is a proxy of `jax.lax`
that overrides `dot_general` alone, installed with monkeypatch as the `lax`
that flax.linen.linear sees; the physics' einsums are untouched.

The JAX trainer of Cartpole at N envs (its yaml's [32, 32] networks, one
action, horizon 16, 8 mini-epochs of minibatches of 256) is built inside
the patch, so its jitted functions trace under it, and runs one epoch: a
rollout and the learner on it. The port's trainer under the rule takes the
JAX trainer's initial state (tests/torch_jax_checkpoint.py `carry_state`)
and learns on JAX's trajectory with JAX's permutations (`_learn`); so does
a second port trainer in exact f32, the control. Then the JAX trainer is
dropped. The JAX package jits its networks only through a trainer's own
bound methods (learn/ppo.py `_epoch_jit`, the rollout's jit), whose traces
die with the trainer, so no trace made under the patch outlives it and
JAX's global caches are left as they are.

Compared, with the tolerances:
- the rollout's forward: the port's networks on JAX's observations against
  the `mu` and `value` JAX's rollout stored, rtol 1e-4 of each element and
  atol 1e-5 of the array's largest (`FWD`). Each input of each Dense is
  rounded to bf16 in both packages: `flips` counts the elements whose
  roundings differ (the f32 sums before them part by an ulp), at most
  FLIP_SHARE of them. The rule is in force on both sides: the port's exact
  f32 forward on the same observations parts from JAX's mu by over ten
  times the packages' gap.
- the learner epoch: every minibatch's KL and the epoch's metrics within
  `KL` and `METRICS` (test_torch_late_learner.py); the lr before and after
  each minibatch rtol 1e-6 (the same steps); the norms `NORM`, their counts
  equal; Adam's count equal and both moments within MOMENT_ATOL of each
  tensor's largest element; `log_std` and every parameter by
  test_torch_ppo.py's `_assert_update_rule` (in each tensor 99.9% of the
  elements within 1e-5, all within 2 lr_max steps, the difference's norm
  within 1e-3 of the tensor's movement). These are the f32 learner's
  tolerances, unwidened. The comparison can fail: the port's exact-f32
  epoch on the same trajectory from the same state breaks them
  (`test_learner_comparison_parts_exact_f32`: some learner gap past
  CONTROL_MIN times its bound).
Measured on the CPU: 0 flips of 69,632 rounded inputs; in units of each
bound, the forward's mu 3.4e-3 and value 1.4e-3, KL 1.1e-2, metrics
3.5e-3; parameters 1.2e-5 of their movement, Adam's moments 1.1e-5 (first)
and 9.3e-6 (second) of their largest element. Exact f32 parts from JAX's
mu 2.2e5 times as far; its learner epoch, in units of each bound,
parameters 67, Adam's moments 145 and 126, KL 18, metrics 3.8. The port's
rule is JAX's under the emulated rule: no fault in its wiring.

The LSTM networks (fault C7): the same emulation reaches `LSTMCore`'s
`wx` and `wh`, the MLP and the heads (all `nn.Dense`). A JAX Cartpole
trainer with an LSTM actor-critic of 16 units before a [16] MLP (`LSTM_KW`,
LSTM_N envs, exact-f32 networks otherwise) is built inside the patch and
runs one epoch; the port's LSTM trainer under the rule, its networks and
norms set to JAX's, replays JAX's observations through `seq` from the
rollout's start states with its resets (the forward, `FWD`), and learns on
JAX's trajectory with JAX's permutations (the learner, the same
tolerances); the port's exact-f32 networks and epoch are the control that
must fail them. Measured on the CPU, in units of each bound: the forward's
mu 1.0e-3, value 1.2e-3; the learner's parameters 1.3e-2, Adam's moments
8.7e-3 and 1.8e-3, KL 3.8e-2, metrics 7.7e-4. Exact f32 parts from JAX's mu
6.0e4 times as far, and its epoch breaks the bounds 6.6 (parameters), 7.0
and 4.8 (moments) and 3.9 (KL) times.

    PYTHONPATH=.:tests python tests/test_torch_rule_emulation.py   # the gaps as JSON
"""

import copy
import json
import sys

import flax.linen.linear as flax_linear
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.learn import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.learn.networks import _linear, set_matmul
from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
from omniisaacgymenvs_torch.scripts import train as ttrain
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.learn import PPOConfig as JPPOConfig
from omniisaacgymenvs_tpu.learn import PPOTrainer as JPPOTrainer
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from test_torch_late_learner import KL, METRICS, NORM, _moments, _record_lr_steps
from test_torch_ppo import _assert_update_rule, _jax_perms, _params_np
from torch_jax_checkpoint import carry_state, jax_trainer
from torch_parity import lstm_named_arrays, np_, to_numpy_tree

RULE = "bf16_operands"
N = 64
MB = ["train.params.config.minibatch_size=256"]
FWD = dict(rtol=1e-4, atol=1e-5)   # atol of the array's largest element
FLIP_SHARE = 1e-4
MOMENT_ATOL = 1e-3   # of each tensor's largest element
PARAM_REL = 1e-3   # of each tensor's movement (_assert_update_rule)
CONTROL_MIN = 10.0
# the LSTM case: 16 sequences of 4 steps a minibatch, 4 a mini-epoch
LSTM_N = 16
LSTM_KW = dict(units=(16,), rnn="lstm", rnn_units=16, seq_len=4, horizon_length=16,
               minibatch_size=64, mini_epochs=4, reward_shaper_scale=0.1)
LSTM_UPDATES = 16


def _round(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _mm(a, b):
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


@jax.custom_vjp
def rule_dot(x, w):
    """x @ W (x (..., K), W (K, M)) on bf16-rounded operands, f32 sums."""
    return _mm(_round(x), _round(w))


def _rule_dot_fwd(x, w):
    return rule_dot(x, w), (x, w)


def _rule_dot_bwd(res, g):
    x, w = res
    gr = _round(g)
    dx = _mm(gr, _round(w).T)
    dw = _mm(_round(x).reshape(-1, x.shape[-1]).T, gr.reshape(-1, g.shape[-1]))
    return dx, dw


rule_dot.defvjp(_rule_dot_fwd, _rule_dot_bwd)


class _Lax:
    """`jax.lax` with `dot_general` taken by `rule_dot` for a Dense's f32
    contraction (any other dot passes through)."""

    def __getattr__(self, name):
        return getattr(lax, name)

    def dot_general(self, lhs, rhs, dimension_numbers, precision=None,
                    preferred_element_type=None, **kw):
        (lc, rc), batch = dimension_numbers
        if ((tuple(lc), tuple(rc), batch) == ((lhs.ndim - 1,), (0,), ((), ()))
                and rhs.ndim == 2 and lhs.dtype == rhs.dtype == jnp.float32):
            return rule_dot(lhs, rhs)
        return lax.dot_general(lhs, rhs, dimension_numbers, precision,
                               preferred_element_type, **kw)


def flips(jtr, tr, obs):
    """(elements whose bf16 roundings differ between the packages, elements
    rounded) over the input of every Dense of the actor-critic on
    observations `obs` (T, N, obs): the port's trunk under the rule against
    flax's captured outputs. The last trunk activation feeds both heads and
    counts once."""
    ac = tr.state.ac
    jx = jtr.state.obs_norm.normalize(jnp.asarray(obs))
    _, inter = jtr.net.apply(jtr.state.params["ac"], jx, capture_intermediates=True,
                             mutable=["intermediates"])
    outs = inter["intermediates"]
    n = len(ac.trunk.layers)
    jins = [jx] + [jax.nn.elu(outs[f"Dense_{i}"]["__call__"][0]) for i in range(n)]
    x = tr.state.obs_norm.normalize(torch.as_tensor(np.array(obs)))
    ins = [x]
    with torch.no_grad():
        for layer in ac.trunk.layers:
            x = ac.trunk.act(_linear(layer, x, ac.matmul))
            ins.append(x)
    count = sum(int((np_(a.to(torch.bfloat16).float()) != np.asarray(_round(b))).sum())
                for a, b in zip(ins, jins))
    return count, sum(a.numel() for a in ins)


def emulated_epoch():
    """One JAX epoch under the emulated rule and the port's learner under
    the rule on its trajectory, from the same state."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_linear, "lax", _Lax())
        jtr = jax_trainer("Cartpole", N, None, MB)
        try:
            return _epoch_pair(jtr)
        finally:
            del jtr


def _port_trainer(jtr, rule):
    _, _, tr = ttrain.build_trainer(["task=Cartpole", f"num_envs={N}", "device=cpu",
                                     *MB, f"train.params.config.net_matmul={rule}"])
    assert tr.net_matmul == rule
    carry_state(jtr, tr)
    return tr


def _port_learn(tr, rec, jts, jtraj, jlast, jstats, perms):
    """The port trainer `tr`'s learner epoch on JAX's rollout (its state
    after it, trajectory, last values and stats) with JAX's permutations,
    each minibatch's lr step recorded in `rec`."""
    ts = tr.state
    ts.es = convert.env_state_from_arrays(
        {k: to_numpy_tree(getattr(jts.es, k))
         for k in ("phys", "carry", "obs", "states", "reward", "done", "timeout",
                   "progress", "metrics")}, device="cpu")
    ts.task_stats = {k: torch.as_tensor(np.array(v))
                     for k, v in to_numpy_tree(jts.task_stats).items()}
    traj = {k: torch.as_tensor(np.array(v)) for k, v in to_numpy_tree(jtraj).items()}
    metrics = tr._learn(ts, traj, torch.as_tensor(np.array(jlast)),
                        {k: torch.as_tensor(np.array(v))
                         for k, v in to_numpy_tree(jstats).items()}, perms=perms)
    names = [k for k, _ in ts.ac.named_parameters()]
    return dict(params=_params_np(ts.ac),
                mu={k: np_(v).copy() for k, v in zip(names, ts.opt_state.mu)},
                nu={k: np_(v).copy() for k, v in zip(names, ts.opt_state.nu)},
                count=float(ts.opt_state.count), lr=float(ts.lr),
                norms={(n, f): np_(getattr(getattr(ts, n), f)).copy() for n, f in NORMS},
                metrics={k: float(v) for k, v in metrics.items()}, rec=list(rec))


NORMS = [(n, f) for n in ("obs_norm", "value_norm") for f in ("mean", "var", "count")]


def _epoch_pair(jtr):
    tr = _port_trainer(jtr, RULE)
    jrec, rec = _record_lr_steps(jtr, tr)
    cfg = tr.cfg
    perms = torch.as_tensor(np.array(_jax_perms(
        jax.random.split(jtr.state.rng)[0], cfg.mini_epochs, cfg.horizon_length * N)))
    init = _params_np(tr.state.ac)
    start = copy.deepcopy(tr.state)
    jts_r, jtraj, jlast, jstats = jax.jit(jtr._rollout)(jtr.state)

    def learn(ts, traj, last, stats):
        jtr._rollout = lambda _: (ts, traj, last, stats)
        try:
            return jtr._epoch(ts)
        finally:
            del jtr._rollout

    jts, jm = jax.jit(learn)(jts_r, jtraj, jlast, jstats)
    jax.effects_barrier()
    obs = torch.as_tensor(np.array(jtraj["obs"]))
    n_flips = flips(jtr, tr, np.asarray(jtraj["obs"]))
    with torch.no_grad():
        mu, _, value, _, _ = tr._policy(start, obs, None)
        set_matmul(start.ac, "f32")
        mu32 = tr._policy(start, obs, None)[0]
    rollout = (jts, jtraj, jlast, jstats, perms)
    port = _port_learn(tr, rec, *rollout)
    # the control: exact f32 from the same state (JAX's side has run, so its
    # record from this second wrapping stays empty)
    tr32 = _port_trainer(jtr, "f32")
    port32 = _port_learn(tr32, _record_lr_steps(jtr, tr32)[1], *rollout)
    ac = tr.state.ac
    jmu, jnu = _moments(jts.opt_state[1], ac)
    return dict(
        flips=n_flips, init=init, mu32=np_(mu32),
        fwd=dict(mu=(np_(mu), np.asarray(jtraj["mu"])),
                 value=(np_(value), np.asarray(jtraj["value"]))),
        port=port, port32=port32,
        jax=dict(params=convert.actor_critic_arrays(to_numpy_tree(jts.params["ac"]), ac),
                 mu=jmu, nu=jnu, count=float(jts.opt_state[1].count), lr=float(jts.lr),
                 norms={(n, f): np.asarray(getattr(getattr(jts, n), f)) for n, f in NORMS},
                 metrics={k: float(v) for k, v in jm.items()}, rec=list(jrec)))


@pytest.fixture(scope="module")
def run():
    # the port on two threads at most (test_torch_trained_learner.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        yield emulated_epoch()
    finally:
        torch.set_num_threads(threads)


def _fwd_close(a, b):
    return np.abs(a - b) <= FWD["rtol"] * np.abs(b) + FWD["atol"] * np.abs(b).max()


def test_rollout_forward_matches_jax(run):
    """The port's networks under the rule on JAX's observations against the
    mu and value JAX's rollout took under the emulated rule; the rule in
    force on both sides."""
    count, total = run["flips"]
    assert count <= FLIP_SHARE * total, run["flips"]
    for k, (a, b) in run["fwd"].items():
        assert _fwd_close(a, b).all(), (k, float(np.abs(a - b).max()))
    port, jmu = run["fwd"]["mu"]
    assert np.abs(run["mu32"] - jmu).max() > 10.0 * np.abs(port - jmu).max()


def test_learner_epoch_matches_jax(run):
    """One learner epoch on JAX's trajectory from the same state: every
    minibatch's KL and lr steps, the metrics, the norms, Adam's count and
    moments, log_std and every parameter."""
    assert_epoch_matches(run["port"], run["jax"], run["init"])


def test_learner_comparison_parts_exact_f32(run):
    """The control of the learner comparison: the port's exact-f32 epoch on
    the same trajectory from the same state parts from JAX's under the
    emulated rule by more than CONTROL_MIN times a learner bound, and fails
    `assert_epoch_matches`."""
    g = learner_gaps(run["port32"], run["jax"], run["init"])
    assert max(g.values()) > CONTROL_MIN, g
    with pytest.raises(AssertionError):
        assert_epoch_matches(run["port32"], run["jax"], run["init"])


def assert_epoch_matches(p, j, init, updates=32):
    n = len(j["rec"])
    assert n == len(p["rec"]) == updates and p["count"] == j["count"] == n
    for i, ((kl, lr0, lr1), (jkl, jlr0, jlr1)) in enumerate(zip(p["rec"], j["rec"])):
        assert abs(kl - jkl) <= KL["atol"] + KL["rtol"] * abs(jkl), (i, kl, jkl)
        np.testing.assert_allclose([lr0, lr1], [jlr0, jlr1], rtol=1e-6, err_msg=str(i))
    np.testing.assert_allclose(p["lr"], j["lr"], rtol=1e-6)
    assert sorted(p["metrics"]) == sorted(j["metrics"])
    for k, v in j["metrics"].items():
        assert abs(p["metrics"][k] - v) <= METRICS["atol"] + METRICS["rtol"] * abs(v), k
    for key, v in j["norms"].items():
        if key[1] == "count":
            assert float(p["norms"][key]) == float(v), key
        np.testing.assert_allclose(p["norms"][key], v, **NORM, err_msg=str(key))
    for which in ("mu", "nu"):
        for k, ref in j[which].items():
            assert np.abs(p[which][k] - ref).max() <= MOMENT_ATOL * np.abs(ref).max(), \
                (which, k)
    lr_max = max(max(lr0, lr1) for _, lr0, lr1 in j["rec"])
    _assert_update_rule(p["params"], j["params"], init, lr_max, n)


def learner_gaps(p, j, init):
    """A learner epoch's worst gaps to JAX's, each in units of its bound:
    parameters' by the norm of the difference over PARAM_REL of their
    movement, Adam's moments over MOMENT_ATOL of their largest element, KL
    and metrics over their tolerances."""
    g = dict(params=max(float(np.linalg.norm(p["params"][k] - j["params"][k])
                              / (PARAM_REL * np.linalg.norm(j["params"][k] - init[k])))
                        for k in init))
    for w in ("mu", "nu"):
        g[w] = max(float(np.abs(p[w][k] - j[w][k]).max()
                         / (MOMENT_ATOL * np.abs(j[w][k]).max())) for k in j[w])
    g["kl"] = max(abs(a[0] - b[0]) / (KL["atol"] + KL["rtol"] * abs(b[0]))
                  for a, b in zip(p["rec"], j["rec"]))
    g["metrics"] = max(abs(p["metrics"][k] - v) / (METRICS["atol"] + METRICS["rtol"] * abs(v))
                       for k, v in j["metrics"].items())
    return g


def emulated_lstm_epoch():
    """One JAX epoch of the LSTM actor-critic under the emulated rule, and
    the port's LSTM trainer under the rule (and in exact f32, the control)
    on its observations and trajectory from the same state."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_linear, "lax", _Lax())
        jtr = JPPOTrainer(JVecEnv(jget_task("Cartpole"), LSTM_N), JPPOConfig(**LSTM_KW),
                          seed=0)
        try:
            return _lstm_epoch_pair(jtr)
        finally:
            del jtr


def _lstm_port_trainer(jtr, rule):
    tr = PPOTrainer(VecEnv(get_task("Cartpole", device="cpu"), LSTM_N, seed=0),
                    PPOConfig(**LSTM_KW, net_matmul=rule), seed=0)
    assert tr.net_matmul == rule and tr.state.ac.lstm.matmul == rule
    convert.lstm_actor_critic_from_arrays(to_numpy_tree(jtr.state.params["ac"]),
                                          tr.state.ac)
    for name in ("obs_norm", "value_norm", "states_norm"):
        jn = getattr(jtr.state, name)
        setattr(tr.state, name, RunningNorm(*(torch.as_tensor(np.array(getattr(jn, f)))
                                              for f in ("mean", "var", "count"))))
    return tr


def _lstm_forward(tr, ts, jtraj, hidden0):
    """(mu, value) of the port's networks on JAX's observations: `seq` over
    the horizon from the rollout's start states, resetting where JAX's
    episodes ended, as its rollout stepped them."""
    obs = torch.as_tensor(np.array(jtraj["obs"])).transpose(0, 1)
    done = torch.as_tensor(np.array(jtraj["done"])).transpose(0, 1)
    with torch.no_grad():
        mu, _, v = ts.ac.seq(ts.obs_norm.normalize(obs), hidden0, done)
    return np_(mu.transpose(0, 1)), np_(ts.value_norm.denormalize(v).transpose(0, 1))


def _lstm_epoch_pair(jtr):
    tr = _lstm_port_trainer(jtr, RULE)
    jrec, rec = _record_lr_steps(jtr, tr)
    cfg = tr.cfg
    slices = LSTM_N * cfg.horizon_length // cfg.seq_len
    perms = torch.as_tensor(np.array(_jax_perms(
        jax.random.split(jtr.state.rng)[0], cfg.mini_epochs, slices)))
    init = _params_np(tr.state.ac)
    hidden0 = tuple(torch.as_tensor(np.array(h)) for h in jtr.state.hidden)
    start = copy.deepcopy(tr.state)
    jts_r, jtraj, jlast, jstats = jax.jit(jtr._rollout)(jtr.state)

    def learn(ts, traj, last, stats):
        jtr._rollout = lambda _: (ts, traj, last, stats)
        try:
            return jtr._epoch(ts)
        finally:
            del jtr._rollout

    jts, jm = jax.jit(learn)(jts_r, jtraj, jlast, jstats)
    jax.effects_barrier()
    mu, value = _lstm_forward(tr, start, jtraj, hidden0)
    set_matmul(start.ac, "f32")
    mu32 = _lstm_forward(tr, start, jtraj, hidden0)[0]
    rollout = (jts, jtraj, jlast, jstats, perms)
    port = _port_learn(tr, rec, *rollout)
    tr32 = _lstm_port_trainer(jtr, "f32")
    port32 = _port_learn(tr32, _record_lr_steps(jtr, tr32)[1], *rollout)
    adam = jts.opt_state[1]
    arrays = lambda t: lstm_named_arrays(to_numpy_tree(t["ac"]), 1)  # noqa: E731
    moments = {k: v for k, v in arrays(adam.mu).items()}
    return dict(
        init=init, mu32=mu32,
        fwd=dict(mu=(mu, np.asarray(jtraj["mu"])), value=(value, np.asarray(jtraj["value"]))),
        port=port, port32=port32,
        jax=dict(params=arrays(jts.params), mu=moments, nu=arrays(adam.nu),
                 count=float(adam.count), lr=float(jts.lr),
                 norms={(n, f): np.asarray(getattr(getattr(jts, n), f)) for n, f in NORMS},
                 metrics={k: float(v) for k, v in jm.items()}, rec=list(jrec)))


@pytest.fixture(scope="module")
def lstm_run():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        yield emulated_lstm_epoch()
    finally:
        torch.set_num_threads(threads)


def test_lstm_forward_matches_jax(lstm_run):
    """C7: the port's LSTM networks under the rule on JAX's observations
    against the mu and value JAX's rollout took under the emulated rule;
    the exact-f32 forward parts from JAX's mu by over ten times as far."""
    for k, (a, b) in lstm_run["fwd"].items():
        assert _fwd_close(a, b).all(), (k, float(np.abs(a - b).max()))
    port, jmu = lstm_run["fwd"]["mu"]
    assert np.abs(lstm_run["mu32"] - jmu).max() > 10.0 * np.abs(port - jmu).max()


def test_lstm_learner_epoch_matches_jax(lstm_run):
    """C7: the port's LSTM learner epoch under the rule on JAX's trajectory
    from the same state, at the feed-forward case's tolerances."""
    assert_epoch_matches(lstm_run["port"], lstm_run["jax"], lstm_run["init"],
                         LSTM_UPDATES)


def test_lstm_learner_comparison_parts_exact_f32(lstm_run):
    """The LSTM control: the port's exact-f32 epoch on the same trajectory
    from the same state fails the comparison."""
    with pytest.raises(AssertionError):
        assert_epoch_matches(lstm_run["port32"], lstm_run["jax"], lstm_run["init"],
                             LSTM_UPDATES)


def gaps(r):
    """The comparisons' worst gaps, each in units of its bound; the exact
    f32 forward's and learner epoch's beside the rule's."""
    g = {k: float(np.max(np.abs(a - b) / (FWD["rtol"] * np.abs(b)
                                          + FWD["atol"] * np.abs(b).max())))
         for k, (a, b) in r["fwd"].items()}
    g["f32_mu_over_rule_mu"] = float(np.abs(r["mu32"] - r["fwd"]["mu"][1]).max()
                                     / np.abs(r["fwd"]["mu"][0] - r["fwd"]["mu"][1]).max())
    return dict(**({"flips": r["flips"]} if "flips" in r else {}), **g,
                learner=learner_gaps(r["port"], r["jax"], r["init"]),
                learner_f32=learner_gaps(r["port32"], r["jax"], r["init"]))


if __name__ == "__main__":
    print(json.dumps(dict(ff=gaps(emulated_epoch()), lstm=gaps(emulated_lstm_epoch()))))
    sys.exit(0)
