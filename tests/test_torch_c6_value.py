"""Fault C6 through the critic (ROADMAP §C6), on the CPU: the two tasks on
which the port's critic loss stands 4-70 times the JAX record's,
BallBalance and FrankaCabinet, whose episodes run to the time limit with no
`value_bootstrap`, `scale_value` 0.01 and `critic_coef` 4.

Both packages start from a state the port trained on the card,
`results_torch/<task>_c6_state/model.pt` (150 epochs at 4096 envs, seed 42,
the default learner; `tools/c6_arms.sh states`), read through the CLI's
`checkpoint=` and carried into the JAX trainer by `carry_state_to_jax`
(tests/torch_jax_checkpoint.py). Networks in exact f32 in both.

**The learner epoch across the time limit** (`epoch`). N = 64 envs, each
task's train yaml with the minibatch scaled to keep its 8 minibatches a
mini epoch (128). From a JAX reset the JAX trainer rolls out WARMUP
horizons under the held policy (no learning), then every env's progress is
set SHORT steps short of the time limit, so the whole batch reaches it at
the epoch's SHORT-th step and restarts. The JAX trainer rolls out and
learns (its `_epoch`, the rollout handed in). Compared, at
test_torch_ppo.py's Cartpole epoch tolerances, unwidened:
- the trajectory: the port's own rollout (`_rollout` with JAX's action
  noise and JAX's reset draws) against JAX's, within `TRAJ`;
- the env, step by step: the port's `step` from each of JAX's states (a
  replay of JAX's actions through the JAX env's jitted step, which
  reproduces the rollout's observations exactly) with JAX's action and
  JAX's own reset draws for that step, against JAX's next state: done,
  timeout and progress equal, obs and reward within `TRAJ`;
- the policy on JAX's observations: mu, value, the action from JAX's noise
  and the log-probability of JAX's action, within `TRAJ`;
- the returns and advantages (`_gae` on JAX's trajectory) within `TRAJ`;
- the learner on JAX's trajectory with JAX's permutations (`_learn`): every
  metric (the critic loss included) rtol 1e-3, atol 1e-5; the value and obs
  norms rtol 1e-4, atol 1e-6; the parameters by test_torch_ppo.py's
  `_assert_update_rule`.

The first two fail on the trained states. The failures are recorded as
found, each with the factor by which it lies past `TRAJ`:
`ROLLOUT_PARTS` (the first step of the port's own rollout past `TRAJ`, and
what parts there) and `ENV_STEP_PARTS` (every obs element of the step from
JAX's states past `TRAJ`). A test fails if a recorded part moves, comes
inside or is joined by another; an entry leaves its record only when a
rerun brings it inside. `test_env_step_part_starts_in_the_tray_contact`
says where BallBalance's parts start: in the penetration of the ball into
the tray, one ulp apart at the control step's first substep while every
body's pose agrees bit for bit.

**The env over whole episodes** (`episodes`). From one JAX reset carried
into the port (EPISODE_ENVS envs), each env steps under one held policy,
the state's mean action plus exp(log_std) times noise drawn with numpy
from NOISE_SEED (the JAX env's actions from the same networks carried into
flax, one `lax.scan`); after the first episode each package draws its own
resets. Counted per package: episode ends by cause (`limit`: done with the
timeout flag; `early`: done before it, BallBalance's fall or
FrankaCabinet's opened drawer) with the steps they came at; the mean
reward per step; each observation dimension's mean and standard deviation
over the run. Bounds, stated before the run: each count within SD = 4
standard deviations of the difference of two Poisson counts; every other
statistic (per env over the run, then over the envs) within SD standard
errors of the difference of the two packages' means over the envs.
BallBalance's sensor-wrench dimensions (the tray's contact force and
torque / 20, obs 12-17) are held apart from the rest. BallBalance's tier-1
case runs TIER1_STEPS steps (one timeout and its reset), its `slow` case
SLOW_STEPS (two whole episodes and the resets between). FrankaCabinet's
cases are `slow` at both lengths: on the CPU the port's FrankaCabinet step
is the slowest of the two, and its 520 steps alone cost tier 1 some 140 s.

    python -m pytest tests/test_torch_c6_value.py -q            # tier 1
    python -m pytest tests/test_torch_c6_value.py -q -m slow    # the rest
    PYTHONPATH=.:tests python tests/test_torch_c6_value.py [520]  # the figures, JSON
"""

import concurrent.futures
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.learn.networks import gaussian_logprob
from omniisaacgymenvs_torch.ops.parity import COND_DIRECTIONS, cond_nudge
from omniisaacgymenvs_torch.scripts import train as ttrain
from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
from omniisaacgymenvs_tpu.scripts.common import build_env_from_cli as jbuild_env
from test_torch_late_learner import _record_lr_steps
from test_torch_ppo import _assert_update_rule, _jax_perms, _params_np
from test_torch_trained_learner import ENV_FIELDS, jax_learner
from torch_jax_checkpoint import carry_state_to_jax, jax_trainer
from torch_parity import np_, to_numpy_tree

TASKS = ("BallBalance", "FrankaCabinet")
N = 64
MB = ["train.params.config.minibatch_size=128"]
F32 = "train.params.config.net_matmul=f32"
WARMUP = 2
SHORT = 5
TRAJ = dict(rtol=1e-4, atol=1e-5)
METRICS = dict(rtol=1e-3, atol=1e-5)
NORM = dict(rtol=1e-4, atol=1e-6)
EPISODE_ENVS = {"BallBalance": 64, "FrankaCabinet": 16}
TIER1_STEPS, SLOW_STEPS = 520, 1100
NOISE_SEED = 7
SD = 4.0
SENSOR_DIMS = {"BallBalance": tuple(range(12, 18)), "FrankaCabinet": ()}
ROLLOUT_KEYS = ("obs", "action", "mu", "value", "logp", "reward", "done")
STATE = "c6_state"

# Step 1's failures as found (fault C6, ROADMAP §C6). The port's own
# rollout: the first step with a quantity past TRAJ, and each such quantity
# with its largest gap in units of TRAJ.
ROLLOUT_PARTS = {
    "BallBalance": (1, {"action": 1.045}),
    "FrankaCabinet": (3, {"mu": 1.003}),
}
# The step from JAX's states: every obs element past TRAJ, (step, env, dim):
# its gap in units of TRAJ. Dim 14 is the tray's contact force z / 20,
# dim 5 a leg joint's velocity.
ENV_STEP_PARTS = {
    "BallBalance": {(1, 18, 14): 1.026, (1, 32, 14): 1.064, (3, 18, 14): 1.009,
                    (3, 32, 14): 1.067, (4, 63, 14): 1.147, (10, 57, 5): 1.140},
    "FrankaCabinet": {},
}


def _np(x):
    return np.array(x)


def _use(a, b):
    """|a - b| in units of TRAJ's bound at b (> 1: past TRAJ), float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (TRAJ["atol"] + TRAJ["rtol"] * np.abs(b))


@functools.lru_cache(maxsize=None)
def pair(task, state):
    """(JAX trainer, port trainer) at N envs from the committed state
    results_torch/<task>_<state>/model.pt."""
    _, _, tr = ttrain.build_trainer([f"task={task}", f"num_envs={N}", "device=cpu",
                                     f"checkpoint=results_torch/{task}_{state}",
                                     *MB, F32])
    jtr = jax_trainer(task, N, None, MB)
    carry_state_to_jax(tr, jtr)
    return jtr, tr


@functools.lru_cache(maxsize=None)
def jax_roll(task, state):
    """JAX's rollout of one horizon, jitted once per trainer."""
    return jax.jit(pair(task, state)[0]._rollout)


def _port_state(jes):
    return convert.env_state_from_arrays(
        {k: to_numpy_tree(getattr(jes, k)) for k in ENV_FIELDS}, device="cpu")


def _threads(fn):
    """fn run with the port on one thread: its steps are small tensors, and
    under the suite's load more threads only contend (a loaded host made
    more threads slower, test_torch_trained_learner.py)."""
    @functools.wraps(fn)
    def wrapped(*a):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*a)
        finally:
            torch.set_num_threads(threads)
    return wrapped


def _reset_draws(jtask, states):
    """JAX's fresh state of every env for the auto-reset of each step after
    states[t] (the JAX task's `step` splits its key so), as the port's
    `sample_reset` returns it."""
    draw = jax.jit(jax.vmap(lambda r: jtask.sample_reset(
        jax.random.split(jax.random.split(r)[1])[1])))
    out = []
    for es in states:
        q, qd, carry = draw(es.rng)
        out.append((torch.as_tensor(_np(q)), torch.as_tensor(_np(qd)),
                    {key: torch.as_tensor(_np(v)) for key, v in carry.items()}))
    return out


def epoch_start(task, state):
    """JAX's trainer state at the epoch's start: WARMUP horizons from a JAX
    reset under the held policy, then every env's progress SHORT steps
    short of the time limit; with the epoch's action noise (T, N, A) and
    the key left for the learner's permutations."""
    jtr, tr = pair(task, state)
    roll = jax_roll(task, state)
    js = jtr.state
    for _ in range(WARMUP):
        js = roll(js)[0]
    prog = jnp.full(N, tr.env.task.timeout_progress - SHORT, jnp.int32)
    js = js.replace(es=js.es.replace(progress=prog))
    rng_after, k = jax.random.split(js.rng)
    noise = []
    for _ in range(tr.cfg.horizon_length):
        k, kt = jax.random.split(k)
        noise.append(_np(jax.random.normal(kt, (N, tr.env.num_actions))))
    return js, np.stack(noise), rng_after


@functools.lru_cache(maxsize=None)
@_threads
def rollouts(task, state):
    """The epoch's rollout in both packages from `state`: JAX's (its
    `_rollout` outputs), JAX's states replayed step by step, JAX's reset
    draws for each step, and the port's own rollout (ROLLOUT_KEYS) from
    JAX's start with JAX's noise and reset draws."""
    jtr, tr = pair(task, state)
    js, noise, rng_after = epoch_start(task, state)
    jts_r, jtraj, jlast, jstats = jax_roll(task, state)(js)
    states = [js.es]
    for t in range(tr.cfg.horizon_length):
        states.append(jtr.env.step(states[-1], jtraj["action"][t]))
    draws = _reset_draws(jtr.env.task, states[:-1])
    ptask = tr.env.task
    it = iter(draws)
    ptask.sample_reset = lambda n, g: next(it)
    try:
        ts = copy.deepcopy(tr.state)
        ts.es = _port_state(js.es)
        with torch.no_grad():
            own = tr._rollout(ts, torch.as_tensor(noise))[0]
    finally:
        del ptask.sample_reset
    return dict(js=js, noise=noise, rng_after=rng_after,
                jax=(jts_r, jtraj, jlast, jstats), states=states, draws=draws,
                rollout={key: np_(own[key]) for key in ROLLOUT_KEYS})


@functools.lru_cache(maxsize=None)
@_threads
def epoch(task):
    jtr, tr = pair(task, STATE)
    ptask = tr.env.task
    ro = rollouts(task, STATE)
    noise, rng_after = ro["noise"], ro["rng_after"]
    jts_r, jtraj, jlast, jstats = ro["jax"]
    states, draws, rollout = ro["states"], ro["draws"], ro["rollout"]
    cfg, T = tr.cfg, tr.cfg.horizon_length
    perms = torch.as_tensor(_np(_jax_perms(rng_after, cfg.mini_epochs, T * N)))
    start = copy.deepcopy(tr.state)

    # the env, step by step from JAX's states
    steps = []
    for t in range(T):
        ptask.sample_reset = lambda n, g, fresh=draws[t]: fresh
        try:
            es2 = tr.env.step(_port_state(states[t]),
                              torch.as_tensor(_np(jtraj["action"][t])))
        finally:
            del ptask.sample_reset
        steps.append({f: np_(getattr(es2, f)) for f in
                      ("obs", "reward", "done", "timeout", "progress")})
    replay = {f: np.stack([_np(getattr(s, f)) for s in states[1:]])
              for f in ("obs", "reward", "done", "timeout", "progress")}
    port_steps = {f: np.stack([s[f] for s in steps]) for f in replay}

    # the policy on JAX's observations
    with torch.no_grad():
        obs = torch.as_tensor(_np(jtraj["obs"]))
        mu, log_std, value, _, _ = tr._policy(start, obs, None)
        action = mu + torch.exp(log_std) * torch.as_tensor(noise)
        logp = gaussian_logprob(mu, log_std, torch.as_tensor(_np(jtraj["action"])))
    policy = dict(mu=np_(mu), value=np_(value), action=np_(action), logp=np_(logp))

    # returns, advantages and the learner on JAX's trajectory
    traj = {key: torch.as_tensor(_np(v)) for key, v in to_numpy_tree(jtraj).items()}
    last = torch.as_tensor(_np(jlast))
    advs, rets = tr._gae(traj, last)
    jadvs, jrets = jtr._gae(jtraj, jlast)
    jrec, rec = _record_lr_steps(jtr, tr)
    try:
        jts, jm = jax_learner(jtr)(jts_r, jtraj, jlast, jstats)
        jax.effects_barrier()
        ts = copy.deepcopy(start)
        ts.es = _port_state(jts.es)
        m = tr._learn(ts, traj, last,
                      {key: torch.as_tensor(_np(v)) for key, v in jstats.items()},
                      perms=perms)
    finally:
        del jtr._adapt_lr, tr._adapt_lr
    return dict(
        jtraj={key: _np(v) for key, v in jtraj.items()}, states=states, rollout=rollout,
        replay=replay, port_steps=port_steps, policy=policy,
        gae=dict(adv=(np_(advs), _np(jadvs)), ret=(np_(rets), _np(jrets))),
        metrics=({key: float(v) for key, v in m.items()},
                 {key: float(v) for key, v in jm.items()}),
        norms={(n, f): (np_(getattr(getattr(ts, n), f)), _np(getattr(getattr(jts, n), f)))
               for n in ("obs_norm", "value_norm") for f in ("mean", "var", "count")},
        params=(_params_np(ts.ac),
                convert.actor_critic_arrays(to_numpy_tree(jts.params["ac"]), ts.ac),
                _params_np(start.ac)),
        rec=(list(rec), list(jrec)))


@pytest.mark.parametrize("task", TASKS)
def test_epoch_crosses_the_time_limit(task):
    """Every env ends an episode inside the horizon; those that have not
    ended it before end it by the time limit at the SHORT-th step, with the
    timeout flag, and restart there; the port's step flags the same."""
    r = epoch(task)
    done, timeout = r["jtraj"]["done"], r["replay"]["timeout"]
    assert done.any(0).all()
    before = done[:SHORT - 1].any(0)
    assert (~before).sum() >= N // 2, int((~before).sum())
    assert done[SHORT - 1][~before].all() and timeout[SHORT - 1][~before].all()
    assert not timeout[:SHORT - 1][:, ~before].any()
    np.testing.assert_array_equal(r["replay"]["done"], done)
    np.testing.assert_array_equal(r["port_steps"]["timeout"][SHORT - 1][~before], True)


def rollout_parts(r):
    """(first step with a quantity past TRAJ, {quantity: largest gap there
    in units of TRAJ}) of the port's own rollout; (None, {}) if none."""
    for t in range(len(r["rollout"]["obs"])):
        use = {key: float(_use(r["rollout"][key][t], r["jtraj"][key][t]).max())
               for key in ROLLOUT_KEYS}
        past = {key: round(u, 3) for key, u in use.items() if u > 1}
        if past:
            return t, past
    return None, {}


@pytest.mark.parametrize("task", TASKS)
def test_rollout_matches_jax(task):
    """The port's own rollout against JAX's trajectory within TRAJ, up to
    the recorded part: the same first step past TRAJ, the same quantities
    past it there by the same factors."""
    assert rollout_parts(epoch(task)) == ROLLOUT_PARTS[task]


def env_step_parts(r):
    """{(step, env, dim): gap in units of TRAJ} of every obs element of the
    step from JAX's states past TRAJ."""
    use = _use(r["port_steps"]["obs"], r["replay"]["obs"])
    return {tuple(int(i) for i in c): round(float(use[tuple(c)]), 3)
            for c in np.argwhere(use > 1)}


@pytest.mark.parametrize("task", TASKS)
def test_env_steps_match_jax(task):
    """The port's step from each of JAX's states against JAX's next state:
    done, timeout and progress equal; reward within TRAJ; obs within TRAJ
    but for the recorded parts, each past TRAJ by its recorded factor."""
    r = epoch(task)
    rep, port = r["replay"], r["port_steps"]
    for f in ("done", "timeout", "progress"):
        np.testing.assert_array_equal(port[f], rep[f], err_msg=f)
    np.testing.assert_allclose(port["reward"], rep["reward"], **TRAJ)
    assert env_step_parts(r) == ENV_STEP_PARTS[task]


@functools.lru_cache(maxsize=None)
def _jax_tray_contact(task):
    """JAX's pair-contact box branch (omniisaacgymenvs_tpu/physics/contacts.py,
    `pair_contacts`) up to the penetration, for one env, jitted: the bodies'
    poses, the point's offset from the box's centre, the penetration."""
    from omniisaacgymenvs_tpu.physics import dynamics as jdyn
    from omniisaacgymenvs_tpu.physics import rotations as jrot

    je = pair(task, STATE)[0].env.task.engine
    m, g = je.model, je.pair_groups.box
    pi, sb = jnp.asarray(g["pt"]), jnp.asarray(g["sbody"])
    prm = jnp.asarray(g["params"], jnp.float32)
    half, r_pt = prm[:, 3:6], m.cp_radius[pi]

    def contact(q, qd):
        with jax.default_matmul_precision("float32"):
            kin = jdyn.kinematics(m, q, qd)
            cb = m.cp_body[pi]
            pt_w = kin.pw[cb] + jnp.einsum("cij,cj->ci", kin.Rw[cb], m.cp_pos[pi])
            R_box = kin.Rw[sb] @ jrot.quat_to_rotmat(prm[:, 6:10])
            c_w = kin.pw[sb] + jnp.einsum("cij,cj->ci", kin.Rw[sb], prm[:, 0:3])
            p_l = jnp.einsum("cji,cj->ci", R_box, pt_w - c_w)
            d_out = p_l - jnp.clip(p_l, -half, half)
            dist_out = jnp.linalg.norm(d_out, axis=-1)
            pen = jnp.where(dist_out > 1e-9, r_pt - dist_out,
                            r_pt + jnp.min(half - jnp.abs(p_l), axis=-1))
        return kin.pw, kin.Rw, pt_w - c_w, pen

    return jax.jit(contact), jax.jit(functools.partial(
        je._substep, h=je.params.dt / je.params.substeps))


def tray_contact_parts(task, cell):
    """Over the control step of a recorded cell, substep by substep from
    JAX's (q, qd): the largest pose gap in ulps of the pose, and the
    penetration gap (m) with the ulp of the point's offset from the tray's
    centre."""
    from omniisaacgymenvs_torch.physics import contacts, dynamics

    t, env, _ = cell
    jtr, tr = pair(task, STATE)
    jtask, eng = jtr.env.task, tr.env.task.engine
    contact, substep = _jax_tray_contact(task)
    es = jax.tree_util.tree_map(lambda x: x[env], epoch(task)["states"][t])
    action = epoch(task)["jtraj"]["action"][t][env]
    ctrl = jtask.control(jnp.asarray(action), es)
    f_applied = jnp.concatenate([ctrl.body_torque, ctrl.body_force], axis=-1)
    q, qd = es.phys.q, es.phys.qd
    out = []
    for _ in range(jtask.decimation * jtask.engine.params.substeps):
        pw, Rw, offset, pen = (_np(x) for x in contact(q, qd))
        kin = dynamics.kinematics(eng.model, torch.as_tensor(_np(q))[None],
                                  torch.as_tensor(_np(qd))[None])
        ppen = np_(contacts.pair_penetrations(eng.model, eng.pair_groups,
                                              kin.pw, kin.Rw))[0]
        pose_ulps = max(
            float((np.abs(np_(x)[0] - y) / np.spacing(np.abs(y))).max())
            for x, y in ((kin.pw, pw), (kin.Rw, Rw)))
        out.append(dict(pose_ulps=pose_ulps, pen=float(pen[0]),
                        pen_gap=abs(float(ppen[0]) - float(pen[0])),
                        ulp=float(np.spacing(np.abs(offset).max()))))
        q, qd, _ = substep(q, qd, ctrl, f_applied)
    return out


@pytest.mark.parametrize("cell", sorted(ENV_STEP_PARTS["BallBalance"]),
                         ids=lambda c: "step{}-env{}-dim{}".format(*c))
def test_env_step_part_starts_in_the_tray_contact(cell):
    """Where a recorded BallBalance part starts: from JAX's (q, qd) before
    each substep of the cell's control step, the port's bodies' poses agree
    with JAX's bit for bit at the first substep, and the ball's penetration
    into the tray differs there, by one ulp of the ball's offset from the
    tray's centre; at no substep by more."""
    subs = tray_contact_parts("BallBalance", cell)
    assert subs[0]["pose_ulps"] == 0.0
    assert 0.0 < subs[0]["pen_gap"] <= subs[0]["ulp"]
    for s in subs:
        assert s["pen_gap"] <= s["ulp"], s


@pytest.mark.parametrize("task", TASKS)
def test_policy_on_jax_observations(task):
    r = epoch(task)
    for key, v in r["policy"].items():
        np.testing.assert_allclose(v, r["jtraj"][key], err_msg=key, **TRAJ)


@pytest.mark.parametrize("task", TASKS)
def test_returns_and_advantages_match_jax(task):
    for key, (a, b) in epoch(task)["gae"].items():
        np.testing.assert_allclose(a, b, err_msg=key, **TRAJ)


@pytest.mark.parametrize("task", TASKS)
def test_learner_epoch_matches_jax(task):
    """The learner across the time limit: every metric (the critic loss
    included), the norms and the parameters."""
    r = epoch(task)
    m, jm = r["metrics"]
    assert sorted(m) == sorted(jm)
    for key, v in jm.items():
        np.testing.assert_allclose(m[key], v, err_msg=key, **METRICS)
    for key, (a, b) in r["norms"].items():
        np.testing.assert_allclose(a, b, err_msg=str(key), **NORM)
    rec, jrec = r["rec"]
    assert len(rec) == len(jrec) == 64
    lr_max = max(max(lr0, lr1) for _, lr0, lr1 in jrec)
    port, ref, init = r["params"]
    _assert_update_rule(port, ref, init, lr_max, len(jrec))


# -- whole episodes --------------------------------------------------------

def _jax_run(jtr, jenv, jes, eps):
    """The JAX env under the held policy (flax networks carrying the port's
    state) over len(eps) steps in one scan: per step done, timeout, reward,
    obs."""
    params, norm, net = jtr.state.params["ac"], jtr.state.obs_norm, jtr.net
    step = jax.vmap(jenv.task.step)

    def body(es, e):
        mu, log_std, _ = net.apply(params, norm.normalize(es.obs))
        es2 = step(es, mu + jnp.exp(log_std) * e)
        return es2, (es2.done, es2.timeout, es2.reward, es2.obs)

    _, out = jax.jit(lambda es, e: jax.lax.scan(body, es, e))(jes, jnp.asarray(eps))
    return tuple(_np(x) for x in out)


def _port_run(tr, env, es, eps):
    out = []
    for e in eps:
        with torch.no_grad():
            mu, log_std, *_ = tr._policy(tr.state, es.obs, None)
            es = env.step(es, mu + torch.exp(log_std) * torch.as_tensor(e))
        out.append([np_(getattr(es, f)).copy() for f in ("done", "timeout", "reward", "obs")])
    return tuple(np.stack(x) for x in zip(*out))


@functools.lru_cache(maxsize=None)
@_threads
def episodes(task, steps):
    jtr, tr = pair(task, STATE)
    n = EPISODE_ENVS[task]
    _, _, jenv = jbuild_env([f"task={task}", f"num_envs={n}", "pipeline=cpu"])
    _, _, env = build_env_from_cli([f"task={task}", f"num_envs={n}", "device=cpu"])
    jes = jenv.reset(seed=0)
    es = _port_state(jes)
    eps = np.random.default_rng(NOISE_SEED).standard_normal(
        (steps, n, env.num_actions)).astype(np.float32)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_jax_run, jtr, jenv, jes, eps)
        port = _port_run(tr, env, es, eps)
        ref = fut.result()
    return {name: summary(*run) for name, run in (("port", port), ("jax", ref))}


def summary(done, timeout, reward, obs):
    """The run's counts and per-env statistics."""
    limit, early = done & timeout, done & ~timeout
    return dict(
        limit=int(limit.sum()), early=int(early.sum()),
        limit_steps=sorted(set(np.nonzero(limit)[0].tolist())),
        early_steps=np.nonzero(early)[0], reward=reward.mean(0),
        obs_mean=obs.mean(0), obs_sd=obs.std(0))


def _poisson_sd(a: int, b: int) -> float:
    return 0.0 if a + b == 0 else abs(a - b) / np.sqrt(a + b)


def _se_gap(a, b):
    """|mean(a) - mean(b)| over envs (axis 0) in standard errors of the
    difference."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    gap = np.abs(a.mean(0) - b.mean(0))
    return np.where(se > 0, gap / np.where(se > 0, se, 1.0), np.where(gap > 0, np.inf, 0.0))


def _case(task, steps, *extra):
    slow = task == "FrankaCabinet" or steps == SLOW_STEPS
    return pytest.param(task, *extra, steps, id="-".join((task, *extra, str(steps))),
                        marks=[pytest.mark.slow] if slow else [])


EPISODES = [_case(t, n) for t in TASKS for n in (TIER1_STEPS, SLOW_STEPS)]


@pytest.mark.parametrize("task,steps", EPISODES)
def test_episode_ends_match_jax(task, steps):
    """Ends by cause: each count within SD of JAX's; the first time limit
    comes at the same step in both, the first episode's last."""
    r = episodes(task, steps)
    p, j = r["port"], r["jax"]
    for key in ("limit", "early"):
        assert _poisson_sd(p[key], j[key]) <= SD, (key, p[key], j[key])
    first = pair(task, STATE)[1].env.task.timeout_progress - 1
    assert p["limit_steps"][0] == j["limit_steps"][0] == first


@pytest.mark.parametrize("task,steps", EPISODES)
def test_episode_reward_matches_jax(task, steps):
    r = episodes(task, steps)
    gap = _se_gap(r["port"]["reward"], r["jax"]["reward"])
    assert gap <= SD, float(gap)


OBS_PARTS = [_case(t, n, part) for t in TASKS
             for part in (("sensor", "rest") if SENSOR_DIMS[t] else ("all",))
             for n in (TIER1_STEPS, SLOW_STEPS)]


@pytest.mark.parametrize("task,part,steps", OBS_PARTS)
def test_episode_observations_match_jax(task, part, steps):
    """Each observation dimension's mean and standard deviation over the
    run, per env, within SD standard errors; BallBalance's sensor-wrench
    dimensions apart."""
    sensor = SENSOR_DIMS[task]
    r = episodes(task, steps)
    n_obs = r["port"]["obs_mean"].shape[-1]
    dims = [d for d in range(n_obs) if (d in sensor) == (part == "sensor")]
    for stat in ("obs_mean", "obs_sd"):
        gap = _se_gap(r["port"][stat][:, dims], r["jax"][stat][:, dims])
        assert (gap <= SD).all(), (stat, {d: float(g) for d, g in zip(dims, gap)})


def nudged(es, d):
    """A JAX env state with q and qd nudged by `parity.cond_nudge` in
    direction d."""
    phys = es.phys.replace(
        q=jnp.asarray(cond_nudge(torch.as_tensor(_np(es.phys.q)), d).numpy()),
        qd=jnp.asarray(cond_nudge(torch.as_tensor(_np(es.phys.qd)), d).numpy()))
    return es.replace(phys=phys)


def jax_controls(task) -> dict:
    """JAX against itself, measured after step 1's run (it judges nothing):
    JAX's own step from each of its states with q and qd nudged by the
    port's conditioning rule (ops/parity.py `cond_nudge`, COND_EPS = 2^-22
    of their size, in each of the six COND_DIRECTIONS), the largest change
    of each recorded env-step part in units of TRAJ; and JAX's own rollout
    from its start state so nudged, the first step at which it parts from
    the rollout unnudged past TRAJ (None if it does not), per direction."""
    jtr, _ = pair(task, STATE)
    r = epoch(task)
    states, actions = r["states"], r["jtraj"]["action"]
    step_change = {}
    for t, env, dim in ENV_STEP_PARTS[task]:
        ref = r["replay"]["obs"][t, env, dim]
        step_change[(t, env, dim)] = max(
            float(_use(_np(jtr.env.step(nudged(states[t], d), actions[t]).obs)[env, dim], ref))
            for d in COND_DIRECTIONS)
    js = rollouts(task, STATE)["js"]
    first = {}
    for d in COND_DIRECTIONS:
        traj = jax_roll(task, STATE)(js.replace(es=nudged(js.es, d)))[1]
        past = [t for t in range(len(traj["obs"]))
                if any(_use(_np(traj[k][t]), r["jtraj"][k][t]).max() > 1
                       for k in ROLLOUT_KEYS)]
        first[d] = past[0] if past else None
    return dict(step_change=step_change, rollout_first_part=first)


def report(steps=TIER1_STEPS) -> dict:
    """The figures behind the tests, per task: the recorded parts of the
    port's own rollout and of the step from JAX's states, where each
    BallBalance part starts (per substep), JAX's controls; the epoch's
    worst gaps in units of TRAJ (policy, returns) and of the learner's
    bound (metrics), the critic loss of both learners; the episodes'
    counts and the largest standard-error gaps."""
    out = {}
    for task in TASKS:
        r = epoch(task)
        m, jm = r["metrics"]
        e = episodes(task, steps)
        p, j = e["port"], e["jax"]
        out[task] = dict(
            rollout_parts=rollout_parts(r),
            env_step_parts={str(c): u for c, u in env_step_parts(r).items()},
            env_reward=float(_use(r["port_steps"]["reward"], r["replay"]["reward"]).max()),
            tray_contact={str(c): tray_contact_parts(task, c) for c in ENV_STEP_PARTS[task]},
            jax_controls={k: {str(c): u for c, u in v.items()}
                          for k, v in jax_controls(task).items()},
            policy={k: float(_use(v, r["jtraj"][k]).max()) for k, v in r["policy"].items()},
            gae={k: float(_use(a, b).max()) for k, (a, b) in r["gae"].items()},
            metrics=max(abs(m[k] - v) / (METRICS["atol"] + METRICS["rtol"] * abs(v))
                        for k, v in jm.items()),
            critic_loss=(m["critic_loss"], jm["critic_loss"]),
            episodes={k: (p[k], j[k]) for k in ("limit", "early")},
            reward_se=float(_se_gap(p["reward"], j["reward"])),
            obs_se={stat: float(_se_gap(p[stat], j[stat]).max())
                    for stat in ("obs_mean", "obs_sd")})
    return out


if __name__ == "__main__":
    import json
    import sys

    import conftest  # noqa: F401  (the suite's JAX settings: CPU, 8 devices)

    print(json.dumps(report(int(sys.argv[1]) if len(sys.argv) > 1 else TIER1_STEPS)))
