"""How often AllegroHand's cube falls under one fixed policy, counted in the
JAX package's env and in the port's, on the CPU, and in the port on the
card through K1 (either form) or through the plain path.

    python tests/torch_fall_rates.py [policy=hold:4] [runs=jax,port] \
        [num_envs=256] [steps=150] [seed=0] [out=FILE]
    python tests/torch_fall_rates.py checkpoint=DIR [mode=sample|mean] \
        [runs=jax,port] [num_envs=512] [steps=601]
    python tests/torch_fall_rates.py runs=k1,thread,plain num_envs=8192   # on the card

`task.env.<key>=<value>` overrides go to both packages' task yaml (the
tier-1 test shortens the episodes so that timeouts occur in a short run).

The policy is one of:
  - `policy=hold:K`: actions of +1 or -1 in every dimension, drawn with
    numpy from `seed` and held K control steps;
  - `checkpoint=DIR`: a port checkpoint's `model.pt` (networks and norms,
    exact f32 products in every run), its actions sampled as the training
    rollout samples them (`mode=sample`: mean + std * noise, the noise drawn
    with numpy from `seed`, the env clamping) or its mean clipped to
    [-1, 1] (`mode=mean`).
Every run steps the same actions (hold) or the same policy and noise
(checkpoint). The port's networks act in the JAX env too: its observation
goes to the port's policy on the CPU and the action comes back, so the
runs differ in their envs only. Each package draws its own resets.

Runs:
  - `jax`: the JAX package's env on the CPU (the only run that imports JAX);
  - `port`: the port's env on the CPU, through `PhysicsEngine.step_n`;
  - `k1`: the port on the card through K1 in the form `launch_config` picks
    (the product path); `group` / `thread`: K1 in that form (`design=`);
  - `plain`: the port on the card through `fused_step.step_plain` on the
    card's tensors (the task's `physics_steps` replaced in this script, not
    through any switch of the engine).
The card's runs start from the same resets and take the same actions, so
they part by their arithmetic only.

Per run, from the env state each step returns (nothing of either package
is changed), per 1000 env-steps with a 95% Poisson interval: the resets by
cause (`fell`: goal_dist >= fallDistance; `timeout`; `nonfinite`: the
step's guard of a non-finite state, `tasks/base.py`; `other`: any done of
none of those, which AllegroHand's yaml does not have), goal hits, the
cube's "ejections" (steps with its linear speed over EJECT_LIN or its
angular speed over EJECT_ANG) and the falls that came within EJECT_WINDOW
steps of an ejection of their env; the reward and length of a finished
episode (mean, 95% interval); the cube's p99 and largest linear and
angular speed. `pairs` holds, for each pair of runs, the difference of
each count's rate in standard deviations of that difference. `per_env`
holds, for goal hits and each kind of ejection, how the count spreads over
the envs: how many envs count any, the PER_ENV_TOP envs that count most
(env, count, the step of its first one), the shares of the total that
the top one and the top PER_ENV_TOP carry, and the mean and sd of the
count over the envs. A count that a few envs carry is clustered, and its
Poisson interval understates its spread: `pairs` then also compares the
means over envs (`<key>_by_env`).

Prints one JSON object (and writes it to `out=`).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASK = "AllegroHand"
# a cube that falls freely over the fall distance (0.24 m) reaches
# sqrt(2 * 9.81 * 0.24) = 2.17 m/s: a linear speed over EJECT_LIN comes
# from a throw, not from a drop. The integrator caps a free body's angular
# velocity at 64 rad/s a component (110.85 in norm): an angular speed over
# EJECT_ANG is a spin near that cap
EJECT_LIN = 2.5     # m/s
EJECT_ANG = 100.0   # rad/s
EJECT_WINDOW = 10   # control steps from an ejection to a fall
CAUSES = ("fell", "timeout", "nonfinite", "other")
COUNTS = CAUSES + ("goal_hits", "ejections_lin", "ejections_ang",
                   "falls_after_ejection")
PER_ENV = ("goal_hits", "ejections_lin", "ejections_ang")
PER_ENV_TOP = 5
CARD_RUNS = ("k1", "group", "thread", "plain")
Z95 = 1.959964


def poisson_interval(k: int, z: float = Z95):
    """The exact (Garwood) 95% interval of a Poisson mean from one count."""
    from scipy.stats import chi2

    a = 1.0 - 2.0 * (1.0 - 0.5 * (1.0 + math.erf(z / math.sqrt(2.0))))
    lo = 0.0 if k == 0 else float(chi2.ppf((1.0 - a) / 2, 2 * k)) / 2
    return lo, float(chi2.ppf((1.0 + a) / 2, 2 * k + 2)) / 2


def rate(k: int, exposure: int) -> dict:
    """A count over `exposure` env-steps, per 1000 env-steps with its
    interval."""
    lo, hi = poisson_interval(k)
    s = 1000.0 / exposure
    return dict(count=int(k), per_1000=k * s, lo=lo * s, hi=hi * s)


def diff_sd(k1: int, e1: int, k2: int, e2: int) -> float:
    """(rate 1 - rate 2) in standard deviations of the difference of two
    Poisson rates; 0 where both counts are 0."""
    var = k1 / e1 ** 2 + k2 / e2 ** 2
    return 0.0 if var == 0 else (k1 / e1 - k2 / e2) / math.sqrt(var)


def mean_interval(x) -> dict:
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return dict(n=0, mean=None, lo=None, hi=None)
    m = float(x.mean())
    h = Z95 * float(x.std(ddof=1)) / math.sqrt(x.size) if x.size > 1 else 0.0
    return dict(n=int(x.size), mean=m, lo=m - h, hi=m + h)


class Tally:
    """Counts a run's steps. `add` takes the step's rows (8, N) of done,
    timeout, finite state, goal distance, reward, goal hit, cube linear and
    angular speed, as numpy."""

    def __init__(self, n: int, fall_dist: float):
        self.n, self.fall_dist, self.steps = n, fall_dist, 0
        self.counts = dict.fromkeys(COUNTS, 0)
        self.ep_ret = np.zeros(n)
        self.ep_len = np.zeros(n)
        self.last_eject = np.full(n, -10 ** 9)
        self.env_counts = {k: np.zeros(n, np.int64) for k in PER_ENV}
        self.env_first = {k: np.full(n, -1, np.int64) for k in PER_ENV}
        self.returns, self.lengths, self.lin, self.ang = [], [], [], []

    def add(self, rows: np.ndarray):
        done, timeout, finite, goal_dist, reward, goal, lin, ang = rows
        done, timeout, finite, goal = (x > 0.5 for x in (done, timeout, finite, goal))
        nonfinite = done & ~finite
        fell = done & finite & (goal_dist >= self.fall_dist)
        timed = done & finite & ~fell & timeout
        c = self.counts
        c["nonfinite"] += int(nonfinite.sum())
        c["fell"] += int(fell.sum())
        c["timeout"] += int(timed.sum())
        c["other"] += int((done & ~(nonfinite | fell | timed)).sum())
        c["goal_hits"] += int((goal & finite).sum())
        lin, ang = np.where(finite, lin, 0.0), np.where(finite, ang, 0.0)
        ej_lin, ej_ang = lin > EJECT_LIN, ang > EJECT_ANG
        c["ejections_lin"] += int(ej_lin.sum())
        c["ejections_ang"] += int(ej_ang.sum())
        for k, hit in zip(PER_ENV, (goal & finite, ej_lin, ej_ang)):
            self.env_counts[k] += hit
            self.env_first[k] = np.where(hit & (self.env_first[k] < 0), self.steps,
                                         self.env_first[k])
        self.last_eject = np.where(ej_lin | ej_ang, self.steps, self.last_eject)
        c["falls_after_ejection"] += int(
            (fell & (self.steps - self.last_eject <= EJECT_WINDOW)).sum())
        self.ep_ret += np.where(finite, reward, 0.0)
        self.ep_len += 1
        self.returns.append(self.ep_ret[done].copy())
        self.lengths.append(self.ep_len[done].copy())
        self.ep_ret[done] = 0.0
        self.ep_len[done] = 0.0
        self.last_eject[done] = -10 ** 9
        self.lin.append(lin[finite].astype(np.float32))
        self.ang.append(ang[finite].astype(np.float32))
        self.steps += 1

    def result(self) -> dict:
        e = self.n * self.steps
        lin, ang = np.concatenate(self.lin), np.concatenate(self.ang)
        out = dict(env_steps=e, steps=self.steps,
                   rates={k: rate(v, e) for k, v in self.counts.items()},
                   per_env={k: self.spread(k) for k in PER_ENV},
                   episode_reward=mean_interval(np.concatenate(self.returns)),
                   episode_length=mean_interval(np.concatenate(self.lengths)))
        for name, x in (("lin", lin), ("ang", ang)):
            out[f"cube_{name}_speed"] = dict(
                p99=float(np.percentile(x, 99)) if x.size else None,
                max=float(x.max()) if x.size else None)
        return out

    def spread(self, key: str) -> dict:
        """How `key`'s count spreads over the envs (`per_env` above)."""
        c, first = self.env_counts[key], self.env_first[key]
        total = int(c.sum())
        top = np.argsort(-c, kind="stable")[:PER_ENV_TOP]
        top = [int(i) for i in top if c[i] > 0]
        share = lambda k: 0.0 if total == 0 else k / total  # noqa: E731
        return dict(total=total, envs=int((c > 0).sum()),
                    mean=float(c.mean()), sd=float(c.std(ddof=1)) if c.size > 1 else 0.0,
                    top=[dict(env=i, count=int(c[i]), first_step=int(first[i]))
                         for i in top],
                    top1_share=share(int(c[top[0]]) if top else 0),
                    top_share=share(int(c[top].sum()) if top else 0))


def compare(a: dict, b: dict) -> dict:
    """Each count's rate difference between two runs' results, in
    standard deviations of the difference; for the per-env counts also
    `<key>_by_env`: the difference of the means over envs in standard
    errors of that difference, which a count clustered in few envs does
    not overstate."""
    ea, eb = a["env_steps"], b["env_steps"]
    out = {k: round(diff_sd(a["rates"][k]["count"], ea, b["rates"][k]["count"], eb), 3)
           for k in COUNTS}
    na, nb = ea // a["steps"], eb // b["steps"]
    for k in PER_ENV:
        sa, sb = a["per_env"][k], b["per_env"][k]
        se = math.sqrt(sa["sd"] ** 2 / na + sb["sd"] ** 2 / nb)
        out[f"{k}_by_env"] = 0.0 if se == 0 else round((sa["mean"] - sb["mean"]) / se, 3)
    return out


# -- the policy ------------------------------------------------------------

class HoldPolicy:
    """+1 / -1 in every action dimension, drawn with numpy from `seed`
    for every env, held `hold` control steps."""

    def __init__(self, n: int, num_actions: int, hold: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n, self.na, self.hold, self.a = n, num_actions, hold, None

    def __call__(self, t: int, obs_fn):
        if t % self.hold == 0:
            self.a = self.rng.choice(np.array([-1.0, 1.0], np.float32),
                                     size=(self.n, self.na))
        return self.a


class CheckpointPolicy:
    """A port checkpoint's feed-forward policy on `device`: mean +
    std * noise (noise drawn with numpy from `seed`; `mode=sample`) or
    the mean clipped to [-1, 1] (`mode=mean`)."""

    def __init__(self, trainer, mode: str, seed: int):
        if mode not in ("sample", "mean"):
            raise ValueError(f"mode={mode!r}: sample or mean")
        if trainer.is_rnn:
            raise ValueError("a feed-forward policy only")
        self.tr, self.mode = trainer, mode
        self.rng = np.random.default_rng(seed)

    def __call__(self, t: int, obs_fn):
        import torch

        obs = obs_fn()
        with torch.no_grad():
            mu, log_std, *_ = self.tr._policy(self.tr.state, obs, obs[:, :0])
            if self.mode == "mean":
                a = mu.clamp(-1.0, 1.0)
            else:
                eps = self.rng.standard_normal(mu.shape).astype(np.float32)
                a = mu + torch.exp(log_std) * torch.as_tensor(eps, device=mu.device)
        return a.float().cpu().numpy()


def load_policy_trainer(checkpoint: str, device: str):
    """A port trainer holding `checkpoint`'s model.pt (test=True: the main
    file only) on `device`, at 8 envs, its networks computing in exact f32
    (`net_matmul=f32`): its networks and norms are the policy."""
    from omniisaacgymenvs_torch.scripts.train import build_trainer

    _, _, tr = build_trainer([f"task={TASK}", "num_envs=8", f"device={device}",
                              "test=True", f"checkpoint={os.path.join(ROOT, checkpoint)}",
                              "train.params.config.net_matmul=f32"])
    return tr


def make_policy(args: dict, n: int, device: str, num_actions: int = 16):
    if "checkpoint" in args:
        tr = load_policy_trainer(args["checkpoint"], device)
        return CheckpointPolicy(tr, args.get("mode", "sample"), int(args.get("seed", 0)))
    kind, _, hold = args.get("policy", "hold:4").partition(":")
    if kind != "hold" or not hold:
        raise ValueError(f"policy={args.get('policy')!r}: hold:K or checkpoint=DIR")
    return HoldPolicy(n, num_actions, int(hold), int(args.get("seed", 0)))


# -- the runs --------------------------------------------------------------

def use_route(task, route: str):
    """Make the task step its physics through K1 in the form `route`
    ("group" / "thread"), or through `fused_step.step_plain` ("plain"), on
    the card's tensors: an attribute of this task object, set here only."""
    import torch

    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.physics.state import State

    eng = task.engine
    assert not eng.has_terrain and eng.k1_launches(task.decimation) == 1

    def physics_steps(phys, ctrl, overlay=None):
        f_applied = torch.cat([ctrl.body_torque, ctrl.body_force], dim=-1)
        ins = (phys.q.contiguous(), phys.qd.contiguous(), ctrl.effort.contiguous(),
               ctrl.pos_target.contiguous(), ctrl.vel_target.contiguous(), f_applied)
        n_steps = task.decimation * eng.params.substeps
        if route == "plain":
            out = fs.step_plain(eng, *ins, n_steps, None, overlay)
        else:
            out = fs.step(eng, *ins, n_steps, overlay=overlay, design=route)
        q, qd, sf, pos, quat, avel, lvel = out
        return State(q=q, qd=qd, body_pos=pos, body_quat=quat, body_lvel=lvel,
                     body_avel=avel, sensor_forces=sf)

    task.physics_steps = physics_steps


def port_rows(task, es):
    """The step's rows for `Tally.add`, one transfer from the device."""
    import torch

    q, qd, b, qa = es.phys.q, es.phys.qd, task._obj_body, task._obj_q
    finite = torch.isfinite(q.sum(-1) + qd.sum(-1))
    rows = torch.stack([
        es.done.float(), es.timeout.float(), finite.float(),
        torch.linalg.norm(q[:, qa:qa + 3] - task.goal_pos, dim=-1), es.reward,
        es.carry["reset_goal"].float(),
        torch.linalg.norm(es.phys.body_lvel[:, b], dim=-1),
        torch.linalg.norm(es.phys.body_avel[:, b], dim=-1)])
    return rows.cpu().numpy().astype(np.float64)


def run_port(n: int, steps: int, policy, seed: int = 0, device: str = "cpu",
             route: str | None = None, overrides=()) -> dict:
    """The port's AllegroHand at n envs for `steps` control steps under
    `policy`, its resets drawn from `seed`; `route` (on the card): None or
    "k1" for the product path, else `use_route`'s; `overrides`: the CLI's
    `task.*=` overrides. Returns the Tally's result with the run's wall
    time and, on the card, its launches."""
    import torch

    from omniisaacgymenvs_torch.scripts.common import build_env_from_cli

    _, task, env = build_env_from_cli([f"task={TASK}", f"num_envs={n}",
                                       f"device={device}", f"seed={seed}", *overrides])
    if route not in (None, "k1"):
        use_route(task, route)
    tally = Tally(n, task.fall_dist)
    es = env.reset(seed=seed)
    kern = task.engine.kernels if device != "cpu" else None
    if kern is not None:
        kern.reset_counts()
    t0 = time.perf_counter()
    for t in range(steps):
        a = policy(t, lambda: es.obs)
        es = env.step(es, torch.as_tensor(a, device=task.device))
        tally.add(port_rows(task, es))
    out = dict(tally.result(), seconds=time.perf_counter() - t0)
    if kern is not None:
        out["launches"] = dict(kern.launches)
        out["thread_launches"] = kern.thread_launches["step"]
        out["form"] = (kern.config(n)[0]["design"] if route in (None, "k1")
                       else route)
    return out


def run_jax(n: int, steps: int, policy, seed: int = 0, overrides=()) -> dict:
    """The JAX package's AllegroHand on the CPU, as `run_port`; the policy
    (the port's, on the CPU) sees the JAX env's observations."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from omniisaacgymenvs_tpu.scripts.common import build_env_from_cli

    _, _, env = build_env_from_cli([f"task={TASK}", f"num_envs={n}", "pipeline=cpu",
                                    f"seed={seed}", *overrides])
    task = env.task
    qa, b = task._obj_q, task._obj_body
    goal = jnp.asarray(task.goal_pos)

    @jax.jit
    def rows_of(es):
        q, qd = es.phys.q, es.phys.qd
        finite = jnp.isfinite(q.sum(-1) + qd.sum(-1))
        return jnp.stack([
            es.done * 1.0, es.timeout * 1.0, finite * 1.0,
            jnp.linalg.norm(q[:, qa:qa + 3] - goal, axis=-1), es.reward,
            es.carry["reset_goal"] * 1.0,
            jnp.linalg.norm(es.phys.body_lvel[:, b], axis=-1),
            jnp.linalg.norm(es.phys.body_avel[:, b], axis=-1)])

    tally = Tally(n, task.fall_dist)
    es = env.reset(seed=seed)
    t0 = time.perf_counter()
    for t in range(steps):
        a = policy(t, lambda: torch.as_tensor(np.asarray(es.obs)))
        es = env.step(es, jnp.asarray(a))
        tally.add(np.asarray(rows_of(es), np.float64))
    return dict(tally.result(), seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv)
    overrides = [a for a in argv if a.startswith("task.")]
    runs = args.get("runs", "jax,port").split(",")
    n, steps = int(args.get("num_envs", 256)), int(args.get("steps", 150))
    seed = int(args.get("seed", 0))
    unknown = [r for r in runs if r not in ("jax", "port") + CARD_RUNS]
    if unknown:
        raise ValueError(f"unknown runs {unknown}")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    policy_name = (f"checkpoint={args['checkpoint']} mode={args.get('mode', 'sample')}"
                   if "checkpoint" in args else args.get("policy", "hold:4"))
    out = dict(task=TASK, policy=policy_name, num_envs=n, steps=steps, seed=seed,
               overrides=overrides,
               eject_lin=EJECT_LIN, eject_ang=EJECT_ANG, eject_window=EJECT_WINDOW,
               runs={})
    if any(r in CARD_RUNS for r in runs):
        if not torch.cuda.is_available():
            raise SystemExit("the card's runs need a CUDA card")
        from chip_smoke import card_line

        out["card"] = card_line()
        out["torch"] = torch.__version__
    for r in runs:
        dev = "cuda" if r in CARD_RUNS else "cpu"
        policy = make_policy(args, n, dev)
        if r == "jax":
            res = run_jax(n, steps, policy, seed, overrides)
        else:
            res = run_port(n, steps, policy, seed, dev, None if r == "port" else r,
                           overrides)
        out["runs"][r] = res
        print(f"{r}: " + ", ".join(f"{k} {v['count']}" for k, v in res["rates"].items())
              + f"; {res['seconds']:.1f} s; per env " + "; ".join(
                  f"{k} {v['total']} in {v['envs']} envs, top {v['top_share']:.3f}"
                  for k, v in res["per_env"].items()), file=sys.stderr, flush=True)
    names = list(out["runs"])
    out["pairs"] = {f"{a}-{b}": compare(out["runs"][a], out["runs"][b])
                    for i, a in enumerate(names) for b in names[i + 1:]}
    text = json.dumps(out)
    if "out" in args:
        os.makedirs(os.path.dirname(os.path.abspath(args["out"])), exist_ok=True)
        with open(args["out"], "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
