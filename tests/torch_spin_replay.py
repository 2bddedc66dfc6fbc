"""Where AllegroHand's cube parts between the JAX package's env and the port's
under a trained policy, substep by substep, on the CPU (fault C4).

    python tests/torch_spin_replay.py from=build/c4/AllegroHand_seed1_mean.json \
        [top=3] [steps=3] [closed=K] [out=FILE]
    python tests/torch_spin_replay.py checkpoint=DIR mode=mean envs=17:233,40:12 ...

`from=` reads a `tests/torch_fall_rates.py` result of `runs=jax,...` and
takes its policy, env count and seed, and the `top` envs of the JAX run
that count the most angular ejections (cube past EJECT_ANG), each with the
step of its first one; `envs=ENV:STEP,...` names them instead.

The JAX env runs that policy again (the same noise from numpy) and keeps
its state before the step of each env's first ejection. From that state,
carried into the port as numpy arrays (`convert.env_state_from_arrays`),
both packages' engines run the next `steps` control steps on the same
controls (the port's `control` on the JAX state of each step and the JAX
run's action: the hand's targets do not depend on the physics) one plain
substep at a time, 16 a control step: the JAX engine's `_substep` (its XLA
path, the one its env takes on the CPU) and the port's
(`fused_step.substep_plain`). After each substep the cube's coordinates
(position, quaternion sign-aligned) and velocities (angular, linear) are
held to tests/test_torch_tasks.py's rule (rtol 2e-3, atol 2e-3); the first
substep past it is where the packages part. The same is done for the port
against itself from the state nudged by `parity.COND_EPS` (every
coordinate up): where that parts as early, the step amplifies rounding,
and `parity.well_conditioned` says so for each control step's start.

`closed=K` then asks whether the port's engine keeps such a cube spinning
as the JAX one does: from the same state, as it is and nudged by
`parity.COND_EPS` in each of `parity.COND_DIRECTIONS`, each package steps
its env K control steps under the policy acting on its own observations,
and counts the steps whose cube spins past EJECT_ANG before the episode
ends.

Prints one JSON object (and writes it to `out=`): per env, the step, the
first parting substep of JAX against the port and of the port against its
nudge, each control step's conditioning, and the cube's angular speed at
each control step's end in both packages.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

RULE = dict(rtol=2e-3, atol=2e-3)   # tests/test_torch_tasks.py OBS_TOL
ENV_FIELDS = ("phys", "carry", "obs", "states", "reward", "done", "timeout",
              "progress", "metrics")


def pick_envs(result: dict, top: int):
    """[(env, first step)] of the JAX run's `top` envs by angular ejections."""
    spread = result["runs"]["jax"]["per_env"]["ejections_ang"]
    return [(r["env"], r["first_step"]) for r in spread["top"][:top]]


def jax_states(args: dict, n: int, seed: int, wanted: set, last: int):
    """The JAX env under the run's policy: {step t: (state before step t as
    numpy fields, action of step t)} for t in `wanted`, stepping to `last`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from omniisaacgymenvs_tpu.scripts.common import build_env_from_cli
    from torch_fall_rates import TASK, make_policy
    from torch_parity import to_numpy_tree

    _, _, env = build_env_from_cli([f"task={TASK}", f"num_envs={n}", "pipeline=cpu",
                                    f"seed={seed}"])
    policy = make_policy(args, n, "cpu")
    es = env.reset(seed=seed)
    out = {}
    for t in range(last + 1):
        a = policy(t, lambda: torch.as_tensor(np.array(es.obs)))
        if t in wanted:
            out[t] = ({k: to_numpy_tree(getattr(es, k)) for k in ENV_FIELDS}, a, es)
        es = env.step(es, jnp.asarray(a))
    return env, out


def closed_loop(jenv, penv, policy, state, env: int, steps: int) -> dict:
    """The env's state (`state`: numpy fields, action, the JAX EnvState)
    in 1 + len(COND_DIRECTIONS) copies, as it is and nudged by COND_EPS in
    each direction, stepped `steps` control steps in both packages, each
    under the policy acting on its own observations: per copy, the steps
    whose cube spins past EJECT_ANG before its episode ends, and the step it
    ends at (None: it did not)."""
    import jax
    import jax.numpy as jnp
    import torch

    from omniisaacgymenvs_torch import convert
    from omniisaacgymenvs_torch.ops import parity
    from torch_fall_rates import EJECT_ANG

    fields, _, jes = state
    n = np.asarray(fields["done"]).shape[0]
    idx = np.full(1 + len(parity.COND_DIRECTIONS), env)

    def take(x):
        return x[idx] if getattr(x, "ndim", 0) and x.shape[0] == n else x

    def nudged(x):
        x = torch.as_tensor(np.array(x))
        out = x.clone()
        for k, d in enumerate(parity.COND_DIRECTIONS, 1):
            out[k] = parity.cond_nudge(x, d)[k]
        return out

    jes = jax.tree.map(take, jes)
    q, qd = nudged(jes.phys.q), nudged(jes.phys.qd)
    jes = jes.replace(phys=jes.phys.replace(q=jnp.asarray(q.numpy()),
                                            qd=jnp.asarray(qd.numpy())))
    pes = convert.env_state_from_arrays(jax.tree.map(take, fields), device="cpu")
    pes.phys.q, pes.phys.qd = q.clone(), qd.clone()
    body = penv.task._obj_body
    out = {}
    for name, es, step, ang in (
            ("jax", jes, lambda e, a: jenv.step(e, jnp.asarray(a)),
             lambda e: np.linalg.norm(np.asarray(e.phys.body_avel)[:, body], axis=-1)),
            ("port", pes, lambda e, a: penv.step(e, torch.as_tensor(a)),
             lambda e: torch.linalg.norm(e.phys.body_avel[:, body], dim=-1).numpy())):
        alive = np.ones(len(idx), bool)
        spins, ends = np.zeros(len(idx), int), [None] * len(idx)
        for t in range(steps):
            es = step(es, policy(t, lambda: torch.as_tensor(np.array(es.obs))))
            spins += alive & (ang(es) > EJECT_ANG)
            done = np.asarray(es.done, bool)
            for k in np.flatnonzero(alive & done):
                ends[k] = t + 1
            alive &= ~done
        out[name] = dict(spins=spins.tolist(), ends=ends)
    return out


def cube(q, qd, qa, va):
    """The cube's [pos, quat] and [angular, linear velocity], numpy."""
    q, qd = np.asarray(q, np.float64), np.asarray(qd, np.float64)
    return q[..., qa:qa + 7], qd[..., va:va + 6]


def parted(a, b) -> bool:
    """Past the rule, the quaternions sign-aligned."""
    (qa_, va_), (qb, vb) = a, b
    qa_ = qa_.copy()
    if np.dot(qa_[3:7], qb[3:7]) < 0:
        qa_[3:7] *= -1
    x, y = np.concatenate([qa_, va_]), np.concatenate([qb, vb])
    return not np.allclose(x, y, **RULE)


def replay(jtask, task, states, env: int, t0: int, steps: int) -> dict:
    """One env from the JAX state before step t0, `steps` control steps."""
    import jax
    import jax.numpy as jnp
    import torch

    from omniisaacgymenvs_torch import convert
    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_tpu.physics.state import Control as JControl

    jeng, eng = jtask.engine, task.engine
    m = eng.model
    qa, va = m.root_q_adr("object"), m.root_v_adr("object")
    h = jeng.params.dt / jeng.params.substeps
    n_sub = task.decimation * eng.params.substeps
    gen = torch.Generator().manual_seed(0)

    @jax.jit
    @jax.vmap
    def jsub(q, qd, eff, ptg, vtg, fa):   # the JAX engine steps one env
        ctrl = JControl(effort=eff, pos_target=ptg, vel_target=vtg,
                        body_force=fa[:, 3:6], body_torque=fa[:, 0:3])
        return jeng._substep(q, qd, ctrl, fa, h)[:2]

    fields = states[t0][0]
    es = convert.env_state_from_arrays(fields, device="cpu")
    sl = slice(env, env + 1)
    q = es.phys.q[sl].clone()
    qd = es.phys.qd[sl].clone()
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    nq, nqd = parity.cond_nudge(q, "+"), parity.cond_nudge(qd, "+")
    first = dict(jax=None, nudge=None)
    rec = []
    for k in range(steps):
        t = t0 + k
        fields, action, _ = states[t]
        if bool(fields["done"][env]) and k > 0:
            break
        es = convert.env_state_from_arrays(fields, device="cpu")
        es = task.pre_physics(es, gen)
        a = torch.clamp(torch.as_tensor(action), -task.clip_actions, task.clip_actions)
        ctrl = task.control(a, es, gen)
        fa = torch.cat([ctrl.body_torque, ctrl.body_force], dim=-1)[sl]
        ins = (ctrl.effort[sl], ctrl.pos_target[sl], ctrl.vel_target[sl], fa)

        def run_plain(q_, qd_):
            return fs.step_plain(eng, q_, qd_, *ins, n_sub)

        keep = parity.well_conditioned(run_plain, q, qd, run_plain(q, qd),
                                       parity.STEP_NAMES, parity.step_tol(m),
                                       max_excluded=1.0)
        jins = tuple(jnp.asarray(x.numpy()) for x in ins)
        for s in range(n_sub):
            q, qd, _ = fs.substep_plain(eng, q, qd, *ins)
            nq, nqd, _ = fs.substep_plain(eng, nq, nqd, *ins)
            jq, jqd = jsub(jq, jqd, *jins)
            port = cube(q[0], qd[0], qa, va)
            for name, other in (("jax", cube(jq[0], jqd[0], qa, va)),
                                ("nudge", cube(nq[0], nqd[0], qa, va))):
                if first[name] is None and parted(port, other):
                    first[name] = k * n_sub + s + 1
        jc, pc = cube(jq[0], jqd[0], qa, va), cube(q[0], qd[0], qa, va)
        rec.append(dict(
            step=t, well_conditioned=bool(keep[0]),
            ang_speed=dict(jax=float(np.linalg.norm(jc[1][:3])),
                           port=float(np.linalg.norm(pc[1][:3]))),
            lin_speed=dict(jax=float(np.linalg.norm(jc[1][3:])),
                           port=float(np.linalg.norm(pc[1][3:]))),
            gap=float(np.abs(np.concatenate(jc) - np.concatenate(pc)).max())))
    return dict(env=env, step=t0, substeps_a_step=n_sub, first_parting_substep=first,
                steps=rec)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv)
    import torch

    from omniisaacgymenvs_torch.scripts.common import build_env_from_cli
    from torch_fall_rates import TASK, make_policy

    torch.set_num_threads(min(4, torch.get_num_threads()))
    steps = int(args.get("steps", 3))
    if "from" in args:
        with open(args["from"]) as f:
            res = json.load(f)
        policy = res["policy"]
        if policy.startswith("checkpoint="):
            ck, mode = policy.split()
            args.setdefault("checkpoint", ck.split("=", 1)[1])
            args.setdefault("mode", mode.split("=", 1)[1])
        else:
            args.setdefault("policy", policy)
        args.setdefault("num_envs", str(res["num_envs"]))
        args.setdefault("seed", str(res["seed"]))
        picks = pick_envs(res, int(args.get("top", 3)))
    else:
        picks = [tuple(int(x) for x in e.split(":")) for e in args["envs"].split(",")]
    n, seed = int(args.get("num_envs", 512)), int(args.get("seed", 0))
    # the state before each first ejection and the steps after it
    wanted = {t + k for _, t in picks for k in range(steps)}
    jenv, states = jax_states(args, n, seed, wanted, max(wanted))
    _, task, penv = build_env_from_cli([f"task={TASK}", f"num_envs={n}", "device=cpu",
                                        f"seed={seed}"])
    closed = int(args.get("closed", 0))
    policy = make_policy(args, n, "cpu")
    out = dict(policy=args.get("checkpoint", args.get("policy")), mode=args.get("mode"),
               num_envs=n, seed=seed, rule=RULE, closed_steps=closed, envs=[])
    for env, t0 in picks:
        r = replay(jenv.task, task, states, env, t0, steps)
        if closed:
            r["closed_loop"] = closed_loop(jenv, penv, policy, states[t0], env, closed)
        out["envs"].append(r)
        print(f"env {env} from step {t0}: first parting substep {r['first_parting_substep']}"
              f", conditioning {[s['well_conditioned'] for s in r['steps']]}"
              + (f", closed loop {r['closed_loop']}" if closed else ""),
              file=sys.stderr, flush=True)
    text = json.dumps(out)
    if "out" in args:
        os.makedirs(os.path.dirname(os.path.abspath(args["out"])), exist_ok=True)
        with open(args["out"], "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
