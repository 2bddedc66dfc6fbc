"""Where one learner epoch of AllegroHand from a trained state parts card
against CPU (fault C4's full-width arm, chip_smoke.py phase 17).

    python tools/learner_card_cpu.py [checkpoint=results_torch/AllegroHand_seed1] \
        [num_envs=8192] [seed=0] [draws=1] [out=FILE]

Each draw builds the trainer as phase 17 builds it (the CLI's
`build_trainer`, exact f32 networks) with seed `seed` + the draw's index,
and makes one rollout on the card through K1. On that stored rollout, with
one set of permutations:
- the epoch (`_learn`) runs three times apart: on the card in f32, on the
  CPU in f32 and on the CPU in f64 (the networks, the learner state and
  the rollout cast to float64, new tensors float64 by default). Every
  minibatch's loss terms and the lr after it are recorded
  (`chip_smoke.traced_learner`), and after each Adam step every parameter;
  then, per minibatch and for each pair of the three, the largest gap of
  each loss term (relative to the f64 run's) and of the parameters (the
  norm of the difference over the norm of the f64 run's movement since the
  epoch began, worst tensor), and after how many minibatches the card
  stands farther from f64 than the CPU's f32 does;
- the f64 epoch once more, and at each of its steps the same step in f32
  from its state of that moment on the card and on the CPU
  (`chip_smoke.learner_step_from`): each side's error of one step against
  f64 (worst tensor, named), and the ratio card / CPU. An epoch run apart
  grows whatever rounding enters it; a single step from a shared state
  shows what each side's arithmetic puts in.
On the first draw, before the epochs, the gradient of the first minibatch
at the epoch's start is held against its f64 value on each side, also with
the minibatch in 8 equal parts (`first_gradients`): which reduction carries
the error. Prints a line per draw to stderr and one JSON object (also
written to `out=`). Needs a CUDA card (`device=cpu` runs every side on the
CPU).
"""

from __future__ import annotations

import copy
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIDES = ("card", "cpu", "f64")
PAIRS = (("card", "cpu"), ("card", "f64"), ("cpu", "f64"))


def _side(trainer, device):
    tr = copy.copy(trainer)
    tr.device = torch.device(device)
    return tr


def run_side(trainer, rollout, perms, device, dtype):
    """One `_learn` of a copy of the trainer's state on `device` in `dtype`:
    (per-minibatch trace, per-step parameters as f64 CPU tensors, metrics)."""
    import chip_smoke as cs

    tr = _side(trainer, device)
    st = cs.state_to(trainer.state, device, dtype)
    st.ac.dtype = None
    st.ac.matmul = st.ac.trunk.matmul = "f32"
    steps = []

    def after(row, params, state):
        steps.append([p.detach().to("cpu", torch.float64).clone() for p in params])

    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        traj, last_value, stats = (cs.state_to(x, device, dtype) for x in rollout)
        with cs.traced_learner(tr, after_step=after) as rows:
            m = tr._learn(st, traj, last_value, stats, perms=perms.to(device))
    finally:
        torch.set_default_dtype(old)
    return rows, steps, {k: float(v) for k, v in m.items()}


def steps_from_f64(trainer, rollout, perms, device):
    """The f64 epoch on the CPU, and at each of its minibatch steps the same
    step in f32 from its state of that moment (`chip_smoke.learner_step_from`)
    on the card (`device`) and on the CPU. Per step and side: the step's
    error against the f64 step (the norm of the difference over the norm of
    the f64 step, worst tensor, and that tensor's name) and the loss terms'
    gaps relative to the f64 terms."""
    import chip_smoke as cs

    tr = _side(trainer, "cpu")
    st = cs.state_to(trainer.state, "cpu", torch.float64)
    st.ac.dtype = None
    st.ac.matmul = st.ac.trunk.matmul = "f32"
    names = [k for k, _ in st.ac.named_parameters()]
    sides = {"card": (_side(trainer, device), copy.deepcopy(st.ac).to(device, torch.float32)),
             "cpu": (_side(trainer, "cpu"), copy.deepcopy(st.ac).to("cpu", torch.float32))}
    out, held = [], {}

    def before(row, stash, params, state, lr, max_norm):
        held["before"] = [p.detach().clone() for p in params]
        held["terms"] = {k: cs.learner_step_from(t, net, stash, params, state, lr, max_norm)[0]
                         for k, (t, net) in sides.items()}

    def after(row, params, state):
        entry = {}
        for k, (_, net) in sides.items():
            errs = [(float((g.detach().to("cpu", torch.float64) - p.detach()).norm()
                           / (p.detach() - b).norm().clamp_min(1e-300)), n)
                    for n, g, p, b in zip(names, net.parameters(), params, held["before"])]
            terms = {t: abs(v - row[t]) / max(abs(row[t]), 1e-12)
                     for t, v in held["terms"][k].items()}
            entry[k] = dict(step=max(errs)[0], tensor=max(errs)[1], terms=terms)
        out.append(entry)

    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        traj, last_value, stats = (cs.state_to(x, "cpu", torch.float64) for x in rollout)
        with cs.traced_learner(tr, before, after):
            tr._learn(st, traj, last_value, stats, perms=perms.cpu())
    finally:
        torch.set_default_dtype(old)
    return out


def first_gradients(trainer, rollout, perms, device, dtype, chunks=1):
    """The gradient of the epoch's first minibatch loss at the epoch's
    start, on `device` in `dtype`, as `_learn` reaches it (GAE, the value
    norm, the advantages' moments, the minibatch gather); with `chunks` > 1
    the minibatch's samples in that many equal parts, the mean of their
    gradients (each product's reduction over the batch `chunks` times
    shorter). Returns the gradients as f64 CPU tensors."""
    import chip_smoke as cs
    from omniisaacgymenvs_torch.learn import ppo
    from omniisaacgymenvs_torch.parallel import mesh

    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        tr = _side(trainer, device)
        st = cs.state_to(trainer.state, device, dtype)
        traj, last_value, _ = (cs.state_to(x, device, dtype) for x in rollout)
        st.ac.dtype = None
        st.ac.matmul = st.ac.trunk.matmul = "f32"
        advs, returns = tr._gae(traj, last_value)
        traj = dict(traj, adv=advs, ret=returns)
        st.value_norm = st.value_norm.update(returns)
        dataset, _, num_slices, mb_slices = tr._datasets(traj)
        am, av = mesh.moments(advs.reshape(-1))
        idx = perms.to(device)[0, :mb_slices]
        take = ppo._minibatch_taker(dataset)
        params = list(st.ac.parameters())
        total = None
        for part in idx.chunk(chunks):
            loss, _ = tr._loss(st, take(part), am, torch.sqrt(av))
            g = torch.autograd.grad(loss, params)
            total = list(g) if total is None else [a + b for a, b in zip(total, g)]
        return [(t / chunks).detach().to("cpu", torch.float64) for t in total]
    finally:
        torch.set_default_dtype(old)


def one_draw(tr, device, gradients):
    """One rollout through the trainer and one set of permutations: the
    three epochs run apart, the steps from the f64 epoch's state and, where
    `gradients`, the first minibatch's gradient against f64."""
    rollout = tr._rollout(tr.state)
    S, _ = tr._slices()
    perms = tr._perms(tr.cfg.mini_epochs, S)
    names = [k for k, _ in tr.state.ac.named_parameters()]
    grad_err = {}
    if gradients:
        g64 = first_gradients(tr, rollout, perms, "cpu", torch.float64)
        for label, dev, chunks in (("card", device, 1), ("card_chunks8", device, 8),
                                   ("cpu", "cpu", 1), ("cpu_chunks8", "cpu", 8)):
            g = first_gradients(tr, rollout, perms, dev, torch.float32, chunks)
            grad_err[label] = {n: float((a - b).norm() / b.norm())
                               for n, a, b in zip(names, g, g64)}
    init = [p.detach().to("cpu", torch.float64) for p in tr.state.ac.parameters()]
    res = {s: run_side(tr, rollout, perms, dev, dt) for s, dev, dt in (
        ("card", device, torch.float32), ("cpu", "cpu", torch.float32),
        ("f64", "cpu", torch.float64))}
    rows64, steps64, _ = res["f64"]
    per_mb = []
    for i in range(len(rows64)):
        entry = {"f64": rows64[i]}
        for a, b in PAIRS:
            ra, rb = res[a][0][i], res[b][0][i]
            terms = {k: abs(ra[k] - rb[k]) / max(abs(rows64[i][k]), 1e-12) for k in rb}
            params = max(float((pa - pb).norm() / max(float((p64 - p0).norm()), 1e-30))
                         for pa, pb, p64, p0 in zip(res[a][1][i], res[b][1][i],
                                                    steps64[i], init))
            entry[f"{a}-{b}"] = dict(terms=terms, params=params)
        per_mb.append(entry)
    steps = steps_from_f64(tr, rollout, perms, device)
    return dict(first_gradient=grad_err, metrics={s: res[s][2] for s in SIDES},
                per_minibatch=per_mb, steps_from_f64=steps,
                final={f"{a}-{b}": per_mb[-1][f"{a}-{b}"]["params"] for a, b in PAIRS},
                farther={"card": sum(e["card-f64"]["params"] > e["cpu-f64"]["params"]
                                     for e in per_mb),
                         "of": len(per_mb)},
                step_ratio=[e["card"]["step"] / max(e["cpu"]["step"], 1e-30) for e in steps])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv)
    import chip_smoke as cs
    from omniisaacgymenvs_torch.scripts.train import build_trainer

    device = args.get("device", "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    ck = args.get("checkpoint", "results_torch/AllegroHand_seed1")
    extra = [a for a in argv if a.startswith("train.")]
    draws = []
    for d in range(int(args.get("draws", 1))):
        # each draw a trainer of its own seed: its resets, action noise and
        # permutations
        seed = int(args.get("seed", 0)) + d
        _, _, tr = build_trainer([
            "task=AllegroHand", f"num_envs={args.get('num_envs', 8192)}",
            f"device={device}", f"seed={seed}", f"checkpoint={os.path.join(ROOT, ck)}",
            "train.params.config.net_matmul=f32", *extra])
        r = dict(seed=seed, **one_draw(tr, device, gradients=d == 0))
        draws.append(r)
        print(f"draw {d} (seed {seed}): final params against f64 card "
              f"{r['final']['card-f64']:.3e}, cpu {r['final']['cpu-f64']:.3e}; the card "
              f"farther from f64 after {r['farther']['card']} of {r['farther']['of']} "
              f"minibatches; a step from the f64 state, card / cpu error against f64: "
              + " ".join(f"{e['card']['step']:.2e}/{e['cpu']['step']:.2e}"
                         for e in r["steps_from_f64"]), file=sys.stderr)
    out = dict(checkpoint=ck, num_envs=tr.env.num_envs, samples=tr._slices()[0],
               card=cs.card_line() if device == "cuda" else "cpu",
               torch=torch.__version__, draws=draws)
    text = json.dumps(out)
    if "out" in args:
        os.makedirs(os.path.dirname(os.path.abspath(args["out"])), exist_ok=True)
        with open(args["out"], "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
