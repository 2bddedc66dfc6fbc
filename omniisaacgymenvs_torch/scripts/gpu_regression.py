"""GPU regression checks of the kernels, run on the card after any kernel
change (the port's counterpart of the JAX package's
scripts/tpu_regression.py).

    python -m omniisaacgymenvs_torch.scripts.gpu_regression [check ...] [device=cpu]

Prints ONE JSON line, {"ok": bool, "checks": {name: {..., "ok": bool}}},
and exits 1 unless every check is ok. A check that raises is reported as
{"ok": false, "error": ...}. Runs on CUDA unless device=cpu is given;
on the CPU the kernel wrappers run their plain versions, so there the
checks hold the harness itself, not the kernels.

Checks (all by default):
  sqrt_branch        - the card's float32 sqrt of 1e-18 (reported); the
                       kernels' nvcc flags hold no fast-math switch; and one
                       K1 launch of one substep on the box rest scene
                       (ops/parity.build_rest_scene) with the ball's point
                       inside the box: its contact force must be the plain
                       version's, not zero (a point classified outside).
  pair_rest          - the box rest scene at 256 envs, the ball just above
                       the box top (z0 0.555): one K1 launch of 32 substeps
                       against the plain path over the same substeps; neither
                       may sink through the box.
  pair_rest_interior - the same with the ball's point starting inside the
                       box (z0 0.52): the interior branch through the kernel.
  shadowhand         - a 40-step random-policy ShadowHand rollout at 128
                       envs through VecEnv: K1 once per control step, and a
                       reset rate below 0.02 per env-step (a cube falling
                       through the palm gives some 0.05).
  ballbalance        - a 40-step random-policy BallBalance rollout at 128
                       envs: K1 once per control step, finite observations.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import torch

from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.scripts.random_policy import uniform_policy
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config, parse_cli
from omniisaacgymenvs_torch.utils.device import resolve_device

CHECKS = ("sqrt_branch", "pair_rest", "pair_rest_interior", "shadowhand",
          "ballbalance")
# nvcc switches that approximate sqrt or flush denormals to zero
FAST_MATH_FLAGS = ("--use_fast_math", "-use_fast_math", "-prec-sqrt=false",
                   "--prec-sqrt=false", "-ftz=true", "--ftz=true")
REST_ENVS, REST_SUBSTEPS = 256, 32
# the box's top is at z 0.54 and the point's radius 0.03: 0.555 settles
# through the outside branch, 0.52 starts inside the box
REST_Z0, INTERIOR_Z0 = 0.555, 0.52
# the TPU harness's bounds: the ball's lowest z (a fall-through ends well
# below the box top) and the largest |q kernel - q plain|
REST_MIN_Z, REST_MAX_DQ = 0.52, 5e-2
# the contact force of a point inside the box is hundreds of newtons; one
# classified outside gets none
MIN_INTERIOR_FORCE = 1.0
ROLLOUT_STEPS, ROLLOUT_ENVS = 40, 128
MAX_RESET_RATE = 0.02


def _rest_inputs(m, n: int, z0: float, device):
    """(q, qd, effort, pos_target, vel_target, f_applied) of n envs of a
    rest scene at rest, the ball's centre at height z0."""
    q = m.default_q.to(device).repeat(n, 1)
    q[:, m.q_adr[m.body_index("ball")] + 2] = z0
    z = torch.zeros((n, m.njd), device=device)
    return (q, torch.zeros((n, m.nv), device=device), z, z.clone(), z.clone(),
            torch.zeros((n, m.nb, 6), device=device))


def _k1_launches(engine) -> int | None:
    return None if engine.kernels is None else engine.kernels.launches["step"]


def check_sqrt_branch(device) -> dict:
    """Documents the card's sqrt of 1e-18 and shows that the kernel's
    inside / outside decision does not rest on it: a point inside the box
    keeps its contact force."""
    s = float(torch.sqrt(torch.tensor(1e-18, dtype=torch.float32, device=device)))
    bad_flags = [f for f in fs.NVCC_FLAGS if f in FAST_MATH_FLAGS]
    m, eng = parity.build_rest_scene("box", device)
    ins = _rest_inputs(m, 1, INTERIOR_Z0, device)
    before = _k1_launches(eng)
    out = fs.step(eng, *ins, 1)
    ref = fs.step_plain(eng, *ins, 1)
    b = m.body_index("ball")
    g = torch.tensor(eng.params.gravity, device=device)
    # the ball starts at rest: its contact force is m (dv / h - g)
    force, force_plain = (float(m.body_mass[b]) * (x[6][0, b] / eng.h - g)
                          for x in (out, ref))
    err = float((force - force_plain).abs().max())
    fz, fz_plain = float(force[2]), float(force_plain[2])
    launched = None if before is None else _k1_launches(eng) - before
    ok = (not bad_flags and fz_plain > MIN_INTERIOR_FORCE
          and err <= 1e-3 * abs(fz_plain) + 1e-2 and launched in (None, 1))
    return {"sqrt_1e18": s, "sqrt_gt_1e9": s > 1e-9, "nvcc_fast_math": bad_flags,
            "interior_force_z": fz, "interior_force_z_plain": fz_plain,
            "force_abs_err": err, "interior_misclassified": abs(fz) < MIN_INTERIOR_FORCE,
            "k1_launches": launched, "ok": ok}


def check_pair_rest(device, z0: float = REST_Z0) -> dict:
    """The box rest scene at REST_ENVS envs, the ball's centre at z0: one K1
    launch of REST_SUBSTEPS substeps against the plain path over the same
    substeps. Beside the TPU harness's bounds, the reading against
    ops/parity.py's K1 limits (`limit_use`, a finding: not held)."""
    m, eng = parity.build_rest_scene("box", device)
    ins = _rest_inputs(m, REST_ENVS, z0, device)
    before = _k1_launches(eng)
    out = fs.step(eng, *ins, REST_SUBSTEPS)
    ref = fs.step_plain(eng, *ins, REST_SUBSTEPS)
    launched = None if before is None else _k1_launches(eng) - before
    zi = m.q_adr[m.body_index("ball")] + 2
    z_kernel, z_plain = float(out[0][:, zi].min()), float(ref[0][:, zi].min())
    dq = float((out[0] - ref[0]).abs().max())
    res = parity.compare(out, ref, parity.STEP_NAMES, parity.step_tol(m))
    worst = max(res, key=lambda k: res[k][1])
    ok = (z_kernel > REST_MIN_Z and z_plain > REST_MIN_Z and dq < REST_MAX_DQ
          and launched in (None, 1))
    return {"z0": z0, "envs": REST_ENVS, "substeps": REST_SUBSTEPS,
            "z_kernel": z_kernel, "z_plain": z_plain, "max_dq": dq,
            "limit_use": res[worst][1], "limit_use_field": worst,
            "k1_launches": launched, "ok": ok}


def check_pair_rest_interior(device) -> dict:
    return check_pair_rest(device, z0=INTERIOR_Z0)


def _rollout(name: str, device) -> dict:
    """A ROLLOUT_STEPS-step random-policy rollout of `name` (its yaml) at
    ROLLOUT_ENVS envs: resets, K1 launches against one per control step
    (the engine's counter), finite observations."""
    task = get_task(name, load_config({"task": name})["task"], device=device)
    env = VecEnv(task, ROLLOUT_ENVS, seed=0)
    eng = task.engine
    es = env.reset(seed=0)
    policy = uniform_policy(env.num_actions)
    before = _k1_launches(eng)
    resets = torch.zeros((), dtype=torch.int64, device=device)
    finite = torch.ones((), dtype=torch.bool, device=device)
    t0 = time.perf_counter()
    for _ in range(ROLLOUT_STEPS):
        es = env.step(es, policy(es.obs, env.generator))
        resets += es.done.sum()
        finite &= torch.isfinite(es.obs).all()
    launched = None if before is None else _k1_launches(eng) - before
    want = ROLLOUT_STEPS * eng.k1_launches(task.decimation)
    return {"envs": ROLLOUT_ENVS, "steps": ROLLOUT_STEPS, "resets": int(resets),
            "finite_obs": bool(finite), "k1_launches": launched,
            "k1_expected": want, "k1_exact": launched in (None, want),
            "elapsed_s": time.perf_counter() - t0}


def check_shadowhand(device) -> dict:
    r = _rollout("ShadowHand", device)
    r["reset_rate"] = r["resets"] / (r["steps"] * r["envs"])
    r["ok"] = r["k1_exact"] and r["finite_obs"] and r["reset_rate"] < MAX_RESET_RATE
    return r


def check_ballbalance(device) -> dict:
    r = _rollout("BallBalance", device)
    r["ok"] = r["k1_exact"] and r["finite_obs"]
    return r


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = [a for a in argv if "=" not in a] or list(CHECKS)
    unknown = [n for n in which if n not in CHECKS]
    if unknown:
        raise SystemExit(f"unknown checks {unknown}; the checks are {CHECKS}")
    device = resolve_device(parse_cli([a for a in argv if "=" in a]).get("device"))
    checks = {}
    for name in which:
        try:
            checks[name] = globals()["check_" + name](device)
        except Exception as e:  # a crash is a failed check, reported
            traceback.print_exc()
            checks[name] = {"ok": False, "error": repr(e)[:300]}
    ok = all(c.get("ok") for c in checks.values())
    print(json.dumps({"ok": ok, "checks": checks}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
