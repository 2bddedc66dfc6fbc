"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit, and the nvcc build of the kernels
     (registers and spills as ptxas reports them);
  2. K1 (whole control step) against its plain version on the card:
     Humanoid, 32768 + 37 envs (the last block partly masked), 4 substeps,
     states near default_q with some contact points in the ground;
  3. K2 (report FK) against its plain version on the same states;
  4. the main path: the random-policy entry point's Humanoid VecEnv at
     32768 envs, reset and a 64-step rollout, with the launch counts read
     around it (K1 exactly once per control step, K2 at least as often);
     the rollout's rate over repeated runs; a short rollout on the card
     against the plain path on the CPU;
  5. K1 / K2 against their plain versions again at 32768 envs, and their
     times there (CUDA events) beside the plain versions' and the roofline
     bound.
Tolerances and check states come from omniisaacgymenvs_torch/ops/parity.py.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
# outside the tensor cores, FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

N_MAIN = 32768
N_CHECK = N_MAIN + 37  # not a multiple of the kernels' 128-thread block
STEPS = 64
RATE_RUNS = 5  # untraced rollouts timed for the rate's spread
N_SUB = 4  # Humanoid: decimation 2 x substeps 2
# end to end, kernel path on the card vs plain path on the CPU, 3 steps
E2E_TOL = (5e-3, 5e-3)


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
    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.physics import rotations as rot
    from omniisaacgymenvs_torch.physics.engine import PhysicsEngine
    from omniisaacgymenvs_torch.scripts import random_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib = fs.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_s:.2f} s) -> {lib.path.name}")
    for line in lib.ptxas_log.splitlines():
        if any(k in line for k in ("registers", "spill", "stack frame",
                                   "Compiling entry")):
            log(f"  ptxas: {line.strip()}")

    # ---- 2./3. kernels against their plain versions ----
    from omniisaacgymenvs_torch.tasks import get_task

    task = get_task("Humanoid", device=dev)
    eng: PhysicsEngine = task.engine
    m = eng.model
    q, qd, eff = parity.check_inputs(m, N_CHECK, seed=0, device=dev)
    z = torch.zeros((N_CHECK, m.njd), device=dev)
    fa = torch.zeros((N_CHECK, m.nb, 6), device=dev)
    pos0, quat0, _, _ = fs.fk_plain(m, q, qd)
    cb = torch.as_tensor(m.cp_body, dtype=torch.long, device=dev)
    pt = pos0[:, cb] + (rot.quat_to_rotmat(quat0[:, cb])
                        @ m.cp_pos[..., None])[..., 0]
    n_pen = int((pt[..., 2] < m.cp_radius).sum())
    log(f"K1 check: {N_CHECK} envs, {N_SUB} substeps, {n_pen} contact "
        f"points in the ground")
    assert n_pen > 0, "the check states must put contact points in the ground"
    k1 = fs.step(eng, q, qd, eff, z, z, fa, N_SUB)
    p1 = fs.step_plain(eng, q, qd, eff, z, z, fa, N_SUB)
    torch.cuda.synchronize()
    err1 = parity.assert_within(
        "K1", parity.compare(k1, p1, parity.STEP_NAMES, parity.STEP_TOL),
        parity.STEP_TOL, log)
    k2 = fs.fk(eng, q, qd)
    p2 = fs.fk_plain(m, q, qd)
    torch.cuda.synchronize()
    err2 = parity.assert_within(
        "K2", parity.compare(k2, p2, parity.FK_NAMES, parity.FK_TOL),
        parity.FK_TOL, log)
    del q, qd, eff, z, fa, k1, p1, k2, p2, pos0, quat0, pt

    # ---- 4. the main path ----
    argv = ["task=Humanoid", f"num_envs={N_MAIN}", f"max_iterations={STEPS}",
            "seed=0", "device=cuda"]
    cfg, mtask, env = random_policy.build_env(argv)
    kern = mtask.engine.kernels
    kern.reset_counts()
    stats = random_policy.drive(cfg, env)
    launches = dict(kern.launches)
    log(f"main path: {card} | Humanoid {N_MAIN} envs x {STEPS} steps: "
        f"{stats['env_steps_per_s']:.1f} env-steps/s, "
        f"{stats['seconds'] * 1e3 / STEPS:.3f} ms per control step, "
        f"mean reward {stats['mean_reward']:.4f}, done rate "
        f"{stats['done_rate']:.4f}, launches {launches}")
    assert launches["step"] == STEPS, launches
    assert launches["fk"] >= STEPS, launches
    es = stats["state"]
    obs, rew, done = stats["trajectory"]
    assert obs.shape == (STEPS, N_MAIN, 87) and rew.shape == (STEPS, N_MAIN)
    for name, x in (("obs", obs), ("reward", rew), ("q", es.phys.q),
                    ("qd", es.phys.qd), ("body_pos", es.phys.body_pos)):
        assert torch.isfinite(x).all(), f"non-finite {name}"
    assert float(done.float().mean()) < 0.5, "most envs must stay up"
    del es, obs, rew, done, stats
    rates = []
    for _ in range(RATE_RUNS):
        r = random_policy.drive(cfg, env)
        rates.append(r["env_steps_per_s"])
        del r
    rs = sorted(rates)
    log(f"main path rate: {card} | {RATE_RUNS} more rollouts of {STEPS} "
        f"steps: env-steps/s min {rs[0]:.1f}, median {rs[len(rs) // 2]:.1f}, "
        f"max {rs[-1]:.1f} ({', '.join(f'{x:.1f}' for x in rates)})")
    del env

    # a short rollout on the card vs the plain path on the CPU, same start
    # and actions; envs that reset in either are left out (their noise is
    # drawn from different generators)
    import dataclasses

    from omniisaacgymenvs_torch.envs import VecEnv
    from omniisaacgymenvs_torch.tasks.base import EnvState

    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return {k: to_cpu(v) for k, v in x.items()}

    n_e2e = 256
    genv = VecEnv(get_task("Humanoid", device=dev), n_e2e, seed=5)
    cenv = VecEnv(get_task("Humanoid", device="cpu"), n_e2e, seed=5)
    ges = genv.reset(seed=5)
    ces: EnvState = to_cpu(ges)
    g = torch.Generator().manual_seed(7)
    ever_done = torch.zeros(n_e2e, dtype=torch.bool)
    for _ in range(3):
        a = 2 * torch.rand((n_e2e, genv.num_actions), generator=g) - 1
        ges = genv.step(ges, a.to(dev))
        ces = cenv.step(ces, a)
        ever_done |= ges.done.cpu() | ces.done
    keep = ~ever_done
    err = (ges.obs.cpu()[keep] - ces.obs[keep]).abs()
    rtol, atol = E2E_TOL
    assert keep.sum() > n_e2e // 2
    assert bool((err <= atol + rtol * ces.obs[keep].abs()).all()), float(err.max())
    log(f"end to end vs CPU plain path: {int(keep.sum())} envs x 3 steps, "
        f"obs max abs err {float(err.max()):.3e} (rtol {rtol}, atol {atol})")

    # ---- 5. kernels against plain again, and times, at the main path's
    # shapes ----
    q, qd, eff = parity.check_inputs(m, N_MAIN, seed=1, device=dev)
    z = torch.zeros((N_MAIN, m.njd), device=dev)
    fa = torch.zeros((N_MAIN, m.nb, 6), device=dev)
    err1 = max(err1, parity.assert_within(
        "K1", parity.compare(fs.step(eng, q, qd, eff, z, z, fa, N_SUB),
                             fs.step_plain(eng, q, qd, eff, z, z, fa, N_SUB),
                             parity.STEP_NAMES, parity.STEP_TOL),
        parity.STEP_TOL, log))
    err2 = max(err2, parity.assert_within(
        "K2", parity.compare(fs.fk(eng, q, qd), fs.fk_plain(m, q, qd),
                             parity.FK_NAMES, parity.FK_TOL),
        parity.FK_TOL, log))
    ops, nbytes = fs.op_count(m, N_SUB), fs.io_bytes(m)
    rows = []
    for key, name, line, src_err, run_k, run_p in (
        ("step", "fused_step_k1", 1016, err1,
         lambda: fs.step(eng, q, qd, eff, z, z, fa, N_SUB),
         lambda: fs.step_plain(eng, q, qd, eff, z, z, fa, N_SUB)),
        ("fk", "report_fk_k2", 943, err2,
         lambda: fs.fk(eng, q, qd),
         lambda: fs.fk_plain(m, q, qd)),
    ):
        ms = time_ms(run_k, 20)
        plain_ms = time_ms(run_p, 3)
        t_bytes = N_MAIN * nbytes[key] / PEAK_BYTES_S * 1e3
        t_ops = N_MAIN * ops[key] / PEAK_FP32_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"{name}: {card} | {N_MAIN} envs: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({ops[key]} FP32 ops and {nbytes[key]} bytes per env), "
            f"{bound_ms / ms * 100:.2f}% of roofline")
        rows.append(dict(
            name=name, route="cuda",
            source="omniisaacgymenvs_torch/ops/csrc/fused_step.cu",
            replaces=f"omniisaacgymenvs_tpu/ops/fused_substep.py:{line}",
            launches=launches[key], max_abs_err=src_err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None,
        ))
    torch.cuda.synchronize()

    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
