"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit, and the nvcc build of the kernels
     (registers and spills as ptxas reports them);
  2. K1 (whole control step), K2 (report FK) and K3 (single substep)
     against their plain versions on the card: Humanoid at 32768 + 37 envs
     (the last block partly masked), ShadowHand at 8192 + 37, AnymalTerrain
     at 2048 + 37 (K1 and K3 on terrain planes: K1 as the main path
     launches it, one substep, and over four substeps on the same planes;
     treads, riser walls, step edges and wedge points all in contact),
     BallBalance, Cartpole, Anymal and the synthetic pair scene of
     ops/parity.py (sphere, capsule and box surfaces, a prismatic joint, a
     tendon), on check states that put contact points in the ground and
     pairs in contact;
  3. the Humanoid main path: the random-policy entry point's VecEnv at
     32768 envs, reset and a 64-step rollout, with the launch counts read
     around it (K1 exactly once per control step, K2 at least as often);
     the rollout's rate over repeated runs; a short rollout on the card
     against the plain path on the CPU;
  4. the ShadowHand main path, the same at 8192 envs, with the cube still
     in the hand in most envs;
  5. the AnymalTerrain main path, the same at 2048 envs: K1 once per
     substep (four launches per control step), each on contact planes
     sampled from the launch before; the terrain level finite;
  6. K1 / K2 / K3 against their plain versions again at the main paths'
     env counts, and their times there (CUDA events) beside the plain
     versions' and the roofline bound; AnymalTerrain's K1 also at 32768
     envs, a width that fills the card.
Tolerances and check states come from omniisaacgymenvs_torch/ops/parity.py.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
# outside the tensor cores, FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

STEPS = 64
RATE_RUNS = 3  # untraced rollouts timed for the rate's spread
# the main paths: task, env count (the task yaml's numEnvs for ShadowHand
# and AnymalTerrain)
MAIN = {"Humanoid": 32768, "ShadowHand": 8192, "AnymalTerrain": 2048}
# smaller scenes that hold a FIXED root, a prismatic joint, a forest and
# every surface type on the card, and the flat-ground Anymal
SIDE = {"BallBalance": 4096, "Cartpole": 512, "PairScene": 4096,
        "Anymal": 4096}
WIDE = 32768  # AnymalTerrain's K1 is also timed at a width that fills the card
N_PAD = 37  # the checks' env counts are not a multiple of the 128-thread block
# end to end, kernel path on the card vs plain path on the CPU, 3 steps
E2E_TOL = (5e-3, 5e-3)
SOURCE = "omniisaacgymenvs_torch/ops/csrc/fused_step.cu"
TPU_FILE = "omniisaacgymenvs_tpu/ops/fused_substep.py"


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


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return {k: to_cpu(v) for k, v in x.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from omniisaacgymenvs_torch.envs import VecEnv
    from omniisaacgymenvs_torch.ops import fused_step as fs
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
    from omniisaacgymenvs_torch.scripts import random_policy
    from omniisaacgymenvs_torch.tasks import get_task
    from omniisaacgymenvs_torch.utils.config import load_config

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

    # the engines the kernels are held on: each task as its yaml configures
    # it, the pair scene alone; n_sub: the substeps of the main path's K1
    # launch (a whole control step, or one substep where the terrain planes
    # are refreshed before each)
    tasks, engines, n_sub = {}, {}, {}
    for name in list(MAIN) + list(SIDE):
        if name == "PairScene":
            engines[name] = PhysicsEngine(parity.build_pair_scene(dev),
                                          SimParams(dt=1.0 / 120.0, substeps=2))
            n_sub[name] = 4
        else:
            task = get_task(name, load_config({"task": name})["task"], device=dev)
            tasks[name], engines[name] = task, task.engine
            n_sub[name] = (task.decimation * task.engine.params.substeps
                           // task.engine.k1_launches(task.decimation))

    def check_states(name: str, n: int, seed: int):
        """(q, qd, eff, {planes} on terrain) of `name`'s check states. Kernel
        and plain version get the same planes tensor, computed once here:
        which feature a point resolves to is a discontinuity of the plane
        function, not of the kernels."""
        eng = engines[name]
        if not eng.has_terrain:
            return (*parity.check_inputs(eng.model, n, seed=seed, device=dev), {})
        q, qd, eff = parity.terrain_check_inputs(tasks[name], n, seed, dev)
        return q, qd, eff, {"planes": eng._contact_planes(eng.init_state(q, qd))}

    def check(name: str, n: int, seed: int) -> dict:
        """K1, K2 and K3 of `name`'s engine against their plain versions on
        n check states; the largest abs error per kernel."""
        eng = engines[name]
        m = eng.model
        q, qd, eff, pl = check_states(name, n, seed)
        ptg = parity.check_targets(m, q, seed)
        z = torch.zeros((n, m.njd), device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        fa = 0.05 * torch.randn((n, m.nb, 6), device=dev, generator=gen)
        active = (parity.terrain_contacts(tasks[name], eng, q, qd) if pl
                  else parity.active_contacts(eng, q, qd))
        log(f"{name} check: {n} envs, {n_sub[name]} substeps, active contacts "
            f"{active}")
        if name == "Humanoid":
            assert active["ground"] > 0, "no contact point in the ground"
        if pl:
            assert min(active.values()) > 0, f"a terrain feature is not hit: {active}"
        if len(m.pair_surf):
            assert active["pairs"] > 0, "no pair in contact"
        if name == "PairScene":
            assert min(active[k] for k in ("sphere", "capsule", "box")) > 0, active

        def k1(n_steps):
            return ("step", f"K1 x{n_steps}", parity.STEP_NAMES, parity.step_tol(m),
                    lambda: fs.step(eng, q, qd, eff, ptg, z, fa, n_steps, **pl),
                    lambda: fs.step_plain(eng, q, qd, eff, ptg, z, fa, n_steps, **pl))

        errs = {}
        # on terrain also four substeps on the same planes (the launch of an
        # engine without the plane refresh)
        for key, label, names, tol, run_k, run_p in (
            *([k1(4)] if pl and n_sub[name] != 4 else []),
            k1(n_sub[name]),
            ("fk", "K2", parity.FK_NAMES, parity.FK_TOL,
             lambda: fs.fk(eng, q, qd), lambda: fs.fk_plain(m, q, qd)),
            ("substep", "K3", parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL,
             lambda: fs.substep(eng, q, qd, eff, ptg, z, fa, **pl),
             lambda: fs.substep_plain(eng, q, qd, eff, ptg, z, fa, **pl)),
        ):
            out, ref = run_k(), run_p()
            torch.cuda.synchronize()
            err = parity.assert_within(
                f"{name} {label}", parity.compare(out, ref, names, tol), tol, log)
            errs[key] = max(err, errs.get(key, 0.0))
        return errs

    # ---- 2. kernels against their plain versions ----
    errs = {}
    for name, n in {**MAIN, **SIDE}.items():
        errs[name] = check(name, n + N_PAD, seed=0)

    # ---- 3./4./5. the main paths ----
    launches = {}

    def main_path(name: str, n: int, e2e_envs: int, e2e_cfg=None):
        argv = [f"task={name}", f"num_envs={n}", f"max_iterations={STEPS}",
                "seed=0", "device=cuda"]
        cfg, mtask, env = random_policy.build_env(argv)
        kern = mtask.engine.kernels
        kern.reset_counts()
        stats = random_policy.drive(cfg, env)
        launches[name] = dict(kern.launches)
        log(f"main path: {card} | {name} {n} envs x {STEPS} steps: "
            f"{stats['env_steps_per_s']:.1f} env-steps/s, "
            f"{stats['seconds'] * 1e3 / STEPS:.3f} ms per control step, "
            f"mean reward {stats['mean_reward']:.4f}, done rate "
            f"{stats['done_rate']:.4f}, launches {launches[name]}")
        # K1 once per control step, or once per substep with the plane
        # refresh; K2 at every reset (each step computes one for the merge)
        per_step = mtask.engine.k1_launches(mtask.decimation)
        assert launches[name]["step"] == STEPS * per_step, launches
        assert launches[name]["fk"] >= STEPS, launches
        assert launches[name]["substep"] == 0, launches
        es = stats["state"]
        obs, rew, done = stats["trajectory"]
        assert obs.shape == (STEPS, n, mtask.num_obs), obs.shape
        assert rew.shape == (STEPS, n)
        for label, x in (("obs", obs), ("reward", rew), ("q", es.phys.q),
                         ("qd", es.phys.qd), ("body_pos", es.phys.body_pos)):
            assert torch.isfinite(x).all(), f"non-finite {label}"
        # Humanoid: most envs stay up; ShadowHand: the cube stays in the
        # hand in most envs (the plain path on the CPU shows a done rate of
        # the same size under the same policy, PERF.md)
        assert float(done.float().mean()) < 0.5, "most envs must not end"
        if "episode/terrain_level" in es.metrics:
            level = es.metrics["episode/terrain_level"]
            assert torch.isfinite(level).all(), "non-finite terrain level"
            log(f"  terrain level: mean {float(level.mean()):.4f}, max "
                f"{float(level.max()):.0f}")
        del es, obs, rew, done, stats
        rates = []
        for _ in range(RATE_RUNS):
            r = random_policy.drive(cfg, env)
            rates.append(r["env_steps_per_s"])
            del r
        rs = sorted(rates)
        log(f"main path rate: {card} | {name} {RATE_RUNS} more rollouts of "
            f"{STEPS} steps: env-steps/s min {rs[0]:.1f}, median "
            f"{rs[len(rs) // 2]:.1f}, max {rs[-1]:.1f} "
            f"({', '.join(f'{x:.1f}' for x in rates)})")
        del env

        # a short rollout on the card vs the plain path on the CPU, same
        # start and actions; envs that reset in either are left out (their
        # noise is drawn from different generators)
        task_cfg = cfg["task"] if e2e_cfg is None else e2e_cfg(cfg["task"])
        genv = VecEnv(get_task(name, task_cfg, device=dev), e2e_envs, seed=5)
        cenv = VecEnv(get_task(name, task_cfg, device="cpu"), e2e_envs, seed=5)
        ges = genv.reset(seed=5)
        ces = to_cpu(ges)
        g = torch.Generator().manual_seed(7)
        ever_done = torch.zeros(e2e_envs, dtype=torch.bool)
        for _ in range(3):
            a = 2 * torch.rand((e2e_envs, genv.num_actions), generator=g) - 1
            ges = genv.step(ges, a.to(dev))
            ces = cenv.step(ces, a)
            ever_done |= ges.done.cpu() | ces.done
        keep = ~ever_done
        err = (ges.obs.cpu()[keep] - ces.obs[keep]).abs()
        rtol, atol = E2E_TOL
        assert keep.sum() > e2e_envs // 2
        assert bool((err <= atol + rtol * ces.obs[keep].abs()).all()), float(err.max())
        log(f"end to end vs CPU plain path: {name} {int(keep.sum())} envs x 3 "
            f"steps, obs max abs err {float(err.max()):.3e} (rtol {rtol}, "
            f"atol {atol})")

    def without_noise(task_cfg: dict) -> dict:
        """The card and the CPU draw the observation noise from different
        generators, so the comparison runs without it."""
        env_cfg = task_cfg["env"]
        return {**task_cfg, "env": {
            **env_cfg, "learn": {**env_cfg["learn"], "addNoise": False}}}

    main_path("Humanoid", MAIN["Humanoid"], 256)
    main_path("ShadowHand", MAIN["ShadowHand"], 128)
    main_path("AnymalTerrain", MAIN["AnymalTerrain"], 128, without_noise)

    # ---- 6. kernels against plain again, and times, at the main paths'
    # shapes ----
    rows = []
    for name, n in MAIN.items():
        again = check(name, n, seed=1)
        eng = engines[name]
        m = eng.model
        q, qd, eff, pl = check_states(name, n, seed=1)
        ptg = parity.check_targets(m, q, 1)
        z = torch.zeros((n, m.njd), device=dev)
        fa = torch.zeros((n, m.nb, 6), device=dev)
        ops = fs.op_count(m, n_sub[name], planes=bool(pl))
        nbytes = fs.io_bytes(m, planes=bool(pl))
        suffix = "" if name == "Humanoid" else "_" + name.lower()
        for key, kname, line, run_k, run_p in (
            ("step", "fused_step_k1", 1016,
             lambda: fs.step(eng, q, qd, eff, ptg, z, fa, n_sub[name], **pl),
             lambda: fs.step_plain(eng, q, qd, eff, ptg, z, fa, n_sub[name], **pl)),
            ("fk", "report_fk_k2", 943,
             lambda: fs.fk(eng, q, qd), lambda: fs.fk_plain(m, q, qd)),
            ("substep", "substep_k3", 898,
             lambda: fs.substep(eng, q, qd, eff, ptg, z, fa, **pl),
             lambda: fs.substep_plain(eng, q, qd, eff, ptg, z, fa, **pl)),
        ):
            ms = time_ms(run_k, 20)
            plain_ms = time_ms(run_p, 2)
            t_bytes = n * nbytes[key] / PEAK_BYTES_S * 1e3
            t_ops = n * ops[key] / PEAK_FP32_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            log(f"{kname} {name}: {card} | {n} envs: {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({ops[key]} FP32 ops and {nbytes[key]} bytes per env), "
                f"{bound_ms / ms * 100:.2f}% of roofline, "
                f"{launches[name][key]} launches on the main path")
            rows.append(dict(
                name=kname + suffix, model=name, route="cuda", source=SOURCE,
                replaces=f"{TPU_FILE}:{line}", launches=launches[name][key],
                max_abs_err=max(errs[name][key], again[key]), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None,
            ))
        if n_sub[name] != 4:
            # beside the main path's depth, K1 at four substeps
            ms4 = time_ms(lambda: fs.step(eng, q, qd, eff, ptg, z, fa, 4, **pl), 20)
            log(f"fused_step_k1 {name}: {card} | {n} envs, 4 substeps "
                f"instead of the main path's {n_sub[name]}: {ms4:.4f} ms")
        if pl:
            # the main path's 2048 envs are 16 blocks on 132 SMs: the same
            # launch at a width that fills the card, and the sampling of
            # its planes (the task's plane function as PyTorch ops)
            wq, wqd, weff, wpl = check_states(name, WIDE, seed=1)
            wz = torch.zeros((WIDE, m.njd), device=dev)
            wfa = torch.zeros((WIDE, m.nb, 6), device=dev)
            ms_w = time_ms(lambda: fs.step(eng, wq, wqd, weff, wz, wz, wfa,
                                           n_sub[name], **wpl), 20)
            t_b = WIDE * nbytes["step"] / PEAK_BYTES_S * 1e3
            t_o = WIDE * ops["step"] / PEAK_FP32_S * 1e3
            log(f"fused_step_k1 {name}: {card} | {WIDE} envs: {ms_w:.4f} ms, "
                f"bound {max(t_b, t_o):.4f} ms by "
                f"{'bytes' if t_b >= t_o else 'operations'}, "
                f"{max(t_b, t_o) / ms_w * 100:.2f}% of roofline")
            for width, st in ((n, eng.init_state(q, qd)),
                              (WIDE, eng.init_state(wq, wqd))):
                ms_p = time_ms(lambda: eng._contact_planes(st), 20)
                log(f"contact planes {name}: {card} | {width} envs: "
                    f"{ms_p:.4f} ms per sampling (CUDA events over 20)")
            del wq, wqd, weff, wpl, wz, wfa
    torch.cuda.synchronize()
    # K1 and K2 carry each main path; K3 is a launch mode no product path
    # takes, held against its plain version above
    for r in rows:
        assert r["launches"] > 0 or r["name"].startswith("substep_k3"), r

    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
