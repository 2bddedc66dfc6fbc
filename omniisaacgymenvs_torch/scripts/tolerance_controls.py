"""Readings behind the kernel-vs-plain tolerances of `ops/parity.py`: the
sound build against the plain version, and broken controls that the
tolerances must refuse.

    python -m omniisaacgymenvs_torch.scripts.tolerance_controls \
        [task=Humanoid|ShadowHand|AnymalTerrain|ShadowHandOpenAI_FF] \
        [num_envs=N]

Needs a CUDA card. Runs on the task's states from `parity.check_inputs`
(32805 Humanoid envs, 8229 ShadowHand envs, 2085 AnymalTerrain envs from
`parity.terrain_check_inputs`, unless num_envs is given):
  sound       the kernels as built for the main path (two seeds, and one
              seed with the FREE roots lowered further: Humanoid 0.5 m, five
              times deeper; ShadowHand 2 cm, past the palm's half thickness;
              AnymalTerrain 2 to 5 cm into the treads);
  fast-math   the same source built with --use_fast_math;
  -1 substep  K1 with one substep dropped;
Humanoid and AnymalTerrain:
  kn x1.001   K1 with every contact point's normal gain 0.1% high;
  cp +1mm     K1 with every contact point 1 mm off along the body's x
              (torques and penetration about the wrong point);
AnymalTerrain (K1 is the main path's launch, one substep on terrain planes;
K1x4 is four substeps on the same planes; the kernel gets the broken planes,
the plain version the sound ones):
  d +1mm      K1, K1x4 and K3 with every plane's offset 1 mm high;
  n vertical  the same with the normal of one contact point's planes (the
              point most often on a wall or an edge) set to +z;
  env shift   the same with env i's planes fed to env i + 1;
ShadowHand:
  pair drop   K1 and K3 without the candidate pair most often in contact;
  box +1mm    K1 and K3 with every box surface's half extents 1 mm larger;
  tendon x1.001  K1 and K3 with every tendon's stiffnesses 0.1% high;
ShadowHandOpenAI_FF (the hand under randomization: 12 substeps a K1 launch,
every run under an overlay of all ten keys from `parity.overlay_inputs`; the
kernel gets the broken overlay, the plain version the sound one):
  ov shift    K1 and K3 with env i's overlay fed to env i + 1;
  mass off    the same with mass_scale ignored (set to 1);
  geom x1.01  the same with every geom_scale 1% high;
  klim fixed  the same with the tendons' limit stiffness left unscaled:
              both sides get a tendon_stiffness_scale of 1.3 in every env
              and the kernel's table holds the limit stiffness over 1.3;
all:
  jpos +0.1mm K2 with every joint 0.1 mm off along x.
Under an overlay the readings are taken over the envs whose step is well
conditioned (`parity.well_conditioned`; the line says how many were left
out), as the checks take them.
Each line gives, per output, the max abs error and the tolerance use (the
largest error over its limit; below 1 passes). A control is caught when
some output's use exceeds 1. The last line is all readings as JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.physics import contacts, dynamics
from omniisaacgymenvs_torch.physics.model import SurfaceType
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config



def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    task_name = args.get("task", "Humanoid")
    n = int(args.get("num_envs", {"Humanoid": 32805, "AnymalTerrain": 2085}
                     .get(task_name, 8229)))
    if not torch.cuda.is_available():
        print("tolerance_controls: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(2) as pool:
        sound_f = pool.submit(fs.library)
        fast_f = pool.submit(fs.build, fs.NVCC_FLAGS + ("--use_fast_math",))
        sound, fast = sound_f.result(), fast_f.result()

    dev = torch.device("cuda")
    task = get_task(task_name, load_config({"task": task_name})["task"],
                    device=dev)
    eng = task.engine
    terrain = eng.has_terrain
    # the main path's K1 launch: all substeps of a control step, or one
    # substep when the planes are refreshed before each
    n_sub = (task.decimation * eng.params.substeps
             // eng.k1_launches(task.decimation))
    m = eng.model
    k = eng.kernels
    ftab = k.ftab.clone()
    off = fs.table_offsets(m)
    ar = lambda count: torch.arange(count, device=dev)  # noqa: E731
    cp_kn = fs._CP_STRIDE * ar(m.ncp) + off["f_cp"] + 5
    cp_x = fs._CP_STRIDE * ar(m.ncp) + off["f_cp"]
    jpos_x = (fs._BODY_STRIDE * torch.arange(1, m.nb, device=dev)
              + fs._F_BODY + fs._B_JPOS)

    def table(idx=None, mul=1.0, add=0.0):
        t = ftab.clone()
        if idx is not None:
            t[idx] = t[idx] * mul + add
        return t

    readings = []

    def inputs(seed, drop=None, overlay=None):
        """(q, qd, eff, planes or None) of the check states of `seed`, moved
        off the ties of two box faces under `overlay`'s geom_scale."""
        if not terrain:
            q, qd, eff = parity.check_inputs(m, n, seed, dev, drop=drop)
            return parity.clear_box_ties(eng, q, qd, overlay), qd, eff, None
        depth = parity.TERRAIN_DEPTH if drop is None else drop
        q, qd, eff = parity.terrain_check_inputs(task, n, seed, dev, depth)
        return q, qd, eff, eng._contact_planes(eng.init_state(q, qd))

    randomized = task._dr_on

    def run(label, kernel, seed=0, drop=None, lib=sound, tab=None,
            n_steps=None, break_planes=None, break_overlay=None,
            both_overlay=None):
        ov = ov_k = None
        if randomized:
            ov = parity.overlay_inputs(m, n, seed, dev)
            if both_overlay is not None:
                ov = both_overlay(ov)
            ov_k = ov if break_overlay is None else break_overlay(ov)
        q, qd, eff, planes = inputs(seed, drop, ov)
        ptg = parity.check_targets(m, q, seed)
        z = torch.zeros((n, m.njd), device=dev)
        fa = torch.zeros((n, m.nb, 6), device=dev)
        fs._LIBRARY, k.ftab = lib, ftab if tab is None else tab
        planes_k = planes if break_planes is None else break_planes(planes)
        n_ref = 4 if kernel == "K1x4" else n_sub
        n_steps = n_ref if n_steps is None else n_steps
        try:
            if kernel in ("K1", "K1x4"):
                out = fs.step(eng, q, qd, eff, ptg, z, fa, n_steps,
                              planes=planes_k, overlay=ov_k)

                def plain(q_, qd_):
                    return fs.step_plain(eng, q_, qd_, eff, ptg, z, fa, n_ref,
                                         planes=planes, overlay=ov)
                names, tol = parity.STEP_NAMES, parity.step_tol(m)
            elif kernel == "K3":
                out = fs.substep(eng, q, qd, eff, ptg, z, fa, planes=planes_k,
                                 overlay=ov_k)

                def plain(q_, qd_):
                    return fs.substep_plain(eng, q_, qd_, eff, ptg, z, fa,
                                            planes=planes, overlay=ov)
                names, tol = parity.SUBSTEP_NAMES, parity.SUBSTEP_TOL
            else:
                out = fs.fk(eng, q, qd)

                def plain(q_, qd_):
                    return fs.fk_plain(m, q_, qd_)
                names, tol = parity.FK_NAMES, parity.FK_TOL
            ref = plain(q, qd)
            torch.cuda.synchronize()
        finally:
            fs._LIBRARY, k.ftab = sound, ftab
        keep, left_out = None, 0
        if ov is not None and kernel != "K2":
            # a reading, not a check: however many envs fall out
            keep = parity.well_conditioned(plain, q, qd, ref, names, tol,
                                           max_excluded=1.0)
            left_out = int((~keep).sum())
        res = parity.compare(out, ref, names, tol, keep)
        worst = max(use for _, use in res.values())
        readings.append(dict(label=label, kernel=kernel, seed=seed, drop=drop,
                             worst_use=worst, left_out=left_out, fields=res))
        print(f"{kernel} {label:13s} worst use {worst:.4g} | " + "  ".join(
            f"{f} {e:.3e}/{u:.3g}" for f, (e, u) in res.items())
            + (f" | {left_out} envs left out" if keep is not None else ""),
            flush=True)

    q0, qd0, _, planes0 = inputs(0)
    active = (parity.terrain_contacts(task, eng, q0, qd0) if terrain
              else parity.active_contacts(eng, q0, qd0))
    print(f"card: {card} | {n} envs, {task_name}, {n_sub} substeps a K1 "
          f"launch{', under an overlay of all ten keys' if randomized else ''}, "
          f"active contacts {active}")
    deep = {"Humanoid": 0.5, "AnymalTerrain": (0.02, 0.05)}.get(task_name, 0.02)
    step_kernels = ("K1", "K1x4") if terrain else ("K1",)
    for kern in (*step_kernels, "K3", "K2"):
        run("sound", kern, seed=0)
        run("sound", kern, seed=1)
        run("sound deep", kern, seed=0, drop=deep)
        run("fast-math", kern, lib=fast)
    for kern in step_kernels:
        if kern == "K1x4" or n_sub > 1:
            run("-1 substep", kern, n_steps=(4 if kern == "K1x4" else n_sub) - 1)
    if task_name in ("Humanoid", "AnymalTerrain"):
        for kern in step_kernels:
            run("kn x1.001", kern, tab=table(cp_kn, mul=1.001))
            run("cp +1mm", kern, tab=table(cp_x, add=1e-3))
    if terrain:
        # the contact point most often on a wall or an edge
        slanted = (planes0[..., 2].abs() < 0.99).sum(0)
        col = int(slanted.argmax())

        def offset(p):
            p = p.clone()
            p[..., 3] += 1e-3
            return p

        def vertical(p):
            p = p.clone()
            p[:, col, 0:3] = p.new_tensor([0.0, 0.0, 1.0])
            return p

        for kern in (*step_kernels, "K3"):
            run("d +1mm", kern, break_planes=offset)
            run("n vertical", kern, break_planes=vertical)
            run("env shift", kern, break_planes=lambda p: p.roll(1, 0).contiguous())
    elif task_name != "Humanoid":
        # the pair most often in contact on the check states
        kin = dynamics.kinematics(m, q0, qd0)
        pen = contacts.pair_penetrations(m, eng.pair_groups, kin.pw, kin.Rw)
        busiest = int((pen > 0).sum(0).argmax())
        pair_gain = off["f_pair"] + fs._PAIR_STRIDE * busiest + ar(3)
        boxes = [si for si, t in enumerate(m.surf_type)
                 if t == SurfaceType.BOX]
        box_half = torch.cat([off["f_surf"] + fs._SURF_STRIDE * si + 3 + ar(3)
                              for si in boxes])
        tend_k = torch.cat([off["f_tend"] + fs._TEND_STRIDE * ar(m.nt) + c
                            for c in (3, 7)])
        for kern in ("K1", "K3"):
            run("pair drop", kern, tab=table(pair_gain, mul=0.0))
            run("box +1mm", kern, tab=table(box_half, add=1e-3))
            run("tendon x1.001", kern, tab=table(tend_k, mul=1.001))
        if randomized:
            tend_klim = off["f_tend"] + fs._TEND_STRIDE * ar(m.nt) + 7

            def change(key, fn):
                return lambda ov: {**ov, key: fn(ov[key]).contiguous()}

            for kern in ("K1", "K3"):
                run("ov shift", kern, break_overlay=lambda ov: {
                    k: v.roll(1, 0).contiguous() for k, v in ov.items()})
                run("mass off", kern,
                    break_overlay=change("mass_scale", torch.ones_like))
                run("geom x1.01", kern,
                    break_overlay=change("geom_scale", lambda v: v * 1.01))
                run("klim fixed", kern, tab=table(tend_klim, mul=1.0 / 1.3),
                    both_overlay=change("tendon_stiffness_scale",
                                        lambda v: torch.full_like(v, 1.3)))
    run("jpos +0.1mm", "K2", tab=table(jpos_x, add=1e-4))
    print(card)
    print(json.dumps({"card": card, "task": task_name, "num_envs": n,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
