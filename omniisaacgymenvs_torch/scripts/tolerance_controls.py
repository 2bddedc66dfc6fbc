"""Readings behind the kernel-vs-plain tolerances of `ops/parity.py`: the
sound build against the plain version, and broken controls that the
tolerances must refuse.

    python -m omniisaacgymenvs_torch.scripts.tolerance_controls [num_envs=32805]

Needs a CUDA card. Runs on Humanoid states from `parity.check_inputs`:
  sound       the kernels as built for the main path (two seeds, and one
              seed with the root dropped 0.5 m, five times deeper);
  fast-math   the same source built with --use_fast_math;
  3 substeps  K1 with one substep dropped;
  kn x1.001   K1 with every contact point's normal gain 0.1% high;
  cp +1mm     K1 with every contact point 1 mm off along the body's x
              (torques and penetration about the wrong point);
  jpos +0.1mm K2 with every joint 0.1 mm off along x.
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
from omniisaacgymenvs_torch.tasks import get_task

N_SUB = 4  # Humanoid: decimation 2 x substeps 2


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    n = int(args.get("num_envs", 32805))
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
    eng = get_task("Humanoid", device=dev).engine
    m = eng.model
    k = eng.kernels
    ftab = k.ftab.clone()
    C0 = fs._F_BODY + fs._BODY_STRIDE * m.nb
    cp_kn = fs._CP_STRIDE * torch.arange(m.ncp, device=dev) + C0 + 5
    cp_x = fs._CP_STRIDE * torch.arange(m.ncp, device=dev) + C0
    jpos_x = (fs._BODY_STRIDE * torch.arange(1, m.nb, device=dev)
              + fs._F_BODY + fs._B_JPOS)

    def table(idx=None, mul=1.0, add=0.0):
        t = ftab.clone()
        if idx is not None:
            t[idx] = t[idx] * mul + add
        return t

    readings = []

    def run(label, kernel, seed=0, drop=parity.CHECK_DROP, lib=sound,
            tab=None, n_steps=N_SUB):
        q, qd, eff = parity.check_inputs(m, n, seed, dev, drop=drop)
        z = torch.zeros((n, m.njd), device=dev)
        fa = torch.zeros((n, m.nb, 6), device=dev)
        fs._LIBRARY, k.ftab = lib, ftab if tab is None else tab
        try:
            if kernel == "K1":
                out = fs.step(eng, q, qd, eff, z, z, fa, n_steps)
                ref = fs.step_plain(eng, q, qd, eff, z, z, fa, N_SUB)
                names, tol = parity.STEP_NAMES, parity.STEP_TOL
            else:
                out = fs.fk(eng, q, qd)
                ref = fs.fk_plain(m, q, qd)
                names, tol = parity.FK_NAMES, parity.FK_TOL
            torch.cuda.synchronize()
        finally:
            fs._LIBRARY, k.ftab = sound, ftab
        res = parity.compare(out, ref, names, tol)
        worst = max(use for _, use in res.values())
        readings.append(dict(label=label, kernel=kernel, seed=seed, drop=drop,
                             worst_use=worst, fields=res))
        print(f"{kernel} {label:12s} worst use {worst:.4g} | " + "  ".join(
            f"{f} {e:.3e}/{u:.3g}" for f, (e, u) in res.items()), flush=True)

    print(f"card: {card} | {n} envs, Humanoid, {N_SUB} substeps")
    for kern in ("K1", "K2"):
        run("sound", kern, seed=0)
        run("sound", kern, seed=1)
        run("sound deep", kern, seed=0, drop=0.5)
        run("fast-math", kern, lib=fast)
    run("3 substeps", "K1", n_steps=N_SUB - 1)
    run("kn x1.001", "K1", tab=table(cp_kn, mul=1.001))
    run("cp +1mm", "K1", tab=table(cp_x, add=1e-3))
    run("jpos +0.1mm", "K2", tab=table(jpos_x, add=1e-4))
    print(card)
    print(json.dumps({"card": card, "num_envs": n, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
