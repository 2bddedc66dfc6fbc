"""Where K1's time goes inside the kernel's group form, phase by phase, on
a CUDA card.

    python -m omniisaacgymenvs_torch.scripts.profile_kernel \
        [task=Humanoid] [num_envs=32768] [substeps=N]

Builds `ops/csrc/fused_step.cu` with -DOIGE_PROFILE, in which lane 0 of
every group adds the clock cycles between the phase marks of `step_env` to
one counter per phase (`clock64`, atomics), launches K1 once on the task's
check states (on terrain planes where the task has them, under an overlay
where it randomizes) and prints, per phase, the cycles a group spends on it
per env and substep and its share of the group's time. The counters cost
time themselves, so the K1 time printed beside them is not the kernel's.
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config, parse_cli

PHASES = ("load", "fk_local", "fk_chain", "fk_world", "contact", "sum_drive",
          "bias", "inward_acc", "inward_head", "inward_t",
          "root", "outward", "integrate", "store", "report")


def main(argv=None) -> int:
    args = parse_cli(sys.argv[1:] if argv is None else argv)
    substeps = args.pop("substeps", None)
    n = int(args.setdefault("num_envs", 32768))
    args.setdefault("task", "Humanoid")     # the bench's main path
    cfg = load_config(args)
    name = cfg["task_name"]
    if not torch.cuda.is_available():
        print("profile_kernel: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lib = fs.build(fs.NVCC_FLAGS + ("-DOIGE_PROFILE",))
    fs._LIBRARY = lib
    counters = (ctypes.c_ulonglong * (2 * len(PHASES)))()
    lib.lib.oige_profile.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    task = get_task(name, cfg["task"], device=dev)
    eng = task.engine
    m = eng.model
    n_sub = task.decimation * eng.params.substeps
    kw = {}
    if eng.has_terrain:
        n_sub //= eng.k1_launches(task.decimation)
        q, qd, eff = parity.terrain_check_inputs(task, n, seed=1, device=dev)
        kw["planes"] = eng._contact_planes(eng.init_state(q, qd))
    else:
        q, qd, eff = parity.check_inputs(m, n, seed=1, device=dev)
    if getattr(task, "_dr_on", False):
        kw["overlay"] = parity.overlay_inputs(m, n, seed=1, device=dev)
    if substeps is not None:
        n_sub = int(substeps)
    z = torch.zeros((n, m.njd), device=dev)
    fa = torch.zeros((n, m.nb, 6), device=dev)
    def run():
        fs.step(eng, q, qd, eff, z, z, fa, n_sub, **kw, design="group")

    run()
    torch.cuda.synchronize()
    lib.lib.oige_profile(ctypes.addressof(counters))  # read and zero
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    err = lib.lib.oige_profile(ctypes.addressof(counters))
    if err:
        raise RuntimeError(f"oige_profile failed: {err}")
    lc = eng.kernels.config(n, "planes" in kw, "overlay" in kw, design="group")[0]
    cycles = [counters[2 * k] for k in range(len(PHASES))]
    total = sum(cycles)
    print(f"{card} | {name} {n} envs, {n_sub} substeps, {fs.describe_config(lc)}; "
          f"K1 with the counters {start.elapsed_time(end):.4f} ms")
    for k, ph in enumerate(PHASES):
        per = cycles[k] / (n * n_sub)
        print(f"  {ph:12s} {per:12.1f} cycles per env-substep  "
              f"{cycles[k] / max(total, 1):.4f} of the group's time  "
              f"({counters[2 * k + 1]} marks)")
    print(f"  total {total / (n * n_sub):.1f} cycles per env-substep")
    return 0


if __name__ == "__main__":
    sys.exit(main())
