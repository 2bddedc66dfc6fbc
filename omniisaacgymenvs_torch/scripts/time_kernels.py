"""Times of the kernels alone at a task's shapes, for comparing two trees
of the port within one call on one card.

    python omniisaacgymenvs_torch/scripts/time_kernels.py \
        [task=Humanoid] [num_envs=32768] [label=change] [substeps=N]

Imports whichever `omniisaacgymenvs_torch` comes first on `sys.path`, so
the same file times another tree of the port: unpack the parent commit
with `git archive` into a git-ignored directory and run this file with
`PYTHONPATH` set to it, in turns (parent, change, change, parent). Prints
three readings of K1 (the launch the task's control step makes: all its
substeps at once, or, on terrain with the plane refresh, one substep on
terrain planes; `substeps=N` overrides the depth), K2 and, where the tree
has it, K3, each over 20 launches with CUDA events, then the ptxas lines of
the build. For a task under domain randomization (`task=ShadowHandOpenAI_FF`,
or `task=ShadowHand task.domain_randomization.randomize=True`) K1 and K3
are timed with an overlay of all ten keys (`parity.overlay_inputs`) and,
beside it, without one. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config, parse_cli


def time_ms(fn, reps: int = 20) -> float:
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


def main(argv=None) -> int:
    args = parse_cli(sys.argv[1:] if argv is None else argv)
    label = args.pop("label", "change")
    substeps = args.pop("substeps", None)
    n = int(args.setdefault("num_envs", 32768))
    cfg = load_config(args)
    name = cfg["task_name"]
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    task = get_task(name, cfg["task"], device=dev)
    eng = task.engine
    m = eng.model
    n_sub = task.decimation * eng.params.substeps
    kw = {}
    if getattr(eng, "has_terrain", False):
        n_sub //= eng.k1_launches(task.decimation)
        q, qd, eff = parity.terrain_check_inputs(task, n, seed=1, device=dev)
        kw["planes"] = eng._contact_planes(eng.init_state(q, qd))
    else:
        q, qd, eff = parity.check_inputs(m, n, seed=1, device=dev)
    if substeps is not None:
        n_sub = int(substeps)
    z = torch.zeros((n, m.njd), device=dev)
    fa = torch.zeros((n, m.nb, 6), device=dev)
    runs = {"K1": lambda: fs.step(eng, q, qd, eff, z, z, fa, n_sub, **kw),
            "K2": lambda: fs.fk(eng, q, qd)}
    if hasattr(fs, "substep"):
        runs["K3"] = lambda: fs.substep(eng, q, qd, eff, z, z, fa, **kw)
    if getattr(task, "_dr_on", False):
        ov = parity.overlay_inputs(m, n, seed=1, device=dev)
        runs["K1+overlay"] = lambda: fs.step(eng, q, qd, eff, z, z, fa, n_sub,
                                             overlay=ov, **kw)
        runs["K3+overlay"] = lambda: fs.substep(eng, q, qd, eff, z, z, fa,
                                                overlay=ov, **kw)
    for rep in range(3):
        print(f"{label} {card} | {name} {n} envs, {n_sub} substeps a launch"
              f"{', terrain planes' if kw else ''}, reading "
              f"{rep}: " + "  ".join(f"{k} {time_ms(fn):.4f} ms"
                                     for k, fn in runs.items()), flush=True)
    for line in fs.library().ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
