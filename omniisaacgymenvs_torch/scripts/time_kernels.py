"""Times of the kernels alone at a task's shapes, for comparing two trees
of the port within one call on one card.

    python omniisaacgymenvs_torch/scripts/time_kernels.py \
        [task=Humanoid] [num_envs=32768] [label=change] [substeps=N] \
        [sweep=1] [design=group|thread] [define=NAME] [sass=1]

Imports whichever `omniisaacgymenvs_torch` comes first on `sys.path`, so
the same file times another tree of the port: unpack the parent commit
with `git archive` into a git-ignored directory and run this file with
`PYTHONPATH` set to it, in turns (parent, change, change, parent). Prints
the launch configuration of each kernel (`fused_step.launch_config`, where
the tree has it), then three readings of K1 (the launch the task's control
step makes: all its substeps at once, or, on terrain with the plane
refresh, one substep on terrain planes; `substeps=N` overrides the depth),
K2 and, where the tree has it, K3, each over 20 launches with CUDA events,
then each kernel's device time per launch from the profiler's trace (the
kernel alone, where the host's time per call exceeds a small launch's),
then the ptxas lines of the build. For a task under domain randomization
(`task=ShadowHandOpenAI_FF`, or `task=ShadowHand
task.domain_randomization.randomize=True`) K1 and K3 are timed with an
overlay of all ten keys (`parity.overlay_inputs`) and, beside it, without
one. `sweep=1` times K1 instead at 1024, 2048, ..., 32768 envs (under the
overlay where the task randomizes), in both of its forms where the tree
has two (the group of lanes per env and one thread per env, in turns: three
readings each, with the per-env cost and the device time per launch), so
the width where one thread per env takes over can be read off.
`design=group|thread` times K1 and K3 in that form where the tree has
both; `define=NAME` builds the kernels with `-DNAME` (a build switch of
the source, timed against the plain build in turns). `sass=1` also counts
the instructions and the local-memory loads and stores (`LDL`, `STL`) of
every kernel in `cuobjdump -sass` of the libraries. Needs a CUDA card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config, parse_cli

SWEEP = (1024, 2048, 4096, 8192, 16384, 32768)
DEV = torch.device("cuda")


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


OPCODES = ("LDS", "STS", "LD", "ST", "LDG", "STG", "LDL", "STL", "WARPSYNC",
           "BAR", "FFMA", "FMUL", "FADD", "IMAD", "BRA")


# the wait at each end of kernel_times's trace (`profile_rollout.settle`):
# four times longer after a trace that lost a launch, for the process's life
TRACE_PAD_S = [0.1]
# small kernels launched at each end of that trace: late in a long process
# its traces held 16-18 of 20 launches whatever the wait (chip_smoke.py)
TRACE_FILLER = 32
# a trace's device time per launch over its events time, past which the
# trace misread a clock and is taken again (`kernel_times`)
TRACE_SLACK = 1.1


def _filler() -> None:
    x = torch.zeros(1, device=DEV)
    for _ in range(TRACE_FILLER):
        x.add_(1.0)


def _warm() -> None:
    """Some 20 ms of GEMMs: the card's clocks up again after a trace's wait,
    as they are when the same launches are timed outside the profiler."""
    a = torch.full((4096, 4096), 1e-3, device=DEV)
    b = torch.empty_like(a)
    for _ in range(8):
        torch.mm(a, a, out=b)


def _ours(name: str) -> bool:
    return "step_kernel" in name or "fk_kernel" in name


def trace_once(fn, reps: int, durations: bool = False):
    """One trace of `reps` calls of fn: (launches of the port's kernels
    held, their device ms per call, the CUDA-event ms per call of the same
    calls in the same trace, and with `durations` each launch's device us
    in the order the trace lists them, else None)."""
    from omniisaacgymenvs_torch.scripts.profile_rollout import _device_us, settle

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        settle(TRACE_PAD_S[0])
        _filler()
        _warm()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        _filler()
        settle(TRACE_PAD_S[0])
    ours = [e for e in prof.key_averages() if _ours(e.key)]
    each = ([_device_us(e) for e in prof.events() if _ours(e.name)]
            if durations else None)
    return (sum(e.count for e in ours), sum(_device_us(e) for e in ours) / reps / 1e3,
            start.elapsed_time(end) / reps, each)


def kernel_times(fn, reps: int = 20, tries: int = 4) -> tuple[float, float]:
    """(device ms, events ms) per launch of the port's kernels
    (`step_kernel`, `fk_kernel`) over `reps` calls of fn, each of which
    launches one: the profiler's device time of the kernel alone, where the
    CUDA-event time of a small launch can be the host's time per call, and
    the CUDA-event time of the same calls in the same trace, so that the two
    see the same clocks. A trace counts when it holds every launch and its
    device time is at most `TRACE_SLACK` times its events time (the launches
    lie between the two events on one stream, so a trace past that misread
    a clock). Traces again while one does not count, with a longer wait at
    its ends after a lost launch, and raises after `tries` or if a trace
    holds more launches than fn made."""
    fn()
    torch.cuda.synchronize()
    held = []
    for _ in range(tries):
        n, d, w, _ = trace_once(fn, reps)
        held.append((n, round(d, 4), round(w, 4)))
        if n == reps and 0 < d <= TRACE_SLACK * w:
            return d, w
        if n > reps:
            break
        if n < reps:
            TRACE_PAD_S[0] *= 4
    raise RuntimeError(f"no trace of {reps} launches counted: (launches, device ms, "
                       f"events ms) per trace {held}")


def kernel_device_ms(fn, reps: int = 20, tries: int = 4) -> float:
    """The device time per launch of `kernel_times`."""
    return kernel_times(fn, reps, tries)[0]


def sass_counts(path) -> dict:
    """{kernel: (instructions, LDL, STL, {opcode: count})} from `cuobjdump
    -sass` of the library; the opcodes of OPCODES, without modifiers."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0, 0, {}]
        elif name is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name][0] += 1
            op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if op and op.group(1) in OPCODES:
                hist = counts[name][3]
                hist[op.group(1)] = hist.get(op.group(1), 0) + 1
            if re.search(r"\bLDL(\.\S+)?\s", line):
                counts[name][1] += 1
            elif re.search(r"\bSTL(\.\S+)?\s", line):
                counts[name][2] += 1
    return {k: tuple(v) for k, v in counts.items()}


def inputs(task, n: int):
    """(q, qd, eff, zeros, f_applied, {planes}) check inputs of `task` at n
    envs."""
    eng = task.engine
    m = eng.model
    kw = {}
    if getattr(eng, "has_terrain", False):
        q, qd, eff = parity.terrain_check_inputs(task, n, seed=1, device=DEV)
        kw["planes"] = eng._contact_planes(eng.init_state(q, qd))
    else:
        q, qd, eff = parity.check_inputs(m, n, seed=1, device=DEV)
    z = torch.zeros((n, m.njd), device=DEV)
    fa = torch.zeros((n, m.nb, 6), device=DEV)
    return q, qd, eff, z, fa, kw


def main(argv=None) -> int:
    args = parse_cli(sys.argv[1:] if argv is None else argv)
    label = args.pop("label", "change")
    substeps = args.pop("substeps", None)
    sweep = bool(int(args.pop("sweep", 0)))
    sass = bool(int(args.pop("sass", 0)))
    design = args.pop("design", None)
    define = args.pop("define", None)
    n = int(args.setdefault("num_envs", 32768))
    args.setdefault("task", "Humanoid")     # the bench's main path
    cfg = load_config(args)
    name = cfg["task_name"]
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    task = get_task(name, cfg["task"], device=DEV)
    eng = task.engine
    m = eng.model
    n_sub = task.decimation * eng.params.substeps
    if getattr(eng, "has_terrain", False):
        n_sub //= eng.k1_launches(task.decimation)
    if substeps is not None:
        n_sub = int(substeps)
    forms = getattr(fs, "DESIGNS", None)  # trees with both forms of K1
    kg = {} if design is None or forms is None else {"design": design}
    if define is not None:
        fs._LIBRARY = fs.build(fs.NVCC_FLAGS + (f"-D{define}",))
        label = f"{label} -D{define}"
    terrain = bool(getattr(eng, "has_terrain", False))
    dr = bool(getattr(task, "_dr_on", False))
    if hasattr(fs, "launch_config"):
        for kname, kw_cfg in (("K1", dict(planes=terrain, **kg)),
                              ("K1+overlay", dict(planes=terrain, overlay=True, **kg)),
                              ("K2", dict(fk=True))):
            if kname == "K1+overlay" and not dr:
                continue
            lc = fs.launch_config(m, n, **kw_cfg)
            print(f"{label} {card} | {name} {n} envs, {kname} launch config: "
                  f"{fs.describe_config(lc)}", flush=True)
    if sweep:
        for width in SWEEP:
            q, qd, eff, z, fa, kw = inputs(task, width)
            if dr:
                kw["overlay"] = parity.overlay_inputs(m, width, seed=1, device=DEV)
            order = [{}] if forms is None else [{"design": d} for d in
                                                (*forms, *forms[::-1])]
            for kd in order:
                run = lambda: fs.step(eng, q, qd, eff, z, z, fa, n_sub,  # noqa: E731
                                      **kw, **kd)
                ts = [time_ms(run) for _ in range(3)]
                tag = f" {kd['design']} form" if kd else ""
                print(f"{label} {card} | {name} K1{tag} sweep, {width} envs, "
                      f"{n_sub} substeps{', overlay' if dr else ''}: "
                      + ", ".join(f"{t:.4f}" for t in ts) + " ms; "
                      f"{min(ts) * 1e6 / width:.2f} ns per env; device time "
                      f"{kernel_device_ms(run):.4f} ms", flush=True)
            del q, qd, eff, z, fa, kw
    else:
        q, qd, eff, z, fa, kw = inputs(task, n)
        runs = {"K1": lambda: fs.step(eng, q, qd, eff, z, z, fa, n_sub, **kw, **kg),
                "K2": lambda: fs.fk(eng, q, qd)}
        if hasattr(fs, "substep"):
            runs["K3"] = lambda: fs.substep(eng, q, qd, eff, z, z, fa, **kw, **kg)
        if dr:
            ov = parity.overlay_inputs(m, n, seed=1, device=DEV)
            runs["K1+overlay"] = lambda: fs.step(eng, q, qd, eff, z, z, fa, n_sub,
                                                 overlay=ov, **kw, **kg)
            runs["K3+overlay"] = lambda: fs.substep(eng, q, qd, eff, z, z, fa,
                                                    overlay=ov, **kw, **kg)
        for rep in range(3):
            print(f"{label} {card} | {name} {n} envs, {n_sub} substeps a launch"
                  f"{', terrain planes' if kw else ''}, reading "
                  f"{rep}: " + "  ".join(f"{k} {time_ms(fn):.4f} ms"
                                         for k, fn in runs.items()), flush=True)
        print(f"{label} {card} | {name} {n} envs, device time per launch "
              "(profiler): " + "  ".join(f"{k} {kernel_device_ms(fn):.4f} ms"
                                         for k, fn in runs.items()), flush=True)
    lib = fs.library()
    for line in lib.ptxas_log.splitlines():
        if any(k in line for k in ("registers", "spill", "stack frame",
                                   "Compiling entry")):
            print(f"  ptxas: {line.strip()}")
    if sass:
        for path in (lib.path, getattr(lib, "thread_path", None)):
            if path is None:
                continue
            for kname, (n_ins, ldl, stl, hist) in sass_counts(path).items():
                print(f"  sass: {kname}: {n_ins} instructions, {ldl} LDL, {stl} STL; "
                      + ", ".join(f"{k} {hist.get(k, 0)}" for k in OPCODES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
