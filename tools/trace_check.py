"""How far the profiler's device time of the port's kernels and the CUDA-event
time of the same launches agree, trace by trace (the check of
`time_kernels.kernel_times` that chip_smoke.py's kernel rows pass).

    python tools/trace_check.py [task=Custom] [task.env.robot=...] \
        [num_envs=32768] [traces=30] [out=FILE]

Builds the task on the card, makes K1's and K2's inputs as
`time_kernels.py` does, and traces each kernel `traces` times, 20 launches
a trace (`time_kernels.trace_once`). Prints a line per trace: launches
held, device ms and events ms per launch and their ratio, and the smallest,
median and largest launch of the trace in us; then for each kernel how many
traces passed `TRACE_SLACK`. The same in JSON to `out=`. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from omniisaacgymenvs_torch.ops import fused_step as fs  # noqa: E402
from omniisaacgymenvs_torch.scripts import time_kernels as tk  # noqa: E402
from omniisaacgymenvs_torch.tasks import get_task  # noqa: E402
from omniisaacgymenvs_torch.utils.config import load_config, parse_cli  # noqa: E402

REPS = 20


def main(argv=None) -> int:
    args = parse_cli(sys.argv[1:] if argv is None else argv)
    traces = int(args.pop("traces", 30))
    out = args.pop("out", None)
    n = int(args.setdefault("num_envs", 32768))
    args.setdefault("task", "Custom")
    if args["task"] == "Custom":
        args.setdefault("task.env.robot", "examples/double_pendulum.urdf")
    if not torch.cuda.is_available():
        print("trace_check: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = load_config(args)
    task = get_task(cfg["task_name"], cfg["task"], device=tk.DEV)
    eng = task.engine
    n_sub = task.decimation * eng.params.substeps
    q, qd, eff, z, fa, kw = tk.inputs(task, n)
    runs = {"K1": lambda: fs.step(eng, q, qd, eff, z, z, fa, n_sub, **kw),
            "K2": lambda: fs.fk(eng, q, qd)}
    report = {"card": card, "task": cfg["task_name"], "num_envs": n,
              "slack": tk.TRACE_SLACK, "kernels": {}}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        rows = []
        for t in range(traces):
            held, d, w, each = tk.trace_once(fn, REPS, durations=True)
            each = sorted(each)
            rows.append(dict(held=held, device_ms=d, events_ms=w, ratio=d / w,
                             launch_us=[each[0], statistics.median(each), each[-1]]
                             if each else None))
            print(f"{card} | {cfg['task_name']} {n} envs {name} trace {t}: {held} "
                  f"launches, device {d:.5f} ms, events {w:.5f} ms, ratio "
                  f"{d / w:.4f}; launches (min, median, max) "
                  f"{rows[-1]['launch_us']} us", flush=True)
        passed = sum(r["held"] == REPS and 0 < r["device_ms"] <= tk.TRACE_SLACK
                     * r["events_ms"] for r in rows)
        print(f"{name}: {passed} of {traces} traces within {tk.TRACE_SLACK} of "
              f"their events time; ratio max "
              f"{max(r['ratio'] for r in rows):.4f}", flush=True)
        report["kernels"][name] = dict(passed=passed, traces=rows)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
