"""The envs behind a kernel-vs-plain reading (under a randomization overlay
where the task randomizes), and how their plain step moves under small
changes of the state.

    python tools/conditioning_probe.py \
        [task=ShadowHandOpenAI_FF|AllegroHand] [num_envs=8229] [seeds=0,1,2,3] [top=6]

Needs a CUDA card (`device=cpu` runs the plain version on both sides, a dry
run of the script). For each seed, on the check states and overlay that
`scripts/tolerance_controls.py` uses (`parity.check_inputs`,
`parity.overlay_inputs` where the task randomizes, `parity.clear_box_ties`),
K1 at the main path's depth against its plain version, per env:
  gap        the kernel's tolerance use against the plain step;
  nudge d    the plain step's own tolerance use when the state moves by
             `parity.COND_EPS` of its size in direction d
             (`parity.cond_nudge`): `+` (the one direction the conditioning
             test took before), `-`, and `r0`..`r3`, random signs per
             coordinate;
  kernel +   the kernel's own tolerance use under the `+` nudge.
Then, for each criterion, the envs it leaves out and the worst gap of the
envs it keeps. For the `top` envs of the largest gap among those that the
`+` nudge keeps: every field's gap and nudges, the overlay values of the
bodies that move most, and the gap and the `+` nudge after 1, 2, ..., n
substeps (does the gap grow as the plain step's own sensitivity does, or
jump at one substep?). The summary, with every top env's overlay, goes as
JSON to `out=` (default conditioning_probe.json in the working directory).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.config import load_config

def field_use(outs, refs, names, tol) -> torch.Tensor:
    """(fields, N) float64 per-env tolerance use of each field."""
    rows = []
    for n, a, b in zip(names, outs, refs):
        if n == "body_quat":
            a = parity.sign_align(a, b)
        rows.append(parity.env_tolerance_use(a, b, *tol[n]))
    return torch.stack(rows)


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    task_name = args.get("task", "ShadowHandOpenAI_FF")
    n = int(args.get("num_envs", 8229))
    seeds = [int(s) for s in args.get("seeds", "0,1,2,3").split(",")]
    top = int(args.get("top", 6))
    dev = torch.device(args.get("device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("conditioning_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    task = get_task(task_name, load_config({"task": task_name})["task"],
                    device=dev)
    eng = task.engine
    m = eng.model
    n_sub = (task.decimation * eng.params.substeps
             // eng.k1_launches(task.decimation))
    names, tol = parity.STEP_NAMES, parity.step_tol(m)
    print(f"card: {card} | {task_name}, {n} envs, {n_sub} substeps a K1 launch",
          flush=True)
    summary = {"card": card, "task": task_name, "num_envs": n, "seeds": {}}
    for seed in seeds:
        ov = parity.overlay_inputs(m, n, seed, dev) if task._dr_on else None
        q, qd, eff = parity.check_inputs(m, n, seed, dev)
        q = parity.clear_box_ties(eng, q, qd, ov)
        ptg = parity.check_targets(m, q, seed)
        z = torch.zeros((n, m.njd), device=dev)
        fa = torch.zeros((n, m.nb, 6), device=dev)

        def plain(q_, qd_, k=n_sub, idx=None):
            s = slice(None) if idx is None else idx
            o = None if ov is None else {key: v[s].contiguous() for key, v in ov.items()}
            return fs.step_plain(eng, q_, qd_, eff[s], ptg[s], z[s], fa[s], k,
                                 overlay=o)

        def kernel(q_, qd_, k=n_sub, idx=None):
            s = slice(None) if idx is None else idx
            o = None if ov is None else {key: v[s].contiguous() for key, v in ov.items()}
            return fs.step(eng, q_, qd_, eff[s].contiguous(), ptg[s].contiguous(),
                           z[s].contiguous(), fa[s].contiguous(), k, overlay=o)

        ref = plain(q, qd)
        gap_f = field_use(kernel(q, qd), ref, names, tol)
        gap = gap_f.amax(0)
        nud_f = {d: field_use(plain(parity.cond_nudge(q, d),
                                    parity.cond_nudge(qd, d)), ref, names, tol)
                 for d in parity.COND_DIRECTIONS}
        nud = {d: v.amax(0) for d, v in nud_f.items()}
        kref = kernel(q, qd)
        k_self = field_use(kernel(parity.cond_nudge(q, "+"),
                                  parity.cond_nudge(qd, "+")), kref, names, tol).amax(0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        crit = {
            "+ (current)": nud["+"],
            "+ and -": torch.maximum(nud["+"], nud["-"]),
            "all six (well_conditioned)": torch.stack(list(nud.values())).amax(0),
        }
        rows = {}
        for label, use in crit.items():
            keep = use < parity.COND_SHARE
            worst = float(gap[keep].max())
            rows[label] = {"left_out": int((~keep).sum()), "worst_gap": worst,
                           "envs_over_1": int((gap[keep] > 1).sum())}
            print(f"seed {seed} criterion {label:12s}: {rows[label]['left_out']} "
                  f"of {n} left out, worst gap of the kept {worst:.4f}, kept envs "
                  f"over 1: {rows[label]['envs_over_1']}", flush=True)
        # how the gap and the nudges relate, over all envs
        ratio = gap / torch.stack(list(nud.values())).amax(0).clamp_min(1e-12)
        print(f"seed {seed}: envs with gap > 0.5: {int((gap > 0.5).sum())}; gap over "
              f"the largest nudge: median {float(ratio.median()):.3g}, max "
              f"{float(ratio.max()):.3g}; kernel's own + nudge max "
              f"{float(k_self.max()):.4g}", flush=True)
        keep0 = nud["+"] < parity.COND_SHARE
        order = torch.argsort(torch.where(keep0, gap, torch.zeros_like(gap)),
                              descending=True)[:top]
        envs = []
        for e in order.tolist():
            fields = {
                name: {"gap": float(gap_f[i, e]),
                       **{d: float(nud_f[d][i, e]) for d in parity.COND_DIRECTIONS}}
                for i, name in enumerate(names)}
            ov_e = {key: [round(float(x), 4) for x in v[e].tolist()]
                    for key, v in (ov or {}).items()}
            envs.append({"env": e, "gap": float(gap[e]),
                         "nudge": {d: float(nud[d][e]) for d in parity.COND_DIRECTIONS},
                         "kernel_nudge": float(k_self[e]), "fields": fields,
                         "overlay": ov_e})
            print(f"  env {e}: gap {float(gap[e]):.4f}; nudges "
                  + ", ".join(f"{d} {float(nud[d][e]):.4f}" for d in parity.COND_DIRECTIONS)
                  + f"; kernel + {float(k_self[e]):.4f}", flush=True)
            for name, f in fields.items():
                print(f"    {name:13s} gap {f['gap']:.4f} | "
                      + " ".join(f"{d} {f[d]:.4f}" for d in parity.COND_DIRECTIONS), flush=True)
            if ov is None:
                continue
            # the FREE cube is the model's last body
            print("    cube: " + ", ".join(
                f"{key} {ov_e[key][-1]}" for key in
                ("mass_scale", "geom_scale", "friction_scale"))
                + f"; gravity_delta {ov_e['gravity_delta']}", flush=True)
        # the gap and the `+` nudge after 1..n_sub substeps, top envs only
        idx = order.to(dev)
        qi, qdi = q[idx].contiguous(), qd[idx].contiguous()
        growth = []
        for k in range(1, n_sub + 1):
            r = plain(qi, qdi, k, idx)
            g_k = field_use(kernel(qi, qdi, k, idx), r, names, tol).amax(0)
            n_k = field_use(plain(parity.cond_nudge(qi, "+"),
                                  parity.cond_nudge(qdi, "+"), k, idx),
                            r, names, tol).amax(0)
            growth.append({"substeps": k, "gap": g_k.tolist(), "nudge": n_k.tolist()})
            print(f"  after {k:2d} substeps: gap "
                  + " ".join(f"{x:.3g}" for x in g_k.tolist()) + " | + nudge "
                  + " ".join(f"{x:.3g}" for x in n_k.tolist()), flush=True)
        summary["seeds"][seed] = {"criteria": rows, "top": envs, "growth": growth}
    out = args.get("out", "conditioning_probe.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f)
    print(f"{card} | summary in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
