"""Holding the kernels against their plain versions: the check states, the
tolerances and the comparison, shared by `chip_smoke.py`, the tolerance
controls (`scripts/tolerance_controls.py`) and the card tests.

An output element passes when

    |kernel - plain| <= atol + rtol * |plain| + scale * max_env |plain|

where max_env is the largest magnitude of that output within the same env
(a contact force is judged against that env's forces, not against the
deepest contact of the whole batch). `tolerance_use` is the largest ratio
of the error to that limit: below 1 passes.
"""

from __future__ import annotations

import numpy as np
import torch

STEP_NAMES = ("q", "qd", "sensor_forces", "body_pos", "body_quat",
              "body_avel", "body_lvel")
FK_NAMES = ("body_pos", "body_quat", "body_avel", "body_lvel")

# (rtol, scale, atol) per output. K1: float32 in another operation order
# over 4 substeps with stiff contacts. Each limit sits between the largest
# error of the sound build and the reading of a broken control: the
# velocities' limits refuse a --use_fast_math build, and every output
# refuses a dropped substep or a 0.1% gain error (readings from
# scripts/tolerance_controls.py in PERF.md, Findings). A contact force
# errs by the point gain times the position error whatever the force's
# size: 5.5e4 N/m (the stiffest point) times 2e-5 m (twice the sound
# runs' largest q error) gives the sensor forces' 1 N floor.
STEP_TOL = {"q": (1e-3, 1e-4, 0.0), "qd": (2e-3, 4e-4, 0.0),
            "sensor_forces": (1e-3, 5e-4, 1.0), "body_pos": (1e-3, 1e-4, 0.0),
            "body_quat": (1e-3, 1e-3, 0.0), "body_avel": (2e-3, 4e-4, 0.0),
            "body_lvel": (2e-3, 4e-4, 0.0)}
# K2: one FK pass; Shepperd's small quaternion components round at about
# sqrt(float32 eps) of their size
FK_TOL = {"body_pos": (1e-4, 1e-5, 0.0), "body_quat": (0.0, 1e-3, 0.0),
          "body_avel": (1e-4, 1e-5, 0.0), "body_lvel": (1e-4, 1e-5, 0.0)}

# the check states lower the root by up to this much (m): feet press into
# the ground about as deep as they do in a standing rollout's first steps
CHECK_DROP = 0.1


def perturbed_batch(default_q, jq, lower, upper, nv, rng, N, scale=0.05,
                    vel=0.3, drop=0.0):
    """(q, qd) float32 numpy batch near default_q for a single FREE-root
    model: joint coords jittered within limits, root pose jittered with a
    renormalized quaternion, root height lowered by up to `drop`."""
    q = np.tile(np.asarray(default_q, np.float64), (N, 1))
    q[:, jq] += scale * rng.standard_normal((N, len(jq)))
    q[:, jq] = np.clip(q[:, jq], lower, upper)
    q[:, 0:3] += scale * rng.standard_normal((N, 3))
    q[:, 2] -= drop * rng.uniform(0.0, 1.0, N)
    q[:, 3:7] += scale * rng.standard_normal((N, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = vel * rng.standard_normal((N, nv))
    return q.astype(np.float32), qd.astype(np.float32)


def check_inputs(model, n: int, seed: int, device, drop: float = CHECK_DROP):
    """(q, qd, effort) on `device`: states near default_q (perturbed_batch)
    and uniform efforts in [-40, 40] N m, made from `seed` with numpy."""
    cpu = lambda x: x.detach().cpu().numpy()  # noqa: E731
    rng = np.random.default_rng(seed)
    q, qd = perturbed_batch(cpu(model.default_q), model.jq_idx,
                            cpu(model.dof_limit_lower),
                            cpu(model.dof_limit_upper), model.nv, rng, n,
                            drop=drop)
    eff = rng.uniform(-40.0, 40.0, (n, model.njd)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (q, qd, eff))


def sign_align(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a with each quaternion's sign flipped to agree with b (q and -q are
    one rotation)."""
    s = torch.sign((a * b).sum(-1, keepdim=True))
    return a * torch.where(s == 0, torch.ones_like(s), s)


def tolerance_use(a: torch.Tensor, b: torch.Tensor, rtol: float,
                  scale: float, atol: float) -> float:
    """Largest |a - b| / (atol + rtol |b| + scale max_env |b|); inf where a
    is not finite or an error meets a zero limit."""
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    a64, b64 = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    err = (a64 - b64).abs()
    lim = atol + rtol * b64.abs() + scale * b64.abs().amax(dim=1, keepdim=True)
    use = torch.where(err == 0, torch.zeros_like(err), err / lim)
    return float(use.max())


def compare(outs, refs, names, tol) -> dict:
    """{name: (max abs err, tolerance use)} of kernel outputs against plain
    ones; quaternions are sign-aligned first."""
    res = {}
    for n, a, b in zip(names, outs, refs):
        if n == "body_quat":
            a = sign_align(a, b)
        res[n] = (float((a - b).abs().max()), tolerance_use(a, b, *tol[n]))
    return res


def assert_within(label: str, res: dict, tol: dict, log=print) -> float:
    """Log each field of a `compare` result and raise if any is out of
    tolerance; returns the largest abs error."""
    for n, (err, use) in res.items():
        log(f"  {label} {n}: max abs err {err:.3e}, tolerance use "
            f"{use:.3f} (rtol, scale, atol {tol[n]})")
    bad = [n for n, (_, use) in res.items() if not use <= 1.0]
    if bad:
        raise AssertionError(f"{label}: {bad} out of tolerance")
    return max(err for err, _ in res.values())
