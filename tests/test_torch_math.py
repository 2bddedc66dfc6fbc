"""Port parity: rotations and spatial algebra, one parametrised case per
function, on batches drawn like tests/test_rotations.py (seed 0) and
tests/test_spatial.py (seed 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.physics import rotations as trot
from omniisaacgymenvs_torch.physics import spatial as tsp
from omniisaacgymenvs_tpu.physics import rotations as jrot
from omniisaacgymenvs_tpu.physics import spatial as jsp

B = 16  # batch of random inputs per case


def _quats(rng, n=B):
    q = rng.standard_normal((n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _vecs(rng, d=3, n=B, s=1.0):
    return (s * rng.standard_normal((n, d))).astype(np.float32)


def _rotations(rng, n=B):
    out = []
    for _ in range(n):
        Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        out.append(Q)
    return np.stack(out).astype(np.float32)


def _inertias(rng, n=B):
    return np.stack([np.diag(rng.uniform(0.1, 1.0, 3))
                     for _ in range(n)]).astype(np.float32)


ROT_CASES = {
    "quat_mul": lambda r: (_quats(r), _quats(r)),
    "quat_conjugate": lambda r: (_quats(r),),
    "quat_normalize": lambda r: (_vecs(r, 4),),
    "quat_rotate": lambda r: (_quats(r), _vecs(r)),
    "quat_rotate_inverse": lambda r: (_quats(r), _vecs(r)),
    "quat_from_angle_axis": lambda r: (
        r.uniform(-3, 3, B).astype(np.float32),
        _quats(r)[:, 1:] / np.linalg.norm(_quats(r)[:, 1:], axis=1,
                                          keepdims=True)),
    "quat_exp_approx": lambda r: (_vecs(r, s=0.1),),
    "quat_integrate_body": lambda r: (_quats(r), _vecs(r), 0.01),
    "quat_to_rotmat": lambda r: (_quats(r),),
    "rotmat_to_quat": lambda r: (_rotations(r),),
    "normalize_angle": lambda r: (r.uniform(-10, 10, B).astype(np.float32),),
    "get_euler_xyz": lambda r: (_quats(r),),
    "compute_heading_and_up": lambda r: (
        _quats(r), np.array([1, 0, 0, 0], np.float32), _vecs(r),
        np.array([1, 0, 0], np.float32), np.array([0, 0, 1], np.float32), 2),
    "compute_rot": lambda r: (_quats(r), _vecs(r), _vecs(r),
                              np.array([1000, 0, 0], np.float32), _vecs(r)),
    "unscale": lambda r: (_vecs(r), np.float32(-1.5) + np.zeros(3, np.float32),
                          np.float32(2.0) + np.zeros(3, np.float32)),
}

SPATIAL_CASES = {
    "skew": lambda r: (_vecs(r),),
    "motion_transform": lambda r: (_rotations(r), _vecs(r)),
    "transform_motion": lambda r: (_rotations(r), _vecs(r), _vecs(r, 6)),
    "transform_motion_inv": lambda r: (_rotations(r), _vecs(r), _vecs(r, 6)),
    "transform_force": lambda r: (_rotations(r), _vecs(r), _vecs(r, 6)),
    "transform_force_inv": lambda r: (_rotations(r), _vecs(r), _vecs(r, 6)),
    "cross_motion": lambda r: (_vecs(r, 6), _vecs(r, 6)),
    "cross_force": lambda r: (_vecs(r, 6), _vecs(r, 6)),
    "spatial_inertia": lambda r: (r.uniform(0.5, 2.0, B).astype(np.float32),
                                  _vecs(r, s=0.1), _inertias(r)),
    "transform_inertia": lambda r: (
        _rotations(r), _vecs(r),
        np.stack([np.eye(6) * 2.0 + 0.1] * B).astype(np.float32)),
}


def _as(mod, x):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x) if mod == "jax" else torch.as_tensor(x)
    return x


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize(
    "module,name",
    [("rotations", n) for n in ROT_CASES]
    + [("spatial", n) for n in SPATIAL_CASES],
)
def test_function_matches_jax(module, name):
    cases = ROT_CASES if module == "rotations" else SPATIAL_CASES
    rng = np.random.default_rng(0 if module == "rotations" else 1)
    args = cases[name](rng)
    jmod, tmod = (jrot, trot) if module == "rotations" else (jsp, tsp)
    ref = _flat(getattr(jmod, name)(*[_as("jax", a) for a in args]))
    out = _flat(getattr(tmod, name)(*[_as("torch", a) for a in args]))
    assert len(ref) == len(out)
    for a, b in zip(out, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        if name == "rotmat_to_quat":
            # Shepperd's small components carry ~sqrt(float32 eps) of
            # rounding; align signs at the +-q boundary
            a = a * np.sign(np.sum(a * b, axis=-1, keepdims=True))
            np.testing.assert_allclose(a, b, atol=1e-3)
        else:
            # same float32 formulas, other operation order: a few ulps
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
