"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_*.py): data crosses between the two as
numpy arrays, made from a seed with numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


def jax_fields(obj) -> dict:
    """A JAX dataclass's fields, arrays as numpy (recursing into nested
    dataclasses and dicts)."""
    out = {}
    for f in dataclasses.fields(obj):
        out[f.name] = to_numpy_tree(getattr(obj, f.name))
    return out


def to_numpy_tree(v):
    if dataclasses.is_dataclass(v):
        return jax_fields(v)
    if isinstance(v, dict):
        return {k: to_numpy_tree(x) for k, x in v.items()}
    if hasattr(v, "shape") and not isinstance(v, (np.ndarray, torch.Tensor)):
        return np.asarray(v)
    return v


def lstm_named_arrays(tree, n_mlp: int, actor: bool = True) -> dict:
    """A flax LSTMActorCritic (actor) or LSTMCentralValue tree, parameters
    or their gradients, as {port parameter name: numpy array in the port's
    layout} (flax kernels (in, out), torch weights (out, in))."""
    p = tree["params"] if "params" in tree else tree
    out = {"lstm.wx.weight": p["lstm"]["wx"]["kernel"].T,
           "lstm.wh.weight": p["lstm"]["wh"]["kernel"].T,
           "lstm.wh.bias": p["lstm"]["wh"]["bias"],
           "ln.weight": p["ln"]["scale"], "ln.bias": p["ln"]["bias"]}
    for i in range(n_mlp):
        out[f"mlp_{i}.weight"] = p[f"mlp_{i}"]["kernel"].T
        out[f"mlp_{i}.bias"] = p[f"mlp_{i}"]["bias"]
    for name in (("mu", "value") if actor else ("value",)):
        out[f"{name}.weight"] = p[name]["kernel"].T
        out[f"{name}.bias"] = p[name]["bias"]
    if actor:
        out["log_std"] = p["log_std"]
    return {k: np.asarray(v) for k, v in out.items()}


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def jax_model_from_port(pm):
    """The port's Model as a JAX Model with the same fields (the two
    dataclasses have equal field names, tests/test_torch_model.py)."""
    import jax.numpy as jnp

    from omniisaacgymenvs_tpu.physics.model import Model as JModel

    out = {}
    for f in dataclasses.fields(pm):
        v = getattr(pm, f.name)
        if isinstance(v, (torch.Tensor, np.ndarray)):
            v = jnp.asarray(np_(v))
        out[f.name] = v
    return JModel(**out)


def jax_step(jeng, q, qd, eff, ptg, fa, n_substeps):
    """The JAX engine's step_n (XLA path on the CPU) over a numpy batch:
    (q, qd, sensor_forces, pos, quat, avel, lvel) after n_substeps."""
    import jax
    import jax.numpy as jnp

    from omniisaacgymenvs_tpu.physics.state import Control as JControl

    m = jeng.model

    def one(q1, qd1, e1, p1, f1):
        st = jeng.init_state(q1, qd1)
        ctrl = JControl(effort=e1, pos_target=p1, vel_target=jnp.zeros(m.njd),
                        body_force=f1[:, 3:6], body_torque=f1[:, 0:3])
        s = jeng.step_n(st, ctrl, n_substeps // jeng.params.substeps)
        return (s.q, s.qd, s.sensor_forces, s.body_pos, s.body_quat,
                s.body_avel, s.body_lvel)

    return jax.jit(jax.vmap(one))(*map(jnp.asarray, (q, qd, eff, ptg, fa)))


def jax_substep(jeng, q, qd, eff, ptg, fa):
    """One JAX `_substep` over a numpy batch: (q, qd, sensor_forces)."""
    import jax
    import jax.numpy as jnp

    from omniisaacgymenvs_tpu.physics.state import Control as JControl

    m = jeng.model
    h = jeng.params.dt / jeng.params.substeps

    def one(q1, qd1, e1, p1, f1):
        ctrl = JControl(effort=e1, pos_target=p1, vel_target=jnp.zeros(m.njd),
                        body_force=f1[:, 3:6], body_torque=f1[:, 0:3])
        return jeng._substep(q1, qd1, ctrl, f1, h)

    return jax.jit(jax.vmap(one))(*map(jnp.asarray, (q, qd, eff, ptg, fa)))


# step_n over 4 substeps of float32 dynamics in another operation order:
# positions to 1e-4, velocities and contact wrenches (stiff contacts
# amplify rounding) relative; quaternions sign-aligned. (rtol, atol)
STEP_N_TOL = {"q": (1e-3, 1e-4), "qd": (5e-3, 5e-3),
              "sensor_forces": (1e-3, 1e-2), "pos": (1e-3, 1e-4),
              "quat": (1e-3, 1e-3), "avel": (5e-3, 5e-3), "lvel": (5e-3, 5e-3)}
STEP_N_NAMES = ("q", "qd", "sensor_forces", "pos", "quat", "avel", "lvel")


def assert_step_close(out, ref, names=STEP_N_NAMES, tol=STEP_N_TOL):
    from omniisaacgymenvs_torch.ops.parity import sign_align

    for name, a, b in zip(names, out, ref):
        a, b = np_(a), np.asarray(b)
        assert a.shape == b.shape, name
        if name == "quat":
            a = np_(sign_align(torch.tensor(a), torch.tensor(b)))
        rtol, atol = tol[name]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
