"""Port parity: model data (build_humanoid / build_ant), the JAX-model
converter, and the copied task yamls."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.models import build_ant, build_humanoid
from omniisaacgymenvs_torch.physics import contacts as tcontacts
from omniisaacgymenvs_torch.physics.model import Model
from omniisaacgymenvs_torch.utils.config import CFG_DIR, load_config
from omniisaacgymenvs_tpu.models import build_ant as jbuild_ant
from omniisaacgymenvs_tpu.models import build_humanoid as jbuild_humanoid
from omniisaacgymenvs_tpu.physics import contacts as jcontacts
from torch_parity import jax_fields, np_

BUILDERS = {"Humanoid": (build_humanoid, jbuild_humanoid),
            "Ant": (build_ant, jbuild_ant)}


def _assert_model_equal(pm: Model, jf: dict):
    assert {f.name for f in dataclasses.fields(Model)} == set(jf)
    for f in dataclasses.fields(Model):
        a, b = getattr(pm, f.name), jf[f.name]
        if isinstance(a, (torch.Tensor, np.ndarray)):
            assert a.dtype in (torch.float32, np.int32), f.name
            # both cast the same float64 build values to float32: exact
            np.testing.assert_array_equal(np_(a), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_model_fields_equal(name):
    build, jbuild = BUILDERS[name]
    _assert_model_equal(build(), jax_fields(jbuild()))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_model_from_arrays_equals_build(name):
    build, jbuild = BUILDERS[name]
    carried = convert.model_from_arrays(jax_fields(jbuild()), device="cpu")
    _assert_model_equal(carried, jax_fields(jbuild()))
    own = build()
    for f in dataclasses.fields(Model):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        if isinstance(a, (torch.Tensor, np.ndarray)):
            np.testing.assert_array_equal(np_(a), np_(b), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_task_yaml_copy_equal(name):
    jdir = os.path.join(os.path.dirname(__file__), "..",
                        "omniisaacgymenvs_tpu", "cfg", "task")
    with open(os.path.join(jdir, f"{name}.yaml"), "rb") as f:
        ref = f.read()
    with open(os.path.join(CFG_DIR, "task", f"{name}.yaml"), "rb") as f:
        assert f.read() == ref
    cfg = load_config({"task": name, "num_envs": 16})
    assert cfg["task"]["env"]["numEnvs"] == 16
    assert cfg["task"]["sim"] == yaml.safe_load(ref)["sim"]


@pytest.mark.parametrize("helper", [
    "point_effective_masses", "point_body_masses", "point_share_masses",
])
def test_contact_mass_helpers_equal(helper):
    pm, jm = build_humanoid(), jbuild_humanoid()
    # float64 numpy on the same float32 fields: equal to rounding
    np.testing.assert_allclose(getattr(tcontacts, helper)(pm),
                               getattr(jcontacts, helper)(jm), rtol=1e-12)


def test_contact_gains_equal():
    pm, jm = build_humanoid(), jbuild_humanoid()
    h = 1.0 / 240.0
    pp = tcontacts.auto_contact_params(pm, h)
    jp = jcontacts.auto_contact_params(jm, h)
    for f in ("kn", "kd", "kt", "mu", "fn_max", "per_mass", "kn_pm",
              "kt_pm", "fnm_pm"):
        assert getattr(pp, f) == pytest.approx(getattr(jp, f), rel=1e-12), f
    for a, b in zip(tcontacts.ground_point_gains(pm, pp),
                    jcontacts.ground_point_gains(jm, jp)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
