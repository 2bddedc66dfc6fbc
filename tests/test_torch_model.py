"""Port parity: model data (every ported builder, field by field), the
JAX-model converter, and the copied task yamls."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import yaml

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.models import (build_allegro_hand, build_ant,
                                           build_anymal, build_balance_bot,
                                           build_cartpole, build_crazyflie,
                                           build_franka_cabinet, build_humanoid,
                                           build_ingenuity, build_quadcopter,
                                           build_shadow_hand)
from omniisaacgymenvs_torch.models import importers
from omniisaacgymenvs_torch.physics import contacts as tcontacts
from omniisaacgymenvs_torch.physics.model import Model
from omniisaacgymenvs_torch.utils.config import CFG_DIR, load_config
from omniisaacgymenvs_tpu.models import build_ant as jbuild_ant
from omniisaacgymenvs_tpu.models import flyers as jflyers
from omniisaacgymenvs_tpu.models import importers as jimporters
from omniisaacgymenvs_tpu.models.allegro_hand import (
    build_allegro_hand as jbuild_allegro_hand)
from omniisaacgymenvs_tpu.models.franka_cabinet import (
    build_franka_cabinet as jbuild_franka_cabinet)
from omniisaacgymenvs_tpu.models import build_humanoid as jbuild_humanoid
from omniisaacgymenvs_tpu.models.anymal import build_anymal as jbuild_anymal
from omniisaacgymenvs_tpu.models.balance_bot import (
    build_balance_bot as jbuild_balance_bot)
from omniisaacgymenvs_tpu.models.cartpole import build_cartpole as jbuild_cartpole
from omniisaacgymenvs_tpu.models.shadow_hand import (
    build_shadow_hand as jbuild_shadow_hand)
from omniisaacgymenvs_tpu.physics import contacts as jcontacts
from torch_parity import jax_fields, np_

_TERRAIN_KW = dict(drive=dict(stiffness=80.0, drive_damping=2.0, max_effort=80.0),
                   dual_foot_contacts=True)


def _custom_model(from_urdf):
    """The Custom task's model of examples/double_pendulum.urdf: the file
    imported, Custom.yaml's drive on every dof."""
    b = from_urdf(os.path.join(os.path.dirname(__file__), "..", "examples",
                               "double_pendulum.urdf"))
    for dof in b.dof_names:
        b.set_drive(dof, stiffness=40.0, damping=2.0, max_effort=100.0)
    return b.finalize()

BUILDERS = {"Humanoid": (build_humanoid, jbuild_humanoid),
            "Ant": (build_ant, jbuild_ant),
            "Cartpole": (build_cartpole, jbuild_cartpole),
            "BallBalance": (build_balance_bot, jbuild_balance_bot),
            "ShadowHand": (build_shadow_hand, jbuild_shadow_hand),
            "Anymal": (build_anymal, jbuild_anymal),
            # AnymalTerrain's model: its drive gains and a second contact
            # point per foot
            "AnymalTerrain": (functools.partial(build_anymal, **_TERRAIN_KW),
                              functools.partial(jbuild_anymal, **_TERRAIN_KW)),
            "Ingenuity": (build_ingenuity, jflyers.build_ingenuity),
            "Quadcopter": (build_quadcopter, jflyers.build_quadcopter),
            "Crazyflie": (build_crazyflie, jflyers.build_crazyflie),
            # the yaml's four props (the builder also returns the drawer)
            "FrankaCabinet": (lambda: build_franka_cabinet(4)[0],
                              lambda: jbuild_franka_cabinet(4)[0]),
            "AllegroHand": (build_allegro_hand, jbuild_allegro_hand),
            "Custom": (lambda: _custom_model(importers.from_urdf),
                       lambda: _custom_model(jimporters.from_urdf))}


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
    # a yaml that inherits another (`defaults`) resolves as in the JAX package
    from omniisaacgymenvs_tpu.utils.config import load_config as jload_config
    own = yaml.safe_load(ref)
    assert cfg["task"]["sim"] == own.get(
        "sim", jload_config({"task": name})["task"]["sim"])
    assert "defaults" not in cfg["task"]


@pytest.mark.parametrize("name", ["ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM"])
def test_openai_task_yaml_copy_equal(name):
    """The two OpenAI yamls, which share the hand's model: byte copies too
    (the LSTM one inherits the FF one through `defaults`)."""
    test_task_yaml_copy_equal(name)


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


def test_hand_model_carries_pairs_tendons_and_gravity_compensation():
    """The converter brings surfaces, pairs, tendons and gravity_comp of
    the ShadowHand scene across, also with self-collisions on."""
    for sc in (False, True):
        jm = jbuild_shadow_hand(self_collisions=sc)
        carried = convert.model_from_arrays(jax_fields(jm), device="cpu")
        _assert_model_equal(carried, jax_fields(jm))
        own = build_shadow_hand(self_collisions=sc)
        assert carried.pair_surf == own.pair_surf
        assert carried.surf_type == own.surf_type
        assert carried.surf_params == own.surf_params
        np.testing.assert_array_equal(carried.pair_point, own.pair_point)
        np.testing.assert_array_equal(carried.tendon_dof, own.tendon_dof)
    assert carried.pair_point.dtype == carried.tendon_dof.dtype == np.int32
    assert len(own.pair_surf) == 674
    m = build_shadow_hand()
    assert (m.nb, m.nq, m.nv, m.njd, m.ncp, len(m.pair_surf), m.nt,
            m.num_sensors) == (26, 31, 30, 24, 69, 69, 4, 5)
    assert int(m.gravity_comp.sum()) == 25
    assert [m.jtype[r] for r in m.roots] == [3, 0]  # FIXED + FREE


def test_model_lookup_helpers():
    m = build_balance_bot()
    assert m.body_index("ball") == 4 and m.dof_index("tilt_x") == 1
    assert (m.root_q_adr("ball"), m.root_v_adr("ball")) == (3, 3)
    with pytest.raises(ValueError):
        m.root_q_adr("base")  # a FIXED root has no coordinates
    with pytest.raises(ValueError):
        m.body_index("nobody")
