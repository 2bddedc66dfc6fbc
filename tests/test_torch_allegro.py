"""Port parity of the AllegroHand task: the model (the cube's 26 dense-box
points against the palm's and the cube's boxes, gravity compensation on
every hand body), `observe` in both observation types, `control` and
`reward_done` from a JAX state and carry (a JAX reset and one JAX step
carried across as numpy), and a 3-step VecEnv rollout against JAX's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.convert import env_state_from_arrays
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.models import allegro_hand as alm
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.models import allegro_hand as jalm
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from test_torch_model import _assert_model_equal
from torch_parity import jax_fields, np_, to_numpy_tree

N = 8
# the hooks on the same state: float32 arithmetic in another order
HOOK_TOL = dict(rtol=1e-5, atol=1e-5)
# the rollout: positions and angles to 1e-4; velocity terms and the steep
# rotation reward carry the step's float32 rounding (tests/test_torch_tasks.py)
OBS_TOL = dict(rtol=2e-3, atol=2e-3)


def _fields(jes):
    f = {fl.name: to_numpy_tree(getattr(jes, fl.name))
         for fl in dataclasses.fields(jes)}
    f.pop("rng")
    return f


@functools.lru_cache(maxsize=None)
def case():
    """(JAX task, port task, JAX env, JAX state after a reset and one step,
    the same state in the port, actions)."""
    jtask, task = jget_task("AllegroHand"), get_task("AllegroHand", device="cpu")
    jenv = JVecEnv(jtask, N)
    rng = np.random.default_rng(16)
    actions = rng.uniform(-1, 1, (5, N, task.num_actions)).astype(np.float32)
    jes = jenv.step(jenv.reset(seed=2), jnp.asarray(actions[0]))
    es = env_state_from_arrays(_fields(jes), device="cpu")
    return jtask, task, jenv, jes, es, actions


@pytest.mark.parametrize("scene", [None, {"tilt": (0.0, 0.2), "thumb_abduct": 0.5}])
def test_model_and_scene_frames(scene):
    m = alm.build_allegro_hand(scene)
    _assert_model_equal(m, jax_fields(jalm.build_allegro_hand(scene)))
    for a, b in zip(alm.scene_frames(scene), jalm.scene_frames(scene)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (m.nb, m.njd, m.ncp, len(m.pair_surf), m.num_sensors, m.nt) == (
        18, 16, 62, 62, 0, 0)
    assert int(m.gravity_comp.sum()) == 17      # all but the cube
    assert [m.jtype[r] for r in m.roots] == [3, 0]  # FIXED palm + FREE cube
    assert fs.scope_errors(m) == []


@pytest.mark.parametrize("obs_type", ["full", "full_no_vel"])
def test_observe(obs_type):
    _, _, _, jes, es, actions = case()
    cfg = {"env": {"observationType": obs_type}}
    jtask, task = jget_task("AllegroHand", cfg), get_task("AllegroHand", cfg,
                                                            device="cpu")
    a = actions[1]
    obs, states, carry = task.observe(es.phys, es.carry, torch.as_tensor(a))
    jobs, _, _ = jax.vmap(jtask.observe)(jes.phys, jes.carry, jnp.asarray(a))
    assert obs.shape == (N, {"full": 72, "full_no_vel": 50}[obs_type]) == jobs.shape
    assert states.shape == (N, 0) and carry is es.carry
    np.testing.assert_allclose(np_(obs), np.asarray(jobs), **HOOK_TOL)


def test_task_attributes():
    jtask, task, *_ = case()
    assert task.dr_view_name == jtask.dr_view_name == "allegro_hand_view"
    assert task.num_actions == 16 and task.num_states == 0
    np.testing.assert_array_equal(np_(task.goal_pos), np.asarray(jtask.goal_pos))
    assert task.decimation == jtask.decimation
    assert task.max_episode_length == jtask.max_episode_length
    assert set(task.dr_views["allegro_hand_view"]) == {"dofs", "bodies", "tendons"}


def test_control_and_reward_done():
    jtask, task, _, jes, es, actions = case()
    a = actions[1]
    es1 = dataclasses.replace(es, carry=dict(es.carry))
    ctrl = task.control(torch.as_tensor(a), es1, torch.Generator().manual_seed(0))

    def jcontrol(act, jes1):
        jes1 = jes1.replace(carry=dict(jes1.carry))
        return jtask.control(act, jes1), jes1.carry

    jctrl, jcarry = jax.vmap(jcontrol)(jnp.asarray(a), jes)
    # no env hit its goal in the first step, so no goal is drawn anew
    assert not np.asarray(jes.carry["reset_goal"]).any()
    for f in dataclasses.fields(ctrl):
        np.testing.assert_allclose(np_(getattr(ctrl, f.name)),
                                   np.asarray(getattr(jctrl, f.name)),
                                   err_msg=f.name, **HOOK_TOL)
    for k in jcarry:
        np.testing.assert_allclose(np_(es1.carry[k]), np.asarray(jcarry[k]),
                                   err_msg=k, **HOOK_TOL)
    prog = np.array([1, 2, 598, 599, 600, 5, 6, 7], np.int32)
    r, d, carry, metrics = task.reward_done(es.obs, torch.as_tensor(a), es.phys,
                                            es.carry, torch.as_tensor(prog))
    jr, jd, jcarry, jmetrics = jax.vmap(jtask.reward_done)(
        jes.obs, jnp.asarray(a), jes.phys, jes.carry, jnp.asarray(prog))
    np.testing.assert_allclose(np_(r), np.asarray(jr), **HOOK_TOL)
    np.testing.assert_array_equal(np_(d), np.asarray(jd))
    assert np_(d).any() and not np_(d).all()
    for k in jmetrics:
        np.testing.assert_allclose(np_(metrics[k]), np.asarray(jmetrics[k]))


def test_rollout_matches_jax():
    """Three more steps of both VecEnvs from the same state under the same
    actions; envs that reset, or hit their goal and have it drawn anew, in
    either are left out (the two draw from different generators)."""
    _, task, jenv, jes, es, actions = case()
    env = VecEnv(task, N, seed=0)
    ever = np.zeros(N, bool)
    for k in range(1, 4):
        jes = jenv.step(jes, jnp.asarray(actions[k]))
        es = env.step(es, torch.as_tensor(actions[k]))
        ever |= np.asarray(jes.done) | np_(es.done)
        keep = ~ever
        np.testing.assert_allclose(np_(es.obs)[keep], np.asarray(jes.obs)[keep],
                                   err_msg=f"step {k}", **OBS_TOL)
        # the rotation reward 1 / (|rot_dist| + 0.1) is steep near a hit
        np.testing.assert_allclose(np_(es.reward)[keep],
                                   np.asarray(jes.reward)[keep], rtol=1e-3,
                                   atol=1e-2, err_msg=f"step {k}")
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
        np.testing.assert_array_equal(np_(es.progress), np.asarray(jes.progress))
        ever |= np.asarray(jes.carry["reset_goal"]) | np_(es.carry["reset_goal"])
    assert (~ever).sum() > N // 2


def test_check_states_part_a_tie_along_the_rotated_cube():
    """Env 7615 of the AllegroHand's seed-1 check states holds a fingertip
    point in the cube whose two nearest face distances the first nudge
    direction moves alike: the nudges after the first roll its components,
    and the tie parts (the first direction alone left it within 1e-5 m
    after the seven nudges the eight tries allow)."""
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.physics import contacts, dynamics

    task = get_task("AllegroHand", device="cpu")
    eng, m = task.engine, task.model
    q, qd, _ = parity.check_inputs(m, 8192, seed=1, device="cpu")
    q, qd = q[7615:7616].contiguous(), qd[7615:7616].contiguous()

    def tie(q_):
        kin = dynamics.kinematics(m, q_, qd)
        return float(contacts.box_face_ties(m, eng.pair_groups, kin.pw, kin.Rw)[0])

    assert tie(q) < parity.TIE_MARGIN
    fixed = q.clone()
    for _ in range(7):
        fixed[:, m.q_adr[m.roots[1]]:m.q_adr[m.roots[1]] + 3] += fixed.new_tensor(
            parity.TIE_NUDGE)
    assert tie(fixed) < parity.TIE_MARGIN
    assert tie(parity.clear_box_ties(eng, q, qd)) >= parity.TIE_MARGIN
