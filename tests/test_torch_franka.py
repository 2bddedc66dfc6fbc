"""Port parity of the FrankaCabinet task: the model with no props, with
the yaml's four (four FREE roots, the thread form's maximum) and with 16,
`sample_reset` on JAX's own draws, `control`, `observe` and `reward_done`
from a JAX state and carry (a JAX reset and one JAX step carried across as
numpy), a 3-step VecEnv rollout against JAX's, and the kernels' scope past
four props: the group form takes them, the thread form refuses them."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.convert import env_state_from_arrays
from omniisaacgymenvs_torch.envs import VecEnv
from omniisaacgymenvs_torch.models import build_franka_cabinet
from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.physics.engine import check_scope
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.tasks.franka_cabinet import _tf_combine
from omniisaacgymenvs_tpu.envs import VecEnv as JVecEnv
from omniisaacgymenvs_tpu.models.franka_cabinet import (
    build_franka_cabinet as jbuild_franka_cabinet)
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from omniisaacgymenvs_tpu.tasks import franka_cabinet as jfc
from test_torch_model import _assert_model_equal
from torch_parity import jax_fields, np_, to_numpy_tree

N = 8
CFG = {"env": {"numProps": 4}}
# the hooks on the same state: float32 arithmetic in another order
HOOK_TOL = dict(rtol=1e-5, atol=1e-5)
# the rollout: positions and angles to 1e-4, velocities (dof_vel * 0.1)
# carry the step's float32 rounding (tests/test_torch_env.py)
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
    jtask, task = jget_task("FrankaCabinet", CFG), get_task("FrankaCabinet", CFG,
                                                            device="cpu")
    jenv = JVecEnv(jtask, N)
    rng = np.random.default_rng(9)
    actions = rng.uniform(-1, 1, (5, N, task.num_actions)).astype(np.float32)
    jes = jenv.step(jenv.reset(seed=2), jnp.asarray(actions[0]))
    es = env_state_from_arrays(_fields(jes), device="cpu")
    return jtask, task, jenv, jes, es, actions


@pytest.mark.parametrize("num_props", [0, 4, 16])
def test_model_fields_equal(num_props):
    m, drawer = build_franka_cabinet(num_props)
    jm, jdrawer = jbuild_franka_cabinet(num_props)
    _assert_model_equal(m, jax_fields(jm))
    assert drawer == jdrawer == m.body_index("drawer_top_joint")
    assert fs.n_free_roots(m) == num_props
    if num_props == 4:
        # 19 bodies, 56 contact points, 114 pairs, a prismatic drawer under
        # the FIXED cabinet root, finger pads on prismatic fingers
        assert (m.nb, m.ncp, len(m.pair_surf)) == (19, 56, 114)
        assert fs.scope_errors(m) == [] and fs.thread_scope_errors(m) == []
    if num_props == 16:
        # 16 props on a 4 x 4 grid: 31 bodies, 152 contact points, 402 pairs
        assert (m.nb, m.ncp, len(m.pair_surf)) == (31, 152, 402)
        assert fs.scope_errors(m) == []


def test_fifth_prop_is_refused_on_the_card():
    """Five or 16 FREE roots are past the thread form's maximum of four:
    that form refuses the model, naming the FREE roots, while the group
    form takes it, so the engine accepts it on CUDA and `launch_config`
    takes the group form at the yaml's 4096 envs and at any width; the CPU
    steps it."""
    for n in (5, 16):
        m, _ = build_franka_cabinet(n)
        errs = fs.thread_scope_errors(m)
        assert any("FREE roots" in e for e in errs), errs
        with pytest.raises(ValueError, match="FREE roots"):
            fs.launch_config(m, 4096, design="thread")
        assert fs.scope_errors(m) == []
        check_scope(m, cuda=True)
        check_scope(m, cuda=False)
        for width in (4096, 10 ** 6):
            assert fs.launch_config(m, width)["design"] == "group"
    task = get_task("FrankaCabinet", {"env": {"numProps": 5}}, device="cpu")
    es = VecEnv(task, 2, seed=0).reset(seed=0)
    assert torch.isfinite(es.obs).all()


def test_sample_reset_on_jax_draws():
    jtask, task, *_ = case()
    keys = jax.random.split(jax.random.PRNGKey(12), N)
    jq, jqd, jcarry = jax.vmap(jtask.sample_reset)(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (9,)))(keys)
    q, qd, carry = task.reset_from(torch.tensor(np.asarray(u)))
    np.testing.assert_allclose(np_(q), np.asarray(jq), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(np_(qd), np.asarray(jqd))
    np.testing.assert_allclose(np_(carry["dof_targets"]),
                               np.asarray(jcarry["dof_targets"]), rtol=0, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    es = task.reset(64, g)
    noise = es.phys.q[:, task._fq] - task._default_dof
    assert (noise.abs() <= 0.125 + 1e-6).all() and noise.std() > 0.05


def test_tf_combine():
    rng = np.random.default_rng(3)
    q1, q2 = (rng.standard_normal((N, 4)).astype(np.float32) for _ in range(2))
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    p1, p2 = (rng.standard_normal((N, 3)).astype(np.float32) for _ in range(2))
    out = _tf_combine(*map(torch.as_tensor, (q1, p1, q2, p2)))
    ref = jax.vmap(jfc._tf_combine)(*map(jnp.asarray, (q1, p1, q2, p2)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np_(a), np.asarray(b), **HOOK_TOL)


def test_control():
    jtask, task, _, jes, es, actions = case()
    a = actions[1]
    es1 = dataclasses.replace(es, carry=dict(es.carry))
    ctrl = task.control(torch.as_tensor(a), es1)

    def jcontrol(act, jes1):
        jes1 = jes1.replace(carry=dict(jes1.carry))
        return jtask.control(act, jes1), jes1.carry

    jctrl, jcarry = jax.vmap(jcontrol)(jnp.asarray(a), jes)
    for f in dataclasses.fields(ctrl):
        np.testing.assert_allclose(np_(getattr(ctrl, f.name)),
                                   np.asarray(getattr(jctrl, f.name)),
                                   err_msg=f.name, **HOOK_TOL)
    np.testing.assert_allclose(np_(es1.carry["dof_targets"]),
                               np.asarray(jcarry["dof_targets"]), **HOOK_TOL)
    # the step's own carry took the update, the caller's did not
    assert not torch.equal(es1.carry["dof_targets"], es.carry["dof_targets"])


def test_grasp_frames_observe_and_reward_done():
    jtask, task, _, jes, es, actions = case()
    a = actions[1]
    for x, y in zip(task._grasp_frames(es.phys),
                    jax.vmap(jtask._grasp_frames)(jes.phys)):
        np.testing.assert_allclose(np_(x), np.asarray(y), **HOOK_TOL)
    obs, states, _ = task.observe(es.phys, es.carry, torch.as_tensor(a))
    jobs, _, _ = jax.vmap(jtask.observe)(jes.phys, jes.carry, jnp.asarray(a))
    assert obs.shape == (N, 23) == jobs.shape and states.shape == (N, 0)
    np.testing.assert_allclose(np_(obs), np.asarray(jobs), **HOOK_TOL)
    L = task.max_episode_length
    prog = np.array([1, 2, L - 3, L - 2, L - 1, L, 5, 6], np.int32)
    # the drawer opened past each threshold in some envs, the fingers
    # around the handle in others: every branch of the reward
    phys = es.phys
    q = phys.q.clone()
    q[:, task._drawer_q] = torch.tensor([0.0, 0.005, 0.05, 0.25, 0.395, 0.1, 0.3, 0.0])
    pos = phys.body_pos.clone()
    _, _, _, dg = task._grasp_frames(phys)
    pos[4:, task._lfinger_body, 2] = dg[4:, 2] + 0.01
    pos[4:, task._rfinger_body, 2] = dg[4:, 2] - 0.01
    phys = dataclasses.replace(phys, q=q, body_pos=pos)
    jphys = jes.phys.replace(q=jnp.asarray(np_(q)), body_pos=jnp.asarray(np_(pos)))
    r, d, _, m = task.reward_done(es.obs, torch.as_tensor(a), phys, es.carry,
                                  torch.as_tensor(prog))
    jr, jd, _, _ = jax.vmap(jtask.reward_done)(jes.obs, jnp.asarray(a), jphys,
                                               jes.carry, jnp.asarray(prog))
    np.testing.assert_allclose(np_(r), np.asarray(jr), **HOOK_TOL)
    np.testing.assert_array_equal(np_(d), np.asarray(jd))
    assert np_(d)[4] and np_(d)[5] and not np_(d)[0] and m == {}


def test_rollout_matches_jax():
    """Three more steps of both VecEnvs (the task's default sim block: 4
    substeps a step) from the same state under the same actions; envs that
    reset in either are left out."""
    _, task, jenv, jes, es, actions = case()
    env = VecEnv(task, N, seed=0)
    ever_done = np.zeros(N, bool)
    for k in range(1, 4):
        jes = jenv.step(jes, jnp.asarray(actions[k]))
        es = env.step(es, torch.as_tensor(actions[k]))
        ever_done |= np.asarray(jes.done) | np_(es.done)
        keep = ~ever_done
        np.testing.assert_allclose(np_(es.obs)[keep], np.asarray(jes.obs)[keep],
                                   err_msg=f"step {k}", **OBS_TOL)
        np.testing.assert_allclose(np_(es.reward)[keep],
                                   np.asarray(jes.reward)[keep], rtol=1e-3,
                                   atol=1e-3, err_msg=f"step {k}")
        np.testing.assert_array_equal(np_(es.done), np.asarray(jes.done))
        np.testing.assert_array_equal(np_(es.progress), np.asarray(jes.progress))
        # the props stay on the drawer's tray
        np.testing.assert_allclose(np_(es.phys.q), np.asarray(jes.phys.q),
                                   rtol=1e-3, atol=1e-4, err_msg=f"q, step {k}")
    assert (~ever_done).sum() > N // 2


def test_check_profile_holds_the_handle_between_the_pads():
    """The card checks' FrankaCabinet states (`ops/parity.py`): in every
    other env the arm's angles put the grasp frame on the handle bar's axis,
    gripper forward along the drawer's inward axis, gripper up along world
    z, the finger pads in the bar; the props on the drawer's tray."""
    from omniisaacgymenvs_torch.ops import parity
    from omniisaacgymenvs_torch.physics import rotations as rot

    task = get_task("FrankaCabinet", CFG, device="cpu")
    m = task.model
    curl = parity.check_profile(m)["curl"]
    q = m.default_q.expand(1, -1).clone()
    for name, angle in curl.items():
        q[0, int(m.jq_idx[m.dof_index(name)])] = angle
    st = task.engine.init_state(q, torch.zeros(1, m.nv))
    fg_rot, fg_pos, _, _ = task._grasp_frames(st)
    bar_axis = torch.tensor([[0.64, 0.0, 0.7172]])   # drawer frame (-0.16, 0, 0)
    torch.testing.assert_close(fg_pos, bar_axis, rtol=0, atol=1e-3)
    fwd = rot.quat_rotate(fg_rot, task._gripper_forward)
    up = rot.quat_rotate(fg_rot, task._gripper_up)
    assert float(fwd[0, 0]) > 0.999 and float(up[0, 2]) > 0.999
    q, qd, _ = parity.check_inputs(m, 64, seed=0, device="cpu")
    active = parity.active_contacts(task.engine, q, qd)
    assert active["capsule"] > 0 and active["box"] > 0, active
