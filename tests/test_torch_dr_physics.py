"""Domain-randomization overlays through the physics of both packages:
seeded numpy overlays through `engine.step_n` and `engine._substep` of the
port and of the JAX package on BallBalance (eight keys) and the ShadowHand
scene (all ten), the port's plain substep against the JAX kernel's
`substep_math` with `dr_keys`, every key's effect on a rollout, the exact
neutrality of a neutral overlay on the CPU, the refusal of wrong shapes and
unknown keys, and the overlay's share of the kernels' bounds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.ops import parity
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_tpu.ops import fused_substep as jfs
from omniisaacgymenvs_tpu.physics.state import Control as JControl
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from torch_parity import (STEP_N_NAMES, STEP_N_TOL, assert_step_close, np_)

N = 8
SCENES = ("BallBalance", "ShadowHand")
TEN = tuple(fs.OVERLAY_KEYS)
# BallBalance has no tendons: the eight keys the JAX kernel's own overlay
# test draws
EIGHT = tuple(k for k in TEN if not k.startswith("tendon_"))


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX engine, port engine, inputs, overlay): `parity.check_inputs`
    states with pairs in contact and an overlay of every key the model has a
    size for, drawn with numpy from a seed."""
    jeng, eng = jget_task(name).engine, get_task(name, device="cpu").engine
    m = eng.model
    q, qd, eff = parity.check_inputs(m, N, seed=4, device="cpu")
    ptg = parity.check_targets(m, q, 4)
    ins = (q, qd, eff, ptg, torch.zeros_like(ptg), torch.zeros(N, m.nb, 6))
    ov = parity.overlay_inputs(m, N, seed=4, device="cpu")
    assert tuple(ov) == (TEN if name == "ShadowHand" else EIGHT)
    assert parity.active_contacts(eng, q, qd)["pairs"] > 0
    return jeng, eng, ins, ov


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(np_(tree))


def _jax_step_n(jeng, ins, n_control, overlay):
    q, qd, eff, ptg, _, fa = (_jnp(a) for a in ins)
    m = jeng.model

    def one(q1, qd1, e1, p1, f1, ov):
        ctrl = JControl(effort=e1, pos_target=p1, vel_target=jnp.zeros(m.njd),
                        body_force=f1[:, 3:6], body_torque=f1[:, 0:3])
        s = jeng.step_n(jeng.init_state(q1, qd1), ctrl, n_control, ov or None)
        return (s.q, s.qd, s.sensor_forces, s.body_pos, s.body_quat,
                s.body_avel, s.body_lvel)

    return jax.jit(jax.vmap(one))(q, qd, eff, ptg, fa, _jnp(overlay or {}))


@pytest.mark.parametrize("name", SCENES)
def test_step_n_with_overlay_matches_jax(name):
    """One control step (4 substeps) under the overlay through both
    engines, at the `step_n` tolerances of the port's first slice,
    unchanged: positions rtol 1e-3 atol 1e-4, velocities 5e-3 / 5e-3,
    sensor forces 1e-3 / 1e-2, quaternions 1e-3 / 1e-3."""
    jeng, eng, ins, ov = case(name)
    assert STEP_N_TOL["q"] == (1e-3, 1e-4) and STEP_N_TOL["qd"] == (5e-3, 5e-3)
    q, qd, eff, ptg, z, fa = ins
    st = eng.init_state(q, qd)
    ctrl = eng.default_control(N)
    ctrl.effort, ctrl.pos_target = eff, ptg
    n_control = 2
    assert n_control * eng.params.substeps == 4
    s = eng.step_n(st, ctrl, n_control, overlay=ov)
    out = (s.q, s.qd, s.sensor_forces, s.body_pos, s.body_quat, s.body_avel,
           s.body_lvel)
    ref = _jax_step_n(jeng, ins, n_control, ov)
    assert_step_close(out, ref)
    # the overlay is no no-op: without it the step ends elsewhere
    bare = eng.step_n(st, ctrl, n_control)
    assert (bare.qd - s.qd).abs().max() > 1e-2
    # and the CPU wrapper is the plain version
    for a, b in zip(fs.step(eng, *ins, 4, overlay=ov), out):
        assert torch.equal(a, b)


def _substep_math(jeng, m, ins, overlay):
    """The JAX kernel's `substep_math` with `dr_keys` on a numpy batch, run
    op by op (no jit: the unrolled scalar trace of the 26-body hand takes
    minutes to compile on the CPU): (q, qd, sensor_forces)."""
    dr_keys = tuple(sorted(overlay))
    fused = jfs.build_fused_substep(
        jeng.model, jeng.params.dt / jeng.params.substeps,
        jeng.params.gravity, jeng.contact_params, dr_keys=dr_keys)
    n = ins[0].shape[0]
    cols = [jnp.asarray(np_(a).reshape(n, -1))
            for a in (*ins, *(overlay[k] for k in dr_keys))]
    outs = fused.substep_math(list(jnp.concatenate(cols, axis=1).T))
    outs = np.stack([np.asarray(o) for o in outs], axis=1)
    return (outs[:, :m.nq], outs[:, m.nq:m.nq + m.nv],
            outs[:, m.nq + m.nv:].reshape(n, -1, 6))


@pytest.mark.parametrize("name", SCENES)
def test_substep_plain_with_overlay_matches_jax_substep_math(name):
    """K3's plain version under the overlay against the JAX kernel's math
    with the same `dr_keys`, and the packed order the CUDA kernel reads."""
    jeng, eng, ins, ov = case(name)
    m = eng.model
    out = fs.substep_plain(eng, *ins, overlay=ov)
    ref = _substep_math(jeng, m, ins, ov)
    assert_step_close(out, ref, names=STEP_N_NAMES[:3])
    for a, b in zip(fs.substep(eng, *ins, overlay=ov), out):
        assert torch.equal(a, b)
    # the JAX kernel takes its keys sorted; so does the packed overlay
    assert tuple(fs.OVERLAY_KEYS) == tuple(sorted(fs.OVERLAY_KEYS))
    packed = fs.pack_overlay(m, ov, N, "cpu")
    assert packed.shape == (N, sum(fs.overlay_sizes(m).values()))
    torch.testing.assert_close(
        packed, torch.cat([ov[k] for k in sorted(ov)], dim=1), rtol=0, atol=0)


@pytest.mark.parametrize("name", SCENES)
def test_substep_with_overlay_matches_jax_substep(name):
    """One `_substep` of both engines' plain paths under the overlay."""
    jeng, eng, ins, ov = case(name)
    q, qd, eff, ptg, _, fa = (_jnp(a) for a in ins)
    m = jeng.model
    h = jeng.params.dt / jeng.params.substeps

    def one(q1, qd1, e1, p1, f1, o):
        ctrl = JControl(effort=e1, pos_target=p1, vel_target=jnp.zeros(m.njd),
                        body_force=f1[:, 3:6], body_torque=f1[:, 0:3])
        return jeng._substep(q1, qd1, ctrl, f1, h, o)

    ref = jax.jit(jax.vmap(one))(q, qd, eff, ptg, fa, _jnp(ov))
    out = fs.substep_plain(eng, *ins, overlay=ov)
    assert_step_close(out, ref, names=STEP_N_NAMES[:3])


# values far from neutral, as the JAX package's own test of the keys'
# effect uses them
STRONG = {
    "stiffness_scale": 1.7, "damping_scale": 3.0, "mass_scale": 1.6,
    "friction_scale": 0.05, "geom_scale": 1.05, "gravity_delta": 4.0,
    "limit_lower_delta": 1.2, "limit_upper_delta": -0.55,
    "tendon_stiffness_scale": 0.05, "tendon_damping_scale": 30.0,
}


@pytest.mark.parametrize("key", TEN)
def test_every_overlay_key_alters_the_rollout(key):
    _, eng, ins, _ = case("ShadowHand")
    size = fs.overlay_sizes(eng.model)[key]
    base = fs.step_plain(eng, *ins, 8)
    alt = fs.step_plain(eng, *ins, 8,
                        overlay={key: torch.full((N, size), STRONG[key])})
    assert (alt[0] - base[0]).abs().max() > 1e-5, key
    assert all(torch.isfinite(x).all() for x in alt)


@pytest.mark.parametrize("name", SCENES)
def test_neutral_overlay_is_exact_on_the_cpu(name):
    _, eng, ins, ov = case(name)
    neutral = {k: torch.ones_like(v) if k.endswith("_scale")
               else torch.zeros_like(v) for k, v in ov.items()}
    for a, b in zip(fs.step_plain(eng, *ins, 4, overlay=neutral),
                    fs.step_plain(eng, *ins, 4)):
        assert torch.equal(a, b)
    # an empty overlay is no overlay
    assert fs.check_overlay(eng.model, {}, N, "cpu") is None
    for a, b in zip(fs.substep_plain(eng, *ins, overlay={}),
                    fs.substep_plain(eng, *ins)):
        assert torch.equal(a, b)


def test_packed_overlay_fills_absent_keys_with_neutral_values():
    _, eng, _, ov = case("ShadowHand")
    m = eng.model
    sizes = fs.overlay_sizes(m)
    assert sum(sizes.values()) == 185 == 4 * 24 + 2 * 4 + 3 * 26 + 3
    packed = fs.pack_overlay(m, {"mass_scale": ov["mass_scale"]}, N, "cpu")
    off = 0
    for key, size in sizes.items():
        part = packed[:, off:off + size]
        if key == "mass_scale":
            assert torch.equal(part, ov[key])
        else:
            assert (part == (1.0 if key.endswith("_scale") else 0.0)).all(), key
        off += size


def test_wrong_shape_or_unknown_key_raises():
    _, eng, ins, ov = case("BallBalance")
    m = eng.model
    q, qd = ins[0], ins[1]
    st = eng.init_state(q, qd)
    ctrl = eng.default_control(N)
    with pytest.raises(KeyError, match="unknown overlay key"):
        eng.step_n(st, ctrl, 1, overlay={"inertia_scale": torch.ones(N, m.nb)})
    with pytest.raises(ValueError, match="shape"):
        eng.step_n(st, ctrl, 1, overlay={"mass_scale": torch.ones(m.nb)})
    with pytest.raises(ValueError, match="shape"):
        fs.step_plain(eng, *ins, 1, overlay={"gravity_delta": torch.zeros(N, 4)})
    with pytest.raises(TypeError, match="dtype"):
        fs.substep_plain(eng, *ins,
                         overlay={"mass_scale": ov["mass_scale"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        fs.step(eng, *ins, 1, overlay={
            "mass_scale": ov["mass_scale"].t().contiguous().t()})
    with pytest.raises(ValueError, match="shape"):
        fs.substep(eng, *ins, overlay={"mass_scale": ov["mass_scale"][:-1]})
    # a key the model has no size for takes an empty tensor
    out = fs.step_plain(eng, *ins, 1,
                        overlay={"tendon_damping_scale": torch.ones(N, 0)})
    for a, b in zip(out, fs.step_plain(eng, *ins, 1)):
        assert torch.equal(a, b)


def test_check_states_are_moved_off_box_face_ties():
    """A cube point inside the palm with two nearest faces at (nearly) the
    same distance: there the contact normal jumps, and the check states are
    moved until every env clears the margin, under the overlay's
    geom_scale too."""
    from omniisaacgymenvs_torch.physics import contacts, dynamics

    _, eng, ins, ov = case("ShadowHand")
    m = eng.model
    n = 2048
    q, qd, _ = parity.check_inputs(m, n, seed=1, device="cpu")
    big = parity.overlay_inputs(m, n, seed=1, device="cpu")

    def gaps(q, gs):
        kin = dynamics.kinematics(m, q, qd)
        return contacts.box_face_ties(m, eng.pair_groups, kin.pw, kin.Rw, gs)

    for gs in (None, big["geom_scale"]):
        g = gaps(q, gs)
        assert torch.isfinite(g).float().mean() > 0.5, "most cubes sit in the palm"
        # five times the guard's margin, so that some of these envs lie inside
        wide = 5 * parity.TIE_MARGIN
        assert int((g < wide).sum()) > 0
        old = parity.TIE_MARGIN
        parity.TIE_MARGIN = wide
        try:
            q2 = parity.clear_box_ties(eng, q, qd, {} if gs is None
                                       else {"geom_scale": gs})
        finally:
            parity.TIE_MARGIN = old
        assert (gaps(q2, gs) >= wide).all()
        moved = (q2 != q).any(dim=1)
        assert moved.tolist() == (g < wide).tolist()
        # only the cube moved, by multiples of the nudge
        qa = m.root_q_adr("object")
        others = [c for c in range(m.nq) if not qa <= c < qa + 3]
        assert torch.equal(q2[:, others], q[:, others])
    # a model without box pairs comes back untouched
    heng = get_task("Humanoid", device="cpu").engine
    hq, hqd, _ = parity.check_inputs(heng.model, 4, 0, "cpu")
    assert parity.clear_box_ties(heng, hq, hqd) is hq


def test_conditioning_mask_leaves_out_what_moves_under_two_ulps():
    """`parity.well_conditioned` runs the plain version again on a state
    changed by 2^-22 of its size and keeps the envs whose result moves by
    less than half the limit; `compare(keep=)` judges only those."""
    _, eng, ins, ov = case("ShadowHand")
    q, qd = ins[0], ins[1]
    tol = parity.step_tol(eng.model)

    def plain(q_, qd_):
        return fs.step_plain(eng, q_, qd_, *ins[2:], 4, overlay=ov)

    ref = plain(q, qd)
    keep = parity.well_conditioned(plain, q, qd, ref, parity.STEP_NAMES, tol,
                                   max_excluded=1.0)
    assert keep.dtype == torch.bool and keep.shape == (N,) and keep.sum() >= N - 2

    # a plain version that answers a changed state with a jump in env 3
    def jumpy(q_, qd_):
        out = [x.clone() for x in ref]
        if not torch.equal(q_, q):
            out[1][3] += 1.0
        return out

    keep = parity.well_conditioned(jumpy, q, qd, ref, parity.STEP_NAMES, tol,
                                   max_excluded=0.5)
    assert keep.tolist() == [i != 3 for i in range(N)]
    with pytest.raises(AssertionError, match="ill conditioned"):
        parity.well_conditioned(jumpy, q, qd, ref, parity.STEP_NAMES, tol)
    # an error in env 3 alone is seen by all envs and not by the kept ones
    off = [x.clone() for x in ref]
    off[1][3] += 1.0
    assert parity.compare(off, ref, parity.STEP_NAMES, tol)["qd"][1] > 1.0
    kept = parity.compare(off, ref, parity.STEP_NAMES, tol, keep)
    assert all(use == 0.0 for _, use in kept.values())
    use = parity.env_tolerance_use(off[1], ref[1], *tol["qd"])
    assert use.shape == (N,) and use[3] > 1.0 and use.sum() == use[3]
    nan = off[1].clone()
    nan[5, 0] = float("nan")
    assert parity.env_tolerance_use(nan, ref[1], *tol["qd"])[5] == float("inf")


def test_overlay_share_of_the_bounds():
    """The hand's K1 reads 185 floats more per env under an overlay, and
    `op_count` adds the keys' products and sums to every substep."""
    m = case("ShadowHand")[1].model
    plain, with_ov = fs.io_bytes(m), fs.io_bytes(m, overlay=True)
    assert with_ov["step"] - plain["step"] == 4 * 185
    assert with_ov["substep"] - plain["substep"] == 4 * 185
    assert with_ov["fk"] == plain["fk"]
    a, b = fs.op_count(m, 12), fs.op_count(m, 12, overlay=True)
    per_substep = b["substep"] - a["substep"]
    # 26 bodies x 42, 25 compensated x 3, 24 joints x 5, 69 points and 69
    # box pairs x (5 + 5 + 6), gravity 3, 4 tendons x 16
    assert per_substep == 26 * 42 + 25 * 3 + 24 * 5 + 69 * 5 + 69 * 11 + 3 + 4 * 16
    assert b["step"] - a["step"] == 12 * per_substep and b["fk"] == a["fk"]
    # AnymalTerrain's variant with planes and an overlay counts both
    am = get_task("Anymal", device="cpu").model
    assert (fs.io_bytes(am, planes=True, overlay=True)["step"]
            - fs.io_bytes(am)["step"]) == 4 * (4 * am.ncp
                                               + sum(fs.overlay_sizes(am).values()))
