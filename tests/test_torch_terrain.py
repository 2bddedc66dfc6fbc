"""Port parity of the terrain slice: the terrain generator, the Anymal
models, AnymalTerrain's height and contact-plane lookups, `plane_contacts`
in its three terrain forms, the step with terrain planes (K1/K3's plain
versions) against the JAX kernel's `substep_math` and interpret mode, and
the engine's `step_n` with and without the per-substep plane refresh."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.ops import fused_step as fs
from omniisaacgymenvs_torch.physics import contacts as tcontacts
from omniisaacgymenvs_torch.physics import dynamics as tdynamics
from omniisaacgymenvs_torch.physics.engine import PhysicsEngine, SimParams
from omniisaacgymenvs_torch.physics.model import JointType, ModelBuilder
from omniisaacgymenvs_torch.physics.state import Control
from omniisaacgymenvs_torch.tasks import anymal_terrain as tat
from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils.terrain import Terrain
from omniisaacgymenvs_tpu.ops import fused_substep as jfs
from omniisaacgymenvs_tpu.physics import contacts as jcontacts
from omniisaacgymenvs_tpu.physics import dynamics as jdynamics
from omniisaacgymenvs_tpu.physics.engine import PhysicsEngine as JPhysicsEngine
from omniisaacgymenvs_tpu.physics.engine import SimParams as JSimParams
from omniisaacgymenvs_tpu.physics.state import Control as JControl
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from omniisaacgymenvs_tpu.utils.terrain import Terrain as JTerrain
from torch_parity import (STEP_N_NAMES, assert_step_close,
                          jax_model_from_port, np_)

# a small grid keeps construction fast: 3 levels x 5 types (one of each
# terrain kind), the yaml's cell size and border
SMALL = {"numLevels": 3, "numTerrains": 5}
N = 8


def _cfg(**terrain):
    return {"env": {"terrain": {**SMALL, **terrain},
                    "learn": {"addNoise": False}}}


@functools.lru_cache(maxsize=None)
def tasks(walls=True, margin=None, refresh=None):
    """(JAX task, port task on the CPU) on the small grid."""
    kw = dict(riserWalls=walls, riserWallMargin=margin)
    if refresh is not None:
        kw["planeRefresh"] = refresh
    return (jget_task("AnymalTerrain", _cfg(**kw)),
            get_task("AnymalTerrain", _cfg(**kw), device="cpu"))


@pytest.mark.parametrize("cfg,seed", [({}, 7), (SMALL, 3)],
                         ids=["default_seed7", "small_seed3"])
def test_terrain_grid_equals_jax(cfg, seed):
    a, b = Terrain(cfg, seed=seed), JTerrain(cfg, seed=seed)
    assert a.height_field_raw.dtype == np.int16
    np.testing.assert_array_equal(a.height_field_raw, b.height_field_raw)
    np.testing.assert_array_equal(a.env_origins, b.env_origins)
    assert a.height_field_raw.std() > 0
    for f in ("horizontal_scale", "vertical_scale", "border_size",
              "env_length", "env_rows", "env_cols", "curriculum"):
        assert getattr(a, f) == getattr(b, f), f


def test_task_tables_equal_jax():
    jt, t = tasks()
    for f in ("_hf", "_hf_min", "_hf_pack", "_origins", "noise_vec",
              "_height_points", "default_dof_pos"):
        np.testing.assert_array_equal(np_(getattr(t, f)),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert t._hf_cols == jt._hf_cols and t._slope_lim_h == jt._slope_lim_h
    for f in ("max_episode_length", "push_interval", "decimation",
              "max_init_level", "curriculum", "_riser_walls", "_foot_wedge",
              "_plane_refresh", "_wall_margin", "rew_scales", "dt"):
        assert getattr(t, f) == getattr(jt, f), f
    np.testing.assert_array_equal(np_(t._secondary_mask),
                                  np.asarray(jt._secondary_mask))
    assert t.engine.plane_refresh and t.engine.contact_plane_fn is not None
    assert (t.engine.params.dt, t.engine.params.substeps) == (0.005, 1)
    # without walls: no wedge points, no refresh
    _, t2 = tasks(walls=False)
    assert t2._secondary_mask is None and t2.model.ncp == t.model.ncp - 4
    assert not t2.engine.plane_refresh


def _probe_points(task, n, seed):
    """(n, ncp, 3) float32 points over the three levels of the grid, most
    of them within 3.5 cm of a cell boundary, from 20 cm under the local
    height to 6 cm above it."""
    rng = np.random.default_rng(seed)
    shape = (n, task.model.ncp)
    x, y = rng.uniform(0, 24, shape), rng.uniform(0, 40, shape)
    near = rng.uniform(size=shape) < 0.7
    along_x = rng.uniform(size=shape) < 0.5

    def snap(v):
        return np.round(v / 0.1) * 0.1 + rng.uniform(-0.035, 0.035, shape)

    x = np.where(near & along_x, snap(x), x).astype(np.float32)
    y = np.where(near & ~along_x, snap(y), y).astype(np.float32)
    h = np_(task._sample_height(torch.as_tensor(x), torch.as_tensor(y)))
    z = (h + rng.uniform(-0.2, 0.06, shape)).astype(np.float32)
    return np.stack([x, y, z], -1)


def test_sample_height_equals_jax():
    jt, t = tasks()
    rng = np.random.default_rng(1)
    # beyond the table on both sides: the index clips
    x = rng.uniform(-30, 60, 8192).astype(np.float32)
    y = rng.uniform(-30, 80, 8192).astype(np.float32)
    out = t._sample_height(torch.as_tensor(x), torch.as_tensor(y))
    ref = jt._sample_height(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(np_(out), np.asarray(ref))
    assert len(np.unique(np_(out))) > 20


def _stable(jt, pt, rad, n_ref):
    """Points whose JAX plane does not jump when the point moves by 20 um
    along any axis: the selection there is not tied (a cell boundary, two
    candidates of equal penetration, the end of a wall's span)."""
    ok = np.ones(pt.shape[:2], bool)
    fn = jax.jit(jax.vmap(jt._contact_plane_fn, in_axes=(0, None)))
    for axis in range(3):
        for s in (-2e-5, 2e-5):
            p2 = pt.copy()
            p2[..., axis] += s
            n2, _ = fn(jnp.asarray(p2), jnp.asarray(rad))
            ok &= np.abs(np.asarray(n2) - n_ref).max(-1) < 1e-2
    return ok


@pytest.mark.parametrize("walls,margin", [(True, None), (True, 0.02),
                                          (False, None)],
                         ids=["walls_auto_margin", "walls_margin_2cm",
                              "tread_only"])
def test_contact_plane_fn_matches_jax(walls, margin):
    jt, t = tasks(walls, margin)
    pt = _probe_points(t, 4096, seed=2)
    rad = np_(t.model.cp_radius)
    n, d, kind = t.contact_features(torch.as_tensor(pt), t.model.cp_radius)
    n2, d2 = t._contact_plane_fn(torch.as_tensor(pt), t.model.cp_radius)
    assert torch.equal(n, n2) and torch.equal(d, d2)
    # op by op, without jit: fused into one XLA program, the boundary
    # coordinate (px + 1) * hs - border becomes a fused multiply-add, one
    # ulp of 20 m off, which an edge's normal (offsets of millimetres from
    # that boundary) shows at 1e-4
    jn, jd = jax.vmap(jt._contact_plane_fn, in_axes=(0, None))(
        jnp.asarray(pt), jnp.asarray(rad))
    jn, jd = np.asarray(jn), np.asarray(jd)
    ok = _stable(jt, pt, rad, jn)
    assert ok.mean() > 0.98
    # same float32 arithmetic on the same table rows
    np.testing.assert_allclose(np_(n)[ok], jn[ok], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_(d)[ok], jd[ok], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(np_(n), axis=-1), 1.0, atol=1e-5)
    counts = np.bincount(np_(kind).ravel(), minlength=15)
    if walls:
        # the tread, all eight walls, all four edges, and the wedge points
        # both on and parked
        assert (counts > 0).all(), counts
        assert counts[list(tat.WALLS)].min() >= 100, counts
        sec = np_(kind)[:, -4:]
        assert np.isin(sec, (tat.WEDGE_ON, tat.WEDGE_OFF)).all()
        assert not np.isin(np_(kind)[:, :-4], (tat.WEDGE_ON, tat.WEDGE_OFF)).any()
    else:
        assert counts[tat.TREAD] == kind.numel()
    # a probe of another point count skips the wedge routing
    n3, d3, k3 = t.contact_features(torch.as_tensor(pt[:, :5]),
                                    t.model.cp_radius[:5])
    assert k3.max() <= max(tat.EDGES)


# ---------------------------------------------------------------------------
# plane_contacts and the step with planes
# ---------------------------------------------------------------------------

def _anymal_states(t, n, seed, drop=0.03):
    """(q, qd, eff, ptg) float32 numpy: resets spread over the grid's levels
    and types, the base lowered by up to `drop` and set moving."""
    m = t.model
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    level = torch.as_tensor(rng.integers(0, t.terrain.env_rows, n), dtype=torch.int32)
    ttype = torch.as_tensor(rng.integers(0, t.terrain.env_cols, n), dtype=torch.int32)
    q, qd, _ = t._reset_at(g, level, ttype)
    q, qd = np_(q).copy(), np_(qd).copy()
    q[:, 0:2] += rng.uniform(-2.5, 2.5, (n, 2))
    h = np_(t._sample_height(torch.as_tensor(q[:, 0]), torch.as_tensor(q[:, 1])))
    q[:, 2] = h + 0.62 - rng.uniform(0.0, drop, n)
    q[:, m.jq0:] += 0.05 * rng.standard_normal((n, m.njd))
    qd += 0.3 * rng.standard_normal(qd.shape)
    eff = rng.uniform(-5, 5, (n, m.njd))
    ptg = q[:, m.jq0:] + 0.1 * rng.standard_normal((n, m.njd))
    return tuple(a.astype(np.float32) for a in (q, qd, eff, ptg))


@pytest.mark.parametrize("form", ["plane_fn", "height_fn", "planes"])
def test_plane_contacts_terrain_forms_match_jax(form):
    jt, t = tasks()
    m, jm = t.model, jt.model
    q, qd, _, _ = _anymal_states(t, N, seed=3)
    kin = tdynamics.kinematics(m, torch.as_tensor(q), torch.as_tensor(qd))
    avel, lvel = tdynamics.world_velocities(m, kin)

    def height_fn(x, y):
        h = t._sample_height(x, y)
        n = torch.tensor([0.1, -0.05, 1.0]) / np.sqrt(1.0125)
        return h, n.expand(h.shape + (3,))

    def jheight_fn(x, y):
        n = jnp.array([0.1, -0.05, 1.0]) / np.sqrt(1.0125)
        return jt._sample_height(x, y), jnp.broadcast_to(n, x.shape + (3,))

    cp = t.engine.contact_params
    if form == "planes":
        planes = t.engine._contact_planes(t.engine.init_state(
            torch.as_tensor(q), torch.as_tensor(qd)))
        kw, jkw = dict(planes=planes), dict(plane_fn=jt._contact_plane_fn)
    elif form == "plane_fn":
        kw = dict(plane_fn=t._contact_plane_fn)
        jkw = dict(plane_fn=jt._contact_plane_fn)
    else:
        kw, jkw = dict(height_fn=height_fn), dict(height_fn=jheight_fn)
    out = tcontacts.plane_contacts(m, kin.pw, kin.Rw, avel, lvel, cp,
                                   t.engine.contact_gains, **kw)

    def one(q1, qd1):
        k = jdynamics.kinematics(jm, q1, qd1)
        a, l = jdynamics.world_velocities(jm, k)
        return jcontacts.plane_contacts(jm, k.pw, k.Rw, a, l,
                                        jt.engine.contact_params, **jkw)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(qd))
    assert np.abs(np.asarray(ref.body_force)).max() > 50.0, "feet must load"
    # forces of some hundred newtons off positions rounded in float32:
    # point gain 5e4 N/m x 1e-7 m, plus the relative part
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-4, atol=2e-2)


def _mini_biped():
    """FREE base with two revolute legs and sphere feet: small enough for
    the JAX kernel's interpret mode to compile in seconds on the CPU."""
    b = ModelBuilder("MiniBiped")
    base = b.add_body("base", parent=-1, joint_type=JointType.FREE, mass=2.0,
                      inertia=(0.02, 0.02, 0.02), default_pos=(0.0, 0.0, 0.3))
    for name, sy in (("L", 0.1), ("R", -0.1)):
        leg = b.add_body(
            f"leg{name}", parent=base, joint_type=JointType.REVOLUTE,
            joint_axis=(0.0, 1.0, 0.0), joint_pos=(0.0, sy, 0.0), mass=0.5,
            com=(0.0, 0.0, -0.125), inertia=(0.005, 0.005, 1e-4),
            limit=(-1.0, 1.0), armature=0.01, stiffness=20.0,
            drive_damping=1.0, max_effort=30.0)
        b.add_sphere_collider(leg, (0.0, 0.0, -0.25), 0.05)
        b.add_force_sensor(leg)
    return b.finalize()


GX, GY, C0 = 0.06, -0.04, 0.02
_NRM = np.array([-GX, -GY, 1.0]) / np.sqrt(1.0 + GX * GX + GY * GY)


def _ramp(x, y):
    n = torch.as_tensor(_NRM, dtype=torch.float32)
    return C0 + GX * x + GY * y, n.expand(x.shape + (3,))


def _jramp(x, y):
    return (C0 + GX * x + GY * y,
            jnp.broadcast_to(jnp.asarray(_NRM, jnp.float32), x.shape + (3,)))


@functools.lru_cache(maxsize=None)
def biped_case():
    pm = _mini_biped()
    params = dict(dt=1.0 / 60.0, substeps=2)
    eng = PhysicsEngine(pm, SimParams(**params), height_fn=_ramp)
    jeng = JPhysicsEngine(jax_model_from_port(pm), JSimParams(**params),
                          height_fn=_jramp)
    rng = np.random.default_rng(4)
    q = np.tile(np_(pm.default_q), (N, 1))
    q[:, 0:3] += 0.01 * rng.standard_normal((N, 3))
    q[:, 7:] += 0.05 * rng.standard_normal((N, 2))
    qd = 0.2 * rng.standard_normal((N, pm.nv))
    eff = 0.3 * rng.standard_normal((N, pm.njd))
    ptg = 0.1 * rng.standard_normal((N, pm.njd))
    fa = 0.2 * rng.standard_normal((N, pm.nb, 6))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    ins = tuple(t(a) for a in (q, qd, eff, ptg, np.zeros_like(ptg), fa))
    planes = eng._contact_planes(eng.init_state(ins[0], ins[1]))
    fused = jfs.build_fused_substep(
        jeng.model, jeng.params.dt / jeng.params.substeps, jeng.params.gravity,
        jeng.contact_params, has_height=True)
    return eng, jeng, fused, ins, planes


def test_contact_planes_from_height_fn_match_jax():
    eng, jeng, _, ins, planes = biped_case()
    assert planes.shape == (N, 2, 4) and planes.is_contiguous()

    def one(q1, qd1):
        return jeng._contact_planes(
            jeng._report_xla(q1, qd1, jnp.zeros((2, 6))))

    ref = jax.vmap(one)(jnp.asarray(np_(ins[0])), jnp.asarray(np_(ins[1])))
    np.testing.assert_allclose(np_(planes), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # flat ground: zeros of the same shape
    flat = PhysicsEngine(eng.model, eng.params)
    st = flat.init_state(ins[0], ins[1])
    assert torch.equal(flat._contact_planes(st), torch.zeros(N, 2, 4))
    assert not flat.has_terrain and flat.k1_launches(3) == 1


@pytest.mark.parametrize("n_steps", [1, 4])
def test_step_plain_with_planes_matches_jax_kernel_interpret(n_steps):
    """K1's plain version with frozen planes against the JAX kernel itself
    (Pallas interpret mode on the CPU), at the step_n tolerances."""
    eng, _, fused, ins, planes = biped_case()
    out = fs.step_plain(eng, *ins, n_steps, planes=planes)
    ref = fused.step(*(jnp.asarray(np_(a)) for a in ins), n_steps,
                     planes=jnp.asarray(np_(planes)), interpret=True)
    assert np.abs(np.asarray(ref[2])).max() > 1.0, "the feet must load"
    assert_step_close(out, ref)
    # the CPU wrapper is the plain version
    for a, b in zip(fs.step(eng, *ins, n_steps, planes=planes), out):
        assert torch.equal(a, b)


def _substep_math(fused, m, ins, planes):
    """The JAX kernel's substep_math on a numpy batch, run op by op (no
    jit: the unrolled scalar trace of a 13-body model takes minutes to
    compile on the CPU): (q, qd, sensor_forces)."""
    n = ins[0].shape[0]
    cols = [jnp.asarray(np_(a).reshape(n, -1)) for a in (*ins, planes)]
    outs = fused.substep_math(list(jnp.concatenate(cols, axis=1).T))
    outs = np.stack([np.asarray(o) for o in outs], axis=1)
    return (outs[:, :m.nq], outs[:, m.nq:m.nq + m.nv],
            outs[:, m.nq + m.nv:].reshape(n, -1, 6))


def test_substep_plain_with_planes_matches_jax_substep_math():
    """K3's plain version on AnymalTerrain's own planes (treads, walls,
    edges, wedge points) against the JAX kernel's math."""
    jt, t = tasks()
    eng, m = t.engine, t.model
    q, qd, eff, ptg = (torch.as_tensor(a) for a in _anymal_states(t, N, seed=5))
    z, fa = torch.zeros_like(ptg), torch.zeros(N, m.nb, 6)
    planes = eng._contact_planes(eng.init_state(q, qd))
    assert (planes[..., 2].abs() < 0.99).any(), "some plane must not be a tread"
    fused = jfs.build_fused_substep(
        jt.model, jt.engine.params.dt, jt.engine.params.gravity,
        jt.engine.contact_params, has_height=True)
    out = fs.substep_plain(eng, q, qd, eff, ptg, z, fa, planes)
    ref = _substep_math(fused, m, (q, qd, eff, ptg, z, fa), planes)
    assert np.abs(ref[2]).max() > 50.0, "the feet must load"
    assert_step_close(out, ref, names=STEP_N_NAMES[:3])
    for a, b in zip(fs.substep(eng, q, qd, eff, ptg, z, fa, planes), out):
        assert torch.equal(a, b)


def test_planes_are_required_exactly_with_terrain():
    eng, _, _, ins, planes = biped_case()
    flat = PhysicsEngine(eng.model, eng.params)
    with pytest.raises(ValueError, match="needs `planes`"):
        fs.step(eng, *ins, 1)
    with pytest.raises(ValueError, match="needs `planes`"):
        fs.substep_plain(eng, *ins)
    with pytest.raises(ValueError, match="without terrain"):
        fs.step_plain(flat, *ins, 1, planes=planes)
    with pytest.raises(ValueError, match="without terrain"):
        fs.substep(flat, *ins, planes=planes)
    with pytest.raises(ValueError, match="shape"):
        fs.step(eng, *ins, 1, planes=planes[:, :1])
    with pytest.raises(TypeError, match="dtype"):
        fs.step(eng, *ins, 1, planes=planes.double())
    with pytest.raises(ValueError, match="contiguous"):
        fs.step(eng, *ins, 1, planes=planes.transpose(1, 2).contiguous()
                .transpose(1, 2))


def test_bounds_count_the_plane_branch():
    _, t = tasks()
    m = t.model
    assert (m.nb, m.nq, m.nv, m.njd, m.ncp, m.num_sensors) == (13, 19, 18, 12,
                                                               20, 4)
    # 151 + 80 input and 61 + 169 output floats per env with planes
    assert fs.io_bytes(m, planes=True) == {"step": 4 * (231 + 230),
                                           "fk": 4 * (37 + 169),
                                           "substep": 4 * (231 + 61)}
    assert fs.io_bytes(m)["step"] == 4 * (151 + 230)
    flat, pl = fs.op_count(m, 1), fs.op_count(m, 1, planes=True)
    # per point: the world position 3, n.pt - d 6, penetration 1 and the
    # force along a general normal 40, instead of penetration 2 and the
    # flat force 20
    assert pl["substep"] - flat["substep"] == 20 * (92 - 64)
    assert pl["fk"] == flat["fk"]
    assert pl["step"] == pl["substep"] + pl["fk"]
    assert fs.scope_errors(m) == []


# ---------------------------------------------------------------------------
# the engine's step_n
# ---------------------------------------------------------------------------

def _controls(t, eff, ptg):
    n = eff.shape[0]
    z3 = torch.zeros(n, t.model.nb, 3)
    return Control(effort=torch.as_tensor(eff), pos_target=torch.as_tensor(ptg),
                   vel_target=torch.zeros(n, t.model.njd), body_force=z3,
                   body_torque=z3)


def test_step_n_with_plane_refresh_matches_jax_engine():
    """plane_refresh: planes from the reported state before every substep.
    The JAX engine on the CPU re-evaluates the plane function inside every
    substep, from the kinematics' rotation matrices, so the two agree to
    rounding."""
    jt, t = tasks()
    eng, jeng = t.engine, jt.engine
    q, qd, eff, ptg = _anymal_states(t, N, seed=6)
    st = eng.init_state(torch.as_tensor(q), torch.as_tensor(qd))
    calls = []
    orig = eng.contact_plane_fn
    eng.contact_plane_fn = lambda p, r: (calls.append(1), orig(p, r))[1]
    try:
        s = eng.step_n(st, _controls(t, eff, ptg), t.decimation)
    finally:
        eng.contact_plane_fn = orig
    assert len(calls) == 4 == eng.k1_launches(t.decimation)

    def one(q1, qd1, e1, p1):
        ctrl = JControl(effort=e1, pos_target=p1, vel_target=jnp.zeros(12),
                        body_force=jnp.zeros((13, 3)),
                        body_torque=jnp.zeros((13, 3)))
        r = jeng.step_n(jeng.init_state(q1, qd1), ctrl, jt.decimation)
        return (r.q, r.qd, r.sensor_forces, r.body_pos, r.body_quat,
                r.body_avel, r.body_lvel)

    ref = jax.jit(jax.vmap(one))(*map(jnp.asarray, (q, qd, eff, ptg)))
    assert np.abs(np.asarray(ref[2])).max() > 50.0, "the feet must load"
    assert_step_close((s.q, s.qd, s.sensor_forces, s.body_pos, s.body_quat,
                       s.body_avel, s.body_lvel), ref)


def test_step_n_without_refresh_freezes_the_planes():
    """planeRefresh off: one launch of decimation x substeps substeps on the
    planes sampled once, as the JAX kernel computes it (its substep_math
    looped on the frozen planes, then the report FK)."""
    jt, t = tasks(refresh=False)
    eng, m = t.engine, t.model
    assert not eng.plane_refresh and eng.k1_launches(t.decimation) == 1
    q, qd, eff, ptg = (torch.as_tensor(a) for a in _anymal_states(t, N, seed=7))
    st = eng.init_state(q, qd)
    s = eng.step_n(st, _controls(t, np_(eff), np_(ptg)), t.decimation)
    z, fa = torch.zeros_like(ptg), torch.zeros(N, m.nb, 6)
    planes = eng._contact_planes(st)

    def jplanes(q1, qd1):
        return jt.engine._contact_planes(
            jt.engine._report_xla(q1, qd1, jnp.zeros((4, 6))))

    jpl = np.asarray(jax.vmap(jplanes)(jnp.asarray(np_(q)), jnp.asarray(np_(qd))))
    # the same feature per point (no tie in these states)
    np.testing.assert_allclose(np_(planes), jpl, rtol=0, atol=1e-5)
    fused = jfs.build_fused_substep(
        jt.model, jt.engine.params.dt, jt.engine.params.gravity,
        jt.engine.contact_params, has_height=True)
    rq, rqd = q, qd
    for _ in range(t.decimation):
        rq, rqd, rsf = _substep_math(fused, m, (rq, rqd, eff, ptg, z, fa), jpl)
    pos, quat, avel, lvel = fs.fk_plain(m, torch.as_tensor(rq), torch.as_tensor(rqd))
    assert_step_close((s.q, s.qd, s.sensor_forces, s.body_pos, s.body_quat,
                       s.body_avel, s.body_lvel),
                      (rq, rqd, rsf, np_(pos), np_(quat), np_(avel), np_(lvel)))
    # and it is not what the refreshed planes give: over 20 ms some foot
    # changes its feature or slides along a slope
    _, t_ref = tasks()
    s2 = t_ref.engine.step_n(st, _controls(t, np_(eff), np_(ptg)), t.decimation)
    assert not torch.allclose(s.qd, s2.qd, rtol=1e-4, atol=1e-4)
