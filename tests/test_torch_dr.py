"""The port's `Randomizer` against the JAX package's on the
ShadowHandOpenAI_FF randomization block and the hand's `dr_views`: the key
set of every gate, shapes, neutral values off a view's indices, the
interval-only keys at reset, `combine_overlays`, the operations, the
warnings, the schedulable parameters, the interval gating and each
distribution.

The draws themselves cannot match across the packages: the port draws from
a `torch.Generator`, the JAX package from its random keys. What is compared
is everything but the random bits: which keys come out, where they are
neutral, the ranges and moments of many draws, and the arithmetic on given
numpy inputs."""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.tasks import get_task
from omniisaacgymenvs_torch.utils import domain_randomization as dr
from omniisaacgymenvs_torch.utils.config import load_config
from omniisaacgymenvs_tpu.tasks import get_task as jget_task
from omniisaacgymenvs_tpu.utils import domain_randomization as jdr
from torch_parity import np_

N = 64
GATES = ("on_reset", "on_startup", "on_interval")
RESET_KEYS = {"stiffness_scale", "damping_scale", "limit_lower_delta",
              "limit_upper_delta", "tendon_stiffness_scale",
              "tendon_damping_scale", "friction_scale"}


def block():
    return copy.deepcopy(
        load_config({"task": "ShadowHandOpenAI_FF"})["task"]["domain_randomization"])


@pytest.fixture(scope="module")
def hands():
    """(JAX task, port task) of the hand; both carry `dr_views`."""
    return jget_task("ShadowHand"), get_task("ShadowHand", device="cpu")


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("gate", GATES)
def test_gate_entries_equal_jax(hands, gate):
    jt, t = hands
    ours = dr.Randomizer(block())._entries(t.model, t.dr_views, gate)
    theirs = jdr.Randomizer(block())._entries(jt.model, jt.dr_views, gate)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a[:2] == b[:2] and a[3] == b[3] and a[4] == b[4]
        if b[2] is None:
            assert a[2] is None
        else:
            np.testing.assert_array_equal(a[2], b[2])


def test_dr_views_equal_jax(hands):
    jt, t = hands
    assert set(t.dr_views) == set(jt.dr_views) == {"shadow_hand_view",
                                                   "object_view"}
    for view, sets in jt.dr_views.items():
        assert set(t.dr_views[view]) == set(sets)
        for k, idx in sets.items():
            np.testing.assert_array_equal(t.dr_views[view][k], idx)


def test_reset_overlay_keys_shapes_and_interval_keys_neutral(hands):
    jt, t = hands
    m = t.model
    ov = dr.Randomizer(block()).sample_overlay(gen(), N, m, t.dr_views)
    jov = jdr.Randomizer(block()).sample_overlay(jax.random.PRNGKey(0),
                                                 jt.model, jt.dr_views)
    # gravity is randomized on_interval only: present from the reset on,
    # at its neutral value
    assert set(ov) == set(jov) == RESET_KEYS | {"gravity_delta"}
    for k, v in ov.items():
        assert v.shape == (N,) + tuple(jov[k].shape) and v.dtype == torch.float32
    assert torch.equal(ov["gravity_delta"], torch.zeros(N, 3))
    # both views randomize the friction: no body stays neutral; every env
    # draws its own values
    assert (ov["friction_scale"] != 1).all()
    assert ov["stiffness_scale"].std(0).min() > 0
    assert (ov["stiffness_scale"] > 0).all()
    assert ov["limit_lower_delta"].abs().max() < 0.1


def test_startup_overlay_is_neutral_off_the_object(hands):
    _, t = hands
    m = t.model
    st = dr.Randomizer(block()).sample_startup_overlay(gen(), N, m, t.dr_views)
    assert set(st) == {"geom_scale", "mass_scale"}
    obj = m.body_index("object")
    hand = [i for i in range(m.nb) if i != obj]
    for key, lo, hi in (("geom_scale", 0.95, 1.05), ("mass_scale", 0.5, 1.5)):
        assert st[key].shape == (N, m.nb)
        assert torch.equal(st[key][:, hand], torch.ones(N, m.nb - 1))
        assert ((st[key][:, obj] >= lo) & (st[key][:, obj] <= hi)).all()
        assert st[key][:, obj].std() > 0


def test_without_views_every_index_is_randomized(hands):
    _, t = hands
    st = dr.Randomizer(block()).sample_startup_overlay(gen(), N, t.model)
    assert (st["geom_scale"] != 1).all()
    # a view map that lacks a view skips its block
    ov = dr.Randomizer(block()).sample_startup_overlay(
        gen(), N, t.model, {"shadow_hand_view": t.dr_views["shadow_hand_view"]})
    assert ov is None


def test_combine_overlays_equal_jax_on_numpy_inputs():
    rng = np.random.default_rng(0)
    a = {"mass_scale": rng.uniform(0.5, 1.5, (N, 5)).astype(np.float32),
         "gravity_delta": rng.normal(size=(N, 3)).astype(np.float32)}
    b = {"mass_scale": rng.uniform(0.5, 1.5, (N, 5)).astype(np.float32),
         "gravity_delta": rng.normal(size=(N, 3)).astype(np.float32),
         "geom_scale": rng.uniform(0.9, 1.1, (N, 5)).astype(np.float32)}
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    out, ref = dr.combine_overlays(t(a), t(b)), jdr.combine_overlays(j(a), j(b))
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_array_equal(np_(out[k]), np.asarray(ref[k]))
    np.testing.assert_array_equal(np_(out["mass_scale"]),
                                  a["mass_scale"] * b["mass_scale"])
    np.testing.assert_array_equal(np_(out["gravity_delta"]),
                                  a["gravity_delta"] + b["gravity_delta"])
    assert dr.combine_overlays(None, None) is None
    assert dr.combine_overlays({}, t(a)).keys() == a.keys()
    assert dr.combine_overlays(t(a), None).keys() == a.keys()


def test_additive_on_scale_gives_one_plus_sample(hands):
    _, t = hands
    spec = {"operation": "additive", "distribution": "uniform",
            "distribution_parameters": [0.1, 0.2]}
    cfg = {"randomize": True, "randomization_params": {"articulation_views": {
        "shadow_hand_view": {"stiffness": {"on_reset": spec}}}}}
    ov = dr.Randomizer(cfg).sample_overlay(gen(), N, t.model, t.dr_views)
    s = ov["stiffness_scale"]
    assert ((s >= 1.1) & (s <= 1.2)).all()
    # the same draw without the operation's shift
    raw = dr._sample(gen(), spec, (N, t.model.njd), "cpu")
    torch.testing.assert_close(s, 1.0 + raw, rtol=0, atol=0)


def test_scaling_on_a_delta_raises(hands):
    _, t = hands
    cfg = {"randomize": True, "randomization_params": {"articulation_views": {
        "shadow_hand_view": {"lower_dof_limits": {"on_reset": {
            "operation": "scaling", "distribution": "uniform",
            "distribution_parameters": [0.9, 1.1]}}}}}}
    with pytest.raises(ValueError, match="scaling operation unsupported"):
        dr.Randomizer(cfg).sample_overlay(gen(), N, t.model, t.dr_views)
    jt = jget_task("ShadowHand")
    with pytest.raises(ValueError, match="scaling operation unsupported"):
        jdr.Randomizer(cfg).sample_overlay(jax.random.PRNGKey(0), jt.model,
                                           jt.dr_views)


@pytest.mark.parametrize("params,match", [
    ({"lighting": {}}, "unknown DR group 'lighting'"),
    ({"articulation_views": {"shadow_hand_view": {"colour": {}}}},
     "unknown DR property articulation_views.shadow_hand_view.'colour'"),
])
def test_unknown_group_and_property_warn(params, match):
    cfg = {"randomize": True, "randomization_params": params}
    for cls in (dr.Randomizer, jdr.Randomizer):
        with pytest.warns(UserWarning, match=match):
            cls(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dr.Randomizer(block())  # the yaml's block names nothing unknown


def test_set_and_get_distribution_parameters(hands):
    _, t = hands
    r, jr = dr.Randomizer(block()), jdr.Randomizer(block())
    path = ("rigid_prim_views", "object_view", "mass", "on_startup")
    assert (r.get_dr_distribution_parameters(*path)
            == jr.get_dr_distribution_parameters(*path) == [0.5, 1.5])
    r.set_dr_distribution_parameters([2.0, 2.5], *path)
    assert r.get_dr_distribution_parameters(*path) == [2.0, 2.5]
    st = r.sample_startup_overlay(gen(), N, t.model, t.dr_views)
    obj = t.model.body_index("object")
    assert ((st["mass_scale"][:, obj] >= 2.0)
            & (st["mass_scale"][:, obj] <= 2.5)).all()
    assert r.get_dr_distribution_parameters("observations", "nowhere") is None
    with pytest.raises(KeyError):
        r.set_dr_distribution_parameters([0, 1], "observations", "nowhere")


def test_interval_overlay_is_gated_by_progress(hands):
    _, t = hands
    r = dr.Randomizer(block())
    assert r.has_interval_overlays() and jdr.Randomizer(block()).has_interval_overlays()
    ov = r.sample_overlay(gen(), N, t.model, t.dr_views)
    progress = torch.arange(N, dtype=torch.int32) * 90      # 0, 90, ..., 5670
    due = (progress % 720 == 0)
    assert 2 < int(due.sum()) < N
    ov2 = r.update_interval_overlay(ov, gen(1), t.model, progress, t.dr_views)
    g = ov2["gravity_delta"]
    assert g.shape == (N, 3)
    assert torch.equal(g[~due], torch.zeros_like(g[~due]))
    # sigma (0, 0, 0.4): only z moves, in every env that is due
    assert (g[due][:, 2] != 0).all() and torch.equal(g[:, :2], torch.zeros(N, 2))
    # the on_reset keys pass through untouched, and the input is not changed
    assert all(ov2[k] is ov[k] for k in RESET_KEYS)
    assert torch.equal(ov["gravity_delta"], torch.zeros(N, 3))
    # off phase, the current values stay
    ov3 = r.update_interval_overlay(ov2, gen(2), t.model, progress + 5,
                                    t.dr_views)
    assert torch.equal(ov3["gravity_delta"], g)
    no_interval = block()
    del no_interval["randomization_params"]["simulation"]
    assert not dr.Randomizer(no_interval).has_interval_overlays()
    assert dr.Randomizer(no_interval).update_interval_overlay(
        ov, gen(), t.model, progress, t.dr_views) is ov


def test_observation_and_action_noise_gating_and_arithmetic():
    r = dr.Randomizer(block())
    corr = r.sample_correlated(gen(), N, 42, 20, "cpu")
    assert corr["obs_corr"].shape == (N, 42) and corr["act_corr"].shape == (N, 20)
    assert 0.5e-4 < float(corr["obs_corr"].std()) < 2e-4     # sigma 1e-4
    assert 0.01 < float(corr["act_corr"].std()) < 0.02       # sigma 0.015
    # with the per-step noise removed the result is obs + corr, as in JAX
    quiet = block()
    for grp in ("observations", "actions"):
        del quiet["randomization_params"][grp]["on_interval"]
    rq, jq = dr.Randomizer(quiet), jdr.Randomizer(quiet)
    obs = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 42))
                          .astype(np.float32))
    out = rq.randomize_observations(obs, gen(), corr)
    ref = jax.vmap(lambda o, c: jq.randomize_observations(
        o, jax.random.PRNGKey(0), {"obs_corr": c}))(
            jnp.asarray(np_(obs)), jnp.asarray(np_(corr["obs_corr"])))
    np.testing.assert_array_equal(np_(out), np.asarray(ref))
    act = torch.zeros(N, 20)
    torch.testing.assert_close(rq.randomize_actions(act, gen(), corr),
                               corr["act_corr"], rtol=0, atol=0)
    # the per-step noise at its frequency only
    spec = {"frequency_interval": 4, "operation": "scaling",
            "distribution": "uniform", "distribution_parameters": [2.0, 3.0]}
    gated = dr.Randomizer({"randomize": True, "randomization_params": {
        "observations": {"on_interval": spec}}})
    progress = torch.arange(N, dtype=torch.int32)
    ones = torch.ones(N, 42)
    out = gated.randomize_observations(ones, gen(), {}, progress)
    due = progress % 4 == 0
    assert torch.equal(out[~due], ones[~due])
    assert ((out[due] >= 2.0) & (out[due] <= 3.0)).all()
    jout = jax.vmap(lambda o, p, k: jdr.Randomizer({
        "randomize": True, "randomization_params": {"observations": {
            "on_interval": spec}}}).randomize_observations(o, k, {}, p))(
        jnp.ones((N, 42)), jnp.arange(N), jax.random.split(jax.random.PRNGKey(0), N))
    assert np.array_equal(np.asarray(jout) == 1.0, np_(out) == 1.0)


@pytest.mark.parametrize("dist,params,check", [
    ("gaussian", [0.5, 0.2], "moments"),
    ("uniform", [0.7, 1.3], "range"),
    ("loguniform", [0.3, 3.0], "range"),
])
def test_distributions_against_jax_over_many_draws(dist, params, check):
    spec = {"distribution": dist, "distribution_parameters": params}
    ours = np_(dr._sample(gen(3), spec, (4096, 8), "cpu"))
    theirs = np.asarray(jdr._sample(jax.random.PRNGKey(3), spec, (4096, 8)))
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    if check == "range":
        for x in (ours, theirs):
            assert x.min() >= params[0] and x.max() <= params[1]
            assert x.min() < params[0] * 1.01 and x.max() > params[1] * 0.99
    stat = np.log if dist == "loguniform" else (lambda x: x)
    # 32768 draws: means agree to a few standard errors, spreads to 3%
    se = stat(theirs).std() / np.sqrt(theirs.size)
    assert abs(stat(ours).mean() - stat(theirs).mean()) < 6 * se
    assert stat(ours).std() == pytest.approx(stat(theirs).std(), rel=0.03)
    with pytest.raises(ValueError, match="unknown distribution"):
        dr._sample(gen(), {"distribution": "cauchy"}, (2, 2), "cpu")


def test_vector_parameters_and_material_triplets():
    # per-component parameters that match the per-env shape are used as
    # they are (gravity); a material triplet gives its first component
    grav = {"distribution": "gaussian",
            "distribution_parameters": [[0.0, 1.0, 0.0], [0.0, 0.0, 0.4]]}
    g = dr._sample(gen(), grav, (N, 3), "cpu")
    assert torch.equal(g[:, 0], torch.zeros(N)) and torch.equal(g[:, 1], torch.ones(N))
    assert 0.25 < float(g[:, 2].std()) < 0.55
    mat = {"distribution": "uniform",
           "distribution_parameters": [[0.7, 1, 1], [1.3, 1, 1]]}
    f = dr._sample(gen(), mat, (N, 26), "cpu")
    assert f.min() >= 0.7 and f.max() <= 1.3 and f.std() > 0.1
    jf = np.asarray(jdr._sample(jax.random.PRNGKey(0), mat, (26,)))
    assert jf.min() >= 0.7 and jf.max() <= 1.3


def test_the_generator_reproduces_a_draw(hands):
    _, t = hands
    r = dr.Randomizer(block())
    a = r.sample_overlay(gen(7), N, t.model, t.dr_views)
    b = r.sample_overlay(gen(7), N, t.model, t.dr_views)
    c = r.sample_overlay(gen(8), N, t.model, t.dr_views)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["damping_scale"], c["damping_scale"])
    assert not dr.Randomizer(None).randomize and dr.Randomizer(block()).randomize
