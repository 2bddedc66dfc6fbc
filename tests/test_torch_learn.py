"""Port parity of the learner's building blocks: RunningNorm, the FF
actor-critic and central-value networks (weights carried by convert.py), the
flax-style initialization, the Gaussian helpers, and the train yamls with
ppo_config_kwargs. Inputs are made from a numpy seed and go through the JAX
function and its port; float32 unless named."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.learn import networks
from omniisaacgymenvs_torch.learn.running_norm import RunningNorm
from omniisaacgymenvs_torch.utils.config import CFG_DIR, load_config, ppo_config_kwargs
from omniisaacgymenvs_tpu.learn import networks as jnetworks
from omniisaacgymenvs_tpu.learn.running_norm import RunningNorm as JRunningNorm
from omniisaacgymenvs_tpu.utils.config import ppo_config_kwargs as jppo_config_kwargs
from torch_parity import np_

TRAIN_TASKS = ("Humanoid", "Ant", "Cartpole", "BallBalance", "Anymal",
               "AnymalTerrain", "ShadowHand", "ShadowHandOpenAI_FF",
               "ShadowHandOpenAI_LSTM", "FrankaCabinet", "Crazyflie",
               "Quadcopter", "Ingenuity", "AllegroHand", "Custom")
# float32 in another summation order: (rtol, atol)
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16 matrix products and activations: both packages return bf16 values
# (cast to f32 by the port), and two bf16 forwards that differ only in where
# they round (torch's fused addmm once per layer, flax's dot + bias twice)
# differ by less than one bf16 step at the output's scale, 2^-8 of its
# largest magnitude. An f32 or fp16 forward misses that by 1.1-1.9 steps.
BF16_STEP = 2.0 ** -8


def _jax_params(module, n_in, seed, dtype=None):
    return module.init(jax.random.PRNGKey(seed), jnp.zeros((1, n_in)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("shape", [(), (5,)])
def test_running_norm_update_normalize(shape):
    rng = np.random.default_rng(0)
    jn, tn = JRunningNorm.create(shape), RunningNorm.create(shape)
    for k in range(3):
        batch = (3.0 * rng.standard_normal((7, 4) + shape) + k).astype(np.float32)
        jn = jn.update(jnp.asarray(batch))
        tn2 = tn.update(torch.as_tensor(batch))
        assert tn2 is not tn and float(tn.count) != float(tn2.count)
        tn = tn2
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(np_(getattr(tn, f)),
                                       np.asarray(getattr(jn, f)), **F32,
                                       err_msg=f)
    x = (10.0 * rng.standard_normal((6,) + shape)).astype(np.float32)
    for clip in (5.0, 1.0, float("inf")):
        np.testing.assert_allclose(
            np_(tn.normalize(torch.as_tensor(x), clip=clip)),
            np.asarray(jn.normalize(jnp.asarray(x), clip=clip)), **F32)
    np.testing.assert_allclose(np_(tn.denormalize(torch.as_tensor(x))),
                               np.asarray(jn.denormalize(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_running_norm_population_variance():
    x = torch.arange(8.0).reshape(4, 2)
    n = RunningNorm(mean=torch.zeros(2), var=torch.zeros(2),
                    count=torch.tensor(0.0)).update(x)
    torch.testing.assert_close(n.var, x.var(0, correction=0))


# (num_obs, num_actions, units): Humanoid's actor, the OpenAI hand's actor
ACTORS = {"humanoid": (87, 21, (400, 200, 100)),
          "openai_ff": (42, 20, (400, 400, 200, 100))}


@pytest.mark.parametrize("name", sorted(ACTORS))
def test_actor_critic_forward(name):
    n_obs, n_act, units = ACTORS[name]
    jnet = jnetworks.ActorCritic(num_actions=n_act, units=units, sigma_init=-1.0)
    params = _jax_params(jnet, n_obs, 1)
    net = convert.actor_critic_from_arrays(
        _np_tree(params), networks.ActorCritic(n_obs, n_act, units))
    x = np.random.default_rng(2).standard_normal((64, n_obs)).astype(np.float32)
    jmu, jls, jv = jnet.apply(params, jnp.asarray(x))
    mu, ls, v = net(torch.as_tensor(x))
    assert mu.dtype == v.dtype == torch.float32 and v.shape == (64,)
    np.testing.assert_allclose(np_(mu), np.asarray(jmu), **F32)
    np.testing.assert_allclose(np_(ls), np.asarray(jls), **F32)
    np.testing.assert_allclose(np_(v), np.asarray(jv), **F32)


def test_central_value_forward():
    """The OpenAI hand's critic on its 187 states."""
    jnet = jnetworks.CentralValue(units=(512, 512, 256, 128))
    params = _jax_params(jnet, 187, 3)
    net = convert.central_value_from_arrays(
        _np_tree(params), networks.CentralValue(187, (512, 512, 256, 128)))
    x = np.random.default_rng(4).standard_normal((32, 187)).astype(np.float32)
    v = net(torch.as_tensor(x))
    assert v.dtype == torch.float32 and v.shape == (32,)
    np.testing.assert_allclose(np_(v), np.asarray(jnet.apply(params, jnp.asarray(x))),
                               **F32)


def _assert_bf16_close(out, ref, name):
    """`out` is a bf16 result and lies within one bf16 step of `ref`'s scale."""
    assert torch.equal(out, out.to(torch.bfloat16).float()), name
    np.testing.assert_allclose(np_(out), ref, rtol=0.0,
                               atol=BF16_STEP * np.abs(ref).max(), err_msg=name)


def test_actor_critic_forward_bf16():
    """mixed_precision: both compute the networks in bf16 over f32
    parameters and return f32; held within one bf16 step of the output's
    scale, which the same network's f32 and fp16 forwards miss."""
    n_obs, n_act, units = ACTORS["humanoid"]
    jnet = jnetworks.ActorCritic(num_actions=n_act, units=units,
                                 dtype=jnp.bfloat16)
    params = _jax_params(jnet, n_obs, 5)
    net = convert.actor_critic_from_arrays(
        _np_tree(params),
        networks.ActorCritic(n_obs, n_act, units, dtype=torch.bfloat16))
    x = np.random.default_rng(6).standard_normal((64, n_obs)).astype(np.float32)
    jmu, _, jv = jnet.apply(params, jnp.asarray(x))
    mu, ls, v = net(torch.as_tensor(x))
    assert mu.dtype == v.dtype == ls.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    jmu, jv = np.asarray(jmu, np.float32), np.asarray(jv, np.float32)
    _assert_bf16_close(mu, jmu, "mu")
    _assert_bf16_close(v, jv, "value")
    # the tolerance tells bf16 from the other precisions, on both outputs
    for other in (None, torch.float16):
        net.dtype = other
        omu, _, ov = net(torch.as_tensor(x))
        for out, ref, name in ((omu, jmu, "mu"), (ov, jv, "value")):
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(np_(out), ref, rtol=0.0,
                                           atol=BF16_STEP * np.abs(ref).max())


def test_flax_style_init_statistics():
    """Weights: truncated normal at +-2 std with std sqrt(scale / fan_in)
    (scale 1, the mu head 0.01), as flax's lecun_normal and
    variance_scaling(0.01, fan_in, truncated_normal) draw them; biases zero;
    log_std at sigma_init. The per-layer std of both packages' draws agrees
    within the sampling error (5% at these sizes)."""
    n_obs, n_act, units = ACTORS["humanoid"]
    net = networks.ActorCritic(n_obs, n_act, units, sigma_init=-1.0,
                               generator=torch.Generator().manual_seed(0))
    jp = _np_tree(_jax_params(jnetworks.ActorCritic(
        num_actions=n_act, units=units, sigma_init=-1.0), n_obs, 0))["params"]
    layers = [*net.trunk.layers, net.mu, net.value]
    names = [f"Dense_{i}" for i in range(len(layers))]
    for layer, jname in zip(layers, names):
        w = np_(layer.weight)
        scale = 0.01 if layer is net.mu else 1.0
        std = np.sqrt(scale / w.shape[1])
        assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
        assert (layer.bias == 0).all()
        assert jp[jname]["kernel"].shape == w.T.shape
        if w.size >= 400:
            np.testing.assert_allclose(w.std(), std, rtol=0.05)
            np.testing.assert_allclose(w.std(), jp[jname]["kernel"].std(), rtol=0.05)
    assert torch.equal(net.log_std, torch.full((n_act,), -1.0))
    # the same generator seed gives the same parameters
    again = networks.ActorCritic(n_obs, n_act, units, sigma_init=-1.0,
                                 generator=torch.Generator().manual_seed(0))
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_gaussian_functions():
    rng = np.random.default_rng(7)
    mu0, mu1, a = (rng.standard_normal((16, 6)).astype(np.float32) for _ in range(3))
    ls0, ls1 = (0.3 * rng.standard_normal((16, 6)).astype(np.float32) for _ in range(2))
    t = torch.as_tensor
    np.testing.assert_allclose(
        np_(networks.gaussian_logprob(t(mu0), t(ls0), t(a))),
        np.asarray(jnetworks.gaussian_logprob(mu0, ls0, a)), **F32)
    np.testing.assert_allclose(np_(networks.gaussian_entropy(t(ls0))),
                               np.asarray(jnetworks.gaussian_entropy(ls0)), **F32)
    np.testing.assert_allclose(
        np_(networks.gaussian_kl(t(mu0), t(ls0), t(mu1), t(ls1))),
        np.asarray(jnetworks.gaussian_kl(mu0, ls0, mu1, ls1)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task", TRAIN_TASKS)
def test_train_yaml_copy_and_ppo_config_kwargs(task):
    jpath = os.path.join(os.path.dirname(__file__), "..", "omniisaacgymenvs_tpu",
                         "cfg", "train", f"{task}PPO.yaml")
    with open(jpath, "rb") as f:
        ref = f.read()
    with open(os.path.join(CFG_DIR, "train", f"{task}PPO.yaml"), "rb") as f:
        assert f.read() == ref
    from omniisaacgymenvs_tpu.utils.config import load_config as jload_config
    cfg, jcfg = load_config({"task": task}), jload_config({"task": task})
    assert cfg["train"] == jcfg["train"]
    assert ppo_config_kwargs(cfg["train"]) == jppo_config_kwargs(jcfg["train"])


def test_load_config_overrides_train_keys():
    cfg = load_config({"task": "Humanoid",
                       "train.params.config.horizon_length": 8})
    kw = ppo_config_kwargs(cfg["train"])
    assert kw["horizon_length"] == 8 and kw["mixed_precision"] is True
    assert kw["units"] == (400, 200, 100) and kw["sigma_init"] == -1.0
