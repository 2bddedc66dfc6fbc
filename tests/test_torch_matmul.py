"""The networks' matmul rule "bf16_operands" (learn/networks.py): the
products of an XLA dot of f32 arrays at the TPU's default precision, the
arithmetic the JAX package's networks trained at on its chip. Each operand
is rounded to bf16 (ties to even), the products (exact in f32) are summed
in f32; the backward pass rounds the incoming gradient, the weight and the
input before each of its two products; biases and their gradients stay
f32.

The rounded layer, forward and backward, is held against an f64 reference
on the same bf16-rounded operands, within the f32 summation bound
n * 2^-24 * sum |a_i b_i| of each output element (n the length of the
sum), and so is the other rule, exact "f32", on the unrounded operands. The rule's wiring through the actor-critic and the central value,
which trainer takes it, the CLI key that sets it, and the defaults: the
learner's (the rule, for f32 feed-forward networks) and the networks' own
(exact f32).
"""

import types

import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch.learn.networks import (
    ActorCritic,
    CentralValue,
    _linear,
    round_bf16,
    rounded_linear,
)
from omniisaacgymenvs_torch.learn.ppo import PPOConfig, PPOTrainer
from omniisaacgymenvs_torch.utils.config import ppo_config_kwargs

U = 2.0 ** -24


def _f64(x):
    return x.detach().to(torch.float64)


def _assert_within_sum_bound(got, ref, abs_terms, n):
    err = (_f64(got) - ref).abs()
    bound = n * U * abs_terms
    assert (err <= bound + 1e-30).all(), float((err - bound).max())


@pytest.mark.parametrize("lead", [(7,), (2, 5)])
def test_rounded_linear_against_f64_reference(lead):
    rng = np.random.default_rng(0)
    n_in, n_out = 211, 96
    x = torch.tensor(rng.standard_normal((*lead, n_in)), dtype=torch.float32,
                     requires_grad=True)
    layer = torch.nn.Linear(n_in, n_out)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(0.1 * rng.standard_normal((n_out, n_in))))
        layer.bias.copy_(torch.tensor(rng.standard_normal(n_out)))
    g = torch.tensor(rng.standard_normal((*lead, n_out)), dtype=torch.float32)
    y = rounded_linear(layer, x)
    y.backward(g)

    xr, wr, gr = (_f64(round_bf16(t)) for t in (x, layer.weight, g))
    # the rounding is real: each operand moved, and the f32 product differs
    for t, r in ((x, xr), (layer.weight, wr), (g, gr)):
        assert (r != _f64(t)).float().mean() > 0.9
        # half a bf16 ulp: 8 significant bits
        assert ((r - _f64(t)).abs() <= 2.0 ** -8 * _f64(t).abs()).all()
    assert not torch.equal(y, layer(x))
    x2, g2 = xr.reshape(-1, n_in), gr.reshape(-1, n_out)
    ref = xr @ wr.T + _f64(layer.bias)
    _assert_within_sum_bound(y, ref, xr.abs() @ wr.abs().T + _f64(layer.bias).abs(),
                             n_in + 1)
    _assert_within_sum_bound(x.grad, gr @ wr, gr.abs() @ wr.abs(), n_out)
    _assert_within_sum_bound(layer.weight.grad, g2.T @ x2, g2.abs().T @ x2.abs(),
                             x2.shape[0])
    g64 = _f64(g).reshape(-1, n_out)
    _assert_within_sum_bound(layer.bias.grad, g64.sum(0), g64.abs().sum(0),
                             g64.shape[0])


@pytest.mark.parametrize("lead", [(7,), (2, 5)])
def test_exact_f32_layer_against_f64_reference(lead):
    """The other rule, "f32": a layer's forward and both backward products
    against the f64 products of the unrounded f32 operands, within the same
    summation bound; the bf16 rule's rounding stands outside it in most
    elements."""
    rng = np.random.default_rng(1)
    n_in, n_out = 211, 96
    x = torch.tensor(rng.standard_normal((*lead, n_in)), dtype=torch.float32,
                     requires_grad=True)
    layer = torch.nn.Linear(n_in, n_out)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(0.1 * rng.standard_normal((n_out, n_in))))
        layer.bias.copy_(torch.tensor(rng.standard_normal(n_out)))
    g = torch.tensor(rng.standard_normal((*lead, n_out)), dtype=torch.float32)
    y = _linear(layer, x, "f32")
    y.backward(g)
    x64, w64, g64 = (_f64(t).reshape(-1, t.shape[-1]) for t in (x, layer.weight, g))
    b64 = _f64(layer.bias)
    ref = x64 @ w64.T + b64
    terms = x64.abs() @ w64.abs().T + b64.abs()
    _assert_within_sum_bound(y.reshape(-1, n_out), ref, terms, n_in + 1)
    _assert_within_sum_bound(x.grad.reshape(-1, n_in), g64 @ w64, g64.abs() @ w64.abs(),
                             n_out)
    _assert_within_sum_bound(layer.weight.grad, g64.T @ x64, g64.abs().T @ x64.abs(),
                             x64.shape[0])
    _assert_within_sum_bound(layer.bias.grad, g64.sum(0), g64.abs().sum(0), g64.shape[0])
    err = (_f64(rounded_linear(layer, x)).reshape(-1, n_out) - ref).abs()
    assert (err > (n_in + 1) * U * terms).float().mean() > 0.5


def _manual_forward(net, x):
    """The trunk and the heads, each Linear through rounded_linear."""
    for layer in net.trunk.layers:
        x = torch.nn.functional.elu(rounded_linear(layer, x))
    heads = [net.mu, net.value] if isinstance(net, ActorCritic) else [net.value]
    return [rounded_linear(h, x) for h in heads]


@pytest.mark.parametrize("cls", [ActorCritic, CentralValue])
def test_networks_take_the_rule_in_every_product(cls):
    gen = torch.Generator().manual_seed(3)
    args = (24, 6) if cls is ActorCritic else (24,)
    net = cls(*args, units=(64, 32), matmul="bf16_operands", generator=gen)
    ref_net = cls(*args, units=(64, 32), generator=torch.Generator().manual_seed(3))
    ref_net.load_state_dict(net.state_dict())
    x = torch.randn(9, 24, generator=gen)
    out = net(x)
    outs = [out[0], out[2]] if cls is ActorCritic else [out]
    want = _manual_forward(net, x)
    for a, b in zip(outs, want):
        assert torch.equal(a, b.reshape(a.shape))
    # the same parameters under the f32 rule compute another function
    f32 = ref_net(x)
    assert not torch.equal(outs[0], f32[0] if cls is ActorCritic else f32)
    # and its gradients flow to every parameter
    loss = sum(o.square().sum() for o in outs)
    grads = torch.autograd.grad(loss, [p for k, p in net.named_parameters()
                                       if k != "log_std"])
    assert all(torch.isfinite(gr).all() and gr.abs().sum() > 0 for gr in grads)


def _rule(net_matmul, rnn=False):
    stub = types.SimpleNamespace(cfg=PPOConfig(net_matmul=net_matmul), is_rnn=rnn)
    return PPOTrainer._net_matmul(stub)


def test_which_trainer_takes_the_rule():
    assert _rule("f32") == "f32"
    assert _rule("f32", rnn=True) == "f32"
    assert _rule("bf16_operands") == "bf16_operands"
    # f32 LSTM networks take the rule as the feed-forward ones do; the
    # autocast ones compute as their dtype says
    assert _rule("bf16_operands", rnn=True) == "bf16_operands"
    stub = types.SimpleNamespace(
        cfg=PPOConfig(net_matmul="bf16_operands", mixed_precision=True), is_rnn=False)
    assert PPOTrainer._net_matmul(stub) == "f32"
    # an unknown rule is refused whatever the networks
    with pytest.raises(ValueError, match="matmul must be"):
        _rule("tf32", rnn=True)
    with pytest.raises(ValueError, match="autocast"):
        ActorCritic(8, 2, units=(16,), dtype=torch.bfloat16, matmul="bf16_operands")
    with pytest.raises(ValueError, match="matmul must be"):
        CentralValue(8, units=(16,), matmul="tf32")
    with pytest.raises(ValueError, match="matmul must be"):
        ActorCritic(8, 2, units=(16,), matmul="auto")


def test_cli_key_sets_the_rule():
    train = {"params": {"config": {"net_matmul": "bf16_operands"}}}
    assert ppo_config_kwargs(train)["net_matmul"] == "bf16_operands"
    # no yaml sets it: the key stays out of the map (the JAX package's map
    # has none), and the trainer takes PPOConfig's default
    assert "net_matmul" not in ppo_config_kwargs({"params": {"config": {}}})


def test_the_default_is_exact_f32():
    """Exact f32 (TF32 off) is the networks' own default, and the rule of
    every trainer whose networks are autocast; a trainer of f32 networks,
    feed-forward or LSTM, takes the TPU's rule unless f32 is asked for
    (`net_matmul=f32`; test_the_learners_default_is_the_tpus_rule)."""
    for rnn, mixed in ((True, False), (True, True), (False, True)):
        stub = types.SimpleNamespace(cfg=PPOConfig(mixed_precision=mixed), is_rnn=rnn)
        assert PPOTrainer._net_matmul(stub) == ("f32" if mixed else "bf16_operands")
    net = ActorCritic(8, 2, units=(16,), generator=torch.Generator().manual_seed(0))
    assert net.matmul == "f32" and net.trunk.matmul == "f32"
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    mu, _, value = net(x)
    lin, w = torch.nn.functional.linear, net.trunk.layers[0]
    h = torch.nn.functional.elu(lin(x, w.weight, w.bias))
    assert torch.equal(mu, lin(h, net.mu.weight, net.mu.bias))
    assert torch.equal(value, lin(h, net.value.weight, net.value.bias)[:, 0])


def test_the_learners_default_is_the_tpus_rule():
    """The learner's default for f32 feed-forward networks is the TPU's
    rule, set in one place (PPOConfig.net_matmul): AllegroHand's seed panel
    over epochs 1900-1999 put it within one pooled standard error of exact
    f32 (ROADMAP §C4), and it closed ShadowHand's gap to the JAX curve
    (§C3). The CLI's `train.params.config.net_matmul=f32` asks for f32."""
    assert PPOConfig().net_matmul == "bf16_operands"
    assert _rule(PPOConfig().net_matmul) == "bf16_operands"
    from omniisaacgymenvs_torch.scripts.common import build_env_from_cli

    for argv, rule in (((), "bf16_operands"),
                       (("train.params.config.net_matmul=f32",), "f32")):
        cfg, _, env = build_env_from_cli(["task=Cartpole", "num_envs=8", "device=cpu",
                                          *argv])
        tr = PPOTrainer(env, PPOConfig(**ppo_config_kwargs(cfg["train"])), seed=0)
        assert tr.net_matmul == tr.state.ac.matmul == tr.state.ac.trunk.matmul == rule


@pytest.mark.parametrize("matmul", ["f32", "bf16_operands"])
def test_chip_smoke_learner_check_takes_the_rule(matmul, capsys):
    """chip_smoke.py phase 8's learner epoch, card against CPU, under each
    rule: here both sides are the CPU, so they agree bit for bit, and the
    networks it compares computed under the rule it names (the trainer's
    own stay as they were)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from omniisaacgymenvs_torch.scripts.common import build_env_from_cli

    cfg, _, env = build_env_from_cli(["task=Cartpole", "num_envs=64", "device=cpu"])
    kw = ppo_config_kwargs(cfg["train"])
    kw.update(minibatch_size=256, mini_epochs=2)
    trainer = PPOTrainer(env, PPOConfig(**kw), seed=0)
    own = trainer.state.ac.matmul
    chip_smoke.learner_card_vs_cpu(trainer, "cpu", matmul=matmul, atol=0.0,
                                   rel_max=0.0, metric_rtol=0.0)
    assert f"({matmul} products)" in capsys.readouterr().out
    assert trainer.state.ac.matmul == trainer.state.ac.trunk.matmul == own
