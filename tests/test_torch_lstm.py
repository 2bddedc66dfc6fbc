"""Port parity of the recurrent networks against the JAX package's on the
CPU: LSTMCore (one step, and the BPTT `seq` path with dones in mid-sequence,
which zero the carry into the next step), LSTMActorCritic and
LSTMCentralValue (forward, `seq`, and the gradients of a loss over `seq`
against jax.grad), `seq` against the port's own step loop, the bf16 forward
(mixed_precision) and the flax-style initialization. Weights cross from
the JAX networks through convert.py; inputs are made from a numpy seed.

Tolerances (float32 unless named):
- forward values and gradients: rtol 1e-4, atol 1e-6 (gradients: atol
  1e-6 of the largest gradient), as tests/test_torch_ppo.py holds the FF
  networks (another summation order through the gates, the LayerNorm and
  the MLP);
- `seq` against the port's step loop: atol 1e-6 (the same arithmetic,
  one input projection over all steps instead of one per step);
- bf16: mu and value are bf16 values within one bf16 step (2^-8) of the
  output's scale of JAX's bf16 forward, which the f32 forward misses; the
  f32 carry within one bf16 step of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.learn import networks
from omniisaacgymenvs_tpu.learn import networks as jnetworks
from torch_parity import lstm_named_arrays, np_

FWD = dict(rtol=1e-4, atol=1e-6)
BF16_STEP = 2.0 ** -8
UNITS, B, T = 32, 6, 4
# dones in mid-sequence: none, one in the middle, all, at the end
DONE = np.array([[0, 0, 0, 0], [0, 1, 0, 0], [1, 1, 1, 1], [0, 0, 1, 0],
                 [0, 0, 0, 1], [1, 0, 0, 0]], bool)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.standard_normal(s).astype(np.float32)


def _hidden(f, n, units, scale=0.5):
    return (scale * f(n, units), scale * f(n, units))


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _core_pair(n_in, units, seed):
    jcore = jnetworks.LSTMCore(units)
    p = _np_tree(jcore.init(jax.random.PRNGKey(seed), jnp.zeros((1, n_in)),
                            (jnp.zeros((1, units)), jnp.zeros((1, units)))))
    core = networks.LSTMCore(n_in, units, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        core.wx.weight.copy_(torch.as_tensor(p["params"]["wx"]["kernel"].T.copy()))
        core.wh.weight.copy_(torch.as_tensor(p["params"]["wh"]["kernel"].T.copy()))
        core.wh.bias.copy_(torch.as_tensor(p["params"]["wh"]["bias"].copy()))
    return jcore, p, core


def test_lstm_core_step_and_seq_match_jax():
    n_in = 10
    jcore, p, core = _core_pair(n_in, UNITS, 0)
    f = _rng(1)
    x, hid = f(B, T, n_in), _hidden(f, B, UNITS)
    jh = tuple(jnp.asarray(h) for h in hid)
    out, (h2, c2) = core(torch.as_tensor(x[:, 0]), _t(*hid))
    jout, (jh2, jc2) = jcore.apply(p, jnp.asarray(x[:, 0]), jh)
    for a, b in ((out, jout), (h2, jh2), (c2, jc2)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(np_(a), np.asarray(b), **FWD)
    seq = core.seq(torch.as_tensor(x), _t(*hid), torch.as_tensor(DONE))
    jseq = jcore.apply(p, jnp.asarray(x), jh, jnp.asarray(DONE),
                       method=jnetworks.LSTMCore.seq)
    assert seq.shape == (B, T, UNITS)
    np.testing.assert_allclose(np_(seq), np.asarray(jseq), **FWD)


def test_lstm_core_seq_matches_its_step_loop():
    """seq (one input projection, then the recurrence) against step() with
    the rollout's reset applied between steps, as JAX's
    tests/test_lstm_compat.py holds its own."""
    n_in = 7
    core = networks.LSTMCore(n_in, UNITS, torch.Generator().manual_seed(3))
    f = _rng(4)
    x, (h, c) = torch.as_tensor(f(B, T, n_in)), _t(*_hidden(f, B, UNITS))
    done = torch.as_tensor(DONE)
    seq = core.seq(x, (h, c), done)
    steps = []
    for t in range(T):
        out, (h, c) = core(x[:, t], (h, c))
        steps.append(out)
        h, c = (torch.where(done[:, t, None], 0.0, v) for v in (h, c))
    torch.testing.assert_close(seq, torch.stack(steps, 1), rtol=0.0, atol=1e-6)
    # a done resets the carry: the row that is done everywhere sees only
    # zeros after its first step, so its outputs from t = 1 on are equal
    torch.testing.assert_close(seq[2, 1], core(x[2:3, 1], _t(
        np.zeros((1, UNITS), np.float32), np.zeros((1, UNITS), np.float32)))[0][0],
        rtol=0.0, atol=1e-6)


# (n_in, lstm units, mlp units): the actor, the central value
NETS = {"actor": (12, UNITS, (24, 16)), "central_value": (20, UNITS, (24,))}


def _net_pair(kind, seed, jdtype=None, dtype=None):
    n_in, lstm_units, units = NETS[kind]
    g = torch.Generator().manual_seed(seed)
    hid0 = (jnp.zeros((1, lstm_units)), jnp.zeros((1, lstm_units)))
    if kind == "actor":
        jnet = jnetworks.LSTMActorCritic(num_actions=5, lstm_units=lstm_units,
                                         units=units, sigma_init=-0.5,
                                         dtype=jdtype)
        net = networks.LSTMActorCritic(n_in, 5, lstm_units, units, sigma_init=-0.5,
                                       dtype=dtype, generator=g)
        load = convert.lstm_actor_critic_from_arrays
    else:
        jnet = jnetworks.LSTMCentralValue(lstm_units=lstm_units, units=units,
                                          dtype=jdtype)
        net = networks.LSTMCentralValue(n_in, lstm_units, units, dtype=dtype,
                                        generator=g)
        load = convert.lstm_central_value_from_arrays
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, n_in)), hid0)
    load(_np_tree(params), net)
    return jnet, params, net


@pytest.mark.parametrize("kind", sorted(NETS))
def test_lstm_networks_forward_and_seq_match_jax(kind):
    n_in, units, _ = NETS[kind]
    jnet, params, net = _net_pair(kind, 5)
    f = _rng(6)
    x, hid = f(B, n_in), _hidden(f, B, units)
    jh = tuple(jnp.asarray(h) for h in hid)
    out = net(torch.as_tensor(x), _t(*hid))
    jout = jnet.apply(params, jnp.asarray(x), jh)
    if kind == "actor":
        (mu, ls, v, (h, c)), (jmu, jls, jv, (jh2, jc2)) = out, jout
        pairs = [(mu, jmu), (ls, jls), (v, jv), (h, jh2), (c, jc2)]
    else:
        (v, (h, c)), (jv, (jh2, jc2)) = out, jout
        pairs = [(v, jv), (h, jh2), (c, jc2)]
    assert v.shape == (B,)
    for a, b in pairs:
        np.testing.assert_allclose(np_(a), np.asarray(b), **FWD)
    xs = f(B, T, n_in)
    seq = net.seq(torch.as_tensor(xs), _t(*hid), torch.as_tensor(DONE))
    jseq = jnet.apply(params, jnp.asarray(xs), jh, jnp.asarray(DONE),
                      method=type(jnet).seq)
    seq, jseq = (seq, jseq) if kind == "actor" else ((seq,), (jseq,))
    assert seq[-1].shape == (B, T)   # the values
    for a, b in zip(seq, jseq):
        np.testing.assert_allclose(np_(a), np.asarray(b), **FWD)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_lstm_networks_seq_gradients_match_jax(kind):
    """The gradients of a loss over the BPTT replay (a weighted sum of
    every output) through both packages."""
    n_in, units, mlp = NETS[kind]
    jnet, params, net = _net_pair(kind, 7)
    f = _rng(8)
    xs, hid = f(B, T, n_in), _hidden(f, B, units)
    w_mu, w_v = f(B, T, 5), f(B, T)

    def jloss(p):
        out = jnet.apply(p, jnp.asarray(xs), tuple(map(jnp.asarray, hid)),
                         jnp.asarray(DONE), method=type(jnet).seq)
        if kind == "actor":
            mu, ls, v = out
            return jnp.sum(mu * w_mu) + jnp.sum(v * w_v) + jnp.sum(ls ** 2)
        return jnp.sum(out * w_v)

    jl, jg = jax.value_and_grad(jloss)(params)
    out = net.seq(torch.as_tensor(xs), _t(*hid), torch.as_tensor(DONE))
    if kind == "actor":
        mu, ls, v = out
        loss = (mu * torch.as_tensor(w_mu)).sum() + (v * torch.as_tensor(w_v)).sum() \
            + (ls ** 2).sum()
    else:
        loss = (out * torch.as_tensor(w_v)).sum()
    named = dict(net.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    ref = lstm_named_arrays(_np_tree(jg), len(mlp), actor=kind == "actor")
    assert sorted(ref) == sorted(grads)
    scale = max(np.abs(g).max() for g in ref.values())
    for name, g in grads.items():
        np.testing.assert_allclose(np_(g), ref[name], rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


def _assert_bf16_close(out, ref, name, representable=True):
    if representable:
        assert torch.equal(out, out.to(torch.bfloat16).float()), name
    np.testing.assert_allclose(np_(out), ref, rtol=0.0,
                               atol=BF16_STEP * np.abs(ref).max(), err_msg=name)


def test_lstm_actor_critic_forward_bf16():
    """mixed_precision: the gate products, the MLP and the heads in bf16
    over f32 parameters; mu and value come back as bf16 values in f32, the
    carry in f32 (a bf16 gate times the f32 cell promotes), in both
    packages."""
    n_in, units, _ = NETS["actor"]
    jnet, params, net = _net_pair("actor", 9, jnp.bfloat16, torch.bfloat16)
    f = _rng(10)
    x, hid = f(64, n_in), _hidden(f, 64, units)
    jmu, _, jv, (jh, jc) = jnet.apply(params, jnp.asarray(x),
                                      tuple(map(jnp.asarray, hid)))
    mu, ls, v, (h, c) = net(torch.as_tensor(x), _t(*hid))
    assert all(t.dtype == torch.float32 for t in (mu, ls, v, h, c))
    assert jh.dtype == jnp.float32 and jc.dtype == jnp.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    ref = {"mu": np.asarray(jmu, np.float32), "value": np.asarray(jv, np.float32)}
    _assert_bf16_close(mu, ref["mu"], "mu")
    _assert_bf16_close(v, ref["value"], "value")
    _assert_bf16_close(h, np.asarray(jh), "h", representable=False)
    _assert_bf16_close(c, np.asarray(jc), "c", representable=False)
    # the rule tells bf16 from f32 on both outputs
    net.dtype = None
    omu, _, ov, _ = net(torch.as_tensor(x), _t(*hid))
    for out, name in ((omu, "mu"), (ov, "value")):
        with pytest.raises(AssertionError):
            _assert_bf16_close(out, ref[name], name)


def test_lstm_init_statistics():
    """wx: truncated normal, std sqrt(1 / fan_in), as flax's lecun_normal;
    wh: orthogonal (its (4H, H) weight has orthonormal columns, the flax
    kernel (H, 4H) orthonormal rows); every bias zero, the LayerNorm's
    weight one, log_std at sigma_init; the MLP and heads as the FF
    networks draw them."""
    n_in, units = 64, 256
    net = networks.LSTMActorCritic(n_in, 8, units, (128,), sigma_init=-1.0,
                                   generator=torch.Generator().manual_seed(0))
    jp = _np_tree(jnetworks.LSTMActorCritic(
        num_actions=8, lstm_units=units, units=(128,), sigma_init=-1.0).init(
        jax.random.PRNGKey(0), jnp.zeros((1, n_in)),
        (jnp.zeros((1, units)), jnp.zeros((1, units)))))["params"]
    wx, wh = np_(net.lstm.wx.weight), np_(net.lstm.wh.weight)
    assert wx.shape == jp["lstm"]["wx"]["kernel"].T.shape == (4 * units, n_in)
    std = np.sqrt(1.0 / n_in)
    assert np.abs(wx).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
    np.testing.assert_allclose(wx.std(), std, rtol=0.05)
    np.testing.assert_allclose(wx.std(), jp["lstm"]["wx"]["kernel"].std(), rtol=0.05)
    np.testing.assert_allclose(wh.T @ wh, np.eye(units), atol=1e-5)
    jwh = jp["lstm"]["wh"]["kernel"]
    np.testing.assert_allclose(jwh @ jwh.T, np.eye(units), atol=1e-5)
    assert net.lstm.wx.bias is None and "bias" not in jp["lstm"]["wx"]
    for name, b in net.named_parameters():
        if name.endswith("bias"):
            assert (b == 0).all(), name
    assert (net.ln.weight == 1).all() and net.ln.eps == 1e-6
    assert torch.equal(net.log_std, torch.full((8,), -1.0))
    again = networks.LSTMActorCritic(n_in, 8, units, (128,), sigma_init=-1.0,
                                     generator=torch.Generator().manual_seed(0))
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)
