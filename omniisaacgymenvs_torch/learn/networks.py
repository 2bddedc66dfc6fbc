"""Actor-critic networks (PyTorch port of the JAX package's
`learn/networks.py`), mirroring rl_games model/network configs.

Model `continuous_a2c_logstd`: a shared MLP trunk, a `mu` head, a
state-independent log-std parameter and a value head; the asymmetric
setups add a separate central-value MLP on the privileged states. The
recurrent networks put an LSTM (and a LayerNorm) before the MLP
(rl_games `rnn` block, `before_mlp`). Parameters are initialized as flax
does it: lecun-normal weights (truncated normal, fan_in, scale 1), zero
biases, the `mu` head at scale 0.01, the LSTM's recurrent kernel
orthogonal. With `dtype=torch.bfloat16` (rl_games mixed_precision) the
forward runs under autocast, so the matrix products and activations
compute in bf16 over f32 parameters; `mu`, `value` and the LSTM carry
come back in f32.

The f32 networks, feed-forward and recurrent, take a second rule for
their matrix products, `matmul`: "f32" computes them in f32 (TF32 stays
off), "bf16_operands" as an XLA dot of f32 arrays at the TPU's default
precision, which the JAX package's networks ran at on its chip: each
operand rounded to bf16, the products (exact in f32) summed in f32, the
result f32. The backward pass follows the same rule (`rounded_linear`);
biases, activations and every elementwise step stay f32. In the LSTM the
rule takes the input and recurrent products of the gates, the MLP's
layers and the heads; the cell's gate arithmetic stays f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

_ACTS = {
    "elu": F.elu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "selu": F.selu,
}

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
# flax LayerNorm's epsilon (torch's default is 1e-5)
LN_EPS = 1e-6

Hidden = Tuple[torch.Tensor, torch.Tensor]


def _autocast(x: torch.Tensor, dtype: Optional[torch.dtype]):
    """bf16 (or `dtype`) compute for a network's forward; off for f32."""
    return torch.autocast(x.device.type, dtype=dtype or torch.bfloat16,
                          enabled=dtype is not None)


MATMULS = ("f32", "bf16_operands")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 (ties to even), kept in f32."""
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundedLinear(torch.autograd.Function):
    """y = round(x) round(W)^T + b, and in the backward pass
    dx = round(g) round(W) and dW = round(g)^T round(x): every product of
    the layer on bf16-rounded operands in an f32 GEMM (bf16 products are
    exact in f32), the bias and its gradient (a sum of g) in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xr, wr)
        return F.linear(xr, wr, bias)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_bf16(g)
        gx = gr @ wr if ctx.needs_input_grad[0] else None
        g2 = gr.reshape(-1, gr.shape[-1])
        gw = g2.T @ xr.reshape(-1, xr.shape[-1])
        gb = (g.reshape(-1, g.shape[-1]).sum(0) if ctx.needs_input_grad[2]
              else None)
        return gx, gw, gb


def rounded_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer(x)` under the "bf16_operands" rule (module docstring)."""
    return _RoundedLinear.apply(x, layer.weight, layer.bias)


def _linear(layer: nn.Linear, x: torch.Tensor, matmul: str) -> torch.Tensor:
    return rounded_linear(layer, x) if matmul == "bf16_operands" else layer(x)


def _check_matmul(matmul: str, dtype: Optional[torch.dtype]) -> str:
    if matmul not in MATMULS:
        raise ValueError(f"matmul must be one of {MATMULS}, got {matmul!r}")
    if matmul != "f32" and dtype is not None:
        raise ValueError(f"matmul={matmul!r} is a rule for f32 networks; these "
                         f"compute in {dtype} under autocast")
    return matmul


def set_matmul(net: nn.Module, matmul: str) -> None:
    """Every product of `net`, a network of this file, under the rule
    `matmul` from here on (its dtype must allow it)."""
    _check_matmul(matmul, getattr(net, "dtype", None))
    for m in net.modules():
        if hasattr(m, "matmul"):
            m.matmul = matmul


def variance_scaling_(weight: torch.Tensor, scale: float,
                      generator: torch.Generator) -> torch.Tensor:
    """flax `variance_scaling(scale, "fan_in", "truncated_normal")` on an
    nn.Linear weight (out, in): fan_in is the weight's second dim."""
    std = math.sqrt(scale / weight.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def _dense(n_in: int, n_out: int, scale: float,
           generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        variance_scaling_(layer.weight, scale, generator)
        layer.bias.zero_()
    return layer


class _MLP(nn.Module):
    """The trunk: Linear + activation per width."""

    def __init__(self, n_in: int, units: Sequence[int], activation: str,
                 generator: torch.Generator, matmul: str = "f32"):
        super().__init__()
        sizes = [n_in, *units]
        self.layers = nn.ModuleList(
            _dense(a, b, 1.0, generator) for a, b in zip(sizes[:-1], sizes[1:]))
        self.act = _ACTS[activation]
        self.matmul = matmul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = self.act(_linear(layer, x, self.matmul))
        return x


class ActorCritic(nn.Module):
    """Shared-trunk actor-critic with a constant log-std."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (256, 128, 64), activation: str = "elu",
                 sigma_init: float = 0.0, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 matmul: str = "f32"):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.dtype = dtype
        self.matmul = _check_matmul(matmul, dtype)
        self.trunk = _MLP(num_obs, units, activation, g, matmul)
        width = units[-1] if units else num_obs
        self.mu = _dense(width, num_actions, 0.01, g)
        self.log_std = nn.Parameter(torch.full((num_actions,), float(sigma_init)))
        self.value = _dense(width, 1, 1.0, g)

    def forward(self, obs: torch.Tensor):
        """(mu (.., A) f32, log_std (A,), value (..,) f32)."""
        with _autocast(obs, self.dtype):
            x = self.trunk(obs)
            mu = _linear(self.mu, x, self.matmul)
            value = _linear(self.value, x, self.matmul)[..., 0]
        return mu.float(), self.log_std, value.float()


class CentralValue(nn.Module):
    """Separate critic on the privileged states (rl_games
    central_value_config)."""

    def __init__(self, num_states: int, units: Sequence[int] = (512, 512, 256, 128),
                 activation: str = "elu", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 matmul: str = "f32"):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.dtype = dtype
        self.matmul = _check_matmul(matmul, dtype)
        self.trunk = _MLP(num_states, units, activation, g, matmul)
        self.value = _dense(units[-1] if units else num_states, 1, 1.0, g)

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        with _autocast(states, self.dtype):
            value = _linear(self.value, self.trunk(states), self.matmul)[..., 0]
        return value.float()


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function as the JAX package computes it: in bf16 XLA
    evaluates 1 / (1 + exp(-x)) with each operation rounded to bf16, where
    torch.sigmoid rounds once; the two differ by a bf16 step in a third of
    the gates, which the recurrence carries past a step at the outputs."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


class LSTMCore(nn.Module):
    """An LSTM layer with fused gate kernels: `wx` (in -> 4H, no bias) and
    `wh` (H -> 4H, orthogonal, with the bias), gates in flax LSTMCell's
    order i, f, g, o. Two apply paths: `forward(x, (h, c))`, one step (the
    rollout), and `seq(x_seq, (h, c), done_seq)`, the BPTT replay of a
    (B, T, in) sequence: one input projection over all T steps, then T
    recurrent steps. It runs inside its caller's autocast; the carry comes
    in f32 and stays f32 (a bf16 gate times the f32 cell promotes). `wx` and
    `wh` take the products' rule `matmul`."""

    def __init__(self, n_in: int, features: int, generator: torch.Generator,
                 matmul: str = "f32"):
        super().__init__()
        self.wx = nn.Linear(n_in, 4 * features, bias=False)
        self.wh = nn.Linear(features, 4 * features)
        self.matmul = matmul
        with torch.no_grad():
            variance_scaling_(self.wx.weight, 1.0, generator)
            nn.init.orthogonal_(self.wh.weight, generator=generator)
            self.wh.bias.zero_()

    def _step(self, h, c, x_gates):
        gates = x_gates + _linear(self.wh, h, self.matmul)
        # the cell's elementwise math in the gates' dtype, on every device
        # (CUDA's autocast would take exp to f32)
        with torch.autocast(gates.device.type, enabled=False):
            i, f, g, o = gates.chunk(4, dim=-1)
            c2 = _sigmoid(f) * c + _sigmoid(i) * torch.tanh(g)
            return _sigmoid(o) * torch.tanh(c2), c2

    def forward(self, x: torch.Tensor, hidden: Hidden):
        h2, c2 = self._step(*hidden, _linear(self.wx, x, self.matmul))
        return h2, (h2.float(), c2.float())

    def seq(self, x_seq: torch.Tensor, hidden: Hidden,
            done_seq: torch.Tensor) -> torch.Tensor:
        """x_seq (B, T, in), done_seq (B, T) bool -> outputs (B, T, H). The
        output at step t is the h before the reset (the action at t came
        from it); the carry into t + 1 is zeroed where done_seq[:, t] is
        set, as the rollout zeroes it."""
        x_gates = _linear(self.wx, x_seq, self.matmul)
        h, c = hidden
        outs = []
        for t in range(x_seq.shape[1]):
            h2, c2 = self._step(h, c, x_gates[:, t])
            outs.append(h2)
            d = done_seq[:, t, None]
            h = torch.where(d, 0.0, h2.float())
            c = torch.where(d, 0.0, c2.float())
        return torch.stack(outs, dim=1)


class _LSTMNet(nn.Module):
    """The recurrent trunk: the LSTM, LayerNorm (flax's epsilon) and the
    MLP `mlp_0`..; `_trunk` runs once on stacked (B, T, H) outputs. Every
    product of the network takes the rule `matmul`."""

    def __init__(self, n_in: int, lstm_units: int, units: Sequence[int],
                 activation: str, layer_norm: bool,
                 dtype: Optional[torch.dtype], generator: torch.Generator,
                 matmul: str = "f32"):
        super().__init__()
        self.dtype = dtype
        self.matmul = _check_matmul(matmul, dtype)
        self.act = _ACTS[activation]
        self.lstm = LSTMCore(n_in, lstm_units, generator, matmul)
        self.ln = nn.LayerNorm(lstm_units, eps=LN_EPS) if layer_norm else None
        sizes = [lstm_units, *units]
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"mlp_{i}", _dense(a, b, 1.0, generator))
        self.n_mlp = len(units)
        self.width = sizes[-1]

    def _trunk(self, out: torch.Tensor) -> torch.Tensor:
        x = self.ln(out) if self.ln is not None else out
        for i in range(self.n_mlp):
            x = self.act(_linear(getattr(self, f"mlp_{i}"), x, self.matmul))
        return x


class LSTMActorCritic(_LSTMNet):
    """LSTM-before-MLP actor-critic (rl_games rnn config: units 1024,
    layer_norm, before_mlp). Carries (h, c) per env: call with obs
    (N, num_obs) and hidden ((N, units), (N, units))."""

    def __init__(self, num_obs: int, num_actions: int, lstm_units: int = 1024,
                 units: Sequence[int] = (512, 512, 256, 128),
                 activation: str = "elu", sigma_init: float = 0.0,
                 layer_norm: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 matmul: str = "f32"):
        g = generator if generator is not None else torch.Generator()
        super().__init__(num_obs, lstm_units, units, activation, layer_norm,
                         dtype, g, matmul)
        self.mu = _dense(self.width, num_actions, 0.01, g)
        self.log_std = nn.Parameter(torch.full((num_actions,), float(sigma_init)))
        self.value = _dense(self.width, 1, 1.0, g)

    def _heads(self, out):
        x = self._trunk(out)
        return (_linear(self.mu, x, self.matmul).float(), self.log_std,
                _linear(self.value, x, self.matmul)[..., 0].float())

    def forward(self, obs: torch.Tensor, hidden: Hidden):
        """(mu, log_std, value, hidden after the step)."""
        with _autocast(obs, self.dtype):
            out, hidden = self.lstm(obs, hidden)
            mu, log_std, value = self._heads(out)
        return mu, log_std, value, hidden

    def seq(self, obs_seq: torch.Tensor, hidden: Hidden, done_seq: torch.Tensor):
        """BPTT replay: (B, T, obs) -> (mu (B, T, A), log_std (A,),
        value (B, T))."""
        with _autocast(obs_seq, self.dtype):
            return self._heads(self.lstm.seq(obs_seq, hidden, done_seq))


class LSTMCentralValue(_LSTMNet):
    """LSTM-before-MLP central value on the privileged states (rl_games
    central_value_config with an rnn block: lstm 1024 + mlp [512])."""

    def __init__(self, num_states: int, lstm_units: int = 1024,
                 units: Sequence[int] = (512,), activation: str = "relu",
                 layer_norm: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 matmul: str = "f32"):
        g = generator if generator is not None else torch.Generator()
        super().__init__(num_states, lstm_units, units, activation, layer_norm,
                         dtype, g, matmul)
        self.value = _dense(self.width, 1, 1.0, g)

    def _head(self, out):
        return _linear(self.value, self._trunk(out), self.matmul)[..., 0].float()

    def forward(self, states: torch.Tensor, hidden: Hidden):
        """(value, hidden after the step)."""
        with _autocast(states, self.dtype):
            out, hidden = self.lstm(states, hidden)
            value = self._head(out)
        return value, hidden

    def seq(self, states_seq: torch.Tensor, hidden: Hidden,
            done_seq: torch.Tensor) -> torch.Tensor:
        """BPTT replay: (B, T, states) -> values (B, T)."""
        with _autocast(states_seq, self.dtype):
            return self._head(self.lstm.seq(states_seq, hidden, done_seq))


def gaussian_logprob(mu, log_std, action):
    """Diagonal Gaussian log pi(a|s)."""
    var = torch.exp(2.0 * log_std)
    return -0.5 * torch.sum(
        (action - mu) ** 2 / var + 2.0 * log_std + math.log(2.0 * math.pi),
        dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)


def gaussian_kl(mu0, log_std0, mu1, log_std1):
    """KL(pi0 || pi1) for diagonal Gaussians (rl_games policy_kl)."""
    var0 = torch.exp(2.0 * log_std0)
    var1 = torch.exp(2.0 * log_std1)
    return torch.sum(
        log_std1 - log_std0 + (var0 + (mu0 - mu1) ** 2) / (2.0 * var1) - 0.5,
        dim=-1)
