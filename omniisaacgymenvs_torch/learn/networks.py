"""Feed-forward actor-critic networks (PyTorch port of the FF part of the JAX
package's `learn/networks.py`), mirroring rl_games model/network configs.

Model `continuous_a2c_logstd`: a shared MLP trunk, a `mu` head, a
state-independent log-std parameter and a value head; the asymmetric
setups add a separate central-value MLP on the privileged states.
Parameters are initialized as flax does it: lecun-normal weights
(truncated normal, fan_in, scale 1), zero biases, the `mu` head at scale
0.01. With `dtype=torch.bfloat16` (rl_games mixed_precision) the forward
runs under autocast, so the matrix products and activations compute in
bf16 over f32 parameters; `mu` and `value` come back in f32. The recurrent
networks are not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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
                 generator: torch.Generator):
        super().__init__()
        sizes = [n_in, *units]
        self.layers = nn.ModuleList(
            _dense(a, b, 1.0, generator) for a, b in zip(sizes[:-1], sizes[1:]))
        self.act = _ACTS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = self.act(layer(x))
        return x


class ActorCritic(nn.Module):
    """Shared-trunk actor-critic with a constant log-std."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (256, 128, 64), activation: str = "elu",
                 sigma_init: float = 0.0, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.dtype = dtype
        self.trunk = _MLP(num_obs, units, activation, g)
        width = units[-1] if units else num_obs
        self.mu = _dense(width, num_actions, 0.01, g)
        self.log_std = nn.Parameter(torch.full((num_actions,), float(sigma_init)))
        self.value = _dense(width, 1, 1.0, g)

    def forward(self, obs: torch.Tensor):
        """(mu (.., A) f32, log_std (A,), value (..,) f32)."""
        with torch.autocast(obs.device.type, dtype=self.dtype or torch.bfloat16,
                            enabled=self.dtype is not None):
            x = self.trunk(obs)
            mu, value = self.mu(x), self.value(x)[..., 0]
        return mu.float(), self.log_std, value.float()


class CentralValue(nn.Module):
    """Separate critic on the privileged states (rl_games
    central_value_config)."""

    def __init__(self, num_states: int, units: Sequence[int] = (512, 512, 256, 128),
                 activation: str = "elu", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.dtype = dtype
        self.trunk = _MLP(num_states, units, activation, g)
        self.value = _dense(units[-1] if units else num_states, 1, 1.0, g)

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        with torch.autocast(states.device.type,
                            dtype=self.dtype or torch.bfloat16,
                            enabled=self.dtype is not None):
            value = self.value(self.trunk(states))[..., 0]
        return value.float()


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
