"""Running mean/std normalization (rl_games RunningMeanStd; PyTorch port of
the JAX package's `learn/running_norm.py`), enabled by normalize_input /
normalize_value in cfg/train/*PPO.yaml.

`update` returns a new RunningNorm and leaves the old one as it was: the
epoch relies on which statistics each phase sees. Variances are population
variances (correction 0). Under a process group the batch's count, mean
and variance are those of every rank's batch together (two passes,
`parallel.mesh.moments`), so every rank holds the same statistics.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from omniisaacgymenvs_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class RunningNorm:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor   # () f32

    @classmethod
    def create(cls, shape, device="cpu") -> "RunningNorm":
        return cls(mean=torch.zeros(shape, device=device),
                   var=torch.ones(shape, device=device),
                   count=torch.tensor(1e-4, device=device))

    def update(self, batch: torch.Tensor) -> "RunningNorm":
        """Welford parallel update with a batch flattened over leading axes
        (over every rank's batch under a process group)."""
        x = batch.reshape((-1,) + tuple(self.mean.shape))
        b_mean, b_var = mesh.moments(x, 0)
        b_count = x.shape[0] * mesh.world_size()
        delta = b_mean - self.mean
        tot = self.count + b_count
        mean = self.mean + delta * b_count / tot
        m2 = (self.var * self.count + b_var * b_count
              + delta ** 2 * self.count * b_count / tot)
        return RunningNorm(mean=mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        y = (x - self.mean) / torch.sqrt(self.var + 1e-5)
        return y if math.isinf(clip) else y.clamp(-clip, clip)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(self.var + 1e-5) + self.mean
