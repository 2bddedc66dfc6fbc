"""The env axis across processes on `torch.distributed` (PyTorch port of the
JAX package's `parallel/mesh.py`).

The JAX package shards the env batch over a 1-D ('env',) device mesh and
replicates the learner. The port keeps that layout with one process per
GPU (`torchrun`): rank r holds the contiguous envs `env_range(N, r, W)`,
every rank holds the whole learner, and what the learner reduces over the
env axis (episode sums, norms, advantage moments, losses, gradients) is
reduced over all ranks. One process drives one card: the kernels raise
their shared-memory limit once per process, on the device current at their
first launch (`ops/csrc/fused_step.cu` allow_max_smem), and
`fused_step.library().claim` refuses a launch on a second device.

Without a process group (or at world size 1) every reduction here is the
plain local one, with the same arithmetic as before there was a group.

NCCL on CUDA and gloo on the CPU. Collectives take tensors where the
backend wants them: NCCL on the rank's card, gloo on the host. Gloo does
all_reduce and broadcast on CUDA tensors itself but not all_gather, so
under gloo a CUDA tensor is staged through a host copy for the gather
alone (`GLOO_HOST_STAGED`); this happens only when two ranks share one
card under gloo (NCCL refuses two ranks on one device), a check, not a
fallback for NCCL.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from omniisaacgymenvs_torch.utils.device import resolve_device

# the collectives a CUDA tensor goes through a host copy for under gloo
GLOO_HOST_STAGED = ("all_gather",)


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _group_up() else 1


def rank() -> int:
    return dist.get_rank() if _group_up() else 0


def active() -> bool:
    """Whether a process group of more than one rank is up."""
    return world_size() > 1


def is_main() -> bool:
    """Rank 0: the process that logs and writes the run's files."""
    return rank() == 0


def init_distributed(device="cuda", backend: str | None = None) -> torch.device:
    """Join the process group that `torchrun` (or a caller) describes in
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, and return
    this rank's device: `cuda:LOCAL_RANK` (made the current device) unless
    `device` names an index, or the CPU. The backend is NCCL on CUDA and
    gloo on the CPU unless `backend` is given. On CUDA the first process of
    each host builds the kernels while the others wait at a barrier, then
    they load the built libraries."""
    world = int(os.environ["WORLD_SIZE"])
    rk = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rk))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(dev if dev.index is not None else f"cuda:{local}")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rk, world_size=world, **kw)
    if dev.type == "cuda":
        from omniisaacgymenvs_torch.ops import fused_step

        if local == 0:
            fused_step.library()
        dist.barrier()
    return dev


def rank_seed(seed: int, rk: int) -> int:
    """The seed of rank rk's generators: `seed` itself on rank 0, so that a
    1-rank run draws as a run without a group does; on another rank (seed,
    rank) mixed into 31 bits (the CPU generator keeps only a seed's low 32
    bits)."""
    if rk == 0:
        return int(seed)
    return (int(seed) * 1_000_003 + int(rk) * 0x9E3779B1) % (1 << 31)


def env_range(num_envs: int, rk: int, world: int) -> slice:
    """The contiguous envs of rank rk among num_envs; refuses a count that
    does not split evenly."""
    if num_envs % world:
        raise ValueError(f"num_envs {num_envs} does not split over {world} ranks")
    n = num_envs // world
    return slice(rk * n, (rk + 1) * n)


# ---------------------------------------------------------------------------
# reductions (no host sync under NCCL: collectives are stream-ordered)
# ---------------------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks (a new tensor); x itself without a group."""
    if not active():
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out


def mean_(x: torch.Tensor) -> torch.Tensor:
    """x replaced, in place, by its mean over the ranks."""
    if active():
        dist.all_reduce(x)
        x.div_(world_size())
    return x


def env_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of all of x's elements over every rank's envs."""
    return all_reduce_sum(x.sum())


def env_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x's elements over every rank's envs (the ranks hold
    equal shares, so the mean of the ranks' means)."""
    m = x.mean()
    if not active():
        return m
    return all_reduce_sum(m) / world_size()


def moments(x: torch.Tensor, dim=0):
    """(mean, population variance) of x over `dim` (an int or a tuple) and
    every rank's envs: two passes, the global mean first, then the global
    sum of squared deviations from it. Without a group:
    `x.mean(dim), x.var(dim, correction=0)`."""
    if not active():
        return x.mean(dim), x.var(dim, correction=0)
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    count = world_size()
    for d in dims:
        count *= x.shape[d]
    mean = all_reduce_sum(x.sum(dims)) / count
    kept = list(x.shape)
    for d in dims:
        kept[d] = 1
    dev = x - mean.reshape(kept)
    return mean, all_reduce_sum((dev * dev).sum(dims)) / count


def broadcast_(tensors, src: int = 0):
    """Every tensor set, in place, to rank src's."""
    if active():
        for t in tensors:
            dist.broadcast(t, src)


def _staged(x: torch.Tensor, op: str) -> bool:
    return (op in GLOO_HOST_STAGED and x.is_cuda
            and dist.get_backend() == dist.Backend.GLOO)


def gather_envs(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x concatenated along the env axis (dim 0), on every rank,
    on x's device. Under NCCL a host tensor goes through the rank's card;
    under gloo a CUDA tensor through a host copy."""
    if not active():
        return x
    y = x.contiguous()
    if _staged(y, "all_gather"):
        y = y.cpu()
    elif dist.get_backend() == dist.Backend.NCCL and not y.is_cuda:
        y = y.cuda()
    parts = [torch.empty_like(y) for _ in range(world_size())]
    dist.all_gather(parts, y)
    return torch.cat(parts).to(x.device)

