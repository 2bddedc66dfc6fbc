"""Multi-GPU training: the env axis split over processes, one per GPU
(`parallel/mesh.py`)."""

from omniisaacgymenvs_torch.parallel.mesh import init_distributed

__all__ = ["init_distributed"]
