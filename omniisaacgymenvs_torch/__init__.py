"""omniisaacgymenvs_torch: the PyTorch and CUDA port of omniisaacgymenvs_tpu.

Mirrors the JAX package's layout; plain functions on batch-first tensors
with a leading env axis, and hand-written CUDA kernels for the physics
step on NVIDIA Hopper:
  physics/   articulation dynamics (Featherstone ABA), contacts, engine
  models/    robot model specs
  tasks/     per-task obs / reward / done / reset, batched
  envs/      vectorized env with auto-reset
  ops/       CUDA kernels (csrc/) with their wrappers and plain versions
  utils/     config system, devices
  scripts/   entry points
Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
