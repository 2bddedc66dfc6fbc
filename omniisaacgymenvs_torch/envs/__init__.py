"""Vectorized environments."""

from omniisaacgymenvs_torch.envs.vec_env import VecEnv
