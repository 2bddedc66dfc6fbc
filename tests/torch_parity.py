"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_*.py): data crosses between the two as
numpy arrays, made from a seed with numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


def jax_fields(obj) -> dict:
    """A JAX dataclass's fields, arrays as numpy (recursing into nested
    dataclasses and dicts)."""
    out = {}
    for f in dataclasses.fields(obj):
        out[f.name] = to_numpy_tree(getattr(obj, f.name))
    return out


def to_numpy_tree(v):
    if dataclasses.is_dataclass(v):
        return jax_fields(v)
    if isinstance(v, dict):
        return {k: to_numpy_tree(x) for k, x in v.items()}
    if hasattr(v, "shape") and not isinstance(v, (np.ndarray, torch.Tensor)):
        return np.asarray(v)
    return v


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
