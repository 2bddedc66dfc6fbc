"""The reverse carrier (tests/torch_jax_checkpoint.py `carry_state_to_jax`):
a port `model.pt` carried into the JAX trainer and back through
`carry_state` equals the original file leaf for leaf and bit for bit, for
both trained AllegroHand states (f32, and the TPU's rule), and the JAX
trainer holds the file's numbers in its own layout and dtypes."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from omniisaacgymenvs_torch import convert
from omniisaacgymenvs_torch.learn import ppo
from omniisaacgymenvs_torch.scripts import train as ttrain
from torch_jax_checkpoint import ROOT, carry_state, carry_state_to_jax, jax_trainer
from torch_parity import to_numpy_tree

STATES = ("results_torch/AllegroHand_seed1", "results_torch/AllegroHand_T_seed1")
N = 8


@functools.lru_cache(maxsize=None)
def jax_side():
    return jax_trainer("AllegroHand", N)


def _port(args=()):
    _, _, tr = ttrain.build_trainer(["task=AllegroHand", f"num_envs={N}",
                                     "device=cpu", *args])
    return tr


def _file(state):
    return torch.load(os.path.join(ROOT, state, ppo.MAIN_FILE), map_location="cpu",
                      weights_only=True)


@pytest.mark.parametrize("state", STATES)
def test_round_trip_equals_the_file(state):
    jtr = jax_side()
    carry_state_to_jax(_port([f"checkpoint={state}", "test=True"]), jtr)
    back = _port()
    carry_state(jtr, back)
    want, got = _file(state), ppo._flatten(back._main_tree())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert got["epoch"] == 2000 and float(got["opt.count"]) == 40000.0


def test_jax_state_holds_the_file():
    """The JAX trainer's leaves: kernels transposed, Adam's count an int32
    step count, the norms' count as the file's, the lr and epoch."""
    state = STATES[0]
    jtr = jax_side()
    tr = _port([f"checkpoint={state}", "test=True"])
    carry_state_to_jax(tr, jtr)
    f, js = _file(state), jtr.state
    p = js.params["ac"]["params"]
    np.testing.assert_array_equal(np.asarray(p["Dense_0"]["kernel"]),
                                  f["ac.trunk.layers.0.weight"].numpy().T)
    np.testing.assert_array_equal(np.asarray(p["Dense_3"]["bias"]), f["ac.mu.bias"].numpy())
    np.testing.assert_array_equal(np.asarray(p["log_std"]), f["ac.log_std"].numpy())
    adam = js.opt_state[1]
    assert adam.count.dtype == jax.numpy.int32 and int(adam.count) == 40000
    mu = convert.actor_critic_arrays(to_numpy_tree(adam.mu["ac"]), tr.state.ac)
    np.testing.assert_array_equal(mu["value.weight"], f["opt.mu.value.weight"].numpy())
    assert float(js.obs_norm.count) == float(f["obs_norm.count"]) == 2000 * 8192 * 16
    assert np.float32(js.lr) == f["lr"].numpy() and int(js.epoch) == 2000


def test_actor_critic_tree_inverts_the_arrays():
    """`convert.actor_critic_tree` is `actor_critic_arrays`'s inverse."""
    tr = _port()
    arrays = {k: np.random.default_rng(0).standard_normal(tuple(v.shape)).astype(np.float32)
              for k, v in tr.state.ac.named_parameters()}
    tree = convert.actor_critic_tree(arrays, tr.state.ac)
    assert sorted(tree["params"]) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3",
                                      "Dense_4", "log_std"]
    back = convert.actor_critic_arrays(tree, tr.state.ac)
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
