"""Carry a model or a state across from the JAX package as numpy arrays.

`model_from_arrays` takes the fields of a JAX `Model` (numeric fields as
numpy arrays, structural fields as they are) and builds the port's Model;
`state_from_arrays` / `env_state_from_arrays` do the same for `State` and
`EnvState`. The model's constants play the role of weights, so both
packages compute on identical inputs. `actor_critic_from_arrays` /
`central_value_from_arrays` and their LSTM counterparts
`lstm_actor_critic_from_arrays` / `lstm_central_value_from_arrays` load a
flax parameter tree of the JAX learner's networks into the port's modules
(flax kernels are (in, out), a torch Linear's weight (out, in); a flax
LayerNorm's `scale` is the torch one's `weight`).
`adam_state_from_arrays` carries the JAX learner's Adam moments across in
the same layout, so that a port trainer can continue where a JAX one
stopped; `actor_critic_tree` lays the port's parameters or moments out as
the flax tree, for the way back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from omniisaacgymenvs_torch.learn.networks import (
    ActorCritic,
    CentralValue,
    LSTMActorCritic,
    LSTMCentralValue,
)
from omniisaacgymenvs_torch.learn.ppo import AdamState
from omniisaacgymenvs_torch.physics.model import Model
from omniisaacgymenvs_torch.physics.state import State
from omniisaacgymenvs_torch.tasks.base import EnvState

# Model fields kept as numpy integer index tables
_INDEX_FIELDS = ("jq_idx", "jv_idx", "cp_body", "pair_point", "tendon_dof")


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a.copy(), device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def model_from_arrays(fields: dict, device="cpu") -> Model:
    out = {}
    for f in dataclasses.fields(Model):
        v = fields[f.name]
        if f.name in _INDEX_FIELDS:
            out[f.name] = np.asarray(v, np.int32)
        elif isinstance(v, np.ndarray):
            out[f.name] = _tensor(v, device)
        else:
            out[f.name] = v
    return Model(**out)


def state_from_arrays(fields: dict, device="cpu") -> State:
    return State(**{f.name: _tensor(fields[f.name], device)
                    for f in dataclasses.fields(State)})


def _tensor_tree(v, device):
    if isinstance(v, dict):
        return {k: _tensor_tree(x, device) for k, x in v.items()}
    return _tensor(v, device)


def env_state_from_arrays(fields: dict, device="cpu") -> EnvState:
    """fields: the EnvState's fields as numpy arrays, with `phys` a dict of
    State fields and `carry` / `metrics` dicts of arrays, which may nest (an
    empty carry of another type becomes an empty dict; a carry's `_dr`, the
    domain randomization's correlated noise and overlays, crosses as nested
    tensors). Random keys still do not cross, the port draws from an
    explicit `torch.Generator`: a carry's
    per-env `noise_key` (AnymalTerrain) becomes the port's `obs_noise`, the
    step's observation noise, at zero."""
    obs = _tensor(fields["obs"], device)
    carry = dict(fields["carry"] or {})
    if "noise_key" in carry:
        del carry["noise_key"]
        carry["obs_noise"] = np.zeros(obs.shape, np.float32)
    return EnvState(
        phys=state_from_arrays(fields["phys"], device),
        carry=_tensor_tree(carry, device),
        obs=obs,
        states=_tensor(fields["states"], device),
        reward=_tensor(fields["reward"], device),
        done=_tensor(fields["done"], device),
        timeout=_tensor(fields["timeout"], device),
        progress=_tensor(fields["progress"], device),
        metrics=_tensor_tree(fields["metrics"], device),
    )


def _dense_names(tree: dict):
    """The tree's Dense_i keys in creation order."""
    return sorted((k for k in tree if k.startswith("Dense_")),
                  key=lambda k: int(k.split("_")[1]))


def _copy(dst: torch.Tensor, src):
    src = np.asarray(src, np.float32)
    if src.shape != tuple(dst.shape):
        raise ValueError(f"array {src.shape} does not fit a parameter of "
                         f"shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.as_tensor(src.copy()))


def _load_dense(layer: torch.nn.Linear, dense: dict):
    """A flax Dense ({"kernel": (in, out), "bias": (out,)}, the bias
    optional) into an nn.Linear (weight (out, in))."""
    _copy(layer.weight, np.asarray(dense["kernel"], np.float32).T)
    if "bias" in dense:
        _copy(layer.bias, dense["bias"])


def _params(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def actor_critic_arrays(tree: dict, module: ActorCritic) -> dict:
    """The flax ActorCritic tree {"params": {"Dense_0".."Dense_k-1"
    (trunk), "Dense_k" (mu), "Dense_k+1" (value), "log_std"}} (numpy
    arrays; an Adam moment of the parameters has the same tree) as
    {`module`'s parameter name: f32 array in the port's layout}."""
    p = _params(tree)
    dense = _dense_names(p)
    prefixes = _ac_prefixes(module)
    if len(dense) != len(prefixes):
        raise ValueError(f"{len(dense)} Dense layers for {len(prefixes)} Linears")
    out = {}
    for name, prefix in zip(dense, prefixes):
        out[f"{prefix}.weight"] = np.asarray(p[name]["kernel"], np.float32).T
        out[f"{prefix}.bias"] = np.asarray(p[name]["bias"], np.float32)
    out["log_std"] = np.asarray(p["log_std"], np.float32)
    return out


def _ac_prefixes(module: ActorCritic) -> list:
    """`module`'s Linears in the order flax creates its Dense_i."""
    return [f"trunk.layers.{i}" for i in range(len(module.trunk.layers))] + [
        "mu", "value"]


def actor_critic_tree(arrays: dict, module: ActorCritic) -> dict:
    """The inverse of `actor_critic_arrays`: {`module`'s parameter name:
    array in the port's layout} (its parameters, or an Adam moment of them)
    as the flax ActorCritic tree {"params": {"Dense_i": {"kernel", "bias"},
    "log_std"}} of f32 numpy arrays."""
    p = {f"Dense_{i}": {"kernel": np.asarray(arrays[f"{prefix}.weight"], np.float32).T,
                        "bias": np.asarray(arrays[f"{prefix}.bias"], np.float32)}
         for i, prefix in enumerate(_ac_prefixes(module))}
    p["log_std"] = np.asarray(arrays["log_std"], np.float32)
    return {"params": p}


def actor_critic_from_arrays(tree: dict, module: ActorCritic) -> ActorCritic:
    """Load the flax ActorCritic tree (`actor_critic_arrays`) into
    `module`, in place; returns it."""
    arrays = actor_critic_arrays(tree, module)
    for k, p in module.named_parameters():
        _copy(p, arrays[k])
    return module


def adam_state_from_arrays(mu: dict, nu: dict, count,
                           module: ActorCritic) -> AdamState:
    """optax `scale_by_adam`'s state of a flax ActorCritic (`mu` and `nu`
    trees shaped as its parameters, the step `count`) as the port's
    AdamState of `module`: each moment in its parameter's layout, in
    `module.parameters()`'s order, on its device."""
    params = dict(module.named_parameters())

    def moments(tree):
        arrays = actor_critic_arrays(tree, module)
        out = []
        for k, p in params.items():
            a = arrays[k]
            if a.shape != tuple(p.shape):
                raise ValueError(f"{k}: a moment of shape {a.shape} for a "
                                 f"parameter of shape {tuple(p.shape)}")
            out.append(torch.as_tensor(a.copy(), device=p.device))
        return out

    device = next(iter(params.values())).device
    return AdamState(mu=moments(mu), nu=moments(nu),
                     count=torch.tensor(float(np.asarray(count)), device=device))


def central_value_from_arrays(tree: dict, module: CentralValue) -> CentralValue:
    """Load the flax CentralValue tree {"params": {"Dense_0".."Dense_k"}}
    (the last the value head) into `module`, in place; returns it."""
    p = _params(tree)
    dense = _dense_names(p)
    layers = [*module.trunk.layers, module.value]
    if len(dense) != len(layers):
        raise ValueError(f"{len(dense)} Dense layers for {len(layers)} Linears")
    for name, layer in zip(dense, layers):
        _load_dense(layer, p[name])
    return module


def _load_lstm_trunk(p: dict, module):
    """lstm.wx / lstm.wh, ln and mlp_0.. of a flax LSTM network."""
    _load_dense(module.lstm.wx, p["lstm"]["wx"])
    _load_dense(module.lstm.wh, p["lstm"]["wh"])
    if module.ln is not None:
        _copy(module.ln.weight, p["ln"]["scale"])
        _copy(module.ln.bias, p["ln"]["bias"])
    mlp = sorted((k for k in p if k.startswith("mlp_")),
                 key=lambda k: int(k.split("_")[1]))
    if len(mlp) != module.n_mlp:
        raise ValueError(f"{len(mlp)} mlp layers for {module.n_mlp} Linears")
    for k in mlp:
        _load_dense(getattr(module, k), p[k])


def lstm_actor_critic_from_arrays(tree: dict,
                                  module: LSTMActorCritic) -> LSTMActorCritic:
    """Load the flax LSTMActorCritic tree {"params": {"lstm": {"wx", "wh"},
    "ln", "mlp_i", "mu", "value", "log_std"}} (numpy arrays) into `module`,
    in place; returns it."""
    p = _params(tree)
    _load_lstm_trunk(p, module)
    _load_dense(module.mu, p["mu"])
    _load_dense(module.value, p["value"])
    _copy(module.log_std, p["log_std"])
    return module


def lstm_central_value_from_arrays(tree: dict,
                                   module: LSTMCentralValue) -> LSTMCentralValue:
    """Load the flax LSTMCentralValue tree {"params": {"lstm", "ln",
    "mlp_i", "value"}} into `module`, in place; returns it."""
    p = _params(tree)
    _load_lstm_trunk(p, module)
    _load_dense(module.value, p["value"])
    return module
