"""Domain randomization (PyTorch port of the JAX package's
`utils/domain_randomization.py`), batched over the env axis.

The task yaml's `domain_randomization` block randomizes observations and
actions (correlated per-episode draws kept in the task carry, uncorrelated
per-step draws) and simulation parameters, which become a per-env `overlay`
dict that the physics engine consumes (`physics/engine.py`, and on CUDA the
step kernel's overlay input).

Overlay keys, each an (N, size) tensor:
  stiffness_scale, damping_scale (njd)        drive gains
  mass_scale (nb)                             mass and inertia (mass, density)
  geom_scale (nb)                             collision geometry (scale)
  friction_scale (nb)                         contact friction per body
                                              (material_properties)
  gravity_delta (3)                           simulation.gravity
  limit_lower_delta, limit_upper_delta (njd)  joint limit shifts
  tendon_stiffness_scale, tendon_damping_scale (nt)

Gates:
  on_startup   sampled once per env, kept across episode resets
  on_reset     sampled anew at every episode reset
  on_interval  sampled anew every `frequency_interval` env steps

Views: a task may expose `dr_views`, mapping the yaml's view names (e.g.
shadow_hand_view, object_view) to index sets {dofs, bodies, tendons}; a
property randomizes only the view's indices and the others stay neutral
(1 for a scale, 0 for a delta). Without a view map every index is
randomized.

Every draw comes from the `torch.Generator` the caller hands in, on the
model's device; each function consumes the generator in a fixed order, so a
seed reproduces a run.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch


def _sample(generator, spec: dict, shape, device) -> torch.Tensor:
    """A draw of `shape` = (N, ...) from the spec's distribution. The two
    distribution parameters are scalars or match the per-env shape; a
    material_properties triplet (static friction, dynamic friction,
    restitution) gives its first component, the one friction coefficient of
    the compliant contact model."""
    dist = spec.get("distribution", "gaussian")
    p = spec.get("distribution_parameters", [0.0, 1.0])
    p0, p1 = np.asarray(p[0], np.float32), np.asarray(p[1], np.float32)
    if p0.ndim > 0 and p0.shape != tuple(shape[1:]):
        p0, p1 = p0.reshape(-1)[0], p1.reshape(-1)[0]
    lo = torch.as_tensor(p0, device=device)
    hi = torch.as_tensor(p1, device=device)
    if dist == "gaussian":
        return lo + hi * torch.randn(shape, generator=generator, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    if dist == "uniform":
        return lo + (hi - lo) * u
    if dist == "loguniform":
        return torch.exp(torch.log(lo) + (torch.log(hi) - torch.log(lo)) * u)
    raise ValueError(f"unknown distribution {dist!r}")


def _apply(x, noise, spec: dict):
    if spec.get("operation", "additive") == "scaling":
        return x * noise
    return x + noise


# property -> (overlay key, kind, view index set, model size attribute)
_PROP_MAP = {
    "stiffness": ("stiffness_scale", "scale", "dofs", "njd"),
    "damping": ("damping_scale", "scale", "dofs", "njd"),
    "mass": ("mass_scale", "scale", "bodies", "nb"),
    "density": ("mass_scale", "scale", "bodies", "nb"),
    "scale": ("geom_scale", "scale", "bodies", "nb"),
    "material_properties": ("friction_scale", "scale", "bodies", "nb"),
    "lower_dof_limits": ("limit_lower_delta", "delta", "dofs", "njd"),
    "upper_dof_limits": ("limit_upper_delta", "delta", "dofs", "njd"),
    "tendon_stiffnesses": ("tendon_stiffness_scale", "scale", "tendons",
                           "nt"),
    "tendon_dampings": ("tendon_damping_scale", "scale", "tendons", "nt"),
}


def combine_overlays(a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
    """Merge two overlay dicts: *_scale keys multiply, *_delta keys add."""
    if not a:
        return b
    if not b:
        return a
    out = dict(a)
    for k, v in b.items():
        if k not in out:
            out[k] = v
        elif k.endswith("_scale"):
            out[k] = out[k] * v
        else:
            out[k] = out[k] + v
    return out


def _neutral(kind: str, n: int, size: int, device) -> torch.Tensor:
    fill = torch.ones if kind == "scale" else torch.zeros
    return fill((n, size), device=device)


class Randomizer:
    """Parses the `domain_randomization` block of a task yaml and draws what
    the task step needs. The distribution parameters are plain Python
    state: `set_dr_distribution_parameters` changes them and the next draw
    uses them."""

    def __init__(self, dr_cfg: Optional[dict]):
        dr_cfg = dr_cfg or {}
        self.randomize = bool(dr_cfg.get("randomize", False))
        self.params = dr_cfg.get("randomization_params", {}) or {}
        self._warn_unknown()

    def _warn_unknown(self):
        known_groups = {"observations", "actions", "simulation",
                        "articulation_views", "rigid_prim_views"}
        for g in self.params:
            if g not in known_groups:
                warnings.warn(f"unknown DR group {g!r} ignored")
        for group in ("articulation_views", "rigid_prim_views"):
            for view, props in (self.params.get(group) or {}).items():
                for prop in props or {}:
                    if prop not in _PROP_MAP:
                        warnings.warn(
                            f"unknown DR property {group}.{view}.{prop!r} "
                            "ignored"
                        )

    # ------------------------------------------------------------------
    def _spec(self, *path):
        d = self.params
        for p in path:
            if not isinstance(d, dict) or p not in d:
                return None
            d = d[p]
        return d

    def get_dr_distribution_parameters(self, *path):
        spec = self._spec(*path)
        return None if spec is None else spec.get("distribution_parameters")

    def set_dr_distribution_parameters(self, parameters, *path):
        spec = self._spec(*path)
        if spec is None:
            raise KeyError(f"no DR spec at {path}")
        spec["distribution_parameters"] = list(parameters)

    # ------------------------------------------------------------------
    # observation and action noise
    def sample_correlated(self, generator, n: int, num_obs: int,
                          num_actions: int, device) -> dict:
        """The per-episode (on_reset) correlated noise of n envs: carry
        entries `obs_corr` (n, num_obs) and `act_corr` (n, num_actions)."""
        out = {}
        spec = self._spec("observations", "on_reset")
        if spec:
            out["obs_corr"] = _sample(generator, spec, (n, num_obs), device)
        spec = self._spec("actions", "on_reset")
        if spec:
            out["act_corr"] = _sample(generator, spec, (n, num_actions),
                                      device)
        return out

    def _randomize(self, group: str, corr_key: str, x, generator, corr: dict,
                   progress):
        spec = self._spec(group, "on_reset")
        if spec and corr_key in corr:
            x = _apply(x, corr[corr_key], spec)
        spec = self._spec(group, "on_interval")
        if spec:
            noised = _apply(x, _sample(generator, spec, x.shape, x.device),
                            spec)
            x = self._gate_interval(spec, progress, noised, x)
        return x

    def randomize_observations(self, obs, generator, corr: dict,
                               progress=None):
        return self._randomize("observations", "obs_corr", obs, generator,
                               corr, progress)

    def randomize_actions(self, action, generator, corr: dict, progress=None):
        return self._randomize("actions", "act_corr", action, generator,
                               corr, progress)

    @staticmethod
    def _gate_interval(spec, progress, noised, clean):
        """The on_interval noise only where `progress` (N,) is a multiple of
        `frequency_interval`."""
        freq = int(spec.get("frequency_interval", 1))
        if freq <= 1 or progress is None:
            return noised
        return torch.where((progress % freq == 0)[:, None], noised, clean)

    # ------------------------------------------------------------------
    # simulation, articulation and rigid-prim parameter overlays
    def _entries(self, model, views, gate):
        """All (overlay key, kind, mask indices or None, size, spec) of one
        gate over the view groups and the simulation block. `views` maps
        the yaml's view names to index sets of the model; without a map
        every index is randomized; with one, a view name it lacks is
        skipped (a goal marker that is only drawn)."""
        out = []
        for group in ("articulation_views", "rigid_prim_views"):
            for view_name, props in (self._spec(group) or {}).items():
                if views is not None and view_name not in views:
                    continue
                vmap = (views or {}).get(view_name, {})
                for prop, gates in (props or {}).items():
                    if prop not in _PROP_MAP:
                        continue
                    spec = (gates or {}).get(gate)
                    if not spec:
                        continue
                    key, kind, idx_field, size_attr = _PROP_MAP[prop]
                    size = getattr(model, size_attr)
                    if size == 0:
                        continue
                    mask = vmap.get(idx_field)
                    if mask is not None:
                        mask = np.asarray(mask, np.int64)
                    out.append((key, kind, mask, size, spec))
        grav = (self._spec("simulation", "gravity") or {}).get(gate)
        if grav:
            out.append(("gravity_delta", "delta", None, 3, grav))
        return out

    def _sample_entry(self, generator, n, device, key, kind, mask, size, spec):
        op = spec.get("operation", "scaling" if kind == "scale" else
                      "additive")
        width = size if mask is None else len(mask)
        sample = _sample(generator, spec, (n, width), device)
        if kind == "scale":
            if op == "additive":
                # an additive operation on a scale: perturb around 1
                sample = 1.0 + sample
        elif op == "scaling":
            raise ValueError(
                f"scaling operation unsupported for delta property {key!r}")
        if mask is None:
            return sample
        out = _neutral(kind, n, size, device)
        out[:, torch.as_tensor(mask, device=device)] = sample
        return out

    def _sample_gate(self, generator, n, model, views, gate) -> Optional[dict]:
        out: dict = {}
        for key, kind, mask, size, spec in self._entries(model, views, gate):
            val = self._sample_entry(generator, n, model.device, key, kind,
                                     mask, size, spec)
            out = combine_overlays(out, {key: val})
        return out or None

    def sample_overlay(self, generator, n: int, model,
                       views=None) -> Optional[dict]:
        """The per-episode (on_reset) overlay of n envs. A key that only an
        on_interval gate randomizes starts at its neutral value, so the
        carry has the same keys at every step and `update_interval_overlay`
        merges into it."""
        out = self._sample_gate(generator, n, model, views, "on_reset")
        ientries = self._entries(model, views, "on_interval")
        if ientries:
            out = dict(out or {})
            for key, kind, _, size, _ in ientries:
                if key not in out:
                    out[key] = _neutral(kind, n, size, model.device)
        return out or None

    def sample_startup_overlay(self, generator, n: int, model,
                               views=None) -> Optional[dict]:
        """The once-per-env (on_startup) overlay; the task base keeps it
        across resets."""
        return self._sample_gate(generator, n, model, views, "on_startup")

    def has_interval_overlays(self) -> bool:
        """Whether any on_interval gate stands under the view groups or the
        simulation block (no model sizes needed)."""
        for group in ("articulation_views", "rigid_prim_views"):
            for props in (self._spec(group) or {}).values():
                for gates in (props or {}).values():
                    if isinstance(gates, dict) and "on_interval" in gates:
                        return True
        return "on_interval" in (self._spec("simulation", "gravity") or {})

    def update_interval_overlay(self, overlay, generator, model, progress,
                                views=None) -> Optional[dict]:
        """Sample the on_interval keys anew in the envs whose `progress`
        (N,) is a multiple of the key's `frequency_interval`; the others
        keep their values."""
        entries = self._entries(model, views, "on_interval")
        if not entries:
            return overlay
        overlay = dict(overlay or {})
        n = progress.shape[0]
        for key, kind, mask, size, spec in entries:
            fresh = self._sample_entry(generator, n, model.device, key, kind,
                                       mask, size, spec)
            freq = int(spec.get("frequency_interval", 1))
            cur = overlay.get(key)
            if cur is None:
                cur = _neutral(kind, n, size, model.device)
            overlay[key] = torch.where((progress % freq == 0)[:, None], fresh,
                                       cur)
        return overlay
