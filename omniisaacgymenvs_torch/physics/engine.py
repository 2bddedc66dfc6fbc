"""Physics engine: stepping functions bound to a (model, params) pair,
batched over a leading env axis (PyTorch port of the JAX package's
`physics/engine.py`: flat ground, pair contacts, gravity compensation and
fixed tendons; heightfields and randomization overlays are not ported and
raise).

The device of the model's tensors picks the path. On CUDA, `step_n` is
one launch of the whole-control-step kernel K1 and `_report` (hence
`init_state`) one launch of the report-FK kernel K2
(`ops/fused_step.py`, which also has the single-substep kernel K3 that no
engine path launches); a model beyond the kernels' maxima raises
`NotImplementedError` there (`check_scope`). On the CPU both run the plain
versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from omniisaacgymenvs_torch.ops import fused_step
from omniisaacgymenvs_torch.physics import dynamics
from omniisaacgymenvs_torch.physics.contacts import (
    ContactParams,
    auto_contact_params,
    build_pair_groups,
    pair_contacts,
    pair_gains,
    plane_contacts,
    point_gains,
)
from omniisaacgymenvs_torch.physics.model import Model
from omniisaacgymenvs_torch.physics.state import Control, State


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation parameters (the task yaml's `sim` block: dt, substeps,
    gravity; contact material from default_physics_material)."""

    dt: float = 1.0 / 60.0
    substeps: int = 1
    gravity: tuple = (0.0, 0.0, -9.81)
    # None -> stable gains derived from the model (auto_contact_params)
    contact: Optional[ContactParams] = None
    friction: float = 1.0
    # contact force cap as an escape velocity
    max_depenetration_velocity: float = 10.0


def sim_params_from_cfg(sim_cfg, dt: float = 1.0 / 60.0, substeps: int = 1,
                        gravity=(0.0, 0.0, -9.81),
                        friction: float = 1.0) -> SimParams:
    """SimParams from a task yaml `sim` block (utils/sim_config)."""
    from omniisaacgymenvs_torch.utils.sim_config import parse_sim_cfg

    return SimParams(**parse_sim_cfg(
        sim_cfg, dt=dt, substeps=substeps, gravity=gravity,
        friction=friction,
    ))


def check_scope(model: Model, cuda: bool):
    """Raise NotImplementedError for a scene the port cannot step: on CUDA
    what lies beyond the kernels' maxima (there is no plain fallback on the
    card)."""
    errs = fused_step.scope_errors(model) if cuda else []
    if errs:
        raise NotImplementedError(f"{model.name}: {'; '.join(errs)}")


class PhysicsEngine:
    """Stepping functions over batched (N, ...) states of one model."""

    def __init__(self, model: Model, params: SimParams, height_fn=None,
                 contact_plane_fn=None):
        if height_fn is not None or contact_plane_fn is not None:
            raise NotImplementedError(
                "heightfield and contact-plane terrain are not ported yet")
        check_scope(model, cuda=model.device.type == "cuda")
        self.model = model
        self.params = params
        self.device = model.device
        self.h = params.dt / params.substeps
        self.contact_params = (
            params.contact
            if params.contact is not None
            else auto_contact_params(
                model, self.h, mu=params.friction,
                max_depenetration_velocity=params.max_depenetration_velocity,
            )
        )
        gains = point_gains(model, self.contact_params)
        self.contact_gains = tuple(
            torch.as_tensor(g, dtype=torch.float32, device=self.device)
            for g in gains
        )
        self._gravity = torch.tensor(params.gravity, dtype=torch.float32,
                                     device=self.device)
        self.pair_groups = build_pair_groups(model)
        self.pair_gains = pair_gains(model, self.pair_groups,
                                     self.contact_params)
        self._has_pairs = len(model.pair_surf) > 0
        # counter-gravity force per body, (nb, 3); None without compensation
        self._gravcomp_force = None
        if bool(torch.any(model.gravity_comp != 0)):
            self._gravcomp_force = (
                -(model.gravity_comp * model.body_mass)[:, None] * self._gravity
            )
        self.kernels = None
        if self.device.type == "cuda":
            # physics runs in full f32: no TF32 in any matmul
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.kernels = fused_step.FusedKernels(
                model, self.h, params.gravity, self.contact_params, gains,
                self.pair_gains,
            )

    # ------------------------------------------------------------------
    def default_control(self, n: int) -> Control:
        m = self.model
        z = lambda *s: torch.zeros((n,) + s, device=self.device)  # noqa: E731
        return Control(effort=z(m.njd), pos_target=z(m.njd),
                       vel_target=z(m.njd), body_force=z(m.nb, 3),
                       body_torque=z(m.nb, 3))

    # ------------------------------------------------------------------
    def _report(self, q, qd, sensor_forces) -> State:
        """Fresh report FK fills the world-frame fields (K2 on CUDA)."""
        pos, quat, avel, lvel = fused_step.fk(
            self, q.contiguous(), qd.contiguous()
        )
        return State(q=q, qd=qd, body_pos=pos, body_quat=quat,
                     body_lvel=lvel, body_avel=avel,
                     sensor_forces=sensor_forces)

    def init_state(self, q: torch.Tensor, qd: torch.Tensor) -> State:
        sf = q.new_zeros((q.shape[0], self.model.num_sensors, 6))
        return self._report(q, qd, sf)

    # ------------------------------------------------------------------
    def _substep(self, q, qd, control: Control, f_applied, h):
        """One plain substep: FK -> contacts -> drives -> ABA -> integrate.
        Returns (q, qd, sensor_forces); sensors read the contact wrench
        [force, torque] of their bodies: ground and pair contacts, without
        applied forces and gravity compensation."""
        m = self.model
        kin = dynamics.kinematics(m, q, qd)
        avel, lvel = dynamics.world_velocities(m, kin)
        cres = plane_contacts(m, kin.pw, kin.Rw, avel, lvel,
                              self.contact_params, self.contact_gains)
        f_contact = cres.f_ext
        if self._has_pairs:
            f_contact = f_contact + pair_contacts(
                m, self.pair_groups, kin.pw, kin.Rw, avel, lvel,
                self.contact_params, self.pair_gains)
        f_ext = f_contact + f_applied
        if self._gravcomp_force is not None:
            # counter-gravity at each compensated body's CoM
            fg = self._gravcomp_force
            com_rel = (kin.Rw @ m.body_com[..., None])[..., 0]
            ng = torch.linalg.cross(com_rel, fg.expand_as(com_rel), dim=-1)
            f_ext = f_ext + torch.cat([ng, fg.expand_as(ng)], dim=-1)
        tau = dynamics.drive_torques(m, q, qd, control, h)
        qdd = dynamics.aba(m, q, qd, tau, f_ext, kin, self._gravity, h)
        q, qd = dynamics.integrate(m, q, qd, qdd, h)
        sb = list(m.sensor_body)
        sensor_forces = torch.cat(
            [f_contact[:, sb, 3:6], f_contact[:, sb, 0:3]], dim=-1
        )
        return q, qd, sensor_forces

    def step_n(self, state: State, control: Control, n: int = 1,
               overlay=None) -> State:
        """Advance n control steps under constant control: n * substeps
        substeps and the report FK, one K1 launch on CUDA."""
        if overlay is not None:
            raise NotImplementedError(
                "domain-randomization overlays are not ported yet")
        f_applied = torch.cat([control.body_torque, control.body_force], dim=-1)
        q, qd, sf, pos, quat, avel, lvel = fused_step.step(
            self, state.q.contiguous(), state.qd.contiguous(),
            control.effort.contiguous(), control.pos_target.contiguous(),
            control.vel_target.contiguous(), f_applied,
            n * self.params.substeps,
        )
        return State(q=q, qd=qd, body_pos=pos, body_quat=quat,
                     body_lvel=lvel, body_avel=avel, sensor_forces=sf)
