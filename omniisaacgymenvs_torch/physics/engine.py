"""Physics engine: stepping functions bound to a (model, params) pair,
batched over a leading env axis (PyTorch port of the JAX package's
`physics/engine.py`: flat ground or terrain contact planes, pair contacts,
gravity compensation, fixed tendons and per-env domain-randomization
overlays).

The device of the model's tensors picks the path. On CUDA, `step_n` is
one launch of the whole-control-step kernel K1 (with `plane_refresh`, one
launch of a single substep per substep, each on planes sampled from the
launch before) and `_report` (hence `init_state`) one launch of the
report-FK kernel K2 (`ops/fused_step.py`, which also has the single-substep
kernel K3 that no engine path launches), for a model of any size: one past
the one-thread-per-env form's maxima takes the group form, and one whose
working set does not fit a block's shared memory the group form's
device-memory placement (`fused_step.launch_config`). The card never runs
the plain physics. On the CPU both run the plain versions, with the same
plane semantics: terrain planes are sampled from the reported state and
stay frozen over the substeps of one launch.

An overlay is a dict of per-env tensors, (N, size) float32 on the engine's
device, under the keys of `fused_step.OVERLAY_KEYS`: `*_scale` keys
multiply a model constant (neutral 1), `*_delta` keys add to one (neutral
0). Every launch of one `step_n` gets the same overlay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
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
from omniisaacgymenvs_torch.physics import rotations as rot
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
    one beyond the group form's scope (`fused_step.scope_errors`: offsets
    past int32, far beyond any model the JAX kernel steps in memory); the
    kernels take every other model, and there is no plain fallback on the
    card."""
    errs = fused_step.scope_errors(model) if cuda else []
    if errs:
        raise NotImplementedError(f"{model.name}: {'; '.join(errs)}")


class PhysicsEngine:
    """Stepping functions over batched (N, ...) states of one model."""

    def __init__(self, model: Model, params: SimParams,
                 height_fn: Optional[Callable] = None,
                 contact_plane_fn: Optional[Callable] = None,
                 plane_refresh: bool = False):
        """height_fn(x, y) -> (h, n): terrain as a height function.
        contact_plane_fn(pt, radius) -> (n, d): a contact plane per point
        (unit normal n, offset d, penetration radius - (n.pt - d)), which
        can express vertical features a height function cannot; it takes
        precedence over height_fn. Both are batched over the env axis: pt
        is (N, ncp, 3), x and y are (N, ncp).
        plane_refresh: sample the contact_plane_fn planes anew before every
        substep instead of once per `step_n`."""
        check_scope(model, cuda=model.device.type == "cuda")
        self.model = model
        self.params = params
        self.device = model.device
        self.height_fn = height_fn
        self.contact_plane_fn = contact_plane_fn
        self.plane_refresh = bool(plane_refresh)
        self.has_terrain = (height_fn is not None
                            or contact_plane_fn is not None)
        self._cp_body = torch.as_tensor(model.cp_body.astype(np.int64),
                                        device=self.device)
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
        # gravity_comp * mass per body, (nb,); None without compensation
        self._gravcomp_mass = None
        if bool(torch.any(model.gravity_comp != 0)):
            self._gravcomp_mass = model.gravity_comp * model.body_mass
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
    def contact_points(self, state: State) -> torch.Tensor:
        """(N, ncp, 3) world positions of the contact points, from the
        reported body poses."""
        cb = self._cp_body
        R = rot.quat_to_rotmat(state.body_quat[:, cb])
        return state.body_pos[:, cb] + (R @ self.model.cp_pos[..., None])[..., 0]

    def _contact_planes(self, state: State) -> torch.Tensor:
        """(N, ncp, 4) terrain contact plane [unit normal n, offset d] of
        every contact point, penetration radius - (n.pt - d), sampled at the
        contact points of the reported state (body_pos, body_quat). With
        contact_plane_fn the task picks the local feature; with height_fn
        alone the plane is anchored at the sampled height. Zeros when there
        is no terrain (flat ground)."""
        m = self.model
        N = state.q.shape[0]
        if not self.has_terrain or m.ncp == 0:
            return state.q.new_zeros((N, m.ncp, 4))
        pt = self.contact_points(state)
        if self.contact_plane_fn is not None:
            n, d = self.contact_plane_fn(pt, m.cp_radius)
        else:
            h, n = self.height_fn(pt[..., 0], pt[..., 1])
            anchor = torch.stack([pt[..., 0], pt[..., 1], h], dim=-1)
            d = (n * anchor).sum(-1)
        return torch.cat([n, d[..., None]], dim=-1).contiguous()

    def _substep(self, q, qd, control: Control, f_applied, h, planes=None,
                 overlay=None):
        """One plain substep: FK -> contacts -> drives -> ABA -> integrate.
        Returns (q, qd, sensor_forces); sensors read the contact wrench
        [force, torque] of their bodies: ground and pair contacts, without
        applied forces and gravity compensation. `planes` (N, ncp, 4): the
        ground contacts' terrain planes (`_contact_planes`), flat ground
        when None. `overlay`: the per-env randomization overlay (module
        docstring), already checked. Contact gains stay the model's under
        `mass_scale`, and the drive's implicit diagonal stays unscaled under
        `stiffness_scale` / `damping_scale`, as in the kernel."""
        m = self.model
        ov = overlay or {}
        mu_scale, geom_scale = ov.get("friction_scale"), ov.get("geom_scale")
        gravity = self._gravity
        if "gravity_delta" in ov:
            gravity = gravity + ov["gravity_delta"]              # (N, 3)
        kin = dynamics.kinematics(m, q, qd)
        avel, lvel = dynamics.world_velocities(m, kin)
        cres = plane_contacts(m, kin.pw, kin.Rw, avel, lvel,
                              self.contact_params, self.contact_gains,
                              planes=planes, mu_scale=mu_scale,
                              geom_scale=geom_scale)
        f_contact = cres.f_ext
        if self._has_pairs:
            f_contact = f_contact + pair_contacts(
                m, self.pair_groups, kin.pw, kin.Rw, avel, lvel,
                self.contact_params, self.pair_gains, mu_scale=mu_scale,
                geom_scale=geom_scale)
        f_ext = f_contact + f_applied
        if self._gravcomp_mass is not None:
            # counter-gravity at each compensated body's CoM; the product
            # with the folded gravity_comp * mass comes first, the mass
            # scale last, as in the kernel
            fg = -self._gravcomp_mass[:, None] * gravity[..., None, :]
            if "mass_scale" in ov:
                fg = fg * ov["mass_scale"][..., None]
            com_rel = (kin.Rw @ m.body_com[..., None])[..., 0]
            fg = fg.expand_as(com_rel)
            ng = torch.linalg.cross(com_rel, fg, dim=-1)
            f_ext = f_ext + torch.cat([ng, fg], dim=-1)
        tendon = dict(
            tendon_stiffness_scale=ov.get("tendon_stiffness_scale"),
            tendon_damping_scale=ov.get("tendon_damping_scale"))
        tau = dynamics.drive_torques(
            m, q, qd, control, h, stiffness_scale=ov.get("stiffness_scale"),
            damping_scale=ov.get("damping_scale"), **tendon)
        qdd = dynamics.aba(m, q, qd, tau, f_ext, kin, gravity, h,
                           mass_scale=ov.get("mass_scale"), **tendon)
        # limit + delta is rounded once, before the comparison, as the
        # kernel's __fadd_rn does
        lim_lo = lim_hi = None
        if "limit_lower_delta" in ov:
            lim_lo = m.dof_limit_lower + ov["limit_lower_delta"]
        if "limit_upper_delta" in ov:
            lim_hi = m.dof_limit_upper + ov["limit_upper_delta"]
        q, qd = dynamics.integrate(m, q, qd, qdd, h, limit_lower=lim_lo,
                                   limit_upper=lim_hi)
        sb = list(m.sensor_body)
        sensor_forces = torch.cat(
            [f_contact[:, sb, 3:6], f_contact[:, sb, 0:3]], dim=-1
        )
        return q, qd, sensor_forces

    def step_n(self, state: State, control: Control, n: int = 1,
               overlay=None) -> State:
        """Advance n control steps under constant control: n * substeps
        substeps and the report FK. Flat ground, or terrain planes sampled
        once from `state`: one K1 launch on CUDA. With `plane_refresh` and a
        contact_plane_fn: one K1 launch of a single substep per substep,
        each on planes sampled from the state the launch before reported (a
        foot that crosses a stair edge within the control step meets the
        new feature at once). `overlay`: the per-env randomization overlay
        of this step (module docstring), the same for every launch; an
        unknown key, a wrong shape, dtype or device raises."""
        overlay = fused_step.check_overlay(self.model, overlay,
                                           state.q.shape[0], self.device)
        f_applied = torch.cat([control.body_torque, control.body_force], dim=-1)
        ctrl = (control.effort.contiguous(), control.pos_target.contiguous(),
                control.vel_target.contiguous(), f_applied)
        launches = self.k1_launches(n)
        n_steps = n * self.params.substeps // launches
        for _ in range(launches):
            q, qd, sf, pos, quat, avel, lvel = fused_step.step(
                self, state.q.contiguous(), state.qd.contiguous(), *ctrl,
                n_steps,
                planes=self._contact_planes(state) if self.has_terrain else None,
                overlay=overlay,
            )
            state = State(q=q, qd=qd, body_pos=pos, body_quat=quat,
                          body_lvel=lvel, body_avel=avel, sensor_forces=sf)
        return state

    def k1_launches(self, n: int = 1) -> int:
        """How many K1 launches `step_n(state, control, n)` makes."""
        if self.plane_refresh and self.contact_plane_fn is not None:
            return n * self.params.substeps
        return 1
