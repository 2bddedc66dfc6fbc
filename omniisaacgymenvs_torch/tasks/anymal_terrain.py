"""ANYmal rough-terrain locomotion with curriculum (PyTorch port of the JAX
package's `tasks/anymal_terrain.py`).

188-dim obs [base_lin_vel*2, base_ang_vel*0.25, projected_gravity,
commands*scale(3), dof_pos, dof_vel*0.05, 140 height measurements, last
actions] with additive uniform observation noise; PD position targets
0.5 a + q_default through the model's drives (Kp 80, Kd 2, +-80 N m) at
decimation 4 x dt 0.005; a procedural terrain grid with a per-env level and
type and a curriculum that moves the level at every reset; random pushes of
the base every 15 s; termination when the base or a knee comes near the
ground; per-term episode reward sums in the metrics.

The ground is the terrain's height field read as contact planes: per contact
point the nearest local feature (stair tread, vertical riser wall, rounded
step edge), picked by `_contact_plane_fn`, which the engine samples before
every substep (`plane_refresh`) and hands to the step kernel as its `planes`
input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from omniisaacgymenvs_torch.models.anymal import build_anymal
from omniisaacgymenvs_torch.physics import rotations as rot
from omniisaacgymenvs_torch.physics.engine import (
    PhysicsEngine,
    sim_params_from_cfg,
)
from omniisaacgymenvs_torch.tasks.anymal import uniform
from omniisaacgymenvs_torch.tasks.base import EnvState, RLTask
from omniisaacgymenvs_torch.utils.device import resolve_device
from omniisaacgymenvs_torch.utils.terrain import Terrain

_REW_KEYS = (
    "lin_vel_xy", "lin_vel_z", "ang_vel_z", "ang_vel_xy", "orient",
    "torques", "joint_acc", "base_height", "action_rate", "hip",
)

# what `contact_features` calls the feature a contact point resolved to: the
# tread, one of the eight riser walls (four of a higher neighbour at +x, -x,
# +y, -y, then four drop-edge walls), one of the four step edges, or, for a
# secondary foot point, its own-cell tread (on) or parked (off)
TREAD, WALLS, EDGES, WEDGE_ON, WEDGE_OFF = 0, range(1, 9), range(9, 13), 13, 14


def _wrap_to_pi(x):
    return torch.atan2(torch.sin(x), torch.cos(x))


class AnymalTerrainTask(RLTask):
    name = "AnymalTerrain"
    num_obs = 188
    num_states = 0
    num_actions = 12
    num_height_points = 140

    def __init__(self, cfg: dict | None = None, device=None):
        cfg = cfg or {}
        env_cfg = cfg.get("env", {})
        learn = env_cfg.get("learn", {})
        control = env_cfg.get("control", {})
        ranges = env_cfg.get("randomCommandVelocityRanges", {})
        terrain_cfg = env_cfg.get("terrain", {})
        sim_cfg = cfg.get("sim", {})
        dev = resolve_device(device)
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.float32), device=dev)

        self.lin_vel_scale = learn.get("linearVelocityScale", 2.0)
        self.ang_vel_scale = learn.get("angularVelocityScale", 0.25)
        self.dof_pos_scale = learn.get("dofPositionScale", 1.0)
        self.dof_vel_scale = learn.get("dofVelocityScale", 0.05)
        self.height_meas_scale = learn.get("heightMeasurementScale", 5.0)
        self.action_scale = control.get("actionScale", 0.5)
        self.Kp = control.get("stiffness", 80.0)
        self.Kd = control.get("damping", 2.0)
        self.decimation = control.get("decimation", 4)
        self.sim_dt = sim_cfg.get("dt", 0.005)
        self.dt = self.decimation * self.sim_dt
        self.max_episode_length_s = learn.get("episodeLength_s", 20.0)
        self.max_episode_length = int(self.max_episode_length_s / self.dt + 0.5)
        self.push_interval = int(learn.get("pushInterval_s", 15.0) / self.dt + 0.5)
        self.base_threshold = 0.2
        self.knee_threshold = 0.1
        self.command_x_range = ranges.get("linear_x", (-1.0, 1.0))
        self.command_y_range = ranges.get("linear_y", (-1.0, 1.0))
        self.command_yaw_range = ranges.get("yaw", (-3.14, 3.14))
        self.clip_obs = env_cfg.get("clipObservations", 5.0)
        self.clip_actions = env_cfg.get("clipActions", 1.0)
        self.add_noise = learn.get("addNoise", True)
        nl = learn.get("noiseLevel", 1.0)
        noise_vec = np.zeros(188, np.float32)
        noise_vec[0:3] = learn.get("linearVelocityNoise", 0.1) * nl * self.lin_vel_scale
        noise_vec[3:6] = learn.get("angularVelocityNoise", 0.2) * nl * self.ang_vel_scale
        noise_vec[6:9] = learn.get("gravityNoise", 0.05) * nl
        noise_vec[12:24] = learn.get("dofPositionNoise", 0.01) * nl * self.dof_pos_scale
        noise_vec[24:36] = learn.get("dofVelocityNoise", 1.5) * nl * self.dof_vel_scale
        noise_vec[36:176] = learn.get("heightMeasurementNoise", 0.06) * nl * self.height_meas_scale
        self.noise_vec = f32(noise_vec)

        self.rew_scales = {
            "termination": learn.get("terminalReward", 0.0),
            "lin_vel_xy": learn.get("linearVelocityXYRewardScale", 1.0),
            "lin_vel_z": learn.get("linearVelocityZRewardScale", -4.0),
            "ang_vel_z": learn.get("angularVelocityZRewardScale", 0.5),
            "ang_vel_xy": learn.get("angularVelocityXYRewardScale", -0.05),
            "orient": learn.get("orientationRewardScale", -0.0),
            "torques": learn.get("torqueRewardScale", -0.00002),
            "joint_acc": learn.get("jointAccRewardScale", -0.0005),
            "base_height": learn.get("baseHeightRewardScale", -0.0),
            "action_rate": learn.get("actionRateRewardScale", -0.01),
            "hip": learn.get("hipRewardScale", -0.0),
            "fallen_over": learn.get("fallenOverRewardScale", -1.0),
        }
        for k in self.rew_scales:
            if k != "termination":
                self.rew_scales[k] *= self.dt

        # ---- terrain: the tables live on the device once per task ----
        self.terrain = Terrain(terrain_cfg, seed=terrain_cfg.get("seed", 7))
        self.curriculum = self.terrain.curriculum
        self.max_init_level = (
            terrain_cfg.get("maxInitMapLevel", 0)
            if self.curriculum else self.terrain.env_rows - 1
        )
        hf = (self.terrain.height_field_raw.astype(np.float32)
              * np.float32(self.terrain.vertical_scale))
        self._hf = f32(hf)
        # min of the cell's own and its diagonal neighbour's height, so a
        # height sample is one gather
        self._hf_min = f32(np.minimum(hf[:-1, :-1], hf[1:, 1:]).ravel())
        self._hf_rows, self._hf_cols = hf.shape[0] - 1, hf.shape[1] - 1
        # Packed per-cell contact table [h, h+gx*hs, h+gy*hs, hxp, hxn, hyp,
        # hyn], one 7-wide gather per contact point: the raw cell height
        # with a slope-limited gradient (where the cell-to-cell step exceeds
        # slopeTreshold * hs the tread is flat at the sampled height, as a
        # trimesh with wall-corrected faces would be; gentler slopes keep
        # their gradient) and the raw heights of the four neighbours for the
        # riser walls.
        hf_raw = hf[:-1, :-1]
        dxs = np.concatenate([hf_raw[1:], hf_raw[-1:]], axis=0) - hf_raw
        dys = np.concatenate([hf_raw[:, 1:], hf_raw[:, -1:]], axis=1) - hf_raw
        slope_lim = (terrain_cfg.get("slopeTreshold", 0.5)
                     * self.terrain.horizontal_scale)
        lim32 = np.float32(slope_lim)
        dxs_t = np.where(np.abs(dxs) > lim32, np.float32(0.0), dxs)
        dys_t = np.where(np.abs(dys) > lim32, np.float32(0.0), dys)
        hxp = np.concatenate([hf_raw[1:], hf_raw[-1:]], axis=0)
        hxn = np.concatenate([hf_raw[:1], hf_raw[:-1]], axis=0)
        hyp = np.concatenate([hf_raw[:, 1:], hf_raw[:, -1:]], axis=1)
        hyn = np.concatenate([hf_raw[:, :1], hf_raw[:, :-1]], axis=1)
        self._hf_pack = f32(np.stack(
            [hf_raw, hf_raw + dxs_t, hf_raw + dys_t, hxp, hxn, hyp, hyn],
            axis=-1,
        ).reshape(-1, 7))
        self._slope_lim_h = slope_lim
        # vertical riser faces with rounded step edges (on by default)
        self._riser_walls = bool(terrain_cfg.get("riserWalls", True))
        # wall-top grazing margin in metres; None / 'auto': the point's
        # contact radius
        wm = terrain_cfg.get("riserWallMargin", None)
        self._wall_margin = None if wm in (None, "auto") else float(wm)
        # planes sampled anew before every substep; follows riserWalls
        self._plane_refresh = bool(
            terrain_cfg.get("planeRefresh", self._riser_walls))
        # a second contact point per foot, routed to the own-cell tread while
        # the first is on a riser feature; follows riserWalls
        self._foot_wedge = bool(
            terrain_cfg.get("footWedgeContacts", self._riser_walls))
        self._hs = self.terrain.horizontal_scale
        # as a device tensor: a division by it is then a true division on
        # every device (by a Python scalar the card multiplies with the
        # reciprocal, which can move a point across a cell boundary)
        self._hs_t = torch.tensor(self._hs, dtype=torch.float32, device=dev)
        self._border = self.terrain.border_size
        self._origins = f32(self.terrain.env_origins)

        # the PD law tau = clip(Kp (targets - q) - Kd qd, +-80) is authored
        # as the model's joint drives, which the engine evaluates at every
        # substep
        self.model = build_anymal(
            spawn_height=0.62,
            drive=dict(stiffness=self.Kp, drive_damping=self.Kd,
                       max_effort=80.0),
            dual_foot_contacts=self._foot_wedge,
            device=dev,
        )
        ncp = self.model.ncp
        # the secondary foot points are the last four contact points
        self._secondary_mask = None
        if self._foot_wedge:
            self._secondary_mask = torch.zeros(ncp, dtype=torch.bool, device=dev)
            self._secondary_mask[ncp - 4:] = True
        self.engine = PhysicsEngine(
            self.model,
            sim_params_from_cfg(
                dict(sim_cfg, dt=self.sim_dt), substeps=1,
                gravity=(0.0, 0.0, -9.81),
            ),
            contact_plane_fn=self._contact_plane_fn,
            plane_refresh=self._plane_refresh,
        )
        self.default_dof_pos = self.model.default_q[self.model.jq0:]
        self._jq = torch.as_tensor(self.model.jq_idx.astype(np.int64), device=dev)
        self._jv = torch.as_tensor(self.model.jv_idx.astype(np.int64), device=dev)
        self._knee_bodies = torch.as_tensor(
            [self.model.body_index(f"{leg}_KFE")
             for leg in ("LF", "LH", "RF", "RH")], device=dev)
        # 14 x 10 height-scan grid about the base
        y = 0.1 * np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5])
        x = 0.1 * np.array([-8, -7, -6, -5, -4, -3, -2, 2, 3, 4, 5, 6, 7, 8])
        gx, gy = np.meshgrid(x, y, indexing="ij")
        self._height_points = f32(
            np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1))
        self._gravity_dir = torch.tensor([0.0, 0.0, -1.0], device=dev)
        self._forward = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self._yaw_only = torch.tensor([1.0, 0.0, 0.0, 1.0], device=dev)
        self._cmd_scale = torch.tensor(
            [self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale],
            device=dev)

    # ------------------------------------------------------------------
    def _cell(self, x, y):
        """Flat index of the height-field cell under (x, y): the coordinate
        truncated toward zero, then clipped to the table."""
        px = ((x + self._border) / self._hs_t).to(torch.int64).clamp(
            0, self._hf_rows - 1)
        py = ((y + self._border) / self._hs_t).to(torch.int64).clamp(
            0, self._hf_cols - 1)
        return px, py, px * self._hf_cols + py

    def _sample_height(self, x, y):
        """Min-of-two-samples height-field lookup."""
        return self._hf_min[self._cell(x, y)[2]]

    def tread_height(self, x, y):
        """Height of the cell under (x, y): where its tread plane sits."""
        return self._hf_pack[self._cell(x, y)[2], 0]

    def _contact_plane_fn(self, pt, radius):
        """Contact plane (n, d) of the nearest local feature per point
        (..., 3): the stair tread (the cell's slope-limited plane), a
        vertical riser wall at a cell boundary whose neighbour differs by
        more than slopeTreshold * hs, or the rounded step edge along a
        riser's top. Among the tread and the riser candidates the active
        feature with the smallest positive penetration wins (the nearest
        surface of the solid)."""
        n, d, _ = self._select_feature(pt, radius, want_kind=False)
        return n, d

    def contact_features(self, pt, radius):
        """(n, d, kind): the planes of `_contact_plane_fn` and which feature
        each point resolved to (TREAD, one of WALLS, one of EDGES; a
        secondary foot point: WEDGE_ON on its own-cell tread, WEDGE_OFF when
        parked)."""
        return self._select_feature(pt, radius, want_kind=True)

    def _select_feature(self, pt, radius, want_kind: bool):
        x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
        px, py, cell = self._cell(x, y)
        vals = self._hf_pack[cell]
        h, hx, hy = vals[..., 0], vals[..., 1], vals[..., 2]
        hxp, hxn, hyp, hyn = (vals[..., 3], vals[..., 4],
                              vals[..., 5], vals[..., 6])
        # tread plane anchored at (x, y, h) with the slope-limited gradient
        n_t = torch.stack(
            [-(hx - h) / self._hs_t, -(hy - h) / self._hs_t,
             torch.ones_like(h)], dim=-1)
        n_t = n_t / torch.linalg.norm(n_t, dim=-1, keepdim=True)
        d_t = n_t[..., 0] * x + n_t[..., 1] * y + n_t[..., 2] * h
        pen_tread = radius - ((pt * n_t).sum(-1) - d_t)

        lim = self._slope_lim_h
        bx1 = (px + 1).to(h.dtype) * self._hs - self._border
        bx0 = px.to(h.dtype) * self._hs - self._border
        by1 = (py + 1).to(h.dtype) * self._hs - self._border
        by0 = py.to(h.dtype) * self._hs - self._border
        zero = torch.zeros_like(h)
        one = torch.ones_like(h)

        best_pen, best_n, best_d = pen_tread, n_t, d_t
        is_tread = torch.ones_like(h, dtype=torch.bool)
        kind = torch.zeros_like(px) if want_kind else None

        def fold(pen, n, d, act, what):
            nonlocal best_pen, best_n, best_d, is_tread, kind
            sel = act & (pen > 0.0) & ((pen < best_pen) | (best_pen <= 0.0))
            best_pen = torch.where(sel, pen, best_pen)
            best_n = torch.where(sel[..., None], n, best_n)
            best_d = torch.where(sel, d, best_d)
            is_tread = is_tread & ~sel   # every folded candidate is a riser feature
            if want_kind:
                kind = torch.where(sel, torch.full_like(kind, what), kind)

        # Within `mg` of a riser's top the contact resolves to the step
        # edge (a rounded corner), not to the wall face: a foot set on the
        # very edge gets support instead of a push straight back. Default
        # margin: the contact radius, the capture range of a sphere on the
        # corner.
        mg = (radius if self._wall_margin is None
              else torch.full_like(h, self._wall_margin))
        if self._riser_walls:
            # (boundary coordinate, wall normal, is a wall, in its span)
            walls = [
                # walls of a higher neighbour push back toward the own (low)
                # cell, active below the neighbour's tread less the margin
                (bx1, (-one, zero, zero), hxp - h > lim, z < hxp - mg),
                (bx0, (one, zero, zero), hxn - h > lim, z < hxn - mg),
                (by1, (zero, -one, zero), hyp - h > lim, z < hyp - mg),
                (by0, (zero, one, zero), hyn - h > lim, z < hyn - mg),
                # drop-edge walls: a point under its own tread next to a
                # lower neighbour crossed the riser from the low side and is
                # pushed back out toward it
                (bx1, (one, zero, zero), h - hxp > lim, (z < h) & (z > hxp)),
                (bx0, (-one, zero, zero), h - hxn > lim, (z < h) & (z > hxn)),
                (by1, (zero, one, zero), h - hyp > lim, (z < h) & (z > hyp)),
                (by0, (zero, -one, zero), h - hyn > lim, (z < h) & (z > hyn)),
            ]
            for what, (b, nw, is_wall, in_span) in zip(WALLS, walls):
                n = torch.stack(nw, dim=-1)
                # plane n . p = d with d = +-b along the wall's axis
                d = n[..., 0] * b + n[..., 1] * b  # one term is zero
                pen = radius - ((pt * n).sum(-1) - d)
                fold(pen, n, d, is_wall & in_span, what)
            # step edges: a sphere against the horizontal edge along the
            # riser's top, active in the band z > h_neighbour - mg; the
            # normal tilts from horizontal (low on the face) to vertical (on
            # the tread), as at a trimesh corner
            edges = [
                (hxp, bx1, x, 0, hxp - h > lim),
                (hxn, bx0, x, 0, hxn - h > lim),
                (hyp, by1, y, 1, hyp - h > lim),
                (hyn, by0, y, 1, hyn - h > lim),
            ]
            for what, (hn, b, coord, axis, is_wall) in zip(EDGES, edges):
                dc = coord - b            # horizontal offset from the edge line
                dz = z - hn               # vertical offset from the riser's top
                dist = torch.sqrt(dc * dc + dz * dz).clamp(min=1e-6)
                nc = dc / dist
                nz = dz / dist
                n = torch.stack(
                    [nc, zero, nz] if axis == 0 else [zero, nc, nz], dim=-1)
                d = n[..., axis] * b + n[..., 2] * hn
                fold(radius - dist, n, d, is_wall & (z > hn - mg), what)
        n, d = best_n, best_d
        if (self._secondary_mask is not None
                and d.shape[-1] == self._secondary_mask.shape[0]):
            # (the shape guard lets a caller probe other point sets; the
            # engine always passes the model's contact points)
            # Secondary (wedge) foot points: support from the own-cell tread
            # while the primary is on a riser feature, the two-plane
            # manifold of a step corner. The gate pen_tread <= 2 radius
            # keeps out a foot that just crossed into the high cell and sees
            # its "own" tread a step height above; a true wedge overlaps the
            # tread by about the radius at most.
            sec_ok = (~is_tread) & (pen_tread <= 2.0 * radius)
            d_far = (pt * n_t).sum(-1) - radius - 1.0
            d_sec = torch.where(sec_ok, d_t, d_far)
            m2 = self._secondary_mask
            n = torch.where(m2[..., None], n_t, n)
            d = torch.where(m2, d_sec, d)
            if want_kind:
                wedge = torch.where(sec_ok, torch.full_like(kind, WEDGE_ON),
                                    torch.full_like(kind, WEDGE_OFF))
                kind = torch.where(m2, wedge, kind)
        return n, d, kind

    # ------------------------------------------------------------------
    def initial_carry(self, n: int):
        dev = self.device
        z = lambda *s: torch.zeros((n,) + s, device=dev)  # noqa: E731
        zi = lambda: torch.zeros(n, dtype=torch.int32, device=dev)  # noqa: E731
        return dict(
            commands=z(4),        # x, y, yaw rate (computed), yaw target
            last_actions=z(12),
            last_dof_vel=z(12),
            torques=z(12),
            targets=self.default_dof_pos.expand(n, -1).clone(),
            # this step's observation noise, drawn where a generator is at
            # hand (reset, pre_physics) so that `observe` stays pure
            obs_noise=z(self.num_obs),
            level=zi(),
            ttype=zi(),
            origin=z(3),
            episode_sums={k: z() for k in _REW_KEYS},
        )

    def initial_metrics(self, n: int):
        m = {"episode/rew_" + k: torch.zeros(n, device=self.device)
             for k in _REW_KEYS}
        m["episode/terrain_level"] = torch.zeros(n, device=self.device)
        return m

    def _sample_commands(self, n: int, generator):
        dev = self.device
        cx = uniform(generator, (n,), *self.command_x_range, dev)
        cy = uniform(generator, (n,), *self.command_y_range, dev)
        cyaw = uniform(generator, (n,), *self.command_yaw_range, dev)
        keep = (torch.linalg.norm(torch.stack([cx, cy], dim=-1), dim=-1)
                > 0.25).to(cx.dtype)
        return torch.stack([cx * keep, cy * keep, torch.zeros_like(cx), cyaw],
                           dim=-1)

    def _draw_noise(self, n: int, generator):
        return uniform(generator, (n, self.num_obs), -1.0, 1.0,
                       self.device) * self.noise_vec

    def _reset_at(self, generator, level, ttype):
        """(q, qd, carry) of episodes that start on terrain (level, ttype)."""
        m = self.model
        n = level.shape[0]
        origin = self._origins[level.long(), ttype.long()]
        offset = uniform(generator, (n, 2), -0.5, 0.5, self.device)
        q = m.default_q.expand(n, -1).clone()
        q[:, 0:2] = origin[:, 0:2] + offset
        q[:, 2] = origin[:, 2] + 0.62
        qd = torch.zeros((n, m.nv), device=self.device)
        carry = self.initial_carry(n)
        carry["commands"] = self._sample_commands(n, generator)
        if self.add_noise:
            carry["obs_noise"] = self._draw_noise(n, generator)
        carry["level"] = level
        carry["ttype"] = ttype
        carry["origin"] = origin
        return q, qd, carry

    def sample_reset(self, n: int, generator: torch.Generator):
        dev = self.device
        level = torch.randint(0, self.max_init_level + 1, (n,),
                              generator=generator, device=dev,
                              dtype=torch.int32)
        ttype = torch.randint(0, self.terrain.env_cols, (n,),
                              generator=generator, device=dev,
                              dtype=torch.int32)
        return self._reset_at(generator, level, ttype)

    # -- hooks of the base step ----------------------------------------
    def resample_reset(self, es: EnvState, generator) -> EnvState:
        """Respawn under the curriculum: the distance walked against the
        command promotes or demotes the terrain level; the terrain column
        is kept."""
        carry = es.carry
        distance = torch.linalg.norm(
            es.phys.q[:, 0:2] - carry["origin"][:, 0:2], dim=-1)
        cmd_norm = torch.linalg.norm(carry["commands"][:, 0:2], dim=-1)
        level = carry["level"]
        if self.curriculum:
            level = level - (
                distance < cmd_norm * self.max_episode_length_s * 0.25
            ).to(torch.int32)
            level = level + (
                distance > self.terrain.env_length / 2).to(torch.int32)
            level = torch.clamp(level, min=0) % self.terrain.env_rows
        return self.fresh_state(*self._reset_at(generator, level,
                                                carry["ttype"]), generator)

    def pre_physics(self, es: EnvState, generator) -> EnvState:
        """Random pushes of the base every push_interval steps, and this
        step's observation noise."""
        n = es.done.shape[0]
        push = (es.progress % self.push_interval) == (self.push_interval - 1)
        quat = es.phys.q[:, 3:7]
        v_world = rot.quat_rotate(quat, es.phys.qd[:, 3:6])
        push_v = uniform(generator, (n, 2), -1.0, 1.0, self.device)
        v_world = torch.cat(
            [torch.where(push[:, None], push_v, v_world[:, 0:2]),
             v_world[:, 2:3]], dim=-1)
        qd = es.phys.qd.clone()
        qd[:, 3:6] = rot.quat_rotate_inverse(quat, v_world)
        if self.add_noise:
            es.carry["obs_noise"] = self._draw_noise(n, generator)
        return dataclasses.replace(
            es, phys=dataclasses.replace(es.phys, qd=qd))

    def control(self, action, es: EnvState, generator=None):
        """Position targets for the model's PD drives."""
        targets = self.action_scale * action + self.default_dof_pos
        es.carry["targets"] = targets
        ctrl = self.engine.default_control(action.shape[0])
        ctrl.pos_target = targets
        return ctrl

    # ------------------------------------------------------------------
    def _base_frame(self, phys):
        """Base linear and angular velocity and the gravity direction in
        the base frame."""
        quat = phys.q[:, 3:7]
        return (rot.quat_rotate_inverse(quat, phys.body_lvel[:, 0]),
                rot.quat_rotate_inverse(quat, phys.body_avel[:, 0]),
                rot.quat_rotate_inverse(quat, self._gravity_dir))

    def observe(self, phys, carry, action):
        quat = phys.q[:, 3:7]
        base_lin_vel, base_ang_vel, projected_gravity = self._base_frame(phys)
        dof_pos = phys.q[:, self._jq]
        dof_vel = phys.qd[:, self._jv]
        # yaw command from the heading of the pose after the step
        forward = rot.quat_rotate(quat, self._forward)
        heading = torch.atan2(forward[:, 1], forward[:, 0])
        cmds = carry["commands"].clone()
        cmds[:, 2] = torch.clamp(
            0.5 * _wrap_to_pi(cmds[:, 3] - heading), -1.0, 1.0)
        # the PD torque at the state after the step feeds the torque penalty
        h = self.sim_dt / self.engine.params.substeps
        torques = torch.clamp(
            self.Kp * (carry["targets"] - dof_pos - h * dof_vel)
            - self.Kd * dof_vel,
            -80.0, 80.0,
        )
        carry = dict(carry, commands=cmds, torques=torques)
        # the scan grid turns with the base's yaw only
        qy = rot.quat_normalize(quat * self._yaw_only)
        pts = rot.quat_rotate(qy[:, None, :], self._height_points) \
            + phys.q[:, None, 0:3]
        measured = self._sample_height(pts[..., 0], pts[..., 1])
        heights = (
            torch.clamp(phys.q[:, 2:3] - 0.5 - measured, -1.0, 1.0)
            * self.height_meas_scale
        )
        obs = torch.cat(
            [
                base_lin_vel * self.lin_vel_scale,
                base_ang_vel * self.ang_vel_scale,
                projected_gravity,
                cmds[:, 0:3] * self._cmd_scale,
                dof_pos * self.dof_pos_scale,
                dof_vel * self.dof_vel_scale,
                heights,
                action,
            ],
            dim=-1,
        )
        if self.add_noise:
            obs = obs + carry["obs_noise"]
        return obs, obs.new_zeros((obs.shape[0], 0)), carry

    def reward_done(self, obs, action, phys, carry, progress):
        base_lin_vel, base_ang_vel, projected_gravity = self._base_frame(phys)
        dof_pos = phys.q[:, self._jq]
        dof_vel = phys.qd[:, self._jv]
        cmds = carry["commands"]
        sq = torch.square

        # termination: the base or a knee near the ground
        ground_base = self._sample_height(phys.q[:, 0], phys.q[:, 1])
        base_fallen = (phys.q[:, 2] - ground_base) < self.base_threshold
        knee_pos = phys.body_pos[:, self._knee_bodies]
        ground_knee = self._sample_height(knee_pos[..., 0], knee_pos[..., 1])
        knees_fallen = torch.any(
            (knee_pos[..., 2] - ground_knee) < self.knee_threshold, dim=-1)
        has_fallen = base_fallen | knees_fallen
        timeout = progress >= self.max_episode_length - 1
        done = has_fallen | timeout

        rs = self.rew_scales
        lin_vel_error = torch.sum(sq(cmds[:, 0:2] - base_lin_vel[:, 0:2]), dim=-1)
        ang_vel_error = sq(cmds[:, 2] - base_ang_vel[:, 2])
        terms = {
            "lin_vel_xy": torch.exp(-lin_vel_error / 0.25) * rs["lin_vel_xy"],
            "ang_vel_z": torch.exp(-ang_vel_error / 0.25) * rs["ang_vel_z"],
            "lin_vel_z": sq(base_lin_vel[:, 2]) * rs["lin_vel_z"],
            "ang_vel_xy": torch.sum(sq(base_ang_vel[:, 0:2]), dim=-1) * rs["ang_vel_xy"],
            "orient": torch.sum(sq(projected_gravity[:, 0:2]), dim=-1) * rs["orient"],
            "base_height": sq(phys.q[:, 2] - 0.52) * rs["base_height"],
            "torques": torch.sum(sq(carry["torques"]), dim=-1) * rs["torques"],
            "joint_acc": torch.sum(sq(carry["last_dof_vel"] - dof_vel), dim=-1) * rs["joint_acc"],
            "action_rate": torch.sum(sq(carry["last_actions"] - action), dim=-1) * rs["action_rate"],
            "hip": torch.sum(torch.abs(dof_pos[:, 0:4] - self.default_dof_pos[0:4]), dim=-1) * rs["hip"],
        }
        reward = torch.clamp(sum(terms.values()), min=0.0)
        reward = reward + has_fallen * rs["fallen_over"] * self.dt
        reward = reward + rs["termination"] * (done & ~timeout)

        sums = {k: carry["episode_sums"][k] + terms[k] for k in _REW_KEYS}
        carry = dict(carry, last_actions=action, last_dof_vel=dof_vel,
                     episode_sums=sums)
        metrics = {"episode/rew_" + k: sums[k] / self.max_episode_length_s
                   for k in _REW_KEYS}
        metrics["episode/terrain_level"] = carry["level"].to(torch.float32)
        return reward, done, carry, metrics
