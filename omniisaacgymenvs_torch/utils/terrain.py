"""Procedural heightfield terrain generation (numpy, build-time).

Reference: utils/terrain_utils/terrain_utils.py (int16 heightfield
generators: uniform noise, slopes, pyramid slopes/stairs, discrete
obstacles, waves, stepping stones — :40-299) and
tasks/utils/anymal_terrain_generator.py (Terrain class tiling a
levels x types curriculum grid with per-cell difficulty scaling and env
origins — :68-163). Same semantics, re-implemented; the heightfield feeds
the terrain task's contact planes instead of a USD trimesh. Pure numpy: the
same `np.random.default_rng(seed)` draws in the same order as the JAX
package's `utils/terrain.py`, so both build the same grid bit for bit.
"""

from __future__ import annotations

import numpy as np


class SubTerrain:
    """reference terrain_utils.py:387-394."""

    def __init__(self, width, length, vertical_scale, horizontal_scale):
        self.width = width
        self.length = length
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.height_field_raw = np.zeros((width, length), dtype=np.int16)


def random_uniform_terrain(terrain, min_height, max_height, step=0.005,
                           downsampled_scale=None, rng=None):
    """reference terrain_utils.py:40-74."""
    rng = rng or np.random.default_rng()
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    hmin = int(min_height / terrain.vertical_scale)
    hmax = int(max_height / terrain.vertical_scale)
    hstep = max(int(step / terrain.vertical_scale), 1)
    rows = int(terrain.width * terrain.horizontal_scale / downsampled_scale)
    cols = int(terrain.length * terrain.horizontal_scale / downsampled_scale)
    heights = rng.choice(
        np.arange(hmin, hmax + hstep, hstep), (max(rows, 2), max(cols, 2))
    )
    # bilinear upsample to the full grid
    x = np.linspace(0, heights.shape[0] - 1, terrain.width)
    y = np.linspace(0, heights.shape[1] - 1, terrain.length)
    x0 = np.clip(x.astype(int), 0, heights.shape[0] - 2)
    y0 = np.clip(y.astype(int), 0, heights.shape[1] - 2)
    fx = (x - x0)[:, None]
    fy = (y - y0)[None, :]
    h = (
        heights[x0][:, y0] * (1 - fx) * (1 - fy)
        + heights[x0 + 1][:, y0] * fx * (1 - fy)
        + heights[x0][:, y0 + 1] * (1 - fx) * fy
        + heights[x0 + 1][:, y0 + 1] * fx * fy
    )
    terrain.height_field_raw += h.astype(np.int16)
    return terrain


def sloped_terrain(terrain, slope):
    """reference terrain_utils.py:76-93."""
    x = np.arange(terrain.width)
    max_h = int(
        slope * terrain.horizontal_scale / terrain.vertical_scale
        * terrain.width
    )
    terrain.height_field_raw += (
        (max_h * x / terrain.width)[:, None]
    ).astype(np.int16)
    return terrain


def pyramid_sloped_terrain(terrain, slope, platform_size=1.0):
    """reference terrain_utils.py:95-127."""
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width // 2, terrain.length // 2
    xx = (cx - np.abs(cx - x))[:, None] / cx
    yy = (cy - np.abs(cy - y))[None, :] / cy
    max_h = int(
        slope * (terrain.horizontal_scale / terrain.vertical_scale)
        * (terrain.width / 2)
    )
    hf = (max_h * xx * yy).astype(np.int16)
    # clip at the central platform
    platform = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = cx - platform, cx + platform
    min_h = min(hf[x1, x1], 0)
    max_hh = max(hf[x1, x1], 0)
    terrain.height_field_raw += np.clip(hf, min_h, max_hh).astype(np.int16)
    return terrain


def discrete_obstacles_terrain(terrain, max_height, min_size, max_size,
                               num_rects, platform_size=1.0, rng=None):
    """reference terrain_utils.py:129-166."""
    rng = rng or np.random.default_rng()
    max_h = int(max_height / terrain.vertical_scale)
    heights = [-max_h, -max_h // 2, max_h // 2, max_h]
    for _ in range(num_rects):
        w = rng.integers(
            int(min_size / terrain.horizontal_scale),
            int(max_size / terrain.horizontal_scale) + 1,
        )
        l = rng.integers(
            int(min_size / terrain.horizontal_scale),
            int(max_size / terrain.horizontal_scale) + 1,
        )
        sx = rng.integers(0, max(terrain.width - w, 1))
        sy = rng.integers(0, max(terrain.length - l, 1))
        terrain.height_field_raw[sx : sx + w, sy : sy + l] = rng.choice(heights)
    # clear the central platform
    p = int(platform_size / terrain.horizontal_scale / 2)
    cx, cy = terrain.width // 2, terrain.length // 2
    terrain.height_field_raw[cx - p : cx + p, cy - p : cy + p] = 0
    return terrain


def wave_terrain(terrain, num_waves=1, amplitude=1.0):
    """reference terrain_utils.py:168-195."""
    amp = int(0.5 * amplitude / terrain.vertical_scale)
    if num_waves > 0:
        div = terrain.length / (num_waves * 2 * np.pi)
        x = np.arange(terrain.width)
        y = np.arange(terrain.length)
        terrain.height_field_raw += (
            amp * np.cos(y[None, :] / div) + amp * np.sin(x[:, None] / div)
        ).astype(np.int16)
    return terrain


def stairs_terrain(terrain, step_width, step_height):
    """reference terrain_utils.py:197-210."""
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    h = 0
    for i in range(0, terrain.width, sw):
        terrain.height_field_raw[i : i + sw, :] += h
        h += sh
    return terrain


def pyramid_stairs_terrain(terrain, step_width, step_height, platform_size=1.0):
    """reference terrain_utils.py:212-241."""
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    platform = int(platform_size / terrain.horizontal_scale)
    h = 0
    sx, sy = 0, 0
    ex, ey = terrain.width, terrain.length
    while (ex - sx) > platform and (ey - sy) > platform:
        sx += sw
        sy += sw
        ex -= sw
        ey -= sw
        h += sh
        terrain.height_field_raw[sx:ex, sy:ey] = h
    return terrain


def stepping_stones_terrain(terrain, stone_size, stone_distance, max_height,
                            platform_size=1.0, depth=-10.0, rng=None):
    """reference terrain_utils.py:243-299."""
    rng = rng or np.random.default_rng()
    ss = max(int(stone_size / terrain.horizontal_scale), 1)
    sd = int(stone_distance / terrain.horizontal_scale)
    mh = int(max_height / terrain.vertical_scale)
    terrain.height_field_raw[:] = int(depth / terrain.vertical_scale)
    sy = 0
    while sy < terrain.length:
        sx = int(rng.integers(0, ss + sd))
        # fill a row of stones
        terrain.height_field_raw[: max(sx - sd, 0), sy : sy + ss] = rng.integers(-mh, mh + 1)
        while sx < terrain.width:
            terrain.height_field_raw[sx : sx + ss, sy : sy + ss] = rng.integers(-mh, mh + 1)
            sx += ss + sd
        sy += ss + sd
    p = int(platform_size / terrain.horizontal_scale / 2)
    cx, cy = terrain.width // 2, terrain.length // 2
    terrain.height_field_raw[cx - p : cx + p, cy - p : cy + p] = 0
    return terrain


class Terrain:
    """Curriculum terrain grid (reference anymal_terrain_generator.py).

    rows = difficulty levels, cols = terrain types; cell (i, j) generated at
    difficulty i/num_levels with type selected by `terrainProportions`.
    """

    def __init__(self, cfg: dict, num_robots: int = 1, seed: int = 7):
        rng = np.random.default_rng(seed)
        self.horizontal_scale = cfg.get("horizontalScale", 0.1)
        self.vertical_scale = cfg.get("verticalScale", 0.005)
        self.border_size = cfg.get("borderSize", 20.0)
        self.env_length = cfg.get("mapLength", 8.0)
        self.env_width = cfg.get("mapWidth", 8.0)
        self.env_rows = cfg.get("numLevels", 10)
        self.env_cols = cfg.get("numTerrains", 20)
        self.proportions = np.cumsum(
            cfg.get("terrainProportions", [0.1, 0.1, 0.35, 0.25, 0.2])
        )
        self.curriculum = cfg.get("curriculum", True)

        self.width_px = int(self.env_width / self.horizontal_scale)
        self.length_px = int(self.env_length / self.horizontal_scale)
        self.border_px = int(self.border_size / self.horizontal_scale)
        self.tot_rows = self.env_rows * self.width_px + 2 * self.border_px
        self.tot_cols = self.env_cols * self.length_px + 2 * self.border_px
        self.height_field_raw = np.zeros(
            (self.tot_rows, self.tot_cols), dtype=np.int16
        )
        self.env_origins = np.zeros((self.env_rows, self.env_cols, 3))

        for i in range(self.env_rows):
            for j in range(self.env_cols):
                terrain = SubTerrain(
                    self.width_px, self.length_px,
                    self.vertical_scale, self.horizontal_scale,
                )
                difficulty = i / max(self.env_rows, 1)
                choice = j / self.env_cols + 0.001
                self._fill(terrain, choice, difficulty, rng)
                sx = self.border_px + i * self.width_px
                sy = self.border_px + j * self.length_px
                self.height_field_raw[
                    sx : sx + self.width_px, sy : sy + self.length_px
                ] = terrain.height_field_raw
                # env origin at cell center, z = max height near center
                cx, cy = self.width_px // 2, self.length_px // 2
                x1, x2 = cx - 10, cx + 10
                y1, y2 = cy - 10, cy + 10
                env_origin_z = (
                    terrain.height_field_raw[x1:x2, y1:y2].max()
                    * self.vertical_scale
                )
                self.env_origins[i, j] = [
                    (i + 0.5) * self.env_width,
                    (j + 0.5) * self.env_length,
                    env_origin_z,
                ]

    def _fill(self, terrain, choice, difficulty, rng):
        """reference anymal_terrain_generator.py curiculum():109-163."""
        slope = difficulty * 0.4
        step_height = 0.05 + 0.175 * difficulty
        obstacle_height = 0.025 + difficulty * 0.15
        stepping_stones_size = 2.0 - 1.8 * difficulty
        p = self.proportions
        if choice < p[0]:
            if choice < p[0] / 2:
                slope *= -1
            pyramid_sloped_terrain(terrain, slope=slope, platform_size=3.0)
        elif choice < p[1]:
            pyramid_sloped_terrain(terrain, slope=slope, platform_size=3.0)
            random_uniform_terrain(
                terrain, min_height=-0.1, max_height=0.1, step=0.025,
                downsampled_scale=0.2, rng=rng,
            )
        elif choice < p[3]:
            if choice < p[2]:
                step_height *= -1
            pyramid_stairs_terrain(
                terrain, step_width=0.31, step_height=step_height,
                platform_size=3.0,
            )
        elif choice < p[4]:
            discrete_obstacles_terrain(
                terrain, obstacle_height, 1.0, 2.0, 40, platform_size=3.0,
                rng=rng,
            )
        else:
            stepping_stones_terrain(
                terrain, stone_size=stepping_stones_size,
                stone_distance=0.1, max_height=0.0, platform_size=4.0,
                rng=rng,
            )

    @property
    def heightsamples(self):
        return self.height_field_raw
