"""Build-time (numpy) helpers: composite body inertias from primitive geoms.

The reference's robots carry authored USD mass properties; here bodies are
built from primitive geometry + density (the same convention the original
MJCF robot definitions use), computed once at model-build time on host.
"""

from __future__ import annotations

import numpy as np


def _rot_z_to(d: np.ndarray) -> np.ndarray:
    """Rotation matrix mapping +z to unit vector d."""
    z = np.array([0.0, 0.0, 1.0])
    d = d / np.linalg.norm(d)
    c = float(np.dot(z, d))
    if c > 1 - 1e-9:
        return np.eye(3)
    if c < -1 + 1e-9:
        return np.diag([1.0, -1.0, -1.0])
    a = np.cross(z, d)
    s = np.linalg.norm(a)
    a = a / s
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + K * s + K @ K * (1 - c)


class BodyGeoms:
    """Accumulates primitive geoms into (mass, com, inertia_about_com)."""

    def __init__(self, density: float = 1000.0):
        self.density = density
        self._geoms = []  # (mass, com, inertia_about_own_com)

    def sphere(self, pos, r: float, density=None):
        rho = density or self.density
        m = rho * 4.0 / 3.0 * np.pi * r**3
        I = np.eye(3) * (0.4 * m * r * r)
        self._geoms.append((m, np.asarray(pos, float), I))
        return self

    def capsule(self, p0, p1, r: float, density=None):
        rho = density or self.density
        p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
        l = float(np.linalg.norm(p1 - p0))
        mc = rho * np.pi * r * r * l
        ms = rho * 4.0 / 3.0 * np.pi * r**3
        izz = mc * r * r / 2.0 + ms * 0.4 * r * r
        ixx = (
            mc * (l * l / 12.0 + r * r / 4.0)
            + ms * (0.4 * r * r + l * l / 4.0 + 3.0 * l * r / 8.0)
        )
        I_axial = np.diag([ixx, ixx, izz])
        if l > 1e-9:
            R = _rot_z_to(p1 - p0)
        else:
            R = np.eye(3)
        I = R @ I_axial @ R.T
        self._geoms.append((mc + ms, 0.5 * (p0 + p1), I))
        return self

    def box(self, pos, half, density=None):
        rho = density or self.density
        half = np.asarray(half, float)
        f = 2.0 * half  # full extents
        m = rho * f[0] * f[1] * f[2]
        I = (
            np.diag(
                [f[1] ** 2 + f[2] ** 2, f[0] ** 2 + f[2] ** 2,
                 f[0] ** 2 + f[1] ** 2]
            )
            * m
            / 12.0
        )
        self._geoms.append((m, np.asarray(pos, float), I))
        return self

    def finalize(self):
        """Returns (mass, com, inertia_about_com)."""
        mass = sum(g[0] for g in self._geoms)
        com = sum(g[0] * g[1] for g in self._geoms) / mass
        I = np.zeros((3, 3))
        for m, p, Ig in self._geoms:
            d = p - com
            I += Ig + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        return mass, com, I


def deg(x):
    return float(np.deg2rad(x))
