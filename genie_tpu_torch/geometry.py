"""Geodetic coordinate transforms and the local Cartesian projection.

Port of ``genie_tpu/geometry.py``: WGS84 ``lla2ecef``/``ecef2lla`` on torch
tensors (differentiable, any device) with float64 numpy host twins, the
Euler-angle :func:`rotation_matrix`, and the closed-form local ENU
:class:`Projection` (+x east, +y north, +z up, centred on the region; the
reference's ``ftrns1``/``ftrns2`` names too). Positions are ``(..., 3)``
arrays of (lat deg, lon deg, depth m; positive above sea level).
"""

from __future__ import annotations

import math

import numpy as np
import torch

WGS84_A = 6378137.0
WGS84_E = 8.18191908426215e-2
SPHERICAL_RADIUS = 6371e3


def lla2ecef(p, a: float = WGS84_A, e: float = WGS84_E):
    """Geodetic (lat deg, lon deg, alt m) → ECEF (m), torch."""
    p = torch.as_tensor(p)
    lat = p[..., 0] * (math.pi / 180.0)
    lon = p[..., 1] * (math.pi / 180.0)
    alt = p[..., 2]
    n = a / torch.sqrt(1.0 - (e**2) * torch.sin(lat) ** 2)
    x = (n + alt) * torch.cos(lat) * torch.cos(lon)
    y = (n + alt) * torch.cos(lat) * torch.sin(lon)
    z = ((1.0 - e**2) * n + alt) * torch.sin(lat)
    return torch.stack((x, y, z), dim=-1)


def ecef2lla(x, a: float = WGS84_A, e: float = WGS84_E):
    """ECEF (m) → geodetic (lat deg, lon deg, alt m), torch (Bowring-style
    closed form with the near-axis altitude fix-up)."""
    x = torch.as_tensor(x)
    b = math.sqrt((a**2) * (1.0 - e**2))
    ep = math.sqrt((a**2 - b**2) / (b**2))
    p = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    th = torch.atan2(a * x[..., 2], b * p)
    lon = torch.atan2(x[..., 1], x[..., 0])
    lat = torch.atan2(x[..., 2] + (ep**2) * b * torch.sin(th) ** 3,
                      p - (e**2) * a * torch.cos(th) ** 3)
    n = a / torch.sqrt(1.0 - (e**2) * torch.sin(lat) ** 2)
    alt = p / torch.cos(lat) - n
    near_axis = (x[..., 0].abs() < 1.0) & (x[..., 1].abs() < 1.0)
    alt = torch.where(near_axis, x[..., 2].abs() - b, alt)
    return torch.stack((lat * (180.0 / math.pi), lon * (180.0 / math.pi), alt), dim=-1)


def lla2ecef_np(p, a: float = WGS84_A, e: float = WGS84_E):
    """Float64 host twin of :func:`lla2ecef`."""
    p = np.asarray(p, dtype=np.float64)
    lat = np.deg2rad(p[..., 0])
    lon = np.deg2rad(p[..., 1])
    alt = p[..., 2]
    n = a / np.sqrt(1.0 - (e**2) * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = ((1.0 - e**2) * n + alt) * np.sin(lat)
    return np.stack((x, y, z), axis=-1)


def ecef2lla_np(x, a: float = WGS84_A, e: float = WGS84_E):
    """Float64 host twin of :func:`ecef2lla`."""
    x = np.asarray(x, dtype=np.float64)
    b = np.sqrt((a**2) * (1.0 - e**2))
    ep = np.sqrt((a**2 - b**2) / (b**2))
    p = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    th = np.arctan2(a * x[..., 2], b * p)
    lon = np.arctan2(x[..., 1], x[..., 0])
    lat = np.arctan2(x[..., 2] + (ep**2) * b * np.sin(th) ** 3,
                     p - (e**2) * a * np.cos(th) ** 3)
    n = a / np.sqrt(1.0 - (e**2) * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    near_axis = (np.abs(x[..., 0]) < 1.0) & (np.abs(x[..., 1]) < 1.0)
    alt = np.where(near_axis, np.abs(x[..., 2]) - b, alt)
    return np.stack((np.rad2deg(lat), np.rad2deg(lon), alt), axis=-1)


def rotation_matrix(a, b, c):
    """Euler-angle (z-y-x intrinsic) 3×3 rotation of the angles ``a``,
    ``b``, ``c`` (radians; numbers or 0-dim tensors), torch."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b, c))
    sa, ca = torch.sin(a), torch.cos(a)
    sb, cb = torch.sin(b), torch.cos(b)
    sc, cc = torch.sin(c), torch.cos(c)
    return torch.stack((
        torch.stack((cb * cc, sa * sb * cc - ca * sc, ca * sb * cc + sa * sc)),
        torch.stack((cb * sc, sa * sb * sc + ca * cc, ca * sb * sc - sa * cc)),
        torch.stack((-sb, sa * cb, ca * cb)),
    ))


def fit_projection(center_latlon, spherical: bool = False):
    """``(rbest, mn)`` with ``project = rbest @ (lla2ecef(x) - mn)``: rows of
    ``rbest`` are the ENU unit vectors at the region centre. ``mn`` is
    computed in float32, as the JAX package does, so both packages place
    the origin at the same point."""
    lat0 = float(center_latlon[0]) * np.pi / 180.0
    lon0 = float(center_latlon[1]) * np.pi / 180.0
    east = np.array([-np.sin(lon0), np.cos(lon0), 0.0])
    north = np.array([-np.sin(lat0) * np.cos(lon0),
                      -np.sin(lat0) * np.sin(lon0), np.cos(lat0)])
    up = np.array([np.cos(lat0) * np.cos(lon0),
                   np.cos(lat0) * np.sin(lon0), np.sin(lat0)])
    rbest = np.stack((east, north, up), axis=0)
    centre = torch.tensor([[center_latlon[0], center_latlon[1], 0.0]],
                          dtype=torch.float32)
    if spherical:
        mn = lla2ecef(centre, a=SPHERICAL_RADIUS, e=0.0)[0]
    else:
        mn = lla2ecef(centre)[0]
    return rbest, mn.numpy()


class Projection:
    """``to_cart``: (lat, lon, depth) → local Cartesian metres; ``to_lla``
    the inverse. Torch versions compute in float32 like the JAX package;
    the ``*_np`` twins are float64 and metre-accurate."""

    def __init__(self, rbest, mn, spherical: bool = False):
        # held at float32 precision like the JAX Projection
        self.rbest = np.asarray(rbest, np.float32).astype(np.float64)
        self.mn = np.asarray(mn, np.float32).astype(np.float64)
        self.spherical = spherical
        self._a = SPHERICAL_RADIUS if spherical else WGS84_A
        self._e = 0.0 if spherical else WGS84_E

    @classmethod
    def from_center(cls, center_latlon, spherical: bool = False):
        rbest, mn = fit_projection(center_latlon, spherical=spherical)
        return cls(rbest, mn, spherical=spherical)

    def _consts(self, x):
        r = torch.as_tensor(self.rbest, dtype=torch.float32, device=x.device)
        m = torch.as_tensor(self.mn, dtype=torch.float32, device=x.device)
        return r, m

    def to_cart(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        r, m = self._consts(x)
        return (lla2ecef(x, a=self._a, e=self._e) - m) @ r.T

    def to_lla(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        r, m = self._consts(x)
        return ecef2lla(x @ r + m, a=self._a, e=self._e)

    def to_cart_np(self, x):
        return (lla2ecef_np(x, a=self._a, e=self._e) - self.mn) @ self.rbest.T

    def to_lla_np(self, x):
        return ecef2lla_np(np.asarray(x, np.float64) @ self.rbest + self.mn,
                           a=self._a, e=self._e)

    # the reference's names for the two directions
    def ftrns1(self, x):
        return self.to_cart(x)

    def ftrns2(self, x):
        return self.to_lla(x)
