"""Orthonormal coordinate systems.

Port of :mod:`pde_tpu.grids.coordinates`: host-side (numpy) metadata
describing the axes of a grid and its geometry (conversions to and from
Cartesian coordinates, scale factors, the metric, cell volumes and the
rotation of the local basis). Cartesian, polar, spherical, cylindrical,
bipolar and bispherical coordinates.
"""

from __future__ import annotations

import numpy as np


class DimensionError(ValueError):
    """Exception indicating that dimensions were inconsistent."""


class CoordinatesBase:
    """Base class for orthonormal coordinate systems."""

    dim: int
    axes: list[str]
    _axes_alt: dict[str, list[str]] = {}
    coordinate_limits: list[tuple[float, float]]
    major_axis: int = 0

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    def __eq__(self, other) -> bool:
        return self.__class__ is other.__class__ and getattr(
            self, "dim", None
        ) == getattr(other, "dim", None)

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, getattr(self, "dim", None)))

    # -- conversions ---------------------------------------------------------
    def _pos_to_cart(self, points):
        raise NotImplementedError

    def pos_to_cart(self, points, *, axis: int = -1):
        """Convert coordinates to Cartesian coordinates."""
        points = np.moveaxis(np.atleast_1d(points), axis, -1)
        if points.shape[-1] != self.dim:
            raise DimensionError(f"Points must have {self.dim} coordinates")
        return np.moveaxis(self._pos_to_cart(points), -1, axis)

    def _pos_from_cart(self, points):
        raise NotImplementedError

    def pos_from_cart(self, points, *, axis: int = -1):
        """Convert Cartesian coordinates to this coordinate system."""
        points = np.moveaxis(np.atleast_1d(points), axis, -1)
        if points.shape[-1] != self.dim:
            raise DimensionError(f"Points must have {self.dim} coordinates")
        return np.moveaxis(self._pos_from_cart(points), -1, axis)

    def distance(self, p1, p2) -> np.ndarray:
        """Euclidean distance between two points given in these coordinates."""
        x1 = self.pos_to_cart(p1)
        x2 = self.pos_to_cart(p2)
        return np.linalg.norm(x2 - x1, axis=-1)  # type: ignore[return-value]

    # -- differential geometry ------------------------------------------------
    def _scale_factors(self, points):
        return np.sqrt(np.diagonal(self.metric(points), axis1=-2, axis2=-1))

    def scale_factors(self, points):
        """Scale factors (Lamé coefficients) h_i at the given points."""
        points = np.atleast_1d(points)
        return self._scale_factors(points)

    def _mapping_jacobian(self, points):
        # generic: finite-difference fallback is avoided; subclasses implement
        raise NotImplementedError

    def mapping_jacobian(self, points):
        """Jacobian matrix d(cartesian)/d(coords)."""
        points = np.atleast_1d(points)
        return self._mapping_jacobian(points)

    def _volume_factor(self, points):
        return np.prod(self._scale_factors(points), axis=0)

    def volume_factor(self, points):
        """Volume element factor (product of scale factors)."""
        points = np.atleast_1d(points)
        return self._volume_factor(points)

    def _cell_volume(self, c_low, c_high):
        # generic: integrate the volume factor numerically over the cuboid cell
        from itertools import product

        n = 17
        samples = []
        for lo, hi in zip(
            np.moveaxis(c_low, -1, 0), np.moveaxis(c_high, -1, 0), strict=True
        ):
            samples.append(np.linspace(lo, hi, n))
        vol = np.zeros(np.broadcast(c_low[..., 0], c_high[..., 0]).shape)
        # simple midpoint quadrature
        for idx in product(range(n - 1), repeat=self.dim):
            pt = np.stack(
                [0.5 * (s[i] + s[i + 1]) for s, i in zip(samples, idx, strict=True)],
                axis=-1,
            )
            w = np.prod(
                np.stack(
                    [s[i + 1] - s[i] for s, i in zip(samples, idx, strict=True)],
                    axis=-1,
                ),
                axis=-1,
            )
            vol = vol + self.volume_factor(pt) * w
        return vol

    def cell_volume(self, c_low, c_high):
        """Volume of a cell spanned by the coordinates `c_low` and `c_high`."""
        c_low = np.atleast_1d(c_low)
        c_high = np.atleast_1d(c_high)
        return self._cell_volume(c_low, c_high)

    def metric(self, points):
        """Metric tensor g_ij at the given points."""
        points = np.atleast_1d(points)
        h = self._scale_factors(points)
        g = np.zeros(points.shape[:-1] + (self.dim, self.dim))
        for i in range(self.dim):
            g[..., i, i] = h[i] ** 2
        return g

    def _basis_rotation(self, points):
        raise NotImplementedError

    def basis_rotation(self, points):
        """Rotation matrix mapping local orthonormal basis to Cartesian basis."""
        points = np.atleast_1d(points)
        return self._basis_rotation(points)

    def vec_to_cart(self, points, components):
        """Convert vector components at given points to Cartesian components."""
        points = np.atleast_1d(points)
        components = np.atleast_1d(components)
        rot = self.basis_rotation(points)
        return np.einsum("...ij,i...->j...", rot, components)


class CartesianCoordinates(CoordinatesBase):
    """n-dimensional Cartesian coordinates."""

    _instances: dict[int, CartesianCoordinates] = {}

    def __new__(cls, dim: int):
        if dim not in cls._instances:
            cls._instances[dim] = super().__new__(cls)
        return cls._instances[dim]

    def __init__(self, dim: int):
        self.dim = dim
        if dim <= 3:
            self.axes = list("xyz"[:dim])
        else:
            self.axes = [f"x{i}" for i in range(dim)]
        self.coordinate_limits = [(-np.inf, np.inf)] * dim

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(dim={self.dim})"

    def _pos_to_cart(self, points):
        return points

    def _pos_from_cart(self, points):
        return points

    def _scale_factors(self, points):
        return np.ones((self.dim,) + points.shape[:-1])

    def _mapping_jacobian(self, points):
        jac = np.zeros(points.shape[:-1] + (self.dim, self.dim))
        for i in range(self.dim):
            jac[..., i, i] = 1
        return jac

    def _volume_factor(self, points):
        return np.ones(points.shape[:-1])

    def _cell_volume(self, c_low, c_high):
        return np.prod(c_high - c_low, axis=-1)

    def _basis_rotation(self, points):
        return self._mapping_jacobian(points)


class PolarCoordinates(CoordinatesBase):
    """2-dimensional polar coordinates (r, φ)."""

    dim = 2
    axes = ["r", "φ"]
    _axes_alt = {"r": ["radius"], "φ": ["phi"]}
    coordinate_limits = [(0.0, np.inf), (0.0, 2 * np.pi)]
    _singleton = None

    def __new__(cls):
        if cls._singleton is None:
            cls._singleton = super().__new__(cls)
        return cls._singleton

    def _pos_to_cart(self, points):
        r, phi = points[..., 0], points[..., 1]
        return np.stack((r * np.cos(phi), r * np.sin(phi)), axis=-1)

    def _pos_from_cart(self, points):
        x, y = points[..., 0], points[..., 1]
        return np.stack((np.hypot(x, y), np.arctan2(y, x)), axis=-1)

    def _scale_factors(self, points):
        r = points[..., 0]
        return np.stack((np.ones_like(r), r))

    def _mapping_jacobian(self, points):
        r, phi = points[..., 0], points[..., 1]
        c, s = np.cos(phi), np.sin(phi)
        jac = np.empty(points.shape[:-1] + (2, 2))
        jac[..., 0, 0] = c
        jac[..., 0, 1] = -r * s
        jac[..., 1, 0] = s
        jac[..., 1, 1] = r * c
        return jac

    def _volume_factor(self, points):
        return points[..., 0]

    def _cell_volume(self, c_low, c_high):
        r0, r1 = c_low[..., 0], c_high[..., 0]
        dphi = c_high[..., 1] - c_low[..., 1]
        return 0.5 * (r1**2 - r0**2) * dphi

    def _basis_rotation(self, points):
        phi = points[..., 1]
        c, s = np.cos(phi), np.sin(phi)
        rot = np.empty(points.shape[:-1] + (2, 2))
        rot[..., 0, 0] = c
        rot[..., 0, 1] = s
        rot[..., 1, 0] = -s
        rot[..., 1, 1] = c
        return rot


class SphericalCoordinates(CoordinatesBase):
    """3-dimensional spherical coordinates (r, θ, φ)."""

    dim = 3
    axes = ["r", "θ", "φ"]
    _axes_alt = {"r": ["radius"], "θ": ["theta"], "φ": ["phi"]}
    coordinate_limits = [(0.0, np.inf), (0.0, np.pi), (0.0, 2 * np.pi)]
    _singleton = None

    def __new__(cls):
        if cls._singleton is None:
            cls._singleton = super().__new__(cls)
        return cls._singleton

    def _pos_to_cart(self, points):
        r, theta, phi = points[..., 0], points[..., 1], points[..., 2]
        rs = r * np.sin(theta)
        return np.stack((rs * np.cos(phi), rs * np.sin(phi), r * np.cos(theta)), axis=-1)

    def _pos_from_cart(self, points):
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        r = np.linalg.norm(points, axis=-1)
        return np.stack((r, np.arctan2(np.hypot(x, y), z), np.arctan2(y, x)), axis=-1)

    def _scale_factors(self, points):
        r, theta = points[..., 0], points[..., 1]
        return np.stack((np.ones_like(r), r, r * np.sin(theta)))

    def _mapping_jacobian(self, points):
        r, theta, phi = points[..., 0], points[..., 1], points[..., 2]
        st, ct = np.sin(theta), np.cos(theta)
        sp, cp = np.sin(phi), np.cos(phi)
        jac = np.empty(points.shape[:-1] + (3, 3))
        jac[..., 0, :] = np.stack((st * cp, r * ct * cp, -r * st * sp), axis=-1)
        jac[..., 1, :] = np.stack((st * sp, r * ct * sp, r * st * cp), axis=-1)
        jac[..., 2, :] = np.stack((ct, -r * st, np.zeros_like(r)), axis=-1)
        return jac

    def _volume_factor(self, points):
        r, theta = points[..., 0], points[..., 1]
        return r**2 * np.sin(theta)

    def _cell_volume(self, c_low, c_high):
        r0, r1 = c_low[..., 0], c_high[..., 0]
        t0, t1 = c_low[..., 1], c_high[..., 1]
        dphi = c_high[..., 2] - c_low[..., 2]
        return (r1**3 - r0**3) / 3 * (np.cos(t0) - np.cos(t1)) * dphi

    def _basis_rotation(self, points):
        theta, phi = points[..., 1], points[..., 2]
        st, ct = np.sin(theta), np.cos(theta)
        sp, cp = np.sin(phi), np.cos(phi)
        rot = np.empty(points.shape[:-1] + (3, 3))
        rot[..., 0, :] = np.stack((st * cp, st * sp, ct), axis=-1)
        rot[..., 1, :] = np.stack((ct * cp, ct * sp, -st), axis=-1)
        rot[..., 2, :] = np.stack((-sp, cp, np.zeros_like(sp)), axis=-1)
        return rot


class CylindricalCoordinates(CoordinatesBase):
    """3-dimensional cylindrical coordinates (r, φ, z)."""

    dim = 3
    axes = ["r", "φ", "z"]
    _axes_alt = {"r": ["radius"], "φ": ["phi"]}
    coordinate_limits = [(0.0, np.inf), (0.0, 2 * np.pi), (-np.inf, np.inf)]
    _singleton = None

    def __new__(cls):
        if cls._singleton is None:
            cls._singleton = super().__new__(cls)
        return cls._singleton

    def _pos_to_cart(self, points):
        r, phi, z = points[..., 0], points[..., 1], points[..., 2]
        return np.stack((r * np.cos(phi), r * np.sin(phi), z), axis=-1)

    def _pos_from_cart(self, points):
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        return np.stack((np.hypot(x, y), np.arctan2(y, x), z), axis=-1)

    def _scale_factors(self, points):
        r = points[..., 0]
        return np.stack((np.ones_like(r), r, np.ones_like(r)))

    def _mapping_jacobian(self, points):
        r, phi = points[..., 0], points[..., 1]
        c, s = np.cos(phi), np.sin(phi)
        zero, one = np.zeros_like(r), np.ones_like(r)
        jac = np.empty(points.shape[:-1] + (3, 3))
        jac[..., 0, :] = np.stack((c, -r * s, zero), axis=-1)
        jac[..., 1, :] = np.stack((s, r * c, zero), axis=-1)
        jac[..., 2, :] = np.stack((zero, zero, one), axis=-1)
        return jac

    def _volume_factor(self, points):
        return points[..., 0]

    def _cell_volume(self, c_low, c_high):
        r0, r1 = c_low[..., 0], c_high[..., 0]
        dphi = c_high[..., 1] - c_low[..., 1]
        dz = c_high[..., 2] - c_low[..., 2]
        return 0.5 * (r1**2 - r0**2) * dphi * dz

    def _basis_rotation(self, points):
        phi = points[..., 1]
        c, s = np.cos(phi), np.sin(phi)
        zero, one = np.zeros_like(phi), np.ones_like(phi)
        rot = np.empty(points.shape[:-1] + (3, 3))
        rot[..., 0, :] = np.stack((c, s, zero), axis=-1)
        rot[..., 1, :] = np.stack((-s, c, zero), axis=-1)
        rot[..., 2, :] = np.stack((zero, zero, one), axis=-1)
        return rot


class BipolarCoordinates(CoordinatesBase):
    """2-dimensional bipolar coordinates (σ, τ) with scale parameter a."""

    dim = 2
    axes = ["σ", "τ"]
    _axes_alt = {"σ": ["sigma"], "τ": ["tau"]}
    coordinate_limits = [(0.0, 2 * np.pi), (-np.inf, np.inf)]

    def __init__(self, scale_parameter: float = 1.0):
        self.scale_parameter = float(scale_parameter)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(scale_parameter={self.scale_parameter})"

    def __eq__(self, other):
        return (
            self.__class__ is other.__class__
            and self.scale_parameter == other.scale_parameter
        )

    def __hash__(self):
        return hash((self.__class__.__name__, self.scale_parameter))

    def _pos_to_cart(self, points):
        sigma, tau = points[..., 0], points[..., 1]
        a = self.scale_parameter
        denom = np.cosh(tau) - np.cos(sigma)
        return np.stack((a * np.sinh(tau) / denom, a * np.sin(sigma) / denom), axis=-1)

    def _pos_from_cart(self, points):
        x, y = points[..., 0], points[..., 1]
        a = self.scale_parameter
        sigma = np.mod(
            np.arctan2(2 * a * y, x**2 + y**2 - a**2), 2 * np.pi
        )
        tau = 0.5 * np.log(((x + a) ** 2 + y**2) / ((x - a) ** 2 + y**2))
        return np.stack((sigma, tau), axis=-1)

    def _scale_factors(self, points):
        sigma, tau = points[..., 0], points[..., 1]
        h = self.scale_parameter / (np.cosh(tau) - np.cos(sigma))
        return np.stack((h, h))

    def _mapping_jacobian(self, points):
        sigma, tau = points[..., 0], points[..., 1]
        a = self.scale_parameter
        denom = np.cosh(tau) - np.cos(sigma)
        jac = np.empty(points.shape[:-1] + (2, 2))
        jac[..., 0, 0] = -a * np.sinh(tau) * np.sin(sigma) / denom**2
        jac[..., 0, 1] = a * (1 - np.cosh(tau) * np.cos(sigma)) / denom**2
        jac[..., 1, 0] = a * (np.cosh(tau) * np.cos(sigma) - 1) / denom**2
        jac[..., 1, 1] = -a * np.sinh(tau) * np.sin(sigma) / denom**2
        return jac

    def _basis_rotation(self, points):
        jac = self._mapping_jacobian(points)
        h = np.moveaxis(self._scale_factors(points), 0, -1)
        return np.swapaxes(jac / h[..., None, :], -1, -2)


class BisphericalCoordinates(CoordinatesBase):
    """3-dimensional bispherical coordinates (σ, τ, φ) with scale parameter a."""

    dim = 3
    axes = ["σ", "τ", "φ"]
    _axes_alt = {"σ": ["sigma"], "τ": ["tau"], "φ": ["phi"]}
    coordinate_limits = [(0.0, np.pi), (-np.inf, np.inf), (0.0, 2 * np.pi)]

    def __init__(self, scale_parameter: float = 1.0):
        self.scale_parameter = float(scale_parameter)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(scale_parameter={self.scale_parameter})"

    def __eq__(self, other):
        return (
            self.__class__ is other.__class__
            and self.scale_parameter == other.scale_parameter
        )

    def __hash__(self):
        return hash((self.__class__.__name__, self.scale_parameter))

    def _pos_to_cart(self, points):
        sigma, tau, phi = points[..., 0], points[..., 1], points[..., 2]
        a = self.scale_parameter
        denom = np.cosh(tau) - np.cos(sigma)
        rho = a * np.sin(sigma) / denom
        return np.stack(
            (rho * np.cos(phi), rho * np.sin(phi), a * np.sinh(tau) / denom), axis=-1
        )

    def _pos_from_cart(self, points):
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        a = self.scale_parameter
        rho = np.hypot(x, y)
        sigma = np.arctan2(2 * a * rho, rho**2 + z**2 - a**2)
        sigma = np.mod(sigma, np.pi) + np.where(
            (rho**2 + z**2 < a**2) & (np.mod(sigma, np.pi) == 0), np.pi, 0
        )
        tau = 0.5 * np.log((rho**2 + (z + a) ** 2) / (rho**2 + (z - a) ** 2))
        phi = np.arctan2(y, x)
        return np.stack((sigma, tau, phi), axis=-1)

    def _scale_factors(self, points):
        sigma, tau = points[..., 0], points[..., 1]
        a = self.scale_parameter
        denom = np.cosh(tau) - np.cos(sigma)
        h = a / denom
        return np.stack((h, h, a * np.sin(sigma) / denom))

    def _basis_rotation(self, points):
        # numerical rotation from normalized Jacobian columns
        eps = 1e-7
        base = self.pos_to_cart(points)
        rot = np.empty(points.shape[:-1] + (3, 3))
        h = self._scale_factors(points)
        for i in range(3):
            shifted = np.array(points, dtype=float)
            shifted[..., i] += eps
            d = (self.pos_to_cart(shifted) - base) / eps
            rot[..., i, :] = d / h[i][..., None]
        return rot
