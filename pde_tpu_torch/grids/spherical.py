"""Spherically symmetric grids: polar (2D) and spherical (3D).

Port of :mod:`pde_tpu.grids.spherical`: one radial axis, the field assumed
independent of the angles. Cell volumes are the volumes of the shells, so
that the conservative operators conserve mass exactly. The state
dictionaries are the JAX package's, so grids round-trip between the two
packages.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any

import numpy as np

from .base import GridBase, _check_shape, discretize_interval
from .coordinates import PolarCoordinates, SphericalCoordinates


def volume_from_radius(radius, dim: int):
    """Volume of a sphere of the given radius in `dim` dimensions."""
    if dim == 1:
        return 2 * radius
    if dim == 2:
        return np.pi * radius**2
    if dim == 3:
        return 4 / 3 * np.pi * radius**3
    raise NotImplementedError(f"Cannot calculate the volume in {dim} dimensions")


def _radii(radius) -> tuple[float, float]:
    """(inner, outer) radius from a radius or a pair of radii."""
    try:
        r_inner, r_outer = radius
    except TypeError:
        r_inner, r_outer = 0.0, float(radius)
    if r_inner < 0:
        raise ValueError("Inner radius must be positive")
    if r_inner >= r_outer:
        raise ValueError("Outer radius must be larger than inner radius")
    return float(r_inner), float(r_outer)


class SphericalSymGridBase(GridBase):
    """Base class for d-dimensional grids with angular symmetry."""

    boundary_names = {"inner": (0, False), "outer": (0, True)}

    def __init__(self, radius, shape):
        self.axes = ["r"]
        super().__init__()
        shape_list = _check_shape(shape)
        if len(shape_list) != 1:
            raise ValueError(f"`shape` must be a single number, not {shape_list}")
        self._shape = (int(shape_list[0]),)
        r_inner, r_outer = _radii(radius)
        rs, dr = discretize_interval(r_inner, r_outer, self._shape[0])
        self._axes_coords = (rs,)
        self._axes_bounds = ((r_inner, r_outer),)
        self._discretization = np.array((dr,))
        self._periodic = [False]

    @property
    def state(self) -> dict[str, Any]:
        return {"radius": self.radius, "shape": self.shape}

    @classmethod
    def from_state(cls, state: dict[str, Any]):
        state = dict(state)
        state.pop("class", None)
        radius = state.pop("radius")
        if isinstance(radius, list):
            radius = tuple(radius)
        return cls(radius=radius, shape=state.pop("shape"))

    @classmethod
    def from_bounds(cls, bounds, shape, periodic=None):
        if len(bounds) != 1:
            raise ValueError("`bounds` must be ((r_min, r_max),)")
        return cls(tuple(bounds[0]), shape)

    @property
    def has_hole(self) -> bool:
        return self.axes_bounds[0][0] > 0

    @property
    def radius(self):
        r_inner, r_outer = self.axes_bounds[0]
        return r_outer if r_inner == 0 else (r_inner, r_outer)

    @property
    def volume(self) -> float:
        r_inner, r_outer = self.axes_bounds[0]
        volume = volume_from_radius(r_outer, dim=self.dim)
        if r_inner > 0:
            volume -= volume_from_radius(r_inner, dim=self.dim)
        return float(volume)

    @functools.cached_property
    def cell_volumes(self) -> np.ndarray:
        """The volume of each shell."""
        dr = self.discretization[0]
        rs = self.axes_coords[0]
        return np.asarray(volume_from_radius(rs + 0.5 * dr, dim=self.dim)
                          - volume_from_radius(rs - 0.5 * dr, dim=self.dim))

    @functools.cached_property
    def _axis_volume_factors(self):
        return [np.asarray(self.cell_volumes)]

    def get_cartesian_grid(self, mode: str = "valid", num: int | None = None):
        """A Cartesian grid covering this grid: ``"valid"`` (or
        ``"inscribed"``) keeps the cube inscribed in the sphere, whose points
        are all resolved; ``"full"`` (or ``"circumscribed"``) covers the
        whole sphere."""
        from .cartesian import CartesianGrid

        r_outer = self.axes_bounds[0][1]
        if mode in ("valid", "inscribed"):
            if mode == "valid" and self.has_hole:
                warnings.warn("Sphere has a hole; not all Cartesian points are valid",
                              stacklevel=2)
            bound = r_outer / np.sqrt(self.dim)
        elif mode in ("full", "circumscribed"):
            bound = r_outer
        else:
            raise ValueError(f"Unsupported mode `{mode}`")
        if num is None:
            num = round(2 * bound / self.discretization[0])
        return CartesianGrid([(-bound, bound)] * self.dim, num)

    def _coords_symmetric(self, points):
        return points[..., :1]

    def _coords_full(self, points):
        extra = np.zeros(points.shape[:-1] + (self.dim - 1,))
        return np.concatenate([points, extra], axis=-1)

    def get_random_point(self, *, boundary_distance=0, avoid_center=False,
                         coords="cartesian", rng=None):
        """A random point, uniform in the shell's volume (``pde_tpu``'s draw
        for the same `rng`)."""
        rng = np.random.default_rng(rng)
        r_inner, r_outer = self.axes_bounds[0]
        r_min = r_inner + boundary_distance if avoid_center else r_inner
        r_max = r_outer - boundary_distance
        if r_max <= r_min:
            raise RuntimeError("Random points would be too close to boundary")
        r = np.array([rng.uniform(r_min**self.dim, r_max**self.dim) ** (1 / self.dim)])
        if coords == "cartesian":
            if self.dim == 2:
                return self.c._pos_to_cart(np.r_[r, rng.uniform(0, 2 * np.pi)])
            theta = np.arccos(rng.uniform(-1, 1))
            return self.c._pos_to_cart(np.r_[r, theta, rng.uniform(0, 2 * np.pi)])
        if coords == "cell":
            return self.transform(r, "grid", "cell")
        if coords == "grid":
            return r
        raise ValueError(f"Unknown coordinate system `{coords}`")

    # -- plotting ----------------------------------------------------------------------
    def get_line_data(self, data, extract: str = "auto") -> dict[str, Any]:
        if extract not in ("auto", "r", "radial"):
            raise ValueError(f"Unknown extraction method `{extract}`")
        return {"data_x": self.axes_coords[0], "data_y": np.asarray(data),
                "extent_x": self.axes_bounds[0], "label_x": self.axes[0]}

    def get_image_data(self, data, *, fill_value: float = 0, masked: bool = True,
                       **kwargs) -> dict[str, Any]:
        """The radial data interpolated onto a Cartesian cross-section (host
        numpy)."""
        data = np.asarray(data)
        r_inner, r_outer = self.axes_bounds[0]
        xs = np.linspace(-r_outer, r_outer, 2 * self.shape[0] + 2)
        xg, yg = np.meshgrid(xs, xs, indexing="ij")
        rg = np.hypot(xg, yg)
        values = np.interp(rg, self.axes_coords[0], data, left=data[0], right=fill_value)
        invalid = (rg > r_outer) | (rg < r_inner)
        image = (np.ma.masked_where(invalid, values) if masked
                 else np.where(invalid, fill_value, values))
        return {"data": image.T, "x": xs, "y": xs,
                "extent": [-r_outer, r_outer, -r_outer, r_outer],
                "label_x": "x", "label_y": "y"}

    def plot(self, *args, **kwargs):
        """Draw the shells' boundaries as circles (requires matplotlib);
        returns the axes."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        r_inner, r_outer = self.axes_bounds[0]
        for r in np.linspace(r_inner, r_outer, self.shape[0] + 1):
            if r > 0:
                ax.add_patch(plt.Circle((0, 0), r, fill=False, color="k", lw=0.5))
        ax.set_xlim(-r_outer, r_outer)
        ax.set_ylim(-r_outer, r_outer)
        ax.set_aspect(1)
        return ax


class PolarSymGrid(SphericalSymGridBase):
    """2D polar grid assuming angular symmetry; vector components (r, φ)."""

    def __init__(self, radius, shape):
        self.c = PolarCoordinates()
        super().__init__(radius, shape)


class SphericalSymGrid(SphericalSymGridBase):
    """3D spherical grid assuming angular symmetry; vector components (r, θ, φ)."""

    def __init__(self, radius, shape):
        self.c = SphericalCoordinates()
        super().__init__(radius, shape)
