"""Cylindrical grid with axial (angular) symmetry.

Port of :mod:`pde_tpu.grids.cylindrical`: a 2D (r, z) grid embedded in 3D
space. Vector and tensor components are ordered (r, z, φ), as in
``pde_tpu``. The r axis is never periodic; z may be. The state dictionaries
are the JAX package's, so grids round-trip between the two packages.
"""

from __future__ import annotations

import functools
from typing import Any, Sequence

import numpy as np
import torch

from .base import DimensionError, GridBase, _check_shape, discretize_interval
from .coordinates import CylindricalCoordinates
from .spherical import _radii


class CylindricalSymGrid(GridBase):
    """3D cylindrical grid assuming angular symmetry."""

    boundary_names = {
        "inner": (0, False),
        "outer": (0, True),
        "bottom": (1, False),
        "top": (1, True),
    }

    def __init__(self, radius, bounds_z, shape, periodic_z: bool = False):
        self.c = CylindricalCoordinates()
        self.axes = ["r", "z"]
        super().__init__()
        shape_list = _check_shape(shape)
        if len(shape_list) == 1:
            self._shape = (shape_list[0], shape_list[0])
        elif len(shape_list) == 2:
            self._shape = tuple(shape_list)
        else:
            raise DimensionError("`shape` must be (N_r, N_z)")
        r_inner, r_outer = _radii(radius)
        bounds_z = tuple(bounds_z)
        if len(bounds_z) != 2:
            raise ValueError("`bounds_z` must be (z_min, z_max)")
        rs, dr = discretize_interval(r_inner, r_outer, self._shape[0])
        zs, dz = discretize_interval(float(bounds_z[0]), float(bounds_z[1]), self._shape[1])
        self._axes_coords = (rs, zs)
        self._axes_bounds = ((r_inner, r_outer), (float(bounds_z[0]), float(bounds_z[1])))
        self._discretization = np.array((dr, dz))
        self._periodic = [False, bool(periodic_z)]

    @property
    def state(self) -> dict[str, Any]:
        return {
            "radius": self.radius,
            "bounds_z": self.axes_bounds[1],
            "shape": self.shape,
            "periodic_z": self.periodic[1],
        }

    @classmethod
    def from_state(cls, state: dict[str, Any]) -> CylindricalSymGrid:
        state = dict(state)
        state.pop("class", None)
        radius = state.pop("radius")
        if isinstance(radius, list):
            radius = tuple(radius)
        return cls(radius=radius, bounds_z=state.pop("bounds_z"), shape=state.pop("shape"),
                   periodic_z=state.pop("periodic_z", False))

    @classmethod
    def from_bounds(cls, bounds, shape, periodic=(False, False)):
        if len(bounds) != 2:
            raise ValueError("`bounds` must be ((r_min, r_max), (z_min, z_max))")
        return cls(tuple(bounds[0]), bounds[1], shape, periodic_z=bool(periodic[1]))

    @property
    def has_hole(self) -> bool:
        return self.axes_bounds[0][0] > 0

    @property
    def radius(self):
        r_inner, r_outer = self.axes_bounds[0]
        return r_outer if r_inner == 0 else (r_inner, r_outer)

    @property
    def length(self) -> float:
        z_min, z_max = self.axes_bounds[1]
        return z_max - z_min

    @property
    def volume(self) -> float:
        r_inner, r_outer = self.axes_bounds[0]
        return float(np.pi * (r_outer**2 - r_inner**2) * self.length)

    @functools.cached_property
    def _axis_volume_factors(self):
        """The ring area of each radial cell, and the spacing along z."""
        dr, dz = self.discretization
        rs = self.axes_coords[0]
        ring_areas = np.pi * ((rs + dr / 2) ** 2 - (rs - dr / 2) ** 2)
        return [ring_areas, np.full(self.shape[1], dz)]

    @functools.cached_property
    def cell_volumes(self) -> np.ndarray:
        return np.outer(*self._axis_volume_factors)

    def get_cartesian_grid(self, mode: str = "valid", num: int | None = None):
        """A 3D Cartesian grid covering this grid: ``"valid"`` (or
        ``"inscribed"``) inscribes the square in the circular cross-section,
        ``"full"`` (or ``"circumscribed"``) circumscribes it; the z axis is
        carried over."""
        from .cartesian import CartesianGrid

        r_outer = self.axes_bounds[0][1]
        if mode in ("valid", "inscribed"):
            bound = r_outer / np.sqrt(2)
        elif mode in ("full", "circumscribed"):
            bound = r_outer
        else:
            raise ValueError(f"Unsupported mode `{mode}`")
        if num is None:
            n_xy = round(2 * bound / self.discretization[0])
            nums = [n_xy, n_xy, self.shape[1]]
        else:
            nums = [num, num, num]
        return CartesianGrid([(-bound, bound), (-bound, bound), self.axes_bounds[1]], nums)

    def _coords_symmetric(self, points):
        return points[..., [0, 2]]  # (r, φ, z) -> (r, z)

    def _coords_full(self, points):
        r, z = points[..., :1], points[..., 1:2]
        return np.concatenate([r, np.zeros_like(r), z], axis=-1)  # (r, z) -> (r, φ=0, z)

    def slice(self, indices: Sequence[int]):
        """The subgrid of the given axes: r gives a polar grid, z a 1D
        Cartesian grid."""
        from .cartesian import CartesianGrid
        from .spherical import PolarSymGrid

        indices = [self.get_axis_index(i) for i in indices]
        if indices == [0]:
            return PolarSymGrid(self.radius, self.shape[0])
        if indices == [1]:
            return CartesianGrid([self.axes_bounds[1]], [self.shape[1]],
                                 periodic=[self.periodic[1]])
        raise ValueError(f"Cannot slice cylindrical grid with indices {indices}")

    # -- plotting ----------------------------------------------------------------------
    def get_line_data(self, data, extract: str = "auto") -> dict[str, Any]:
        """Line data (host numpy): along z at the innermost ring, along r at
        the middle of z, or integrated over the other axis."""
        data = np.asarray(data)
        if extract in ("auto", "cut_axial", "cut_z"):
            return {"data_x": self.axes_coords[1], "data_y": data[0],
                    "extent_x": self.axes_bounds[1], "label_x": "z"}
        if extract in ("cut_r", "cut_radial"):
            return {"data_x": self.axes_coords[0], "data_y": data[:, self.shape[1] // 2],
                    "extent_x": self.axes_bounds[0], "label_x": "r"}
        if extract in ("project_z", "project_r"):
            axis = 1 if extract == "project_z" else 0
            data_y = self.integrate(torch.as_tensor(data), axes=1 - axis).numpy()
            return {"data_x": self.axes_coords[axis], "data_y": data_y,
                    "label_x": self.axes[axis]}
        raise ValueError(f"Unknown extraction method `{extract}`")

    def get_image_data(self, data, **kwargs) -> dict[str, Any]:
        """The (r, z) data mirrored along r into a full cross-section, r
        horizontal and z vertical (host numpy)."""
        data = np.asarray(data)
        r_outer = self.axes_bounds[0][1]
        z_min, z_max = self.axes_bounds[1]
        image = np.concatenate([data[::-1], data], axis=0)
        return {"data": image.T, "x": np.r_[-self.axes_coords[0][::-1], self.axes_coords[0]],
                "y": self.axes_coords[1], "extent": [-r_outer, r_outer, z_min, z_max],
                "label_x": "r", "label_y": "z"}

    def plot(self, *args, **kwargs):
        """Draw the cell boundaries of the (r, z) cross-section (requires
        matplotlib); returns the axes."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        (r0, r1), (z0, z1) = self.axes_bounds
        for r in np.linspace(r0, r1, self.shape[0] + 1):
            ax.axvline(r, color="k", lw=0.5)
        for z in np.linspace(z0, z1, self.shape[1] + 1):
            ax.axhline(z, color="k", lw=0.5)
        ax.set_xlim(r0, r1)
        ax.set_ylim(z0, z1)
        ax.set_xlabel("r")
        ax.set_ylabel("z")
        return ax
