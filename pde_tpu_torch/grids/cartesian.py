"""Cartesian grids.

Port of :mod:`pde_tpu.grids.cartesian`: cell-centered uniform rectilinear
grids with per-axis periodicity. The state dictionaries are the JAX
package's, so grids round-trip between the two packages.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .base import DimensionError, GridBase, _check_shape, discretize_interval
from .coordinates import CartesianCoordinates


class CartesianGrid(GridBase):
    r"""D-dimensional Cartesian grid with uniform discretization per axis.

    Cells are centered at :math:`x_i = x_{min} + (i + 1/2)\,\Delta x`.
    """

    def __init__(
        self,
        bounds: Sequence[tuple[float, float]],
        shape: int | Sequence[int],
        periodic: bool | Sequence[bool] = False,
    ):
        bounds_arr = np.array(bounds, ndmin=1, dtype=np.double)
        if bounds_arr.shape == (2,):
            raise ValueError(
                "`bounds` with shape (2,) is ambiguous; use shape (1, 2) for a 1d "
                "system with two bounds or (2, 1) for a 2d system with upper bounds"
            )
        if bounds_arr.ndim == 1 or bounds_arr.shape[-1] == 1:
            upper = np.atleast_1d(np.squeeze(bounds_arr))
            bounds_arr = np.stack([np.zeros_like(upper), upper], axis=1)
        elif bounds_arr.ndim != 2 or bounds_arr.shape[1] != 2:
            raise ValueError(f"Cannot interpret shape {bounds_arr.shape} for bounds")

        shape_t = _check_shape(shape)
        if len(shape_t) == 1 and len(bounds_arr) > 1:
            shape_t = (int(shape_t[0]),) * len(bounds_arr)
        if len(bounds_arr) != len(shape_t):
            raise DimensionError("Dimension of `bounds` and `shape` are incompatible")

        self._shape = shape_t
        self.c = CartesianCoordinates(dim=len(shape_t))
        self.axes = list(self.c.axes)
        super().__init__()

        if isinstance(periodic, (bool, np.bool_)):
            self._periodic = [bool(periodic)] * self.num_axes
        else:
            self._periodic = [bool(p) for p in periodic]
            if len(self._periodic) != self.num_axes:
                raise DimensionError("Number of periodicity flags must match dimension")

        coords, dxs = [], []
        for (lo, hi), n in zip(bounds_arr, self._shape, strict=True):
            xs, dx = discretize_interval(float(lo), float(hi), n)
            coords.append(xs)
            dxs.append(dx)
        self._axes_coords = tuple(coords)
        self._axes_bounds = tuple((float(lo), float(hi)) for lo, hi in bounds_arr)
        self._discretization = np.array(dxs)

        self.boundary_names = {"left": (0, False), "right": (0, True)}
        if self.num_axes >= 2:
            self.boundary_names.update({"bottom": (1, False), "top": (1, True)})
        if self.num_axes >= 3:
            self.boundary_names.update({"back": (2, False), "front": (2, True)})

    @property
    def state(self) -> dict[str, Any]:
        return {
            "bounds": tuple(self.axes_bounds),
            "shape": self.shape,
            "periodic": list(self.periodic),
        }

    @classmethod
    def from_state(cls, state: dict[str, Any]) -> CartesianGrid:
        state = dict(state)
        state.pop("class", None)
        return cls(
            bounds=state["bounds"], shape=state["shape"], periodic=state["periodic"]
        )

    @classmethod
    def from_bounds(cls, bounds, shape, periodic=False) -> CartesianGrid:
        return cls(bounds, shape, periodic)

    @property
    def volume(self) -> float:
        return float(np.prod([hi - lo for lo, hi in self.axes_bounds]))

    @property
    def cell_volumes(self) -> np.ndarray:
        """Volume of every cell, broadcast to the grid's shape (a read-only
        view): the product of the spacings, as
        :func:`pde_tpu.grids.base.cell_volumes_traced` computes it for
        Cartesian grids. SDE increments scale as ``sqrt(dt * var /
        cell_volume)``."""
        return np.broadcast_to(np.prod(self.discretization), self.shape)

    def slice(self, indices: Sequence[int]) -> CartesianGrid:
        """The grid of the axes `indices` (names or indices) only."""
        indices = [self.get_axis_index(i) for i in indices]
        if len(indices) == 0:
            raise ValueError("Need at least one axis to slice")
        return CartesianGrid(bounds=[self.axes_bounds[i] for i in indices],
                             shape=[self.shape[i] for i in indices],
                             periodic=[self.periodic[i] for i in indices])

    # -- plotting ----------------------------------------------------------------------
    def get_image_data(self, data) -> dict[str, Any]:
        """Image data (host numpy): the 2D data, or the middle slice along
        the last axis of 3D data, transposed so that rows run along y."""
        data = np.asarray(data)
        if self.num_axes == 2:
            image = data
        elif self.num_axes == 3:
            image = data[..., data.shape[-1] // 2]
        else:
            raise NotImplementedError("Rank mismatch for image data")
        return {
            "data": image.T,
            "x": self.axes_coords[0],
            "y": self.axes_coords[1],
            "extent": list(self.axes_bounds[0]) + list(self.axes_bounds[1]),
            "label_x": self.axes[0],
            "label_y": self.axes[1],
        }

    def get_line_data(self, data, extract: str = "auto") -> dict[str, Any]:
        """Line data (host numpy): a cut through the centre along an axis
        (``auto``/``cut_x``, ``cut_y``, ``cut_z``) or the data integrated
        over the other axes (``project_x``, ...)."""
        data = np.asarray(data)
        if extract in ("auto", "cut_x", "cut_0"):
            axis = 0
        elif extract in ("cut_y", "cut_1"):
            axis = 1
        elif extract in ("cut_z", "cut_2"):
            axis = 2
        elif extract.startswith("project_"):
            axis = self.get_axis_index(extract.split("_")[1])
            others = [a for a in range(self.num_axes) if a != axis]
            data_y = self.integrate(torch.as_tensor(data), axes=others).numpy()
            return {"data_x": self.axes_coords[axis], "data_y": data_y,
                    "label_x": self.axes[axis], "label_y": ""}
        else:
            raise ValueError(f"Unknown extraction method `{extract}`")
        idx: list[Any] = [n // 2 for n in self.shape]
        idx[axis] = slice(None)
        return {"data_x": self.axes_coords[axis], "data_y": data[(Ellipsis, *idx)],
                "label_x": self.axes[axis], "label_y": ""}

    def get_vector_data(self, data, **kwargs) -> dict[str, Any]:
        """The components of 2D vector data as images (host numpy)."""
        if self.num_axes != 2:
            raise NotImplementedError("Vector data only supported in 2d")
        data = np.asarray(data)
        result = self.get_image_data(data[0])
        result["data_x"] = data[0].T
        result["data_y"] = data[1].T
        del result["data"]
        return result

    def plot(self, *args, **kwargs):
        """Draw the cell boundaries of a 1D or 2D grid (requires matplotlib);
        returns the axes."""
        import matplotlib.pyplot as plt

        if self.num_axes not in (1, 2):
            raise NotImplementedError("Grid plotting only supported in 1d and 2d")
        fig, ax = plt.subplots()
        if self.num_axes == 1:
            (lo, hi) = self.axes_bounds[0]
            for x in np.linspace(lo, hi, self.shape[0] + 1):
                ax.axvline(x, color="k", lw=0.5)
            ax.set_xlim(lo, hi)
            ax.set_xlabel(self.axes[0])
        else:
            (x0, x1), (y0, y1) = self.axes_bounds
            for x in np.linspace(x0, x1, self.shape[0] + 1):
                ax.axvline(x, color="k", lw=0.5)
            for y in np.linspace(y0, y1, self.shape[1] + 1):
                ax.axhline(y, color="k", lw=0.5)
            ax.set_xlim(x0, x1)
            ax.set_ylim(y0, y1)
            ax.set_xlabel(self.axes[0])
            ax.set_ylabel(self.axes[1])
            ax.set_aspect(1)
        return ax


class UnitGrid(CartesianGrid):
    """D-dimensional Cartesian grid with unit discretization in all directions."""

    def __init__(self, shape: int | Sequence[int], periodic: bool | Sequence[bool] = False):
        shape_t = _check_shape(shape)
        super().__init__(bounds=[(0, n) for n in shape_t], shape=shape_t, periodic=periodic)

    @property
    def state(self) -> dict[str, Any]:
        return {"shape": self.shape, "periodic": list(self.periodic)}

    @classmethod
    def from_state(cls, state: dict[str, Any]) -> CartesianGrid:
        state = dict(state)
        state.pop("class", None)
        if "bounds" in state:
            return CartesianGrid.from_state(state)
        return cls(shape=state["shape"], periodic=state.get("periodic", False))

    def to_cartesian(self) -> CartesianGrid:
        """The same grid as a :class:`CartesianGrid`."""
        return CartesianGrid(bounds=self.axes_bounds, shape=self.shape, periodic=self.periodic)
