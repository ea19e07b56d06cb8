"""Fields of a single tensorial rank.

Port of :mod:`pde_tpu.fields.datafield_base`: construction on a device and
dtype (also from data with ghost cells), random initial states (uniform,
normal and correlated, harmonic, colored: the numbers drawn on the host by
numpy, as ``pde_tpu`` draws them, and copied to the device once), operator
application (returning the field class of the operator's output rank),
volume averages and fluctuations, ghost cells, linear interpolation and
deposition (gathers and ``index_put_`` on the device), Gaussian smoothing in
torch on the device, and line, image and vector plots (matplotlib, imported
where a plot is drawn; a plot copies the data to the host once, and a plot
reference updates its artists in place). A field made from numbers, a numpy
array or a string lands on the config key ``device`` (the card by default)
unless ``device=`` says otherwise; a tensor keeps its own device.
"""

from __future__ import annotations

from typing import Any

import itertools
from typing import Callable

import numpy as np
import torch

from ..grids.base import DomainError, GridBase
from ..utils.config import default_device
from .base import FieldBase, RankError, from_host, to_host, torch_dtype_to_numpy


class DataFieldBase(FieldBase):
    """Abstract base class for fields of a single tensorial rank."""

    rank: int  # set by subclasses

    def __init__(
        self,
        grid: GridBase,
        data: Any = "zeros",
        *,
        label: str | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        with_ghost_cells: bool = False,
    ):
        shape = (grid.dim,) * self.rank + tuple(grid.shape)
        if isinstance(data, DataFieldBase):
            grid.assert_grid_compatible(data.grid)
            data = data.data
        if isinstance(data, str):
            dtype = dtype or torch.get_default_dtype()
            if data not in ("zeros", "empty"):
                raise ValueError(f"Unknown data specification `{data}`")
            arr = torch.zeros(shape, dtype=dtype, device=default_device(device))
        else:
            if not isinstance(data, torch.Tensor):
                device = default_device(device)
            arr = torch.as_tensor(from_host(data), device=device)
            if with_ghost_cells:  # keep the valid cells, as pde_tpu does
                arr = arr[(slice(None),) * self.rank + grid._idx_valid]
            if dtype is None and not (arr.is_floating_point() or arr.is_complex()):
                dtype = torch.get_default_dtype()
            arr = arr.to(dtype=dtype or arr.dtype)
            if arr.shape != shape:
                arr = torch.broadcast_to(arr, shape)
            arr = arr.contiguous()
        super().__init__(grid, arr, label=label)

    @classmethod
    def random_uniform(
        cls, grid: GridBase, vmin: float = 0, vmax: float = 1, *,
        label: str | None = None, dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        rng: np.random.Generator | torch.Generator | None = None,
    ):
        """Field with uniformly random values in [vmin, vmax).

        `rng` is a ``np.random.Generator`` (values drawn in float64 on the
        host, then cast and moved to `device`, by default the config key
        ``device``, as the JAX package draws them) or a ``torch.Generator``
        (values drawn on the generator's device).
        """
        shape = (grid.dim,) * cls.rank + tuple(grid.shape)
        dtype = dtype or torch.get_default_dtype()
        if isinstance(rng, torch.Generator):
            data = torch.rand(shape, generator=rng, dtype=dtype, device=rng.device)
            data = (data * (vmax - vmin) + vmin).to(device or rng.device)
        else:
            values = np.random.default_rng(rng).uniform(vmin, vmax, size=shape)
            data = torch.as_tensor(values, dtype=dtype, device=default_device(device))
        return cls(grid, data=data, label=label)

    @classmethod
    def _from_host(cls, grid: GridBase, values: np.ndarray, dtype, device, label):
        """A field holding host `values`, copied once to `device` (by default
        the config key ``device``) in `dtype` (by default torch's, or the
        values' own complex dtype)."""
        if dtype is None:
            dtype = (torch.complex128 if np.iscomplexobj(values) else torch.get_default_dtype())
        data = torch.as_tensor(np.asarray(values), dtype=dtype, device=default_device(device))
        return cls(grid, data=data, label=label)

    @classmethod
    def random_normal(
        cls, grid: GridBase, mean: float = 0, std: float = 1, *,
        correlation: str = "none", label: str | None = None, dtype: torch.dtype | None = None,
        device=None, rng: np.random.Generator | None = None, scaling: str = "none", **kwargs,
    ):
        """Field of normally distributed values, optionally correlated in
        space (``correlation`` and its parameters, see
        :func:`~pde_tpu_torch.utils.spectral.make_correlated_noise`).

        ``scaling="physical"`` scales the variance with the cell volumes, so
        that the result converges in the continuum limit. The values are
        ``pde_tpu``'s for the same `rng`, drawn on the host in numpy."""
        from ..utils.spectral import make_correlated_noise

        rng = np.random.default_rng(rng)
        shape = (grid.dim,) * cls.rank + tuple(grid.shape)
        make_noise = make_correlated_noise(
            tuple(grid.shape), correlation, discretization=grid.discretization,
            dtype=float if dtype is None else torch_dtype_to_numpy(dtype), rng=rng, **kwargs)
        count = int(np.prod(shape[: cls.rank])) if cls.rank else 1
        noise = np.stack([make_noise() for _ in range(count)]).reshape(shape)
        if scaling == "physical":
            noise = noise / np.sqrt(np.broadcast_to(grid.cell_volumes, grid.shape))
        elif scaling != "none":
            raise ValueError(f"Unknown noise scaling `{scaling}`")
        return cls._from_host(grid, mean + std * noise, dtype, device, label)

    @classmethod
    def random_harmonic(
        cls, grid: GridBase, modes: int = 3, harmonic=np.cos, axis_combination=np.multiply, *,
        label: str | None = None, dtype: torch.dtype | None = None, device=None,
        rng: np.random.Generator | None = None,
    ):
        """Field made of a superposition of random harmonic modes along each
        axis, combined by `axis_combination` (``pde_tpu``'s values for the
        same `rng`)."""
        rng = np.random.default_rng(rng)
        shape = (grid.dim,) * cls.rank + tuple(grid.shape)

        def single():
            axis_data = []
            for i in range(grid.num_axes):
                lo, hi = grid.axes_bounds[i]
                x = 2 * np.pi * (grid.axes_coords[i] - lo) / (hi - lo)
                amps = rng.uniform(size=modes)
                axis_data.append(sum(a / (k + 1) * harmonic((k + 1) * x)
                                     for k, a in enumerate(amps)))
            mesh = np.meshgrid(*axis_data, indexing="ij")
            return axis_combination.reduce(np.array(mesh), axis=0)

        count = int(np.prod(shape[: cls.rank])) if cls.rank else 1
        data = np.stack([single() for _ in range(count)]).reshape(shape)
        return cls._from_host(grid, data, dtype, device, label)

    @classmethod
    def random_colored(
        cls, grid: GridBase, exponent: float = 0, scale: float = 1, *,
        label: str | None = None, dtype: torch.dtype | None = None, device=None,
        rng: np.random.Generator | None = None,
    ):
        """Field of random values with power-law correlations ``~ |k|^exponent``."""
        return cls.random_normal(grid, mean=0, std=scale, correlation="power law",
                                 exponent=exponent, label=label, dtype=dtype, device=device,
                                 rng=rng)

    @classmethod
    def get_class_by_rank(cls, rank: int) -> type[DataFieldBase]:
        """The field class of a tensorial rank (0, 1 or 2)."""
        from .scalar import ScalarField
        from .tensorial import Tensor2Field
        from .vectorial import VectorField

        try:
            return {0: ScalarField, 1: VectorField, 2: Tensor2Field}[rank]
        except KeyError:
            raise RankError(f"Unsupported field rank {rank}") from None

    @property
    def data_shape(self) -> tuple[int, ...]:
        return (self.grid.dim,) * self.rank + tuple(self.grid.shape)

    # -- operators ------------------------------------------------------------------------
    def apply_operator(
        self, operator: str, bc, out=None, *, label: str | None = None,
        args=None, t: float = 0.0, **op_kwargs,
    ) -> DataFieldBase:
        """Apply a differential operator, returning a field of the operator's
        output rank (a :class:`VectorField` for ``gradient``)."""
        info = self.grid._resolve_axis_operator(operator) or self.grid._get_operator_info(operator)
        if info.rank_in != self.rank:
            raise RankError(
                f"Operator `{operator}` expects rank {info.rank_in}, got rank {self.rank}"
            )
        op = self.grid.make_operator(operator, bc=bc, **op_kwargs)
        data = op(self._data, t, args)
        result = self.get_class_by_rank(info.rank_out)(self.grid, data=data, label=label)
        if out is not None:
            out._data = result._data
            return out
        return result

    # -- ghost cells ------------------------------------------------------------------------
    def get_full_data(self, bc=None, *, t: float = 0.0, args=None) -> torch.Tensor:
        """The data with one layer of ghost cells, set by `bc` (zero without)."""
        full = torch.nn.functional.pad(self._data, [1, 1] * self.grid.num_axes)
        if bc is not None:
            bcs = self.grid.get_boundary_conditions(bc, rank=self.rank)
            full = bcs.make_ghost_setter()(full, t, args)
        return full

    def set_ghost_cells(self, bc, *, args=None) -> torch.Tensor:
        """The data with ghost cells set by `bc` (fields hold no ghost cells,
        so this returns them, as ``pde_tpu``'s does)."""
        return self.get_full_data(bc, args=args)

    def get_boundary_values(self, axis: int, upper: bool, bc=None) -> torch.Tensor:
        """The values on one side: the mean of the last valid cell and its
        ghost cell (``bc=None`` takes ``auto_periodic_neumann``, as in
        ``pde_tpu``)."""
        full = self.get_full_data(bc if bc is not None else "auto_periodic_neumann")
        n = self.grid.num_axes
        sel_edge: list = [slice(1, -1)] * n
        sel_ghost: list = [slice(1, -1)] * n
        sel_edge[axis] = -2 if upper else 1
        sel_ghost[axis] = -1 if upper else 0
        lead = (slice(None),) * self.rank
        return 0.5 * (full[lead + tuple(sel_edge)] + full[lead + tuple(sel_ghost)])

    # -- interpolation ------------------------------------------------------------------------
    def make_interpolator(self, *, fill=None, full_data: bool = False, bc=None) -> Callable:
        """Return ``interp(data, points) -> values``, linear interpolation of
        the valid data (with `bc` or `full_data`, of the data with ghost
        cells) at points in grid coordinates, shape ``(..., num_axes)``.

        The points' fractional cell indices and the weights are computed in
        float64 on the data's device and the corners gathered there; the
        values come back in the data's dtype. Outside a non-periodic axis the
        nearest cells are taken, or `fill` where given."""
        grid = self.grid
        num_axes, shape, periodic = grid.num_axes, grid.shape, list(grid.periodic)
        use_ghost = bc is not None or full_data
        ghost_setter = (grid.get_boundary_conditions(bc, rank=self.rank).make_ghost_setter()
                        if bc is not None else None)

        def interp(data, points):
            data = torch.as_tensor(data)
            points = torch.as_tensor(points, dtype=torch.float64, device=data.device)
            frac = grid._grid_to_fractional(points)
            if use_ghost:
                full = torch.nn.functional.pad(data, [1, 1] * num_axes)
                if ghost_setter is not None:
                    full = ghost_setter(full)
                offset = 1
            else:
                full, offset = data, 0
            idx0, weights = [], []
            for ax in range(num_axes):
                f = frac[..., ax]
                if periodic[ax]:
                    f = torch.remainder(f, shape[ax])
                i0 = torch.floor(f).long()
                idx0.append(i0)
                weights.append(f - i0)
            result = None
            for corner in itertools.product((0, 1), repeat=num_axes):
                idx, weight = [], None
                for ax, c in enumerate(corner):
                    i = idx0[ax] + c
                    if periodic[ax]:
                        i = torch.remainder(i, shape[ax]) + offset
                    else:
                        i = torch.clamp(i + offset, 0, shape[ax] - 1 + 2 * offset)
                    idx.append(i)
                    w = weights[ax] if c else 1 - weights[ax]
                    weight = w if weight is None else weight * w
                value = full[(Ellipsis, *idx)] * weight
                result = value if result is None else result + value
            if fill is not None:
                inside = torch.ones(frac.shape[:-1], dtype=torch.bool, device=data.device)
                for ax in range(num_axes):
                    if not periodic[ax]:
                        lim = 0.0 if use_ghost else 0.5
                        inside &= (frac[..., ax] >= -0.5 - lim) & (
                            frac[..., ax] <= shape[ax] - 0.5 + lim)
                result = torch.where(inside, result, fill)
            return result.to(data.dtype)

        return interp

    def interpolate(self, point, *, bc=None, fill=None, **kwargs) -> torch.Tensor:
        """The field's values at one or several points (grid coordinates, on
        the host), on the field's device. Without `fill`, a point outside a
        non-periodic axis raises :class:`~pde_tpu_torch.grids.base.DomainError`."""
        point = np.atleast_1d(np.asarray(point, dtype=float))
        if point.shape[-1] != self.grid.num_axes:
            raise DomainError(f"Points must have {self.grid.num_axes} coordinates, "
                              f"got shape {point.shape}")
        if fill is None:
            for ax in range(self.grid.num_axes):
                if not self.grid.periodic[ax]:
                    lo, hi = self.grid.axes_bounds[ax]
                    coords = point[..., ax]
                    if np.any(coords < lo) or np.any(coords > hi):
                        raise DomainError(f"Point lies outside the grid domain: {point}")
        return self.make_interpolator(fill=fill, bc=bc)(self._data, point)

    def interpolate_to_grid(self, grid: GridBase, *, fill=None, label=None) -> DataFieldBase:
        """The field interpolated onto the cells of `grid`: directly on a grid
        of the same class, else through Cartesian coordinates (scalar fields
        only, as in ``pde_tpu``)."""
        interp = self.make_interpolator(fill=fill)
        if type(grid) is type(self.grid) and grid.num_axes == self.grid.num_axes:
            data = interp(self._data, grid.cell_coords)
            return self.__class__(grid, data=data, label=label or self.label)
        if self.rank != 0:
            raise NotImplementedError(
                "Interpolation between different grid classes requires a scalar field")
        if grid.dim != self.grid.dim:
            raise DomainError("Grids must embed in the same dimension")
        cart = grid.point_to_cartesian(np.asarray(grid.cell_coords).reshape(-1, grid.num_axes))
        data = interp(self._data, self.grid.point_from_cartesian(cart))
        return self.__class__(grid, data=data.reshape(grid.shape), label=label or self.label)

    def insert(self, point, amount) -> DataFieldBase:
        """Deposit `amount` at `point` (grid coordinates) with linear weights
        divided by the cell volumes: indices and weights in float64 on the
        field's device, then ``index_put_(accumulate=True)`` there; the
        field takes the new tensor and is returned, as ``pde_tpu``'s rebinds
        its array."""
        grid = self.grid
        data = self._data.clone()
        device = data.device
        points = torch.as_tensor(np.atleast_1d(np.asarray(point, dtype=float)), device=device)
        frac = grid._grid_to_fractional(points)
        vols = np.broadcast_to(grid.cell_volumes, grid.shape)
        uniform = not any(vols.strides)  # a Cartesian grid's one volume, broadcast
        cell_volumes = float(vols.flat[0]) if uniform else torch.as_tensor(vols.copy(),
                                                                           device=device)
        amount = torch.as_tensor(amount, device=device)
        idx0 = torch.floor(frac).long()
        w = frac - idx0
        # the index tensors address the grid axes, so the component axes go last
        target = (data.movedim(tuple(range(self.rank)), tuple(range(-self.rank, 0)))
                  if self.rank else data)
        for corner in itertools.product((0, 1), repeat=grid.num_axes):
            idx, weight = [], 1.0
            for ax, c in enumerate(corner):
                i = idx0[..., ax] + c
                i = torch.remainder(i, grid.shape[ax]) if grid.periodic[ax] else torch.clamp(
                    i, 0, grid.shape[ax] - 1)
                idx.append(i)
                weight = weight * (w[..., ax] if c else 1 - w[..., ax])
            vol = cell_volumes if uniform else cell_volumes[tuple(idx)]
            values = amount * weight / vol
            target.index_put_(tuple(idx), values.to(data.dtype), accumulate=True)
        self._data = data
        return self

    def add_interpolated(self, point, amount) -> DataFieldBase:
        """Deprecated alias of :meth:`insert`."""
        return self.insert(point, amount)

    # -- signal processing ------------------------------------------------------------------
    def smooth(self, sigma: float = 1, *, out=None, label: str | None = None) -> DataFieldBase:
        """The field smoothed by a Gaussian kernel of physical width `sigma`
        along every axis: scipy's ``gaussian_filter1d`` kernel (radius
        ``int(4 * sigma / dx + 0.5)``, normalized), ``wrap`` on periodic axes
        and ``nearest`` elsewhere, computed with torch on the field's device
        (``pde_tpu`` runs scipy on the host)."""
        data = self._data
        for ax in range(self.grid.num_axes):
            s = sigma / self.grid.discretization[ax]
            radius = int(4.0 * s + 0.5)
            x = np.arange(-radius, radius + 1)
            phi = np.exp(-0.5 / (s * s) * x**2)
            phi = phi / phi.sum()
            n, dim = self.grid.shape[ax], self.rank + ax
            pos = np.arange(-radius, n + radius)
            pos = np.mod(pos, n) if self.grid.periodic[ax] else np.clip(pos, 0, n - 1)
            padded = data.index_select(dim, torch.as_tensor(pos, device=data.device))
            total = None
            for j, weight in enumerate(phi.tolist()):
                term = padded.narrow(dim, j, n) * weight
                total = term if total is None else total + term
            data = total
        result = self.__class__(self.grid, data=data, label=label or self.label)
        if out is not None:
            out._data = result.data
            return out
        return result

    # -- plotting ---------------------------------------------------------------------------
    def get_line_data(self, scalar: str = "auto", extract: str = "auto") -> dict:
        """The data of a line plot, host numpy arrays."""
        field = self if self.rank == 0 else self.to_scalar(scalar)
        data = field.grid.get_line_data(field.to_numpy(), extract=extract)
        if self.label:
            data["label_y"] = self.label
        return data

    def get_image_data(self, scalar: str = "auto", **kwargs) -> dict:
        """The data of an image plot, host numpy arrays."""
        field = self if self.rank == 0 else self.to_scalar(scalar)
        data = field.grid.get_image_data(field.to_numpy(), **kwargs)
        data["title"] = self.label
        return data

    def get_vector_data(self, **kwargs) -> dict:
        raise NotImplementedError

    def _plot_line(self, ax, scalar: str = "auto", extract: str = "auto", **kwargs):
        line_data = self.get_line_data(scalar=scalar, extract=extract)
        (line,) = ax.plot(line_data["data_x"], np.real(line_data["data_y"]), **kwargs)
        ax.set_xlabel(line_data.get("label_x", "x"))
        ax.set_ylabel(line_data.get("label_y", self.label or ""))
        return line

    def _plot_image(self, ax, colorbar: bool = True, scalar: str = "auto", **kwargs):
        img_data = self.get_image_data(scalar=scalar)
        kwargs.setdefault("origin", "lower")
        kwargs.setdefault("extent", img_data["extent"])
        kwargs.setdefault("interpolation", "none")
        im = ax.imshow(np.real(img_data["data"]), **kwargs)
        ax.set_xlabel(img_data.get("label_x", "x"))
        ax.set_ylabel(img_data.get("label_y", "y"))
        if img_data.get("title"):
            ax.set_title(img_data["title"])
        if colorbar:
            import matplotlib.pyplot as plt

            plt.colorbar(im, ax=ax)
        return im

    def plot(self, kind: str = "auto", *args, title=None, filename=None, ax=None, **kwargs):
        """Plot the field (line plot in 1d, image in 2d) from one host copy of
        its data.

        Returns a :class:`~pde_tpu_torch.utils.plotting.PlotReference` whose
        artist :meth:`_update_plot` updates in place, as the plot trackers do.
        """
        import matplotlib.pyplot as plt

        from ..utils.plotting import PlotReference

        if ax is None:
            _, ax = plt.subplots()
        if kind == "auto":
            kind = "line" if self.grid.num_axes == 1 else "image"
        if kind == "line":
            element = self._plot_line(ax, *args, **kwargs)
        elif kind == "image":
            element = self._plot_image(ax, *args, **kwargs)
        elif kind == "vector":
            element = self._plot_vector(ax, *args, **kwargs)
        else:
            raise ValueError(f"Unknown plot kind `{kind}`")
        if title:
            ax.set_title(title)
        if filename:
            ax.figure.savefig(filename)
        return PlotReference(ax, element, dict(kwargs, kind=kind))

    def _update_plot(self, reference) -> None:
        """Update a plot produced by :meth:`plot` with this field's data."""
        kind = reference.parameters.get("kind", "auto")
        element = reference.element
        if kind == "line":
            line_data = self.get_line_data(
                scalar=reference.parameters.get("scalar", "auto"),
                extract=reference.parameters.get("extract", "auto"),
            )
            element.set_data(line_data["data_x"], np.real(line_data["data_y"]))
            reference.ax.relim()
            reference.ax.autoscale_view()
        elif kind == "image":
            img_data = self.get_image_data(scalar=reference.parameters.get("scalar", "auto"))
            data = np.real(img_data["data"])
            element.set_data(data)
            element.set_clim(float(data.min()), float(data.max()))
        elif kind == "vector":
            if reference.parameters.get("method", "quiver") != "quiver":
                raise NotImplementedError("Only quiver plots can be updated")
            data = self.get_vector_data()
            element.set_UVC(data["data_x"], data["data_y"])
        else:
            raise NotImplementedError(f"Cannot update plot kind `{kind}`")

    def _plot_vector(self, ax, **kwargs):
        raise NotImplementedError

    def _get_napari_data(self, **kwargs):
        return {self.label or "field": {"type": "image", "data": self.to_numpy()}}

    # -- reductions ---------------------------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Copy the field data to the host as a numpy array (bfloat16 data
        as float32, which holds it exactly)."""
        return to_host(self._data)

    @property
    def integral(self) -> torch.Tensor:
        """Volume integral of the field."""
        return self.grid.integrate(self._data)

    @property
    def average(self) -> torch.Tensor:
        """Mean value weighted by cell volumes."""
        return self.integral / self.grid.volume

    @property
    def magnitude(self) -> float:
        """Absolute value of the (scalarized) average, read to the host."""
        if self.rank == 0:
            return float(abs(self.average))
        return float(abs(self.to_scalar().average))

    @property
    def fluctuations(self) -> torch.Tensor:
        """Volume-weighted standard deviation (per component for rank > 0)."""
        avg = self.average
        if self.rank:
            avg = avg[(...,) + (None,) * self.grid.num_axes]
        scaled_var = self.grid.integrate((self._data - avg) ** 2) / self.grid.volume
        return torch.sqrt(scaled_var)
