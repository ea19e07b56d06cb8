"""Fields of a single tensorial rank.

Port of :mod:`pde_tpu.fields.datafield_base` restricted to what the main path
reads: construction on a device and dtype, random initial states, operator
application (returning the field class of the operator's output rank),
volume averages and fluctuations. A field made from numbers, a
numpy array or a string lands on the config key ``device`` (the card by
default) unless ``device=`` says otherwise; a tensor keeps its own device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..grids.base import GridBase
from ..ops.common import require_default
from ..utils.config import default_device
from .base import FieldBase, RankError


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
        # data with ghost cells (``pde_tpu`` cuts the valid cells out) is ROADMAP A4
        require_default("with_ghost_cells", with_ghost_cells, False)
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
            arr = torch.as_tensor(data, device=device)
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
    def is_complex(self) -> bool:
        return self._data.is_complex()

    # -- operators ------------------------------------------------------------------------
    def apply_operator(
        self, operator: str, bc, out=None, *, label: str | None = None,
        args=None, t: float = 0.0, **op_kwargs,
    ) -> DataFieldBase:
        """Apply a differential operator, returning a field of the operator's
        output rank (a :class:`VectorField` for ``gradient``)."""
        info = self.grid._get_operator_info(operator)
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

    # -- reductions ---------------------------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Copy the field data to the host as a numpy array."""
        return self._data.detach().cpu().numpy()

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
