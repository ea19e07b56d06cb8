"""Typing protocols for the framework's callables.

The port's own copy of :mod:`pde_tpu.utils.typing`; arrays are numpy data or
torch tensors.
"""

from __future__ import annotations

from typing import Any, Protocol, Sequence, Union

import numpy as np
import torch

Number = Union[int, float, complex]
NumberOrArray = Union[Number, np.ndarray]
FloatingArray = np.ndarray
NumericArray = np.ndarray
ArrayLike = Union[np.ndarray, torch.Tensor, float, int]
BackendType = str


class OperatorType(Protocol):
    """Differential operator on raw (valid) field data."""

    def __call__(self, data: Any, t: float = 0.0, args: Any = None) -> Any: ...


class OperatorNoBCType(Protocol):
    """Differential operator applied to full data including ghost cells."""

    def __call__(self, data_full: Any) -> Any: ...


class GhostCellSetter(Protocol):
    """Function filling the ghost layer of a full data array."""

    def __call__(self, data_full: Any, t: float = 0.0, args: Any = None) -> Any: ...


class VirtualPointEvaluator(Protocol):
    def __call__(self, arr: Any, idx: tuple[int, ...], args: Any = None) -> float: ...


class StepperType(Protocol):
    """Advances a state field from t_start to t_end, returning (state, t)."""

    def __call__(self, state: Any, t_start: float, t_end: float) -> tuple[Any, float]: ...


class StepperHook(Protocol):
    """Post-step hook on raw data leaves."""

    def __call__(self, leaves: Sequence[Any], t: float, post_step_data: Any) -> tuple: ...
