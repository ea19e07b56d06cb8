"""Compute engines, their fused-window policy and the kernel operator registry.

Port of :mod:`pde_tpu.backends`. PyTorch runs eagerly, so the engines differ
only in how solvers and operators treat the hand-written CUDA kernels:

- ``torch`` (default; aliases ``auto`` and ``jax``): solvers take the fused
  kernel window when the configuration is supported and the plain PyTorch
  loop otherwise, recording the reason in ``solver.info["fused_unsupported"]``;
  ``make_operator`` serves the grid's plain operators.
- ``cuda`` (alias ``pallas``): the kernel is required. An unsupported
  configuration, or a state that does not live on a CUDA device, raises.
  ``make_operator`` serves only operators registered with a kernel
  (``laplace`` and the standalone stencil operators on 2D Cartesian grids,
  ``laplace`` on cylindrical grids) and raises
  :class:`~pde_tpu_torch.ops.KernelUnsupportedError` for any other.
- ``numpy``: never fused; the plain step loop (the debugging engine).
"""

from __future__ import annotations

from typing import Callable

import torch


class TorchBackend:
    """Default engine: plain PyTorch, fused kernel windows where supported."""

    name = "torch"
    #: "auto" takes a supported kernel window, "require" makes it mandatory,
    #: "never" disables it
    fused_windows = "auto"

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    def make_operator(self, grid, operator: str, bc, **kwargs) -> Callable:
        """The grid's plain operator ``op(data, t=0.0, args=None)``."""
        return grid.make_operator(operator, bc=bc, **kwargs)


class CudaBackend(TorchBackend):
    """Hand-written CUDA kernels are required; anything else raises.

    The operator registry maps (grid class, operator name) to a kernel
    factory ``factory(grid, bcs, **kwargs)``, looked up along the grid's MRO,
    as ``pde_tpu``'s ``PallasBackend`` does. It is honest: an operator
    without a registered kernel raises instead of serving the plain factory.
    """

    name = "cuda"
    fused_windows = "require"

    #: (grid class, operator name) -> factory(grid, bcs, **kwargs)
    _operators: dict[tuple[type, str], Callable] = {}

    @classmethod
    def register_operator(cls, grid_cls: type, name: str, factory=None):
        """Register a kernel operator factory for a grid class."""

        def register(factory):
            cls._operators[(grid_cls, name)] = factory
            return factory

        if factory is None:
            return register
        return register(factory)

    @classmethod
    def get_registered_factory(cls, grid, operator: str):
        for klass in type(grid).__mro__:
            if (klass, operator) in cls._operators:
                return cls._operators[(klass, operator)]
        return None

    @classmethod
    def registered_operators(cls, grid) -> list[str]:
        """Operator names with a kernel for this grid (via the MRO)."""
        mro = set(type(grid).__mro__)
        return sorted({name for klass, name in cls._operators if klass in mro})

    def make_operator(self, grid, operator: str, bc, **kwargs) -> Callable:
        """The kernel operator ``op(data, t=0.0, args=None)``.

        The conditions are built at rank 0, so one scalar triplet per side
        applies to every component plane, as in ``pde_tpu``'s kernel.
        Raises :class:`~pde_tpu_torch.ops.KernelUnsupportedError` (a
        ``NotImplementedError``) for an operator without a kernel and for a
        configuration the kernel does not take.
        """
        from .grids.boundaries.axes import BoundariesList
        from .ops.cuda_cartesian import KernelUnsupportedError

        factory = self.get_registered_factory(grid, operator)
        if factory is None:
            raise KernelUnsupportedError(
                f"backend='cuda' has no kernel for operator {operator!r} on "
                f"{type(grid).__name__}; registered: {self.registered_operators(grid)} "
                "(backend='torch' serves every operator)"
            )
        bcs = grid.get_boundary_conditions(bc)
        if not isinstance(bcs, BoundariesList):  # a BoundariesSetter
            raise KernelUnsupportedError("backend='cuda' operators require per-axis BCs")
        return factory(grid, bcs, **kwargs)


class NumpyBackend(TorchBackend):
    """Plain step loops only (no fused windows)."""

    name = "numpy"
    fused_windows = "never"


def _require_kernel_options(operator: str, options: dict, defaults: dict) -> None:
    """Raise :class:`~.ops.KernelUnsupportedError` for an option of the plain
    operator that no kernel takes (``spectral=True``, one-sided differences,
    ``central=False``, a corner weight given by argument): ``backend="torch"``
    serves them."""
    from .ops.cuda_cartesian import KernelUnsupportedError

    for name, value in options.items():
        if name not in defaults or value != defaults[name]:
            raise KernelUnsupportedError(
                f"backend='cuda' has no kernel for {operator}({name}={value!r}); "
                "backend='torch' serves it with plain torch")


def _laplace_factory(grid, bcs, **options):
    """``laplace`` through the 2D affine kernel at ``a = 0, b = 1, k = 1``
    (on a cylindrical grid its radial mode), as ``pde_tpu``'s
    ``make_laplace_pallas`` does; per-point and time-dependent side values
    reach it as side inputs (B1(c)), the latter at the call's time `t` (or
    ``args["t"]``)."""
    from .ops import cuda_cartesian as cc

    _require_kernel_options("laplace", options, {"spectral": False, "corner_weight": None})

    specs = {}

    def spec_for(dtype):
        if dtype not in specs:
            specs[dtype] = cc.affine_laplace_spec(grid, a=0.0, b=1.0, k=1, dtype=dtype, bcs=bcs)
        return specs[dtype]

    # check the configuration now
    inputs = cc.AffineSideInputs(grid, bcs) if spec_for(torch.float32).has_sides else None

    def laplace(data, t=0.0, args=None):
        sides = None
        if inputs is not None:
            if isinstance(args, dict) and "t" in args:
                t = args["t"]
            sides = inputs.for_pass(data.dtype, data.device, [float(t)])
        return cc.affine_laplace_2d(data, spec_for(data.dtype), sides=sides)

    return laplace


def _stencil_factory(op_name: str) -> Callable:
    def factory(grid, bcs, **options):
        from .ops.cuda_stencil_op_2d import make_stencil_op_2d

        _require_kernel_options(op_name, options, {"method": "central", "central": True,
                                                   "corner_weight": None})
        return make_stencil_op_2d(grid, op_name, bcs)

    return factory


def _register_default_cuda_operators() -> None:
    from .grids.cartesian import CartesianGrid
    from .grids.cylindrical import CylindricalSymGrid
    from .ops.cuda_stencil_op_2d import OPERATORS

    CudaBackend.register_operator(CartesianGrid, "laplace", _laplace_factory)
    CudaBackend.register_operator(CylindricalSymGrid, "laplace", _laplace_factory)
    for op_name in OPERATORS:
        CudaBackend.register_operator(CartesianGrid, op_name, _stencil_factory(op_name))
    # As in pde_tpu, by design: the polar and spherical grids are 1D radial
    # grids, where a kernel has nothing to win (a stencil over a few thousand
    # points, no pass over device memory to block), so no operator of theirs
    # is registered; and the cylindrical grid registers only laplace (its
    # rank-1 and rank-2 operators carry v_r/r cross terms the stencil-operator
    # kernel does not model; in a rhs they fuse through the radial helpers of
    # the expression kernel). Those raise like any unregistered operator.


_register_default_cuda_operators()


_ENGINES = {
    "torch": TorchBackend,
    "auto": TorchBackend,
    "jax": TorchBackend,
    "numba": TorchBackend,
    "numba_mpi": TorchBackend,
    "scipy": TorchBackend,
    "cuda": CudaBackend,
    "pallas": CudaBackend,
    "numpy": NumpyBackend,
}


def registered_backends() -> list[str]:
    """Names resolvable by :func:`get_backend`."""
    return sorted(_ENGINES)


def get_backend(backend: str | TorchBackend = "auto") -> TorchBackend:
    """Return the compute engine for a name (``KeyError`` when unknown)."""
    if isinstance(backend, TorchBackend):
        return backend
    try:
        return _ENGINES[str(backend)]()
    except KeyError:
        raise KeyError(f"Backend `{backend}` is not registered") from None
