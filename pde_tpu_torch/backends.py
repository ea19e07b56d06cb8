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
- ``numpy``: never fused; the plain step loop (the debugging engine); its
  native data are host numpy arrays.

Every engine also carries ``pde_tpu``'s engine methods (``numpy_to_native``,
``compile_function``, ``make_pde_rhs``, ``make_stepper``, ...), each
delegating to the grid, field, PDE or solver as there. The native type is a
tensor on the config key ``device`` (the numpy engine's a numpy array),
nothing is compiled (PyTorch runs eagerly), and a synchronizer of one
controller is the identity.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


class TorchBackend:
    """Default engine: plain PyTorch, fused kernel windows where supported."""

    name = "torch"
    #: "auto" takes a supported kernel window, "require" makes it mandatory,
    #: "never" disables it
    fused_windows = "auto"

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # -- data movement ---------------------------------------------------------------------
    def numpy_to_native(self, arr, dtype=None) -> torch.Tensor:
        """`arr` as a tensor on the config key ``device`` (`dtype` a torch or
        numpy dtype; ``pde_tpu``'s bfloat16 arrays keep their bits)."""
        from .fields.base import from_host, numpy_dtype_to_torch
        from .utils.config import default_device

        if dtype is not None and not isinstance(dtype, torch.dtype):
            dtype = numpy_dtype_to_torch(dtype)
        return torch.as_tensor(from_host(arr), dtype=dtype, device=default_device())

    def native_to_numpy(self, arr) -> np.ndarray:
        """A tensor's values as a host numpy array (bfloat16 as float32)."""
        from .fields.base import to_host

        return to_host(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)

    # -- compilation -------------------------------------------------------------------------
    def compile_function(self, func: Callable, **kwargs) -> Callable:
        """`func` itself: PyTorch runs eagerly (``pde_tpu``'s ``jax.jit``)."""
        return func

    # -- factories (delegate to the grid, field, PDE and solver layers) -------------------------
    def make_operator(self, grid, operator: str, bc, **kwargs) -> Callable:
        """The grid's plain operator ``op(data, t=0.0, args=None)``."""
        return grid.make_operator(operator, bc=bc, **kwargs)

    def make_operator_no_bc(self, grid, operator: str, **kwargs) -> Callable:
        return grid.make_operator_no_bc(operator, **kwargs)

    def get_operator_info(self, grid, operator: str):
        return grid._get_operator_info(operator)

    def make_ghost_cell_setter(self, bcs) -> Callable:
        return bcs.make_ghost_setter()

    def make_integrator(self, grid) -> Callable:
        return lambda arr: grid.integrate(arr)

    def make_interpolator(self, field, **kwargs) -> Callable:
        return field.make_interpolator(**kwargs)

    def make_inner_prod_operator(self, field, **kwargs) -> Callable:
        return field.make_dot_operator(**kwargs)

    def make_outer_prod_operator(self, field) -> Callable:
        return field.make_outer_prod_operator()

    def make_pde_rhs(self, pde, state) -> Callable:
        return pde.make_pde_rhs(state)

    def make_expression_function(self, expression, **kwargs) -> Callable:
        return expression._get_function(backend="torch", **kwargs)

    def make_mpi_synchronizer(self, operator: str = "MAX", **kwargs) -> Callable:
        """The identity: one controller drives every block (``pde_tpu``'s too)."""
        return lambda value: value

    def make_gaussian_noise(self, state, rng=None) -> Callable:
        """``noise()``: standard normal values of the state's shape, dtype and
        device, from a ``torch.Generator`` seeded from ``numpy``'s `rng` (its
        stream differs from ``pde_tpu``'s JAX keys)."""
        seed = int(np.random.default_rng(rng).integers(0, 2**31 - 1))
        data = state.data
        dtype = data.dtype if data.dtype.is_floating_point else torch.get_default_dtype()
        generator = torch.Generator(device=data.device).manual_seed(seed)

        def noise():
            return torch.randn(data.shape, generator=generator, dtype=dtype, device=data.device)

        return noise

    def make_stepper(self, solver, state, dt=None) -> Callable:
        return solver.make_stepper(state, dt)


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


def _on_host(engine, func: Callable) -> Callable:
    """`func` taking host arrays (numpy, or anything ``torch.as_tensor``
    takes) where it takes tensors, its tensors (and lists of them) returned
    as numpy arrays."""

    def tensor(value):
        from .fields.base import from_host

        if isinstance(value, np.ndarray):
            return torch.as_tensor(from_host(value))
        if isinstance(value, (list, tuple)):  # a rhs's leaves
            return type(value)(tensor(v) for v in value)
        return value

    def host(*args, **kwargs):
        out = func(*map(tensor, args), **kwargs)
        if isinstance(out, (list, tuple)):
            return type(out)(engine.native_to_numpy(o) if isinstance(o, torch.Tensor) else o
                             for o in out)
        return engine.native_to_numpy(out) if isinstance(out, torch.Tensor) else out

    return host


class NumpyBackend(TorchBackend):
    """Plain step loops only (no fused windows), with host numpy arrays as
    its native data and eager functions taking and returning them, as
    ``pde_tpu``'s numpy engine."""

    name = "numpy"
    fused_windows = "never"

    def numpy_to_native(self, arr, dtype=None) -> np.ndarray:
        if isinstance(arr, torch.Tensor):
            arr = self.native_to_numpy(arr)
        if isinstance(dtype, torch.dtype):
            from .fields.base import torch_dtype_to_numpy

            dtype = torch_dtype_to_numpy(dtype)
        return np.asarray(arr, dtype=dtype)


def _host_factory(method: Callable) -> Callable:
    """The numpy engine's `method`: the torch engine's, its function run on
    host arrays (:func:`_on_host`)."""

    @functools.wraps(method)
    def factory(self, *args, **kwargs):
        return _on_host(self, method(self, *args, **kwargs))

    return factory


# the factories whose functions the numpy engine runs on host arrays
for _name in ("compile_function", "make_operator", "make_operator_no_bc",
              "make_ghost_cell_setter", "make_integrator", "make_interpolator",
              "make_inner_prod_operator", "make_outer_prod_operator", "make_pde_rhs",
              "make_expression_function", "make_mpi_synchronizer", "make_gaussian_noise"):
    setattr(NumpyBackend, _name, _host_factory(getattr(TorchBackend, _name)))


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


class BackendRegistry(dict):
    """Registry mapping engine names to instances, made at first use (as
    ``pde_tpu``'s; a name may carry a suffix after ``:``)."""

    def __missing__(self, key):
        engine = _ENGINES.get(str(key).split(":")[0])
        if engine is None:
            raise KeyError(f"Backend `{key}` is not registered")
        self[key] = instance = engine()
        return instance


backends = BackendRegistry()


def registered_backends() -> list[str]:
    """Names resolvable by :func:`get_backend`."""
    return sorted(_ENGINES)


def get_backend(backend: str | TorchBackend = "auto") -> TorchBackend:
    """Return the compute engine for a name (``KeyError`` when unknown)."""
    if isinstance(backend, TorchBackend):
        return backend
    return backends[str(backend)]
