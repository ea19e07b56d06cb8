"""Global configuration: the keys the ported main path reads.

Port of :mod:`pde_tpu.utils.config` restricted to the keys the port reads:
the default device, the device repeat of decomposed runs, the operator keys
and the SDE keys; and :func:`environment`. Values
live in typed :class:`Parameter` objects addressed by dotted keys; calling the
config object gives a context manager that overrides values temporarily.
"""

from __future__ import annotations

import contextlib
import platform
import sys
from dataclasses import dataclass
from typing import Any


@dataclass
class Parameter:
    """A single configuration parameter with metadata."""

    name: str
    default_value: Any = None
    cls: Any = object
    description: str = ""

    def convert(self, value: Any) -> Any:
        if self.cls is object or value is None:
            return value
        return self.cls(value)


class Config:
    """Flat mapping of dotted keys to :class:`Parameter` values, with
    ``pde_tpu``'s access modes:

    * ``insert``: new keys may be added freely
    * ``update``: only existing keys may be changed (unknown keys raise
      ``KeyError``)
    * ``locked``: no changes allowed
    """

    def __init__(self, parameters=(), mode: str = "update"):
        self._params = {p.name: p for p in parameters or ()}
        self.mode = mode

    def __getitem__(self, key: str) -> Any:
        if key in self._params:
            return self._params[key].default_value
        prefix = key + "."
        sub = {k: p.default_value for k, p in self._params.items() if k.startswith(prefix)}
        if not sub:
            raise KeyError(key)
        return sub

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key: str, value: Any) -> None:
        if self.mode == "locked":
            raise RuntimeError("Configuration is locked")
        if key not in self._params:
            if self.mode != "insert":
                raise KeyError(f"Unknown configuration key `{key}`")
            self._params[key] = Parameter(key, value)
            return
        param = self._params[key]
        param.default_value = param.convert(value)

    def __contains__(self, key: str) -> bool:
        return key in self._params

    def items(self) -> list[tuple[str, Any]]:
        return list(self.to_dict().items())

    def to_dict(self) -> dict[str, Any]:
        return {k: p.default_value for k, p in self._params.items()}

    def __iter__(self):
        return iter(self.to_dict())

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.to_dict()})"

    @contextlib.contextmanager
    def __call__(self, values: dict[str, Any] | None = None, **kwargs):
        """Context manager temporarily changing configuration values (also
        of a locked config, as in ``pde_tpu``)."""
        overrides = dict(values or {})
        overrides.update(kwargs)
        saved = {k: self[k] for k in overrides}
        mode, self.mode = self.mode, "update"
        try:
            for k, v in overrides.items():
                self[k] = v
            self.mode = mode
            yield self
        finally:
            self.mode = "update"
            for k, v in saved.items():
                self[k] = v
            self.mode = mode


DEFAULT_CONFIG = [
    Parameter(
        "boundaries.accept_lists",
        True,
        bool,
        "Whether the list form of boundary conditions (one entry per axis, with a "
        "DeprecationWarning) and the {'low': ..., 'high': ...} form are accepted",
    ),
    Parameter(
        "operators.conservative_stencil",
        True,
        bool,
        "Whether the spherical grids' laplace, divergence, tensor_divergence and "
        "tensor_double_divergence take the conservative flux form (shell volumes) "
        "or naive finite differences, as in pde_tpu",
    ),
    Parameter(
        "operators.tensor_symmetry_check",
        True,
        bool,
        "Accepted for compatibility with pde_tpu and not read (pde_tpu does not "
        "read it either)",
    ),
    Parameter(
        "operators.cartesian.default_backend",
        "auto",
        str,
        "Accepted for compatibility with pde_tpu and not read: the port's field "
        "operators run plain torch ops, and its kernels are chosen by the solvers' "
        "backend or `get_backend('cuda')`",
    ),
    Parameter(
        "device",
        "cuda",
        str,
        "Device of the tensor of a field made from numbers, a numpy array or a "
        "string without `device=` (a tensor passed in keeps its own device); "
        "'cpu' asks for the CPU",
    ),
    Parameter(
        "parallel.devices_per_device",
        1,
        int,
        "How many blocks of a decomposed grid each device holds by default: the "
        "default device list of a GridMesh repeats every device of the configured "
        "type this many times (4 runs a 2x2 mesh on one card; the tests use 8, as "
        "pde_tpu's tests use 8 virtual CPU devices)",
    ),
    Parameter(
        "operators.cartesian.laplacian_2d_corner_weight",
        0.0,
        float,
        "Weight of corner points in the 2d Cartesian Laplacian stencil "
        "(1/2: Oono-Puri, 1/3: Patra-Karttunen)",
    ),
    Parameter(
        "sde.rng_impl",
        "threefry2x32",
        str,
        "Accepted for compatibility with pde_tpu and not read: the port has one "
        "generator family, torch's generators for staged increments and Philox4x32-10 "
        "inside the CUDA kernel",
    ),
    Parameter(
        "sde.increment_dist",
        "normal",
        str,
        "Distribution of Euler-Maruyama noise increments: 'normal' (default; "
        "required for strong/pathwise convergence), 'irwin4' (sum of 4 uniforms, "
        "exact first three moments, weak order 1 preserved), 'rademacher' (two-point "
        "law, the minimal weak-order-1 increment)",
    ),
    Parameter(
        "sde.kernel_noise",
        "auto",
        str,
        "Where fused SDE windows generate increments: 'auto' (default; inside the "
        "kernel for the cheap weak laws, staged through device memory from torch's "
        "generator for 'normal'), 'on' (always inside the kernel, Box-Muller for "
        "'normal'), 'off' (always staged)",
    ),
    Parameter(
        "numba.multithreading_threshold",
        256**2,
        int,
        "Unused compatibility setting: accepted for compatibility with pde_tpu and "
        "not read",
    ),
]


config = Config(DEFAULT_CONFIG)


def default_device(device=None):
    """`device` when given, else the config key ``device``."""
    return config["device"] if device is None else device


def environment() -> dict[str, Any]:
    """Diagnostic information about the environment: the package, Python,
    the config, torch, CUDA and the devices (in place of ``pde_tpu``'s jax
    entries), and the versions of the packages the port uses."""
    import torch

    import pde_tpu_torch

    cuda = torch.cuda.is_available()
    env: dict[str, Any] = {
        "package version": pde_tpu_torch.__version__,
        "python version": sys.version,
        "platform": platform.platform(),
        "config": config.to_dict(),
        "torch version": torch.__version__,
        "torch CUDA version": torch.version.cuda,
        "CUDA available": cuda,
        "CUDA devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else [],
        "default dtype": str(torch.get_default_dtype()),
    }
    for pkg in ("numpy", "sympy", "scipy", "h5py", "matplotlib"):
        try:
            env[f"{pkg} version"] = __import__(pkg).__version__
        except ImportError:
            env[f"{pkg} version"] = "not available"
    return env


def packages_from_requirements(requirements_file) -> list[str]:
    """Read package names from a requirements file (``pde_tpu``'s helper): a
    name a line, its version specifier cut, comments and blank lines skipped;
    an empty list where the file cannot be read."""
    try:
        with open(requirements_file) as fh:
            return [
                line.split(">=")[0].split("==")[0].strip()
                for line in fh
                if line.strip() and not line.startswith("#")
            ]
    except OSError:
        return []
