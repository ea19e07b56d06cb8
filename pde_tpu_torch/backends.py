"""Compute engines and their fused-window policy.

Port of :mod:`pde_tpu.backends`. PyTorch runs eagerly, so the engines differ
only in how solvers treat the hand-written CUDA kernels:

- ``torch`` (default; aliases ``auto`` and ``jax``): solvers take the fused
  kernel window when the configuration is supported and the plain PyTorch
  loop otherwise, recording the reason in ``solver.info["fused_unsupported"]``.
- ``cuda`` (alias ``pallas``): the kernel is required. An unsupported
  configuration, or a state that does not live on a CUDA device, raises.
- ``numpy``: never fused; the plain step loop (the debugging engine).
"""

from __future__ import annotations


class TorchBackend:
    """Default engine: plain PyTorch, fused kernel windows where supported."""

    name = "torch"
    #: "auto" takes a supported kernel window, "require" makes it mandatory,
    #: "never" disables it
    fused_windows = "auto"

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"


class CudaBackend(TorchBackend):
    """Hand-written CUDA kernels are required; anything else raises."""

    name = "cuda"
    fused_windows = "require"


class NumpyBackend(TorchBackend):
    """Plain step loops only (no fused windows)."""

    name = "numpy"
    fused_windows = "never"


_ENGINES = {
    "torch": TorchBackend,
    "auto": TorchBackend,
    "jax": TorchBackend,
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
