"""Spatially correlated (colored) random fields by spectral synthesis.

Port of :mod:`pde_tpu.utils.spectral`. For random fields the numbers come
from a ``numpy.random.Generator`` in numpy on the host, exactly as
``pde_tpu``'s do, so a random field made with the same generator equals
``pde_tpu``'s; the field constructors copy them to the device once. The
in-step correlated noise of SDEs (:func:`make_correlated_noise_torch`,
``make_correlated_noise_jax`` there) draws on the device from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _make_corr_spectrum(correlation: str, **kwargs) -> Callable | None:
    """The square root of the power spectrum as a function of the squared
    wavenumbers, or None for uncorrelated noise."""
    if correlation in ("none", "delta"):
        return None
    if correlation == "gaussian":
        length_scale = kwargs.pop("length_scale", 1)
        if length_scale == 0:
            return None
        return lambda k2s: np.exp(-0.5 * length_scale**2 * k2s)
    if correlation == "power law":
        exponent = kwargs.pop("exponent", 0)
        if exponent == 0:
            return None
        return lambda k2s: k2s ** (exponent / 4)
    if correlation == "cosine":
        length_scale = kwargs.pop("length_scale", 1)
        sharpness2 = kwargs.pop("sharpness", 10) ** 2
        return lambda k2s: np.exp(-sharpness2 * (length_scale * np.sqrt(k2s) - 1) ** 2)
    raise ValueError(f"Unknown correlation `{correlation}`")


def _spectral_scaling(shape, discretization, corr_spectrum) -> np.ndarray:
    """Mode amplitudes normalized so that the field has unit variance."""
    dim = len(shape)
    dx_arr = np.broadcast_to(discretization, (dim,))
    k2s = np.array(0.0)
    for i in range(dim):
        k = np.fft.fftfreq(shape[i], dx_arr[i])
        k2s = np.add.outer(k2s, k**2)
    k2s.flat[0] = 1
    S_k = np.asarray(corr_spectrum(k2s), dtype=float)
    S_k.flat[0] = 0
    S_k = S_k / np.sum(S_k) * (np.prod(shape) ** 2)
    return np.sqrt(S_k)


def make_correlated_noise(
    shape: tuple[int, ...],
    correlation: str = "none",
    *,
    discretization=1.0,
    dtype=float,
    rng: np.random.Generator | None = None,
    **kwargs,
) -> Callable[[], np.ndarray]:
    """Return a function making host arrays of random values with the given
    spatial correlation: ``none``/``delta``, ``gaussian`` (``length_scale``),
    ``power law`` (``exponent``) or ``cosine`` (``length_scale``,
    ``sharpness``)."""
    rng = np.random.default_rng(rng)
    dtype = np.dtype(dtype)
    ret_complex = issubclass(dtype.type, np.complexfloating)
    corr_spectrum = _make_corr_spectrum(correlation, **kwargs)

    if corr_spectrum is None:
        if ret_complex:
            return lambda: (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)
        return lambda: rng.normal(size=shape).astype(dtype)

    scaling = _spectral_scaling(shape, discretization, corr_spectrum)
    dim = len(shape)

    def noise_corr() -> np.ndarray:
        arr = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        arr *= scaling
        res = np.fft.ifftn(arr, s=shape, axes=range(dim))
        return res.astype(dtype) if ret_complex else res.real.astype(dtype)

    return noise_corr


def make_correlated_noise_torch(
    shape: tuple[int, ...],
    correlation: str = "none",
    *,
    discretization=1.0,
    dtype=torch.float64,
    **kwargs,
) -> Callable:
    """Return ``noise(generator) -> tensor``: a random field of `dtype` with
    the given spatial correlation, drawn on the generator's device, for use
    inside SDE steps (``pde_tpu``'s ``make_correlated_noise_jax``; `dtype` is
    the port's, since torch tensors carry theirs). The spectral scaling is
    computed once on the host and kept on each device it is used on; the
    modes' real and imaginary parts are two normal draws, transformed by
    ``torch.fft.ifftn``."""
    corr_spectrum = _make_corr_spectrum(correlation, **kwargs)
    if corr_spectrum is None:
        return lambda generator: torch.randn(shape, generator=generator, dtype=dtype,
                                             device=generator.device)

    host_scaling = _spectral_scaling(shape, discretization, corr_spectrum)
    scalings: dict = {}
    dims = tuple(range(len(shape)))

    def noise_corr(generator):
        device = generator.device
        if device not in scalings:
            scalings[device] = torch.as_tensor(host_scaling, dtype=dtype, device=device)
        real = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        imag = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        modes = torch.complex(real, imag) * scalings[device]
        return torch.fft.ifftn(modes, s=shape, dim=dims).real

    return noise_corr
