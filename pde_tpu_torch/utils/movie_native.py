"""ctypes bindings for the native FFV1 movie codec.

The port's own copy of :mod:`pde_tpu.utils.movie_native`. The codec
(``pde_tpu_torch/native/movie_codec.cpp``, libavformat/libavcodec) replaces
the external ``ffmpeg`` subprocess py-pde shells out to: the same on-disk
format (FFV1 in a container chosen by extension, version-1 JSON metadata in
the ``comment`` tag), no binary dependency.
"""

from __future__ import annotations

import ctypes
import functools
import logging

import numpy as np


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL | None:
    from ..native import build_library

    path = build_library(
        "pdemovie", ["movie_codec.cpp"],
        ["avformat", "avcodec", "avutil", "swscale"],
    )
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as err:  # a library the loader cannot link here
        logging.getLogger(__name__).warning("loading native %s failed: %s", path, err)
        return None
    lib.mc_last_error.restype = ctypes.c_char_p
    lib.mcw_open.restype = ctypes.c_void_p
    lib.mcw_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p,
    ]
    lib.mcw_open2.restype = ctypes.c_void_p
    lib.mcw_open2.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.mcw_open3.restype = ctypes.c_void_p
    lib.mcw_open3.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    lib.mcw_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mcw_close.argtypes = [ctypes.c_void_p]
    lib.mcr_open.restype = ctypes.c_void_p
    lib.mcr_open.argtypes = [ctypes.c_char_p]
    lib.mcr_probe.restype = ctypes.c_void_p
    lib.mcr_probe.argtypes = [ctypes.c_char_p]
    lib.mcr_pixfmt.restype = ctypes.c_char_p
    lib.mcr_pixfmt.argtypes = [ctypes.c_void_p]
    for fn in ("mcr_width", "mcr_height", "mcr_bits"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.mcr_nframes.restype = ctypes.c_int64
    lib.mcr_nframes.argtypes = [ctypes.c_void_p]
    lib.mcr_comment.restype = ctypes.c_char_p
    lib.mcr_comment.argtypes = [ctypes.c_void_p]
    lib.mcr_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.mcr_data.argtypes = [ctypes.c_void_p]
    lib.mcr_data_size.restype = ctypes.c_int64
    lib.mcr_data_size.argtypes = [ctypes.c_void_p]
    lib.mcr_close.argtypes = [ctypes.c_void_p]
    return lib


def is_available() -> bool:
    """Whether the native codec built (toolchain + libav present)."""
    return _lib() is not None


class NativeMovieError(RuntimeError):
    pass


def _err(lib) -> str:
    return lib.mc_last_error().decode(errors="replace")


_PIX_BYTES = {"gray": 1, "gray16le": 2, "rgb24": 3, "rgba": 4}


class MovieWriter:
    """Streams raw packed frames into an encoded movie file.

    The default configuration (``bits`` given) is the MovieStorage format:
    grayscale FFV1.  Passing ``codec``/``pix_fmt_in``/``pix_fmt_out``
    instead selects any packed-input encode, e.g. rgb24 → yuv420p H.264
    for rendered-figure movies (in-process swscale conversion).
    """

    def __init__(self, filename: str, width: int, height: int,
                 bits: int | None = None, comment: str = "",
                 fps: float = 30, codec: str | None = None,
                 pix_fmt_in: str | None = None,
                 pix_fmt_out: str | None = None):
        lib = _lib()
        if lib is None:
            raise NativeMovieError("native movie codec unavailable")
        self._lib = lib
        # exact rational frame rate (fractional rates like 23.976 resolve
        # to 24000/1001, matching what `ffmpeg -r 23.976` would set)
        from fractions import Fraction

        rate = Fraction(fps).limit_denominator(1_000_000)
        if bits is not None:
            if bits not in (8, 16):
                raise ValueError("bits_per_channel must be 8 or 16")
            codec = "ffv1"
            pix_fmt_in = pix_fmt_out = "gray16le" if bits == 16 else "gray"
            self._frame_bytes = width * height * (bits // 8)
        else:
            if codec is None or pix_fmt_in is None or pix_fmt_out is None:
                raise ValueError(
                    "either bits or codec/pix_fmt_in/pix_fmt_out is required"
                )
            self._frame_bytes = width * height * _PIX_BYTES[pix_fmt_in]
        self._h = lib.mcw_open3(
            str(filename).encode(), width, height, rate.numerator,
            rate.denominator, comment.encode(), codec.encode(),
            pix_fmt_in.encode(), pix_fmt_out.encode(),
        )
        if not self._h:
            raise NativeMovieError(f"open failed: {_err(lib)}")

    def write(self, payload: bytes) -> None:
        if len(payload) != self._frame_bytes:
            raise ValueError(
                f"frame payload is {len(payload)} bytes, "
                f"expected {self._frame_bytes}"
            )
        if self._lib.mcw_write(self._h, payload) < 0:
            raise NativeMovieError(f"write failed: {_err(self._lib)}")

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, None
            if self._lib.mcw_close(h) < 0:
                raise NativeMovieError(f"close failed: {_err(self._lib)}")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class MovieProbe:
    """Container/stream metadata only — no frames are decoded.

    Works for any pixel format (the decoder only handles gray8/gray16le);
    ``n_frames`` is None when the container header does not record it.
    """

    def __init__(self, filename: str):
        lib = _lib()
        if lib is None:
            raise NativeMovieError("native movie codec unavailable")
        h = lib.mcr_probe(str(filename).encode())
        if not h:
            raise NativeMovieError(f"probe failed: {_err(lib)}")
        try:
            self.width = lib.mcr_width(h)
            self.height = lib.mcr_height(h)
            self.bits = lib.mcr_bits(h)
            n = int(lib.mcr_nframes(h))
            self.n_frames = n if n >= 0 else None
            self.comment = lib.mcr_comment(h).decode(errors="replace")
            self.pix_fmt = lib.mcr_pixfmt(h).decode(errors="replace")
        finally:
            lib.mcr_close(h)


class MovieInfo:
    """Decoded movie: metadata + all frames as one contiguous array."""

    def __init__(self, filename: str):
        lib = _lib()
        if lib is None:
            raise NativeMovieError("native movie codec unavailable")
        h = lib.mcr_open(str(filename).encode())
        if not h:
            raise NativeMovieError(f"decode failed: {_err(lib)}")
        try:
            self.width = lib.mcr_width(h)
            self.height = lib.mcr_height(h)
            self.bits = lib.mcr_bits(h)
            self.n_frames = int(lib.mcr_nframes(h))
            self.comment = lib.mcr_comment(h).decode(errors="replace")
            self.pix_fmt = lib.mcr_pixfmt(h).decode(errors="replace")
            size = int(lib.mcr_data_size(h))
            buf = ctypes.cast(
                lib.mcr_data(h), ctypes.POINTER(ctypes.c_uint8 * size)
            ).contents
            dtype = np.uint16 if self.bits == 16 else np.uint8
            # copy out before the handle (and its buffer) is freed
            self.frames = (
                np.frombuffer(buf, dtype=dtype)
                .reshape(self.n_frames, self.height, self.width)
                .copy()
            )
        finally:
            lib.mcr_close(h)
