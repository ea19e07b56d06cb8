"""Movie output of rendered figures (H.264).

The port's own copy of :mod:`pde_tpu.visualization.movies`. Frames are
encoded in-process by the native codec
(``pde_tpu_torch/native/movie_codec.cpp``, rgb24 → yuv420p via swscale and
libx264) when libav is linkable, else through an ``ffmpeg`` subprocess pipe
driven as py-pde drives it; without either, making a movie raises.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Any

import numpy as np

from ..utils import movie_native


class Movie:
    """Writes matplotlib figures as frames into an H.264 movie file."""

    def __init__(self, filename: str, framerate: float = 30, dpi: float | None = None,
                 **kwargs):
        self.filename = str(filename)
        self.framerate = framerate
        self.dpi = dpi
        self.kwargs = kwargs
        self._proc = None
        self._writer = None
        self._frame_shape: tuple[int, int] | None = None
        self._native = movie_native.is_available()
        if not self._native and shutil.which("ffmpeg") is None:
            raise RuntimeError(
                "Making movies requires libav or the `ffmpeg` binary, "
                "neither of which was found"
            )

    @classmethod
    def is_available(cls) -> bool:
        return movie_native.is_available() or shutil.which("ffmpeg") is not None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.save()
        return False

    def _start(self, width: int, height: int) -> None:
        if self._native:
            # exact framerate (fractional rates resolve to a rational, the
            # same timing the ffmpeg fallback's `-r` would set)
            self._writer = movie_native.MovieWriter(
                self.filename, width, height, fps=self.framerate,
                codec="libx264", pix_fmt_in="rgb24", pix_fmt_out="yuv420p",
            )
        else:
            cmd = [
                "ffmpeg", "-y",
                "-f", "rawvideo",
                "-vcodec", "rawvideo",
                "-s", f"{width}x{height}",
                "-pix_fmt", "rgb24",
                "-r", str(self.framerate),
                "-i", "-",
                "-an",
                "-vcodec", "libx264",
                "-pix_fmt", "yuv420p",
                self.filename,
            ]
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        self._frame_shape = (width, height)

    def add_figure(self, fig=None) -> None:
        """Render a matplotlib figure as the next movie frame."""
        import matplotlib.pyplot as plt

        if fig is None:
            fig = plt.gcf()
        if self.dpi:
            fig.set_dpi(self.dpi)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        height, width = buf.shape[:2]
        # ensure even dimensions for yuv420p
        height -= height % 2
        width -= width % 2
        buf = buf[:height, :width]
        if self._frame_shape is None:
            self._start(width, height)
        elif (width, height) != self._frame_shape:
            raise ValueError("All frames must have the same size")
        payload = np.ascontiguousarray(buf).tobytes()
        if self._writer is not None:
            self._writer.write(payload)
        else:
            self._proc.stdin.write(payload)

    def save(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
            self._proc = None


def movie(storage, filename: str, *, progress: bool = True, dpi: float | None = None,
          show_time: bool = True, plot_args: dict[str, Any] | None = None,
          movie_args: dict[str, Any] | None = None) -> None:
    """Produce a movie by plotting each stored field."""
    import matplotlib.pyplot as plt

    plot_args = plot_args or {}
    movie_args = movie_args or {}
    iterator = storage.items()
    if progress:
        try:
            from tqdm.auto import tqdm

            iterator = tqdm(list(iterator))
        except ImportError:
            iterator = list(iterator)

    with Movie(filename, dpi=dpi, **movie_args) as writer:
        for t, field in iterator:
            fig = plt.figure()
            field.plot(ax=fig.gca(), **plot_args) if field_supports_ax(field) else field.plot(**plot_args)
            if show_time:
                fig.suptitle(f"Time: {t:g}")
            writer.add_figure(fig)
            plt.close(fig)


def field_supports_ax(field) -> bool:
    from ..fields.collection import FieldCollection

    return not isinstance(field, FieldCollection)


def movie_scalar(storage, filename: str, scale="automatic", extras=None,
                 progress: bool = True, tight: bool = False, show: bool = False) -> None:
    """Produce a movie for a stored scalar field."""
    movie(storage, filename, progress=progress)


def movie_multiple(storage, filename: str, quantities=None, scale="automatic",
                   progress: bool = True) -> None:
    """Produce a movie with several panels."""
    movie(storage, filename, progress=progress)
