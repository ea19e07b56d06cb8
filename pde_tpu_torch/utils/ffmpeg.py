"""ffmpeg format metadata used by movie storage.

The port's own copy of :mod:`pde_tpu.utils.ffmpeg`, with a torch form of the
quantization (:meth:`FFmpegFormat.data_to_frame_tensor`) that gives the same
values as the numpy form on the tensor's own device.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class FFmpegFormat:
    """Information about a video format usable for storing field data."""

    pix_fmt_file: str
    pix_fmt_data: str
    channels: int
    bits_per_channel: int
    codec: str = "ffv1"

    @property
    def bytes_per_channel(self) -> int:
        return self.bits_per_channel // 8

    @property
    def max_value(self) -> int:
        return 2**self.bits_per_channel - 1

    @property
    def dtype(self):
        return np.uint16 if self.bits_per_channel == 16 else np.uint8

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.uint16 if self.bits_per_channel == 16 else torch.uint8

    def data_to_frame(self, normalized_data: np.ndarray) -> np.ndarray:
        """Convert normalized [0, 1] data to frame values."""
        return np.ascontiguousarray(
            np.clip(normalized_data * self.max_value, 0, self.max_value)
        ).astype(self.dtype)

    def data_to_frame_tensor(self, normalized: torch.Tensor) -> torch.Tensor:
        """:meth:`data_to_frame` on a tensor's device: scaled and clipped in
        the tensor's dtype, then truncated to ``uint8`` or ``uint16``, as
        numpy's ``astype`` truncates."""
        scaled = (normalized * self.max_value).clamp_(0, self.max_value)
        return scaled.to(self.torch_dtype).contiguous()

    def data_from_frame(self, frame_data: np.ndarray) -> np.ndarray:
        """Convert frame values back to normalized [0, 1] data."""
        return frame_data.astype(float) / self.max_value


formats: dict[str, FFmpegFormat] = {
    "gray": FFmpegFormat("gray", "gray", 1, 8),
    "rgb24": FFmpegFormat("rgb24", "rgb24", 3, 8),
    "rgb32": FFmpegFormat("rgb32", "rgba", 4, 8),
    "gray16le": FFmpegFormat("gray16le", "gray16le", 1, 16),
    "gbrp16le": FFmpegFormat("gbrp16le", "gbrp16le", 3, 16),
}


def find_format(channels: int, bits_per_channel: int = 8) -> str | None:
    """Find a format with at least the given number of channels and bits."""
    candidates = [
        name
        for name, fmt in formats.items()
        if fmt.channels >= channels and fmt.bits_per_channel >= bits_per_channel
    ]
    if not candidates:
        return None
    return min(
        candidates,
        key=lambda name: (formats[name].bits_per_channel, formats[name].channels),
    )


def is_available() -> bool:
    """Whether the ffmpeg binary is available."""
    return shutil.which("ffmpeg") is not None
