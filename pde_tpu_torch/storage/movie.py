"""Storage writing field time series as (lossily quantized) video files.

Port of :mod:`pde_tpu.storage.movie`, format-interchangeable with it and with
py-pde: fields are normalized to ``[vmin, vmax]``, quantized to the chosen
pixel format, encoded with the lossless FFV1 codec, and the reconstruction
metadata is stored as a shlex-quoted JSON string in the container's
``comment`` tag (version 1), so movies written by either package read back in
the other. Exact time stamps go to a ``<filename>.times`` sidecar text file
(one float per line).

A frame is quantized on the state's device, in the field's dtype, by the same
formula as ``pde_tpu``'s numpy one (the same bytes); then one copy moves the
``uint8`` or ``uint16`` frame to the host, half or a quarter of the field's
bytes. The three steps of :meth:`MovieStorage.append` are methods of their
own (:meth:`~MovieStorage._frame_on_device`, :meth:`~MovieStorage._frame_to_host`,
:meth:`~MovieStorage._write_payload`) so that each can be timed alone.

Three encode backends, in ``pde_tpu``'s order of preference: ``native`` (the
in-process C++ codec ``pde_tpu_torch/native/movie_codec.cpp`` linking
libavformat), ``ffmpeg`` (the external binary) and ``raw`` (uncompressed
frames with a JSON sidecar, the same quantization) when neither libav nor the
binary is present. The choice is one of file format; the quantization runs
on the state's device in every case.
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import shutil
import subprocess

import numpy as np
import torch

from ..fields.base import FieldBase
from ..trackers.base import InfoDict
from ..utils import ffmpeg as ffmpeg_formats
from ..utils import movie_native
from .base import StorageBase


class MovieStorage(StorageBase):
    """Stores scalar-field time series in a video file (quantized)."""

    def __init__(
        self,
        filename: str,
        *,
        vmin: float = 0,
        vmax: float = 1,
        bits_per_channel: int = 16,
        video_format: str = "auto",
        bitrate: int = -1,
        info: InfoDict | None = None,
        write_mode: str = "truncate_once",
        write_times: bool = True,
    ):
        super().__init__(info=info, write_mode=write_mode)
        if movie_native.is_available():
            self._backend = "native"
        elif shutil.which("ffmpeg"):
            self._backend = "ffmpeg"
        else:
            self._backend = "raw"
            logging.getLogger(__name__).warning(
                "neither libav nor ffmpeg found: MovieStorage falls back to "
                "uncompressed raw frames"
            )
        self.filename = str(filename)
        self.vmin = float(vmin)
        self.vmax = float(vmax)
        if bits_per_channel not in (8, 16):
            raise ValueError("bits_per_channel must be 8 or 16")
        self.bits_per_channel = bits_per_channel
        self.video_format = video_format
        self.bitrate = int(bitrate)
        self.write_times = write_times
        self._times: list[float] = []
        self._proc = None
        self._writer = None
        self._raw_fh = None
        self._shape: tuple[int, ...] | None = None
        self._meta_loaded = False

        if os.path.exists(self.filename):
            if os.path.exists(self._meta_path):
                self._load_meta()  # raw backend / legacy JSON sidecar
            elif self._backend != "raw":
                self._read_metadata()

    @property
    def _meta_path(self) -> str:
        return self.filename + ".json"

    @property
    def _times_path(self) -> str:
        return self.filename + ".times"

    @property
    def _format(self) -> ffmpeg_formats.FFmpegFormat:
        name = self.video_format
        if name == "auto":
            name = "gray16le" if self.bits_per_channel == 16 else "gray"
        return ffmpeg_formats.formats[name]

    def _get_metadata(self) -> str:
        """JSON metadata string stored in the movie comment (version 1)."""
        info = {
            "version": 1,
            "vmin": self.vmin,
            "vmax": self.vmax,
            "write_times": self.write_times,
            # extra keys (py-pde ignores them and reads the frame geometry from
            # the stream): used by the ffprobe-less fallback
            "bits_per_channel": self.bits_per_channel,
            "width": self._shape[0] if self._shape else None,
            "height": self._shape[1] if self._shape and len(self._shape) > 1 else 1,
        }
        if self._field is not None:
            info["field_attributes"] = self._field.attributes_serialized
        return json.dumps(info)

    # -- writing -----------------------------------------------------------------------
    def start_writing(self, field: FieldBase, info: InfoDict | None = None) -> None:
        if field.data.ndim not in (1, 2):
            raise NotImplementedError("MovieStorage only supports 1d/2d scalar fields")
        super().start_writing(field, info)
        self._times = []
        self._shape = tuple(field.data.shape)
        # py-pde's frame layout: -s {shape[0]}x{shape[1]} with C-order bytes, so
        # the video's pixel grid is the transposed field, on both ends
        w0 = self._shape[0]
        h0 = self._shape[1] if len(self._shape) > 1 else 1
        if self._backend == "raw":
            self._raw_fh = open(self.filename, "wb")
            return
        fmt = self._format
        if self._backend == "native":
            if fmt.codec == "ffv1" and fmt.channels == 1:
                # the tag value is the shlex-QUOTED json, as py-pde writes it
                # through ffmpeg-python (unquoted on read)
                self._writer = movie_native.MovieWriter(
                    self.filename, w0, h0, bits=fmt.bits_per_channel,
                    comment=shlex.quote(self._get_metadata()),
                )
                return
            if not shutil.which("ffmpeg"):  # exotic format, no binary
                raise NotImplementedError(
                    f"video_format {self.video_format!r} requires the ffmpeg binary"
                )
            self._backend = "ffmpeg"
        cmd = [
            "ffmpeg", "-y",
            "-f", "rawvideo", "-vcodec", "rawvideo",
            "-s", f"{w0}x{h0}", "-pix_fmt", fmt.pix_fmt_data,
            "-r", "30", "-i", "-",
            "-an", "-vcodec", fmt.codec, "-pix_fmt", fmt.pix_fmt_file,
            "-metadata", "comment=" + shlex.quote(self._get_metadata()),
        ]
        if self.bitrate > 0:
            cmd += ["-b:v", str(self.bitrate)]
        cmd.append(self.filename)
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    def _quantize(self, data: np.ndarray) -> np.ndarray:
        """``pde_tpu``'s quantization of host data (numpy)."""
        normalized = (data - self.vmin) / (self.vmax - self.vmin)
        return self._format.data_to_frame(normalized)

    def _frame_on_device(self, data: torch.Tensor) -> torch.Tensor:
        """:meth:`_quantize` on the data's device, in its dtype: the same
        values. The divisor is a tensor on that device, since torch divides
        by a host scalar as a product with its reciprocal on the card.
        bfloat16 data is quantized in float32, as numpy promotes ``pde_tpu``'s
        bfloat16 host data with a Python float."""
        if data.dtype == torch.bfloat16:
            data = data.float()
        span = torch.tensor(self.vmax - self.vmin, dtype=data.dtype, device=data.device)
        return self._format.data_to_frame_tensor((data - self.vmin) / span)

    @staticmethod
    def _frame_to_host(frame: torch.Tensor) -> np.ndarray:
        """One copy of a quantized frame to a new host array."""
        return frame.cpu().numpy()

    def _write_payload(self, payload: bytes) -> None:
        if self._backend == "raw":
            self._raw_fh.write(payload)
        elif self._backend == "native":
            self._writer.write(payload)
        else:
            self._proc.stdin.write(payload)

    def _dequantize(self, raw: np.ndarray) -> np.ndarray:
        normalized = self._format.data_from_frame(raw)
        return normalized * (self.vmax - self.vmin) + self.vmin

    def append(self, field: FieldBase, time: float | None = None) -> None:
        if self._proc is None and self._writer is None and self._raw_fh is None:
            self.start_writing(field)
        frame = self._frame_to_host(self._frame_on_device(field.data))
        self._write_payload(frame.tobytes())
        self._times.append(float(time) if time is not None else len(self._times))

    def _write_times_sidecar(self) -> None:
        if self.write_times:
            with open(self._times_path, "w") as fh:
                fh.writelines(f"{t}\n" for t in self._times)

    def end_writing(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            self._write_times_sidecar()
            return
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
            self._proc = None
            self._write_times_sidecar()
            return
        if self._raw_fh is not None:
            self._raw_fh.close()
            self._raw_fh = None
        meta = {
            "vmin": self.vmin,
            "vmax": self.vmax,
            "bits_per_channel": self.bits_per_channel,
            "backend": self._backend,
            "shape": list(self._shape or ()),
            "times": self._times,
            "field_attributes": (
                self._field.attributes_serialized if self._field else None
            ),
        }
        with open(self._meta_path, "w") as fh:
            json.dump(meta, fh)

    # -- reading ------------------------------------------------------------------------
    def _apply_field_attributes(self, attrs) -> None:
        if not attrs:
            return
        # plain fields and collections (multi-channel movies written by
        # py-pde carry collection attributes)
        self._field = FieldBase.from_state(dict(attrs))
        self._grid = self._field.grid
        self._data_shape = self._shape
        self._dtype = np.dtype(float)

    def _load_meta(self) -> None:
        with open(self._meta_path) as fh:
            meta = json.load(fh)
        self.vmin = meta["vmin"]
        self.vmax = meta["vmax"]
        self.bits_per_channel = meta["bits_per_channel"]
        self._backend = meta.get("backend", self._backend)
        self._shape = tuple(meta["shape"])
        self._times = list(meta["times"])
        self._apply_field_attributes(meta.get("field_attributes"))
        self._meta_loaded = True

    def _read_metadata(self) -> None:
        """Read the comment-tag metadata of an encoded movie, written by this
        class, by ``pde_tpu`` or by py-pde (the same version-1 scheme)."""
        if self._backend == "native":
            # metadata-only probe: works for ANY pixel format (multi-channel
            # movies read their metadata here and decode through the ffmpeg
            # binary in _read_frames)
            probe_info = movie_native.MovieProbe(self.filename)
            raw_comment = probe_info.comment or "{}"
            width, height = probe_info.width, probe_info.height
            pix = probe_info.pix_fmt or ("gray16le" if probe_info.bits == 16 else "gray")
            n_frames = probe_info.n_frames
        else:
            probe = subprocess.run(
                [
                    "ffprobe", "-v", "quiet", "-print_format", "json",
                    "-show_format", "-show_streams", self.filename,
                ],
                stdout=subprocess.PIPE, check=True,
            )
            info = json.loads(probe.stdout)
            tags = info.get("format", {}).get("tags", {})
            raw_comment = tags.get("comment", tags.get("COMMENT", "{}"))
            stream = info.get("streams", [{}])[0]
            width = stream.get("width")
            height = stream.get("height")
            pix = stream.get("pix_fmt")
            n = stream.get("nb_frames")
            n_frames = int(n) if n is not None else None
        try:
            metadata = json.loads(shlex.split(raw_comment)[0])
        except (ValueError, IndexError):
            metadata = {}
        self.vmin = metadata.get("vmin", 0)
        self.vmax = metadata.get("vmax", 1)
        self.write_times = metadata.get("write_times", self.write_times)
        # the video pixel grid is the transposed field (see start_writing)
        if width is None:
            width = metadata.get("width")
            height = metadata.get("height", 1)
        self._shape = (int(width),) if height in (1, None) else (int(width), int(height))
        for name, fmt in ffmpeg_formats.formats.items():
            if fmt.pix_fmt_file == pix:
                self.video_format = name
                self.bits_per_channel = fmt.bits_per_channel
                break
        # times: exact stamps from the sidecar when present
        if os.path.exists(self._times_path):
            with open(self._times_path) as fh:
                self._times = [float(line) for line in fh if line.strip()]
        else:
            count = n_frames if n_frames is not None else len(self._read_frames())
            self._times = [float(i) for i in range(count)]
        self._apply_field_attributes(metadata.get("field_attributes"))
        self._meta_loaded = True

    @property
    def times(self):
        return list(self._times)

    def __len__(self) -> int:
        return len(self._times)

    @property
    def data(self):
        return _MovieFrames(self)

    def _read_frames(self) -> np.ndarray:
        shape = self._shape
        w0 = shape[0]
        h0 = shape[1] if len(shape) > 1 else 1
        fmt = self._format
        if self._backend == "raw":
            with open(self.filename, "rb") as fh:
                raw = fh.read()
        elif self._backend == "native" and fmt.channels == 1:
            # decoded as (n, h0, w0) rows; the byte stream is the C-order field
            # payload, so the reshape below recovers it exactly
            raw = movie_native.MovieInfo(self.filename).frames.tobytes()
        else:
            # the ffmpeg binary: the ffmpeg backend, and the multi-channel
            # formats the native decoder (gray only) does not read
            if self._backend == "native" and not shutil.which("ffmpeg"):
                raise NotImplementedError(
                    f"decoding video_format {self.video_format!r} requires "
                    "the ffmpeg binary (the native codec reads gray movies)"
                )
            cmd = [
                "ffmpeg", "-i", self.filename,
                "-f", "rawvideo", "-pix_fmt", fmt.pix_fmt_data, "-",
            ]
            raw = subprocess.run(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, check=True,
            ).stdout
        frames = np.frombuffer(raw, dtype=fmt.dtype)
        count = len(frames) // (w0 * h0)
        frames = frames[: count * w0 * h0].reshape(count, w0, h0)
        if len(shape) == 1:
            frames = frames[:, :, 0]
        return frames

    def _get_field(self, t_index: int) -> FieldBase:
        frames = self._read_frames()
        return self._reconstruct_field(self._dequantize(frames[t_index]))


class _MovieFrames:
    """Lazy frame accessor for MovieStorage."""

    def __init__(self, storage: MovieStorage):
        self._storage = storage

    def __getitem__(self, index):
        frames = self._storage._read_frames()
        return self._storage._dequantize(frames[index])

    def __len__(self):
        return len(self._storage)
