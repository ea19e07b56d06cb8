"""Movie storage of the port (``pde_tpu_torch.storage.MovieStorage``) and its
codec, held against ``pde_tpu`` on the CPU: the quantized frame bytes of fp32
and fp64 data at 8 and 16 bits (clipping included) equal ``pde_tpu``'s, 1D and
2D movies round-trip, each package reads the other's movies (FFV1 through the
native codec, and raw frames) with equal frames and times, a solve writes a
movie through the storage's tracker, the refusals are ``pde_tpu``'s, and the
codec builds from the port's own source, once, when several processes ask at
once. Inputs come from ``default_rng``."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.storage.movie import MovieStorage as JMovieStorage
from pde_tpu_torch.storage import MovieStorage
from pde_tpu_torch.utils import ffmpeg as tffmpeg
from pde_tpu_torch.utils import movie_native

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"fp32": (np.float32, torch.float32), "fp64": (np.float64, torch.float64)}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu"}):
        yield


@pytest.fixture(scope="module", autouse=True)
def _jax_codec_built_apart(tmp_path_factory):
    """pde_tpu builds its codec into one shared folder without a lock, so two
    test processes building it at once can load a half-written library. This
    file's process builds its own copy of pde_tpu's codec in a private folder
    (once, before any test uses it) and never writes the shared one."""
    import pde_tpu.native as jnative
    from pde_tpu.utils import movie_native as jmovie_native

    if jmovie_native._lib.cache_info().currsize == 0:
        shared, jnative._BUILD_DIR = jnative._BUILD_DIR, str(tmp_path_factory.mktemp("codec"))
        try:
            jmovie_native._lib()
        finally:
            jnative._BUILD_DIR = shared
    yield


@pytest.fixture(params=["native", "raw"])
def backend(request, monkeypatch):
    """The encode backend both packages take: the native codec, or raw frames
    where neither libav nor the ffmpeg binary is found."""
    if request.param == "raw":
        import pde_tpu.utils.movie_native as jmovie_native

        for module in (movie_native, jmovie_native):
            monkeypatch.setattr(module, "is_available", lambda: False)
        monkeypatch.setattr("shutil.which", lambda name: None)
    elif not movie_native.is_available():
        pytest.fail("the native movie codec did not build")
    return request.param


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_bytes_match_jax(dtype, bits, tmp_path):
    """One frame quantized by the port (torch, on the data's device) against
    pde_tpu's numpy formula, values outside [vmin, vmax] clipped."""
    np_dtype = DTYPES[dtype][0]
    data = np.random.default_rng(bits).uniform(-0.6, 1.4, (37, 23)).astype(np_dtype)
    data[0, :3] = [-0.3, 0.1, 0.35]  # both bounds and a value just inside one
    for vmin, vmax in ((0.0, 1.0), (-0.3, 0.35)):
        reference = JMovieStorage(str(tmp_path / "j.mov"), vmin=vmin, vmax=vmax,
                                  bits_per_channel=bits)._quantize(data)
        storage = MovieStorage(str(tmp_path / "t.mov"), vmin=vmin, vmax=vmax,
                               bits_per_channel=bits)
        frame = storage._frame_to_host(storage._frame_on_device(torch.from_numpy(data)))
        assert frame.dtype == reference.dtype and frame.tobytes() == reference.tobytes()
        np.testing.assert_array_equal(storage._quantize(data), reference)


@pytest.mark.parametrize("name", ["gray", "gray16le", "rgb24"])
def test_formats_match_jax(name):
    from pde_tpu.utils import ffmpeg as jffmpeg

    fmt, jfmt = tffmpeg.formats[name], jffmpeg.formats[name]
    assert (fmt.max_value, np.dtype(fmt.dtype), fmt.pix_fmt_data) == (
        jfmt.max_value, np.dtype(jfmt.dtype), jfmt.pix_fmt_data)
    values = np.linspace(-0.5, 1.5, 41)
    np.testing.assert_array_equal(
        fmt.data_to_frame_tensor(torch.from_numpy(values)).numpy(), jfmt.data_to_frame(values))
    assert tffmpeg.find_format(1, 16) == jffmpeg.find_format(1, 16) == "gray16le"


def _write(pkg, storage_cls, path, fields, times, **kwargs):
    storage = storage_cls(str(path), **kwargs)
    storage.start_writing(fields[0])
    for f, t in zip(fields, times, strict=True):
        storage.append(f, time=t)
    storage.end_writing()
    return storage


def _fields(pkg, shape, count=3, seed=0):
    rng = np.random.default_rng(seed)
    grid = pkg.CartesianGrid([(0, 2)] * len(shape), list(shape))
    datas = [rng.random(shape) for _ in range(count)]
    if pkg is tpde:
        datas = [torch.as_tensor(d) for d in datas]
    return [pkg.ScalarField(grid, d, label="c") for d in datas]


@pytest.mark.parametrize("shape", [(24,), (12, 20)], ids=["1d", "2d"])
def test_round_trip(shape, backend, tmp_path):
    """Frames written by the port read back within one quantization step and
    equal to the dequantized quantization; times and the field come back."""
    fields = _fields(tpde, shape)
    storage = _write(tpde, MovieStorage, tmp_path / "m.mov", fields, [0.0, 0.5, 1.25])
    assert storage._backend == backend
    loaded = MovieStorage(str(tmp_path / "m.mov"))
    assert loaded.times == [0.0, 0.5, 1.25] and len(loaded) == 3
    step = 1 / (2**16 - 1)
    for i, f in enumerate(fields):
        frame = loaded.data[i]
        np.testing.assert_allclose(frame, f.to_numpy(), rtol=0, atol=step)
        np.testing.assert_array_equal(frame, loaded._dequantize(loaded._quantize(f.to_numpy())))
    field = loaded[1]
    assert isinstance(field, tpde.ScalarField) and field.grid == fields[0].grid
    assert field.label == "c"
    np.testing.assert_array_equal(field.to_numpy(), loaded.data[1])


@pytest.mark.parametrize("writer", ["pde_tpu writes", "the port writes"])
def test_each_package_reads_the_other(writer, backend, tmp_path):
    """A movie written by one package reads back in the other with equal
    frames, times and field attributes."""
    path = tmp_path / "x.avi"
    times = [0.0, 0.1, 0.7]
    if writer == "pde_tpu writes":
        _write(jpde, JMovieStorage, path, _fields(jpde, (10, 14), seed=3), times, vmin=0.2,
               vmax=0.9, bits_per_channel=8)
    else:
        _write(tpde, MovieStorage, path, _fields(tpde, (10, 14), seed=3), times, vmin=0.2,
               vmax=0.9, bits_per_channel=8)
    jread, tread = JMovieStorage(str(path)), MovieStorage(str(path))
    assert tread.times == jread.times == times
    assert (tread.vmin, tread.vmax, tread.bits_per_channel) == (0.2, 0.9, 8)
    for i in range(3):
        np.testing.assert_array_equal(tread.data[i], np.asarray(jread.data[i]))
    assert tread[2].grid.state == jread[2].grid.state
    np.testing.assert_array_equal(tread[2].to_numpy(), np.asarray(jread[2].data))


def test_solve_writes_a_movie(tmp_path):
    """The storage's tracker in a solve next to a MemoryStorage: every movie
    frame is the quantization of the memory frame of the same time, and
    pde_tpu's movie of the same solve holds frames within one step of it."""
    data = np.random.default_rng(5).random((16, 12))
    movies = {}
    for pkg, cls in ((jpde, JMovieStorage), (tpde, MovieStorage)):
        grid = pkg.UnitGrid([16, 12], periodic=True)
        state = pkg.ScalarField(grid, data if pkg is jpde else torch.as_tensor(data))
        movie, memory = cls(str(tmp_path / f"{pkg.__name__}.mov")), pkg.MemoryStorage()
        pkg.DiffusionPDE(0.1).solve(state, t_range=1.0, dt=0.1,
                                    tracker=[movie.tracker(0.25), memory.tracker(0.25)])
        movies[pkg] = (movie, memory)
    (jmovie, _), (movie, memory) = movies[jpde], movies[tpde]
    assert movie.times == list(memory.times) == jmovie.times and len(movie) == 5
    frames = movie._read_frames()
    for i, frame in enumerate(memory.data):
        np.testing.assert_array_equal(frames[i], movie._quantize(frame))
        np.testing.assert_allclose(movie.data[i], np.asarray(jmovie.data[i]), rtol=0,
                                   atol=1 / (2**16 - 1))


def test_refusals_match_jax(tmp_path):
    """3D data, vector data and bits other than 8 or 16 are refused as in pde_tpu."""
    for pkg, cls in ((jpde, JMovieStorage), (tpde, MovieStorage)):
        with pytest.raises(ValueError, match="8 or 16"):
            cls(str(tmp_path / "b.mov"), bits_per_channel=12)
        for field in (pkg.ScalarField(pkg.UnitGrid([4, 4, 4]), 0.5),
                      pkg.VectorField(pkg.UnitGrid([4, 4]), 0.5)):
            with pytest.raises(NotImplementedError, match="1d/2d scalar"):
                cls(str(tmp_path / "r.mov")).start_writing(field)


BUILD_SCRIPT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
print(module.build_library("pdemovie", ["movie_codec.cpp"],
                           ["avformat", "avcodec", "avutil", "swscale"]))
"""


def test_codec_builds_from_the_ports_source(tmp_path):
    """The codec the port loads is built from pde_tpu_torch/native/ into its
    _build/; three processes building a fresh copy at once get one whole
    library (a file lock, then a rename into place)."""
    path = movie_native._lib()._name
    native = REPO / "pde_tpu_torch" / "native"
    assert Path(path) == native / "_build" / "libpdemovie.so"
    assert os.path.getmtime(path) >= os.path.getmtime(native / "movie_codec.cpp")
    copy = tmp_path / "native"
    copy.mkdir()
    for name in ("__init__.py", "movie_codec.cpp"):
        (copy / name).write_bytes((native / name).read_bytes())
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(copy / "__init__.py")],
                              stdout=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [proc.communicate(timeout=240)[0].strip() for proc in procs]
    assert outs == [str(copy / "_build" / "libpdemovie.so")] * 3
    assert not list((copy / "_build").glob("*.tmp"))
    assert ctypes.CDLL(outs[0]).mc_last_error is not None
