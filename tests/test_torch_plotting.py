"""Plots of the port (``field.plot``, ``grid.plot``, ``ScalarField.from_image``,
``pde_tpu_torch.visualization``), held against ``pde_tpu`` on the CPU in fp64:
the arrays each plot draws (``get_array()``, ``get_ydata()``, quiver
components, extents) agree with ``pde_tpu``'s for the same seeded numpy data
to 1e-12, and so do in-place updates of a plot, the grids' drawings, fields
read from PNG files written here, ``ScalarFieldPlot``, the kymographs, the
magnitudes and the movies of figures (``Movie``, ``movie_scalar``), whose
frame geometry the port's codec probes. matplotlib draws with Agg; every
figure is closed."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pde_tpu as jpde  # noqa: E402
import pde_tpu_torch as tpde  # noqa: E402
from pde_tpu.utils import movie_native as jmovie_native  # noqa: E402
from pde_tpu_torch.utils import movie_native  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu"}):
        yield
    plt.close("all")


@pytest.fixture(scope="module", autouse=True)
def _jax_codec_built_apart(tmp_path_factory):
    """pde_tpu builds its codec into one shared folder without a lock, so two
    test processes building it at once can load a half-written library. This
    file's process builds its own copy of pde_tpu's codec in a private folder
    (once, before any test uses it) and never writes the shared one."""
    import pde_tpu.native as jnative

    if jmovie_native._lib.cache_info().currsize == 0:
        shared, jnative._BUILD_DIR = jnative._BUILD_DIR, str(tmp_path_factory.mktemp("codec"))
        try:
            jmovie_native._lib()
        finally:
            jnative._BUILD_DIR = shared
    yield


# case -> (grid(pkg), field class, complex data, plot keyword arguments)
FIELDS = {
    "scalar 1d line": (lambda p: p.CartesianGrid([(0, 3)], [12]), "ScalarField", False, {}),
    "scalar 2d image": (lambda p: p.CartesianGrid([(0, 2), (-1, 3)], [7, 5]), "ScalarField",
                        False, {}),
    "scalar 2d line projected": (lambda p: p.UnitGrid([6, 5]), "ScalarField", False,
                                 {"kind": "line", "extract": "project_y"}),
    "scalar 3d image": (lambda p: p.UnitGrid([4, 5, 6]), "ScalarField", False, {}),
    "complex 2d image": (lambda p: p.UnitGrid([6, 5], periodic=True), "ScalarField", True,
                         {"colorbar": False}),
    "vector 2d quiver": (lambda p: p.CartesianGrid([(0, 2), (-1, 3)], [6, 4]), "VectorField",
                         False, {}),
    "vector 2d image": (lambda p: p.UnitGrid([6, 4]), "VectorField", False,
                        {"kind": "image", "scalar": "norm"}),
    "tensor 2d image": (lambda p: p.UnitGrid([5, 4]), "Tensor2Field", False, {}),
    "polar line": (lambda p: p.PolarSymGrid((1, 3), 6), "ScalarField", False, {}),
    "spherical image": (lambda p: p.SphericalSymGrid(2, 5), "ScalarField", False,
                        {"kind": "image"}),
    "cylindrical image": (lambda p: p.CylindricalSymGrid(3, (0, 2), (4, 5)), "ScalarField",
                          False, {}),
}


def _field(pkg, case, seed=0, label="f"):
    make_grid, cls, cplx, _ = FIELDS[case]
    grid = make_grid(pkg)
    field_cls = getattr(pkg, cls)
    rng = np.random.default_rng(seed)
    shape = (grid.dim,) * field_cls.rank + tuple(grid.shape)
    data = rng.random(shape) + (1j * rng.random(shape) if cplx else 0)
    return field_cls(grid, data if pkg is jpde else torch.as_tensor(data), label=label)


def _drawn(element):
    """The arrays an artist (or a plot reference, or a list of them) holds."""
    if isinstance(element, list):
        return [_drawn(e) for e in element]
    element = getattr(element, "element", element)
    if hasattr(element, "get_ydata"):
        return [np.asarray(element.get_xdata()), np.asarray(element.get_ydata())]
    if hasattr(element, "U"):
        return [np.asarray(element.X), np.asarray(element.Y), np.asarray(element.U),
                np.asarray(element.V)]
    return [np.ma.getdata(element.get_array()), np.ma.getmaskarray(element.get_array()),
            np.asarray(element.get_extent())]


def _same(got, expected):
    assert len(got) == len(expected)
    for a, b in zip(got, expected, strict=True):
        if isinstance(b, list):
            _same(a, b)
        else:
            np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                                       **TOL)


@pytest.mark.parametrize("case", FIELDS)
def test_field_plot_matches_jax(case, tmp_path):
    kwargs = FIELDS[case][3]
    drawn = {}
    for pkg in (jpde, tpde):
        ref = _field(pkg, case).plot(filename=str(tmp_path / f"{pkg.__name__}.png"), **kwargs)
        drawn[pkg] = _drawn(ref)
        assert ref.parameters["kind"] == (kwargs.get("kind") or ref.parameters["kind"])
    _same(drawn[tpde], drawn[jpde])
    assert (tmp_path / "pde_tpu_torch.png").stat().st_size > 0


@pytest.mark.parametrize("case", ["scalar 1d line", "scalar 2d image", "vector 2d quiver"])
def test_update_plot_matches_jax(case):
    """A plot updated in place with another field's data, as the plot trackers do."""
    drawn = {}
    for pkg in (jpde, tpde):
        ref = _field(pkg, case, seed=1).plot(**FIELDS[case][3])
        _field(pkg, case, seed=2)._update_plot(ref)
        drawn[pkg] = _drawn(ref)
    _same(drawn[tpde], drawn[jpde])


def _collection(pkg, seed=0):
    return pkg.FieldCollection([_field(pkg, "scalar 2d image", seed, "u"),
                                _field(pkg, "scalar 2d image", seed + 1, "v")], label="uv")


def test_collection_plot_and_update_match_jax():
    drawn = {}
    for pkg in (jpde, tpde):
        refs = _collection(pkg).plot(kind=["image", "line"])
        _collection(pkg, seed=5)._update_plot(refs)
        drawn[pkg] = _drawn(refs)
        assert [f for f in _collection(pkg)._get_napari_data()] == ["u", "v"]
    _same(drawn[tpde], drawn[jpde])


def test_tensor_components_match_jax():
    drawn = {pkg: _drawn(_field(pkg, "tensor 2d image").plot_components(colorbar=False))
             for pkg in (jpde, tpde)}
    _same(drawn[tpde], drawn[jpde])


GRIDS = {
    "cartesian 1d": lambda p: p.CartesianGrid([(0, 3)], [6]),
    "cartesian 2d": lambda p: p.CartesianGrid([(0, 2), (-1, 3)], [4, 5]),
    "polar": lambda p: p.PolarSymGrid((0.5, 2), 4),
    "spherical": lambda p: p.SphericalSymGrid(2, 3),
    "cylindrical": lambda p: p.CylindricalSymGrid(2, (0, 3), (4, 6)),
}


@pytest.mark.parametrize("case", GRIDS)
def test_grid_plot_matches_jax(case):
    drawn = {}
    for pkg in (jpde, tpde):
        ax = GRIDS[case](pkg).plot()
        drawn[pkg] = [[np.asarray(line.get_xydata()) for line in ax.lines],
                      [np.asarray(patch.get_radius()) for patch in ax.patches],
                      [np.asarray(ax.get_xlim()), np.asarray(ax.get_ylim())]]
    _same(drawn[tpde], drawn[jpde])
    assert drawn[tpde][0] or drawn[tpde][1]
    with pytest.raises(NotImplementedError, match="does not support plotting"):
        tpde.grids.base.GridBase.plot(GRIDS[case](tpde))


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_from_image_matches_jax(mode, tmp_path):
    from PIL import Image

    pixels = np.random.default_rng(7).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    path = tmp_path / "image.png"
    Image.fromarray(pixels[..., 0] if mode == "L" else pixels, mode=mode).save(path)
    jfield = jpde.ScalarField.from_image(path, bounds=[(0, 2), (1, 4)], periodic=True)
    tfield = tpde.ScalarField.from_image(path, bounds=[(0, 2), (1, 4)], periodic=True)
    assert tfield.grid.state == jfield.grid.state and tfield.data.dtype == torch.float32
    np.testing.assert_array_equal(tfield.to_numpy(), np.asarray(jfield.data))
    assert tpde.ScalarField.from_image(path).grid.shape == (13, 9)


def _storage(pkg, kind, seed=0):
    """A MemoryStorage of three frames of 1D fields or of collections."""
    rng = np.random.default_rng(seed)
    grid = pkg.CartesianGrid([(0, 4)], [10], periodic=True)
    wrap = (lambda d: d) if pkg is jpde else torch.as_tensor
    frames = []
    for _ in range(3):
        fields = [pkg.ScalarField(grid, wrap(rng.random(10)), label=name) for name in "uv"]
        frames.append(fields[0] if kind == "scalar" else pkg.FieldCollection(fields))
    return pkg.MemoryStorage.from_fields([0.0, 0.5, 1.0], frames)


@pytest.mark.parametrize("transpose", [False, True])
def test_kymograph_matches_jax(transpose):
    drawn = {pkg: _drawn(pkg.plot_kymograph(_storage(pkg, "scalar"), transpose=transpose))
             for pkg in (jpde, tpde)}
    _same(drawn[tpde], drawn[jpde])


def test_kymographs_and_magnitudes_match_jax():
    drawn = {}
    for pkg in (jpde, tpde):
        collections = _storage(pkg, "collection")
        drawn[pkg] = [_drawn(pkg.plot_kymographs(collections, colorbar=False)),
                      _drawn(pkg.plot_magnitudes(collections)),
                      _drawn([pkg.plot_magnitudes(_storage(pkg, "scalar"))]),
                      _drawn([pkg.plot_kymograph(collections, 1)])]
        assert pkg.extract_field(collections[0], 1).label == "v"
    _same(drawn[tpde], drawn[jpde])


def test_scalar_field_plot_matches_jax(tmp_path):
    drawn = {}
    for pkg in (jpde, tpde):
        state = _collection(pkg)
        panels = pkg.ScalarFieldPlot(state, show=False)
        panels.update(_collection(pkg, seed=3), title="t")
        panels.savefig(str(tmp_path / "panels.png"))
        drawn[pkg] = [_drawn(ax.images[0]) for ax in panels.axes.flat]
    _same(drawn[tpde], drawn[jpde])


def _probe(path):
    probe = movie_native.MovieProbe(str(path))
    return probe.width, probe.height, probe.n_frames, probe.pix_fmt


def test_movies_of_figures_match_jax(tmp_path):
    """Movie and movie_scalar write H.264 movies of the same geometry and frame
    count as pde_tpu's, probed by the port's codec."""
    assert movie_native.is_available() and jmovie_native.is_available()
    probes = {}
    for pkg in (jpde, tpde):
        fig = plt.figure(figsize=(3, 2), dpi=50)
        fig.gca().plot([0, 1], [1, 0])
        with pkg.Movie(tmp_path / f"{pkg.__name__}_fig.mp4", framerate=10) as movie:
            movie.add_figure(fig)
            movie.add_figure(fig)
        pkg.movie_scalar(_storage(pkg, "scalar"), tmp_path / f"{pkg.__name__}_s.mp4",
                         progress=False)
        probes[pkg] = [_probe(tmp_path / f"{pkg.__name__}_{kind}.mp4") for kind in ("fig", "s")]
    assert probes[tpde] == probes[jpde]
    assert probes[tpde][0][:2] == (150, 100) and probes[tpde][0][3] == "yuv420p"
    assert tpde.Movie.is_available()


def test_plot_interactive_without_napari_matches_jax():
    for pkg in (jpde, tpde):
        with pytest.raises(ImportError, match="napari"):
            pkg.plot_interactive(_storage(pkg, "scalar"))
        with pytest.raises(RuntimeError, match="2 spatial dimensions"):
            _field(pkg, "scalar 1d line").plot_interactive()
