"""The field API of ROADMAP A4's second item against ``pde_tpu`` on the CPU in fp64.

Random fields (bit for bit for the same ``numpy`` generator), fields from
expressions, ghost cells and boundary values, interpolation and deposition,
smoothing, ``evaluate``, the data of plots, projections, slices, the complex
parts and ``apply``, on small grids (8²-32², 64 cells in 1D) with inputs from
``default_rng``; values at 1e-12 of max|f|.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


def _close(got, expected, scale=None):
    """``got`` (a tensor, field or array) within 1e-12 of max|expected|."""
    got = getattr(got, "data", got)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(getattr(expected, "data", expected))
    assert got.shape == expected.shape
    tol = 1e-12 * (scale if scale is not None else max(np.abs(expected).max(), 1e-300))
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol)


# grids of both packages: (constructor arguments); the same call builds either
GRIDS = {
    "unit 16x12 periodic": lambda pkg: pkg.UnitGrid([16, 12], periodic=True),
    "cartesian 10x14 mixed": lambda pkg: pkg.CartesianGrid([(0, 2), (-1, 3)], [10, 14],
                                                          periodic=[True, False]),
    "unit 64 (1D)": lambda pkg: pkg.UnitGrid([64]),
    "cartesian 6x5x7 (3D)": lambda pkg: pkg.CartesianGrid([(0, 1), (0, 2), (1, 2)], [6, 5, 7],
                                                          periodic=[False, True, False]),
    "polar 16": lambda pkg: pkg.PolarSymGrid((0.5, 3.0), 16),
    "spherical 12": lambda pkg: pkg.SphericalSymGrid(2.0, 12),
    "cylindrical 8x10": lambda pkg: pkg.CylindricalSymGrid(2.0, (0, 3), (8, 10), periodic_z=True),
}


def _pair(grid_id, rank=0, seed=0):
    jgrid, tgrid = (GRIDS[grid_id](pkg) for pkg in (jpde, tpde))
    data = np.random.default_rng(seed).uniform(-1, 1, (jgrid.dim,) * rank + jgrid.shape)
    jcls, tcls = ((pkg.ScalarField, pkg.VectorField, pkg.Tensor2Field)[rank]
                  for pkg in (jpde, tpde))
    return jcls(jgrid, data), tcls(tgrid, data, dtype=F64)


# -- random fields: bit for bit ---------------------------------------------------------------
RANDOM = {
    "normal": ("random_normal", {"mean": 0.5, "std": 2.0}),
    "normal physical": ("random_normal", {"scaling": "physical"}),
    "normal gaussian": ("random_normal", {"correlation": "gaussian", "length_scale": 2.0}),
    "normal power law": ("random_normal", {"correlation": "power law", "exponent": -2}),
    "normal cosine": ("random_normal", {"correlation": "cosine", "length_scale": 3.0}),
    "harmonic": ("random_harmonic", {"modes": 4}),
    "harmonic sin add": ("random_harmonic", {"harmonic": np.sin, "axis_combination": np.add}),
    "colored": ("random_colored", {"exponent": -3, "scale": 0.5}),
}


@pytest.mark.parametrize("grid_id", ["unit 16x12 periodic", "cartesian 10x14 mixed",
                                     "unit 64 (1D)", "polar 16"])
@pytest.mark.parametrize("case", RANDOM)
@pytest.mark.parametrize("rank", [0, 1])
def test_random_fields_equal_jax(case, grid_id, rank):
    method, kwargs = RANDOM[case]
    fields = []
    for pkg in (jpde, tpde):
        cls = (pkg.ScalarField, pkg.VectorField)[rank]
        extra = {"dtype": F64} if pkg is tpde else {}
        fields.append(getattr(cls, method)(GRIDS[grid_id](pkg), rng=np.random.default_rng(11),
                                           label="r", **kwargs, **extra))
    expected, got = fields
    assert got.label == "r" and got.dtype == F64
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(expected.data))


def test_random_complex_and_errors():
    grid = tpde.UnitGrid([8, 8])
    got = tpde.ScalarField.random_normal(grid, dtype=torch.complex128, rng=np.random.default_rng(0))
    expected = jpde.ScalarField.random_normal(jpde.UnitGrid([8, 8]), dtype=np.complex128,
                                              rng=np.random.default_rng(0))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(expected.data))
    with pytest.raises(ValueError, match="scaling"):
        tpde.ScalarField.random_normal(grid, scaling="wrong")
    with pytest.raises(ValueError, match="correlation"):
        tpde.ScalarField.random_normal(grid, correlation="wrong")


# -- fields from expressions ------------------------------------------------------------------
EXPRESSIONS = {
    "unit 16x12 periodic": ("sin(2 * pi * x / 16) * cos(y) + x * y", ["x", "y**2"]),
    "unit 64 (1D)": ("exp(-(x - 32)**2 / 50)", ["x / 64"]),
    "cartesian 6x5x7 (3D)": ("x * y - z**2", ["x", "y", "z"]),
    "polar 16": ("r**2 + cartesian[0]", ["r", "cartesian[1]"]),
    "spherical 12": ("1 / (1 + r)", ["r", "0", "cartesian[2]"]),
    "cylindrical 8x10": ("r * sin(z) + cartesian[0]", ["r", "z", "cartesian[1] * z"]),
}


@pytest.mark.parametrize("grid_id", EXPRESSIONS)
def test_from_expression_matches_jax(grid_id):
    scalar, vector = EXPRESSIONS[grid_id]
    jgrid, tgrid = (GRIDS[grid_id](pkg) for pkg in (jpde, tpde))
    _close(tpde.ScalarField.from_expression(tgrid, scalar, label="s", dtype=F64),
           jpde.ScalarField.from_expression(jgrid, scalar))
    _close(tpde.VectorField.from_expression(tgrid, vector, dtype=F64),
           jpde.VectorField.from_expression(jgrid, vector))
    got = tpde.FieldCollection.from_scalar_expressions(tgrid, [scalar, "2"], labels=["a", "b"],
                                                       dtype=F64)
    expected = jpde.FieldCollection.from_scalar_expressions(jgrid, [scalar, "2"])
    assert got.labels == ["a", "b"]
    for g, e in zip(got, expected, strict=True):
        _close(g, e)


def test_from_expression_tensor_consts_and_user_funcs():
    jgrid, tgrid = (pkg.UnitGrid([8, 10]) for pkg in (jpde, tpde))
    rows = [["x", "a * y"], ["f(x)", "x * y"]]
    kw = {"consts": {"a": 3.0}, "user_funcs": {"f": lambda v: v**3}}
    _close(tpde.Tensor2Field.from_expression(tgrid, rows, dtype=F64, **kw),
           jpde.Tensor2Field.from_expression(jgrid, rows, **kw))
    with pytest.raises(ValueError, match="2 expressions"):
        tpde.VectorField.from_expression(tgrid, "x")


# -- ghost cells, boundary values and boundary fields -------------------------------------
BCS = {
    "auto": "auto_periodic_neumann",
    "dirichlet": {"value": 0.5},
    "mixed sides": {"x": {"derivative": 0.2}, "y-": {"value": 1.0},
                    "y+": {"type": "mixed", "value": 1.0, "const": 0.3}},
}


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("rank", [0, 1])
def test_ghost_cells_and_boundary_values_match_jax(bc, rank):
    jf, tf = _pair("cartesian 10x14 mixed" if bc == "auto" else "unit 16x12 periodic", rank)
    if bc != "auto":
        jf, tf = (pkg.__class__(g.grid.__class__([16, 12]), np.asarray(g.data), **kw)
                  for pkg, g, kw in ((jf, jf, {}), (tf, tf, {"dtype": F64})))
    spec = BCS[bc]
    _close(tf.get_full_data(spec), jf.get_full_data(spec))
    _close(tf.set_ghost_cells(spec), jf.set_ghost_cells(spec))
    _close(tf.get_full_data(), jf.get_full_data())
    for axis in (0, 1):
        for upper in (False, True):
            _close(tf.get_boundary_values(axis, upper, spec),
                   jf.get_boundary_values(axis, upper, spec))
    if rank == 0:
        for index in ("left", "top", ("y", True), "x-"):
            _close(tf.get_boundary_field(index, spec), jf.get_boundary_field(index, spec))
    assert tf.data_shape == jf.data_shape


def test_boundary_field_1d():
    jf, tf = _pair("unit 64 (1D)")
    _close(tf.get_boundary_field("right", {"value": 2.0}),
           jf.get_boundary_field("right", {"value": 2.0}))


# -- interpolation and deposition ---------------------------------------------------------
@pytest.mark.parametrize("grid_id", ["unit 16x12 periodic", "cartesian 10x14 mixed",
                                     "unit 64 (1D)", "cartesian 6x5x7 (3D)", "polar 16",
                                     "cylindrical 8x10"])
@pytest.mark.parametrize("rank", [0, 1])
def test_interpolate_matches_jax(grid_id, rank):
    jf, tf = _pair(grid_id, rank, seed=3)
    grid = tf.grid
    rng = np.random.default_rng(4)
    lo = np.array([b[0] for b in grid.axes_bounds])
    hi = np.array([b[1] for b in grid.axes_bounds])
    points = rng.uniform(lo, hi, (25, grid.num_axes))
    _close(tf.interpolate(points), jf.interpolate(points))
    _close(tf.interpolate(points[3]), jf.interpolate(points[3]))
    bc = "auto_periodic_dirichlet"
    _close(tf.interpolate(points, bc=bc), jf.interpolate(points, bc=bc))
    outside = rng.uniform(lo - 1, hi + 1, (25, grid.num_axes))
    _close(tf.interpolate(outside, fill=-7.0), jf.interpolate(outside, fill=-7.0))
    full = tf.get_full_data("auto_periodic_neumann")
    jfull = np.asarray(jf.get_full_data("auto_periodic_neumann"))
    _close(tf.make_interpolator(full_data=True)(full, points),
           jf.make_interpolator(full_data=True)(jfull, points))
    if not all(grid.periodic):
        with pytest.raises(tpde.DomainError):
            tf.interpolate(hi + 1)
    with pytest.raises(tpde.DomainError):
        tf.interpolate(np.zeros(grid.num_axes + 1))


@pytest.mark.parametrize("target", ["same class", "polar to cartesian", "cartesian to polar"])
def test_interpolate_to_grid_matches_jax(target):
    if target == "same class":
        jf, tf = _pair("cartesian 10x14 mixed", 1, seed=5)
        grids = [pkg.CartesianGrid([(0, 2), (-1, 3)], [7, 9], periodic=[True, False])
                 for pkg in (jpde, tpde)]
    elif target == "polar to cartesian":
        # (pde_tpu's get_cartesian_grid fails on a grid with a hole: it logs
        # through a logger its grids do not have)
        data = np.random.default_rng(5).random(16)
        jf, tf = (pkg.ScalarField(pkg.PolarSymGrid(3.0, 16), data, **kw)
                  for pkg, kw in ((jpde, {}), (tpde, {"dtype": F64})))
        grids = [pkg.PolarSymGrid(3.0, 16).get_cartesian_grid() for pkg in (jpde, tpde)]
    else:
        jf, tf = (pkg.ScalarField.from_expression(pkg.CartesianGrid([(-3, 3)] * 2, 24), "x * y")
                  for pkg in (jpde, tpde))
        tf = tf.copy(dtype=F64)
        grids = [pkg.PolarSymGrid(2.5, 10) for pkg in (jpde, tpde)]
    expected = jf.interpolate_to_grid(grids[0], fill=0.0)
    got = tf.interpolate_to_grid(grids[1], fill=0.0, label="i")
    assert got.grid == grids[1] and got.label == "i"
    _close(got, expected)
    collection = tpde.FieldCollection([tf, tf * 2]).interpolate_to_grid(grids[1], fill=0.0)
    _close(collection[1], expected.data * 2, scale=np.abs(np.asarray(expected.data)).max() * 2)


@pytest.mark.parametrize("grid_id", ["unit 16x12 periodic", "cartesian 10x14 mixed",
                                     "unit 64 (1D)", "cylindrical 8x10"])
def test_insert_matches_jax(grid_id):
    jf, tf = _pair(grid_id, 0, seed=6)
    grid = tf.grid
    rng = np.random.default_rng(7)
    lo = np.array([b[0] for b in grid.axes_bounds])
    hi = np.array([b[1] for b in grid.axes_bounds])
    points = rng.uniform(lo, hi, (12, grid.num_axes))
    points[5] = points[2]  # two deposits in the same cells accumulate
    expected = jf.insert(points, 2.5)
    data = tf.data
    got = tf.insert(points, 2.5)
    assert got is tf and tf.data is not data
    _close(got, expected)
    _close(tf.add_interpolated(points[0], 1.0), jf.add_interpolated(points[0], 1.0))


def test_insert_vector_matches_jax():
    jf, tf = _pair("unit 16x12 periodic", 1, seed=8)
    point = np.array([3.3, 7.9])
    _close(tf.insert(point, np.array([1.0, -2.0])), jf.insert(point, np.array([1.0, -2.0])))


# -- smoothing ------------------------------------------------------------------------------
@pytest.mark.parametrize("grid_id", ["unit 16x12 periodic", "cartesian 10x14 mixed",
                                     "unit 64 (1D)", "cartesian 6x5x7 (3D)", "polar 16"])
@pytest.mark.parametrize("sigma", [0.5, 2.0])
def test_smooth_matches_jax(grid_id, sigma):
    for rank in (0, 1):
        jf, tf = _pair(grid_id, rank, seed=9)
        _close(tf.smooth(sigma), jf.smooth(sigma))
    out = tf.copy()
    assert tf.smooth(sigma, out=out) is out
    jc = jpde.FieldCollection([jf, jf * 2])
    tc = tpde.FieldCollection([tf, tf * 2])
    for g, e in zip(tc.smooth(sigma), jc.smooth(sigma), strict=True):
        _close(g, e)


# -- evaluate ---------------------------------------------------------------------------------
EVALUATE = {
    "laplace(a*b) + gradient_squared(a)": {},
    "dot(gradient(a), gradient(b))": {},
    "outer(gradient(a), gradient(b))": {},
    "gradient(a) * b": {},
    "divergence(gradient(a)) - laplace(a)": {},
    "integral(a) * b + x * y": {},
    "laplace(a) + k * c": {"consts": {"k": 2.0, "c": "field"}},
    "g(a) + laplace(b)": {"user_funcs": {"g": lambda v: v**2}},
    "laplace(a) + gradient_squared(b)": {
        "bc": {"x": "periodic", "y": {"value": 1.0}},
        "bc_ops": {"gradient_squared": {"x": "periodic", "y": {"derivative": 0.5}}}},
}


@pytest.mark.parametrize("expression", EVALUATE)
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_evaluate_matches_jax(expression, backend):
    (ja, ta), (jb, tb) = _pair("cartesian 10x14 mixed", 0, 10), _pair("cartesian 10x14 mixed",
                                                                      0, 11)
    kwargs = dict(EVALUATE[expression])
    tkw = dict(kwargs)
    if "consts" in kwargs:
        kwargs["consts"] = {"k": 2.0, "c": ja}
        tkw["consts"] = {"k": 2.0, "c": ta}
    expected = jpde.evaluate(expression, {"a": ja, "b": jb}, **kwargs)
    got = tpde.evaluate(expression, {"a": ta, "b": tb}, label="e", backend=backend, **tkw)
    assert type(got).__name__ == type(expected).__name__ and got.label == "e"
    _close(got, expected)


@pytest.mark.parametrize("expression", ["laplace(a) * b", "gradient(a) + 0 * b",
                                        "divergence(gradient(a)) + gradient_squared(b)"])
def test_evaluate_through_the_cuda_registry(expression):
    """``backend="cuda"`` takes the registry's kernels (their plain versions on
    CPU tensors), as ``pde_tpu``'s evaluate matches its field operators."""
    (ja, ta), (jb, tb) = _pair("unit 16x12 periodic", 0, 12), _pair("unit 16x12 periodic", 0, 13)
    expected = jpde.evaluate(expression, {"a": ja, "b": jb})
    _close(tpde.evaluate(expression, {"a": ta, "b": tb}, backend="cuda"), expected)


def test_evaluate_refusals():
    _, ta = _pair("polar 16")
    with pytest.raises(NotImplementedError, match="no kernel"):
        tpde.evaluate("laplace(a)", {"a": ta}, backend="cuda")
    with pytest.raises(RuntimeError, match="Undefined"):
        tpde.evaluate("laplace(a) + q", {"a": ta})
    with pytest.raises(ValueError, match="at least one"):
        tpde.evaluate("1", {})


# -- the complex parts, apply and the collection API ---------------------------------------
def test_real_imag_conjugate_apply_match_jax():
    jgrid, tgrid = (pkg.UnitGrid([8, 10]) for pkg in (jpde, tpde))
    data = np.random.default_rng(14).random((8, 10)) + 1j * np.random.default_rng(15).random(
        (8, 10))
    jf, tf = jpde.ScalarField(jgrid, data), tpde.ScalarField(tgrid, data)
    assert tf.is_complex and tf.writeable and not tf.readonly
    for name in ("real", "imag"):
        _close(getattr(tf, name), getattr(jf, name))
    _close(tf.conjugate(), jf.conjugate())
    _close(tf.apply(lambda d: d * 2 + 1), jf.apply(lambda d: d * 2 + 1))
    real_j, real_t = jf.real, tf.real
    real_j._label = real_t.label = "u"
    _close(real_t.apply("laplace(u) + u**2"), real_j.apply("laplace(u) + u**2"))
    out = tf.real.copy()
    assert tf.real.apply(torch.sin, out=out) is out
    _close(out, np.sin(np.real(data)))
    _close(tf.real.imag, np.zeros((8, 10)), scale=1.0)


def test_collection_api_matches_jax():
    (ja, ta), (jb, tb) = _pair("unit 16x12 periodic", 0, 16), _pair("unit 16x12 periodic", 1, 17)
    jc = jpde.FieldCollection.from_dict({"a": ja, "b": jb})
    tc = tpde.FieldCollection.from_dict({"a": ta, "b": tb})
    assert tc.labels == ["a", "b"] and not tc.is_complex
    appended = tc.append(ta, tc, label="more")
    assert len(appended) == 5 and appended.label == "more"
    assert appended[0] is not ta and appended[0] == ta
    for g, e in zip(appended, jc.append(ja, jc), strict=True):
        _close(g, e)
    _close(tc.apply("laplace(a) * a"), jc.apply("laplace(a) * a"))
    _close(tc.apply(lambda d: d**2), jc.apply(lambda d: d**2))
    for g, e in zip(tc.real, jc.real, strict=True):
        _close(g, e)
    for g, e in zip(-tc.conjugate(), -jc.conjugate(), strict=True):
        _close(g, e)


# -- projections, slices and the data of plots -----------------------------------------------
@pytest.mark.parametrize("method", ["integral", "average", "max", "min"])
def test_project_and_slice_match_jax(method):
    jf, tf = _pair("cartesian 6x5x7 (3D)", 0, 18)
    for axes in ("x", ["y", "z"], 1):
        got, expected = tf.project(axes, method), jf.project(axes, method)
        assert got.grid == tpde.GridBase.from_state(expected.grid.state_serialized)
        _close(got, expected)
    for position in ({"x": 0.3}, {"y": 1.9, "z": 1.2}):
        _close(tf.slice(position), jf.slice(position))
    with pytest.raises(ValueError, match="outside"):
        tf.slice({"x": 5.0})


PLOT_DATA = {
    "unit 16x12 periodic": ["auto", "cut_y", "project_x", "project_y"],
    "unit 64 (1D)": ["auto", "project_x"],
    "cartesian 6x5x7 (3D)": ["cut_z", "project_y"],
    "polar 16": ["auto"],
    "spherical 12": ["radial"],
    "cylindrical 8x10": ["auto", "cut_r", "project_z", "project_r"],
}


def _dicts_close(got, expected):
    assert set(got) == set(expected)
    for key, value in expected.items():
        if isinstance(value, (str, type(None))):
            assert got[key] == value, key
        elif np.ma.isMaskedArray(value):
            assert np.array_equal(np.ma.getmaskarray(got[key]), np.ma.getmaskarray(value))
            _close(np.ma.filled(got[key], 0.0), np.ma.filled(value, 0.0))
        else:
            _close(np.asarray(got[key], dtype=float), np.asarray(value, dtype=float))


@pytest.mark.parametrize("grid_id", PLOT_DATA)
def test_plot_data_matches_jax(grid_id):
    jf, tf = _pair(grid_id, 0, 19)
    jf._label = tf.label = "f"
    for extract in PLOT_DATA[grid_id]:
        _dicts_close(tf.get_line_data(extract=extract), jf.get_line_data(extract=extract))
    if tf.grid.num_axes > 1 or isinstance(tf.grid, tpde.grids.spherical.SphericalSymGridBase):
        _dicts_close(tf.get_image_data(), jf.get_image_data())
    jv, tv = _pair(grid_id, 1, 20)
    if grid_id == "unit 16x12 periodic":
        _dicts_close(tv.get_vector_data(), jv.get_vector_data())
        _dicts_close(tv.get_vector_data(max_points=4), jv.get_vector_data(max_points=4))
    if tf.grid.num_axes > 1:
        _dicts_close(tv.get_image_data(scalar="norm"), jv.get_image_data(scalar="norm"))


def test_from_state_data_and_compatibility_match_jax():
    (jf, tf), (jv, tv) = _pair("unit 16x12 periodic", 0, 21), _pair("unit 16x12 periodic", 1, 22)
    got = tpde.ScalarField.from_state_data({"grid": tf.grid, "label": "s", "dtype": "x"}, tf.data)
    expected = jpde.ScalarField.from_state_data({"grid": jf.grid, "label": "s", "dtype": "x"},
                                                jf.data)
    assert got.label == expected.label == "s"
    _close(got, expected)
    tf.assert_field_compatible(tf.copy())
    tf.assert_field_compatible(tv, accept_scalar=True)
    for call in (lambda: tf.assert_field_compatible(tv), lambda: tf.assert_field_compatible(1.0)):
        with pytest.raises(TypeError):
            call()
    _close(tf * tv, jf * jv)  # a scalar field times a vector field is a vector field
    assert type(tv / tf).__name__ == "VectorField"
