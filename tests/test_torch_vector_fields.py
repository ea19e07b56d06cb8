"""Vector and tensor fields on Cartesian grids, and the plain rank-1/2 operators.

The same numpy inputs go through ``pde_tpu`` and the port, fp64, at 1e-12:
``apply_operator`` returning the field class of the operator's output rank
(a fault of the port before this slice: ``ScalarField.apply_operator
("gradient")`` raised), the ``VectorField`` and ``Tensor2Field`` API, the
plain ``vector_gradient``, ``vector_laplace`` and ``tensor_divergence`` in 2D
and 3D under periodic, no-flux and mixed conditions on anisotropic grids,
and ``field_from_state`` round trips of vector, tensor and mixed-rank states.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.fields.base import RankError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
MIXED_2D = {"x-": {"value": 0.3}, "x+": {"derivative": 0.1},
            "y-": {"type": "mixed", "value": 2.0, "const": 0.5}, "y+": {"curvature": 0.2}}
MIXED_3D = {"x": {"value": 0.3}, "y": {"derivative": -0.2}, "z": {"curvature": 0.1}}

# id: (bounds, shape, periodic, bc)
GRIDS = {
    "2d periodic": ([(0, 2), (0, 3)], (12, 10), True, "auto_periodic_neumann"),
    "2d no-flux": ([(0, 2), (0, 3)], (12, 10), False, "auto_periodic_neumann"),
    "2d mixed": ([(0, 1), (0, 3)], (12, 10), False, MIXED_2D),
    "3d periodic": ([(0, 1), (0, 2), (0, 3)], (6, 5, 4), True, "periodic"),
    "3d no-flux": ([(0, 1), (0, 2), (0, 3)], (6, 5, 4), False, {"derivative": 0}),
    "3d mixed": ([(0, 1), (0, 2), (0, 3)], (6, 5, 4), False, MIXED_3D),
}


def _grids(case_id):
    bounds, shape, periodic, bc = GRIDS[case_id]
    return (jpde.CartesianGrid(bounds, shape, periodic=periodic),
            tpde.CartesianGrid(bounds, shape, periodic=periodic), bc)


def _carry(jfield):
    return tpde.field_from_state(jfield.attributes_serialized, np.asarray(jfield.data))


def _fields(jgrid, seed):
    rng = np.random.default_rng(seed)
    dim, shape = jgrid.dim, jgrid.shape
    return (jpde.ScalarField(jgrid, rng.uniform(-1, 1, shape)),
            jpde.VectorField(jgrid, rng.uniform(-1, 1, (dim, *shape))),
            jpde.Tensor2Field(jgrid, rng.uniform(-1, 1, (dim, dim, *shape))))


def _same(tfield, jfield):
    assert type(tfield).__name__ == type(jfield).__name__
    np.testing.assert_allclose(tfield.to_numpy(), np.asarray(jfield.data), **TOL)


def test_apply_operator_returns_the_output_rank():
    """``ScalarField.apply_operator("gradient")`` gives a ``VectorField``
    equal to ``pde_tpu``'s (it raised before the repair), and a rank
    mismatch raises ``RankError``."""
    jgrid, tgrid, _ = _grids("2d periodic")
    js, jv, _ = _fields(jgrid, 0)
    ts = _carry(js)
    result = ts.apply_operator("gradient", "periodic")
    assert isinstance(result, tpde.VectorField)
    _same(result, js.apply_operator("gradient", "periodic"))
    _same(ts.gradient("periodic"), js.gradient("periodic"))
    with pytest.raises(RankError):
        ts.apply_operator("divergence", "periodic")
    out = tpde.VectorField(tgrid)
    assert ts.apply_operator("gradient", "periodic", out=out) is out
    _same(out, js.gradient("periodic"))


@pytest.mark.parametrize("case_id", GRIDS)
def test_differential_operators_match_jax(case_id):
    """Gradient, divergence, vector gradient, vector Laplacian and tensor
    divergence through the fields' methods, against ``pde_tpu``'s."""
    jgrid, _, bc = _grids(case_id)
    js, jv, jt = _fields(jgrid, sorted(GRIDS).index(case_id))
    ts, tv, tt = _carry(js), _carry(jv), _carry(jt)
    assert isinstance(tv, tpde.VectorField) and isinstance(tt, tpde.Tensor2Field)
    _same(ts.gradient(bc), js.gradient(bc))
    _same(tv.divergence(bc), jv.divergence(bc))
    _same(tv.gradient(bc), jv.gradient(bc))
    _same(tv.laplace(bc), jv.laplace(bc))
    _same(tt.divergence(bc), jt.divergence(bc))


@pytest.mark.parametrize("case_id", GRIDS)
@pytest.mark.parametrize("op", ["vector_gradient", "vector_laplace", "tensor_divergence"])
def test_plain_operators_match_jax(case_id, op):
    """The plain operators from ``grid.make_operator`` on raw data."""
    jgrid, tgrid, bc = _grids(case_id)
    rank = 2 if op == "tensor_divergence" else 1
    data = np.random.default_rng(len(op)).uniform(-1, 1, (jgrid.dim,) * rank + jgrid.shape)
    expected = np.asarray(jgrid.make_operator(op, bc=bc)(data))
    got = tgrid.make_operator(op, bc=bc)(torch.as_tensor(data)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, **TOL)


def test_vector_laplace_keeps_the_corner_weight_rule():
    """Under a 2D corner weight the vector Laplacian is the 9-point one on
    every component, as ``pde_tpu``'s."""
    jgrid, tgrid, _ = _grids("2d periodic")
    _, jv, _ = _fields(jgrid, 1)
    key = "operators.cartesian.laplacian_2d_corner_weight"
    old = jpde.config[key]
    jpde.config[key] = 0.5
    try:
        with tpde.config({key: 0.5}):
            _same(_carry(jv).laplace("periodic"), jv.laplace("periodic"))
    finally:
        jpde.config[key] = old


def test_vector_field_api_matches_jax():
    jgrid, tgrid, _ = _grids("2d no-flux")
    js, jv, jt = _fields(jgrid, 2)
    _, jw, _ = _fields(jgrid, 3)
    ts, tv, tt, tw = _carry(js), _carry(jv), _carry(jt), _carry(jw)
    _same(tv.dot(tw), jv.dot(jw))
    _same(tv @ tt, jv @ jt)
    _same(tv.outer_product(tw), jv.outer_product(jw))
    a, b = torch.tensor(np.asarray(jv.data)), torch.tensor(np.asarray(jw.data))
    np.testing.assert_allclose(tv.make_dot_operator()(a, b).numpy(),
                               np.asarray(jv.make_dot_operator()(jv.data, jw.data)), **TOL)
    np.testing.assert_allclose(tv.make_outer_prod_operator()(a, b).numpy(),
                               np.asarray(jv.make_outer_prod_operator()(jv.data, jw.data)), **TOL)
    for scalar in ("auto", "norm", "max", "min", "squared_sum", "norm_squared", 1,
                   lambda d: d[0] * d[1]):
        _same(tv.to_scalar(scalar), jv.to_scalar(scalar))
    _same(tv["y"], jv["y"])
    _same(tv[0], jv[0])
    tv["x"], jv["x"] = ts, js
    _same(tv, jv)
    tv[1] = 0.5
    jv[1] = 0.5
    _same(tv, jv)
    _same(tpde.VectorField.from_scalars([ts, tv[1]]), jpde.VectorField.from_scalars([js, jv[1]]))
    with pytest.raises(ValueError):
        tpde.VectorField.from_scalars([ts])
    with pytest.raises(TypeError):
        tv.dot(ts)


def test_tensor_field_api_matches_jax():
    jgrid, tgrid, _ = _grids("3d mixed")
    js, jv, jt = _fields(jgrid, 4)
    _, _, ju = _fields(jgrid, 5)
    ts, tv, tt, tu = _carry(js), _carry(jv), _carry(jt), _carry(ju)
    _same(tt.dot(tv), jt.dot(jv))
    _same(tt @ tu, jt @ ju)
    a, b = torch.tensor(np.asarray(jt.data)), torch.tensor(np.asarray(jv.data))
    np.testing.assert_allclose(tt.make_dot_operator()(a, b).numpy(),
                               np.asarray(jt.make_dot_operator()(jt.data, jv.data)), **TOL)
    _same(tt.transpose, jt.transpose)
    _same(tt.transposed(), jt.transposed())
    _same(tt.symmetrize(), jt.symmetrize())
    _same(tt.symmetrize(make_traceless=True), jt.symmetrize(make_traceless=True))
    _same(tt.trace(), jt.trace())
    for scalar in ("auto", "norm", "min", "max", "squared_sum", "norm_squared", "trace",
                   "invariant1", "invariant2", "determinant", "invariant3"):
        _same(tt.to_scalar(scalar), jt.to_scalar(scalar))
    _same(tt["x", "z"], jt["x", "z"])
    _same(tt[2, 1], jt[2, 1])
    tt[0, "y"], jt[0, "y"] = ts, js
    _same(tt, jt)
    copy = tt.copy()
    assert copy.symmetrize(inplace=True) is copy
    _same(copy, jt.symmetrize())


def test_scalar_to_scalar_matches_jax():
    jgrid, _, _ = _grids("2d mixed")
    js, _, _ = _fields(jgrid, 6)
    ts = _carry(js)
    for scalar in ("auto", "abs", "norm", "real", "imag", "norm_squared", "squared_sum"):
        _same(ts.to_scalar(scalar), js.to_scalar(scalar))


@pytest.mark.parametrize("case_id", ["2d mixed", "3d periodic"])
def test_states_round_trip(case_id):
    """``field_from_state`` rebuilds vector, tensor and mixed-rank states
    from ``pde_tpu``'s serialized attributes and data; a collection's stacked
    data keeps ``pde_tpu``'s layout (a rank-r field on dim**r planes)."""
    jgrid, _, _ = _grids(case_id)
    js, jv, jt = _fields(jgrid, 8)
    for jfield in (jv, jt):
        tfield = _carry(jfield)
        _same(tfield, jfield)
        assert tfield.grid == tpde.CartesianGrid(*GRIDS[case_id][:2], periodic=GRIDS[case_id][2])
    jcol = jpde.FieldCollection([jv, js, jt], labels=["v", "s", "t"])
    tcol = _carry(jcol)
    assert [type(f).__name__ for f in tcol] == ["VectorField", "ScalarField", "Tensor2Field"]
    assert tcol.labels == ["v", "s", "t"]
    dim = jgrid.dim
    assert tcol.data.shape[0] == dim + 1 + dim * dim
    np.testing.assert_allclose(tcol.to_numpy(), np.asarray(jcol.data), **TOL)
    for tf, jf in zip(tcol, jcol, strict=True):
        _same(tf, jf)
    f32 = tpde.field_from_state(jcol.attributes_serialized, np.asarray(jcol.data),
                                dtype=torch.float32)
    assert all(f.dtype == torch.float32 for f in f32)
