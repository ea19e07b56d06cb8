"""Expression parsing, BC routing and the plain operators of the port against
``pde_tpu`` (fp64, CPU): ``PDE.evolution_rate`` at rtol = atol = 1e-12, and
``gradient`` / ``gradient_squared`` / ``divergence`` against the JAX
package's ``grid.make_operator``."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.models.base import expr_prod as jax_expr_prod
from pde_tpu_torch.models.base import expr_prod

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
MIXED_BC = {"x-": {"value": 1}, "x+": {"derivative": 0},
            "y-": {"derivative": 0.2}, "y+": {"type": "mixed", "value": 1.0, "const": 0.3}}
GRIDS = {
    "periodic": ("UnitGrid", ([16, 16],), True),
    "noflux": ("CartesianGrid", ([(0, 8), (0, 8)], (16, 16)), False),
    "anisotropic": ("CartesianGrid", ([(0, 1), (0, 4)], (12, 20)), False),
}
# id: (grid id, rhs, PDE keyword arguments)
RATE_CASES = {
    "cahn-hilliard": ("periodic", {"c": "laplace(c**3 - c - laplace(c))"}, {}),
    "cahn-hilliard-noflux": ("noflux", {"c": "laplace(c**3 - c - laplace(c))"},
                             {"bc": {"derivative": 0}}),
    "brusselator": ("periodic", {"u": "1 + u**2 * v - 2.2 * u + 0.1 * laplace(u)",
                                 "v": "1.2 * u - u**2 * v + 0.02 * laplace(v)"}, {}),
    "brusselator-neumann": ("noflux", {"u": "laplace(u) + 1 - 4 * u + u**2 * v",
                                       "v": "0.1 * laplace(v) + 3 * u - u**2 * v"}, {}),
    "divergence-gradient": ("periodic", {"c": "0.001 * divergence(gradient(c))"}, {}),
    "divergence-gradient-noflux": ("anisotropic", {"c": "divergence(gradient(c))"},
                                   {"bc": {"derivative": 0.3}}),
    "gradient-squared": ("anisotropic", {"c": "gradient_squared(c) - laplace(c)"},
                         {"bc": {"value": 1.5}}),
    "dot-gradients": ("noflux", {"u": "0.1 * laplace(u) + 0.05 * dot(gradient(u), gradient(v))",
                                 "v": "inner(gradient(v), gradient(u))"}, {}),
    "pointwise": ("anisotropic", {"c": "0.1 * laplace(c) + tanh(c) - exp(-c**2) + sqrt(c**2 + 1)"},
                  {"bc": MIXED_BC}),
    "shorthand": ("periodic", {"c": "∇²c - |∇c|² + c³"}, {}),
    "bc-routing": ("noflux", {"c": "laplace(c) + divergence(gradient(c))"},
                   {"bc": {"derivative": 0}, "bc_ops": {"laplace": {"value": 1}}}),
    "consts-time-coords": ("anisotropic", {"c": "a * sin(t) * c + x * laplace(c) - y"},
                           {"consts": {"a": 0.3}}),
    "heaviside-constant": ("periodic", {"u": "heaviside(u - 0.5) * laplace(u)", "v": "0"}, {}),
}


def _grids(grid_id):
    cls, args, periodic = GRIDS[grid_id]
    return (getattr(jpde, cls)(*args, periodic=periodic),
            getattr(tpde, cls)(*args, periodic=periodic))


def _states(grid_id, names, seed):
    jgrid, _ = _grids(grid_id)
    rng = np.random.default_rng(seed)
    fields = [jpde.ScalarField(jgrid, rng.uniform(0.1, 1.0, jgrid.shape), label=n) for n in names]
    jstate = fields[0] if len(fields) == 1 else jpde.FieldCollection(fields)
    return jstate, tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))


@pytest.mark.parametrize("case_id", RATE_CASES)
def test_evolution_rate_matches_jax(case_id):
    grid_id, rhs, kwargs = RATE_CASES[case_id]
    jstate, tstate = _states(grid_id, list(rhs), seed=len(case_id))
    jeq, teq = jpde.PDE(rhs, **kwargs), tpde.PDE(rhs, **kwargs)
    assert teq.expressions == jeq.expressions
    jrate, trate = jeq.evolution_rate(jstate, 0.7), teq.evolution_rate(tstate, 0.7)
    assert type(trate).__name__ == type(jrate).__name__
    np.testing.assert_allclose(trate.to_numpy(), np.asarray(jrate.data), **TOL)
    # make_pde_rhs gives one rate per leaf, the same as evolution_rate
    leaves = [f.data for f in tstate] if isinstance(tstate, tpde.FieldCollection) else [tstate.data]
    rates = teq.make_pde_rhs(tstate)(leaves, 0.7)
    assert len(rates) == len(rhs)
    np.testing.assert_allclose(torch.stack(rates).numpy().reshape(trate.to_numpy().shape),
                               trate.to_numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("bc_c,bc_mu", [(None, None), ({"derivative": 0}, {"value": 0.2})])
def test_cahn_hilliard_rate_matches_jax(bc_c, bc_mu):
    grid_id = "periodic" if bc_c is None else "noflux"
    jstate, tstate = _states(grid_id, ["c"], seed=3)
    jeq = jpde.CahnHilliardPDE(0.7, bc_c=bc_c, bc_mu=bc_mu)
    teq = tpde.CahnHilliardPDE(0.7, bc_c=bc_c, bc_mu=bc_mu)
    assert teq.expression == jeq.expression
    np.testing.assert_allclose(teq.evolution_rate(tstate).to_numpy(),
                               np.asarray(jeq.evolution_rate(jstate).data), **TOL)


BCS = {
    "periodic": "auto_periodic_neumann",
    "derivative": {"derivative": 0.3},
    "value": {"value": 1.5},
    "mixed-sides": MIXED_BC,
}


@pytest.mark.parametrize("bc_id", BCS)
@pytest.mark.parametrize("operator", ["gradient", "gradient_squared", "divergence"])
def test_plain_operators_match_jax(operator, bc_id):
    grid_id = "periodic" if bc_id == "periodic" else "anisotropic"
    jgrid, tgrid = _grids(grid_id)
    shape = ((2,) if operator == "divergence" else ()) + tuple(jgrid.shape)
    data = np.random.default_rng(11).random(shape)
    expected = jgrid.make_operator(operator, bc=BCS[bc_id])(data)
    got = tgrid.make_operator(operator, bc=BCS[bc_id])(torch.tensor(data))
    assert tuple(got.shape) == np.shape(expected)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_field_arithmetic_and_collection():
    jstate, tstate = _states("periodic", ["u", "v"], seed=5)
    assert isinstance(tstate, tpde.FieldCollection)
    assert tstate.labels == ["u", "v"] and len(tstate) == 2
    assert tstate["v"] is tstate[1]
    assert tstate.dtype == torch.float64 and tstate.device.type == "cpu"
    np.testing.assert_allclose(tstate.data.numpy(), np.asarray(jstate.data), rtol=0, atol=0)
    combined = (2 * tstate - 1.0) ** 2 / 3 + tstate
    expected = (2 * jstate - 1.0) ** 2 / 3 + jstate
    np.testing.assert_allclose(combined.to_numpy(), np.asarray(expected.data), **TOL)
    assert combined.labels == ["u", "v"]
    for got, ref in zip(tstate.averages, jstate.averages, strict=True):
        assert float(got) == pytest.approx(float(ref), rel=1e-12)
    copied = tstate.copy(dtype=torch.float32)
    assert copied.dtype == torch.float32 and copied[0].data is not tstate[0].data
    rnd = tpde.FieldCollection.scalar_random_uniform(
        2, tstate.grid, -1, 1, labels=["a", "b"], rng=np.random.default_rng(0)
    )
    ref = np.random.default_rng(0).uniform(-1, 1, (2,) + tstate.grid.shape)
    np.testing.assert_allclose(rnd.to_numpy(), ref.astype(np.float32), rtol=1e-6)


def test_expression_helpers_and_errors():
    for factor in (0, 1, -1, 0.5, 2e-3):
        assert expr_prod(factor, "∇²c") == jax_expr_prod(factor, "∇²c")
    with pytest.raises(ValueError, match="valid field name"):
        tpde.PDE({"1c": "c"})
    with pytest.raises(ValueError, match="denotes time"):
        tpde.PDE({"t": "laplace(t)"})
    with pytest.raises(ValueError, match="Forbidden"):
        tpde.PDE({"c": "__import__('os')"})
    noisy = tpde.PDE({"c": "laplace(c)"}, noise=0.1, rng=np.random.default_rng(0))
    assert noisy.is_sde
    grid = tpde.UnitGrid([8, 8], periodic=True)
    result = noisy.solve(tpde.ScalarField(grid, 0.0, dtype=torch.float64), t_range=0.01,
                         dt=1e-3, tracker=None)
    assert noisy.diagnostics["solver"]["stochastic"] is True
    assert float(result.fluctuations) > 0
    eq = tpde.PDE({"u": "laplace(u) + v", "v": "u"})
    assert eq.expression == jpde.PDE({"u": "laplace(u) + v", "v": "u"}).expression
    state = tpde.ScalarField(tpde.UnitGrid([8, 8], periodic=True), 1.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="Expected 2 fields"):
        eq.evolution_rate(state)
