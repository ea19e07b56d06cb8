"""Faults C1-C7 and C9-C17 of the port (ROADMAP §C), each held against ``pde_tpu`` on the
CPU in fp64 on the 12x10 grid of the re-anchor (and a 6x5x7 one) with inputs
from ``default_rng(0)``. The old max differences are recorded beside each case."""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.grids.boundaries import BCDataError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
SHAPE = (12, 10)


def _grids():
    return jpde.UnitGrid(list(SHAPE)), tpde.UnitGrid(list(SHAPE))


def _data(rank):
    return np.random.default_rng(0).random((2,) * rank + SHAPE)


# -- C1: the normal_* conditions ------------------------------------------------------------
# Before the repair the whole-grid form fell back to auto_periodic_neumann; the
# max differences from pde_tpu were 7.47 (ScalarField.laplace, normal_value),
# 2.00 (VectorField.laplace, normal_value) and 1.00 (normal_derivative)
NORMAL_BCS = {
    "normal_value": {"normal_value": 1.0},
    "normal_derivative": {"normal_derivative": 0.5},
    "normal_mixed": {"normal_mixed": 2.0},
    "normal_curvature": {"normal_curvature": 0.3},
    "per axis": {"x": {"normal_value": 1.0}, "y": {"normal_derivative": -0.5}},
    "per side": {"x-": {"normal_dirichlet": 0.2}, "x+": {"type": "normal_robin", "value": 1.0,
                                                         "const": 0.5},
                 "y": "derivative"},
}


@pytest.mark.parametrize("bc", NORMAL_BCS, ids=list(NORMAL_BCS))
def test_normal_conditions_match_jax(bc):
    jgrid, tgrid = _grids()
    bc = NORMAL_BCS[bc]
    for rank, jcls, tcls in ((0, jpde.ScalarField, tpde.ScalarField),
                             (1, jpde.VectorField, tpde.VectorField)):
        data = _data(rank)
        expected = jcls(jgrid, data).laplace(bc).data
        got = tcls(tgrid, data, dtype=torch.float64).laplace(bc).data
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_normal_value_vector_laplace_euler_steps_match_jax():
    """Ten Euler steps of PDE({"u": "vector_laplace(u)"}) at dt = 0.01 (old
    difference 0.148); the kernels apply one condition to every plane, so the
    port runs its plain loop here and says why."""
    jgrid, tgrid = _grids()
    data = _data(1)
    bc = {"normal_value": 1.0}
    expected = jpde.PDE({"u": "vector_laplace(u)"}, bc=bc).solve(
        jpde.VectorField(jgrid, data), t_range=0.1, dt=0.01, tracker=None)
    eq = tpde.PDE({"u": "vector_laplace(u)"}, bc=bc)
    got = eq.solve(tpde.VectorField(tgrid, data, dtype=torch.float64), t_range=0.1, dt=0.01,
                   tracker=None)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)
    assert "normal conditions" in eq.diagnostics["solver"]["fused_unsupported"]
    with pytest.raises(RuntimeError, match="normal conditions"):
        eq.solve(tpde.VectorField(tgrid, data, dtype=torch.float64), t_range=0.1, dt=0.01,
                 tracker=None, backend="cuda")


def test_unknown_condition_names_raise():
    _, tgrid = _grids()
    field = tpde.ScalarField(tgrid, _data(0), dtype=torch.float64)
    for bc in ({"nromal_value": 1.0}, {"x": "periodic", "z": {"value": 1}}):
        with pytest.raises(BCDataError):
            field.laplace(bc)
    with pytest.raises(BCDataError):
        field.laplace({"x": {"normal_velocity": 1}})


# -- C2: the engine names -------------------------------------------------------------------
def test_registered_backends_match_jax():
    """Before the repair `numba`, `numba_mpi` and `scipy` raised "Unknown
    backend"; the port adds its own engine `cuda`."""
    ours = set(tpde.registered_backends())
    assert ours - {"cuda"} == set(jpde.registered_backends())
    _, tgrid = _grids()
    state = tpde.ScalarField(tgrid, _data(0), dtype=torch.float64)
    eq = tpde.DiffusionPDE(0.1)
    reference = eq.solve(state, t_range=0.05, dt=0.01, tracker=None)
    for name in ("numba", "numba_mpi", "scipy"):
        got = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, backend=name)
        torch.testing.assert_close(got.data, reference.data, rtol=0, atol=0)


# -- C3: solve's arguments ------------------------------------------------------------------
def test_solve_arguments_match_jax():
    """Before the repair ret_info raised TypeError, `explicit` and solver
    classes raised "Unknown solver method" (tests/solvers of pde_tpu)."""
    jgrid, tgrid = _grids()
    data = _data(0)
    expected, jinfo = jpde.DiffusionPDE(0.1).solve(
        jpde.ScalarField(jgrid, data), t_range=0.05, dt=0.01, tracker=None, ret_info=True,
        solver="explicit", backend="numpy",
    )
    eq = tpde.DiffusionPDE(0.1)
    state = tpde.ScalarField(tgrid, data, dtype=torch.float64)
    got, info = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, ret_info=True,
                         solver="explicit")
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)
    assert {"controller", "solver"} <= set(info) and {"controller", "solver"} <= set(jinfo)
    assert info["solver"]["class"] == jinfo["solver"]["class"] == "ExplicitSolver"
    assert info["solver"]["steps"] == jinfo["solver"]["steps"] == 5
    by_class = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, solver=tpde.EulerSolver,
                        gather_mode="main")
    torch.testing.assert_close(by_class.data, got.data, rtol=0, atol=0)
    with pytest.raises(TypeError, match="not an instance"):
        eq.solve(state, t_range=0.05, dt=0.01, tracker=None, solver=tpde.EulerSolver(eq))
    with pytest.raises(ValueError, match="gather_mode"):
        eq.solve(state, t_range=0.05, dt=0.01, tracker=None, gather_mode="some")


# -- C4: negative component indices ---------------------------------------------------------
def test_negative_component_indices_match_jax():
    """Before the repair `VectorField[-1]` raised (get_axis_index rejects
    negative integers); pde_tpu indexes the data."""
    jgrid, tgrid = _grids()
    vec, ten = _data(1), _data(2)
    jvec, tvec = jpde.VectorField(jgrid, vec), tpde.VectorField(tgrid, vec, dtype=torch.float64)
    jten = jpde.Tensor2Field(jgrid, ten)
    tten = tpde.Tensor2Field(tgrid, ten, dtype=torch.float64)
    for key in (-1, -2, 1, "x", "y"):
        np.testing.assert_array_equal(tvec[key].data.numpy(), np.asarray(jvec[key].data))
    for key in ((-1, 0), (0, -1), (-2, -2), ("y", -1)):
        np.testing.assert_array_equal(tten[key].data.numpy(), np.asarray(jten[key].data))
    tvec[-1] = tpde.ScalarField(tgrid, np.ones(SHAPE), dtype=torch.float64)
    jvec[-1] = jpde.ScalarField(jgrid, np.ones(SHAPE))
    np.testing.assert_array_equal(tvec.data.numpy(), np.asarray(jvec.data))
    tten[-1, 0] = 2.0
    jten[-1, 0] = 2.0
    np.testing.assert_array_equal(tten.data.numpy(), np.asarray(jten.data))


# -- C5: field equality ------------------------------------------------------------------------
# Before the repair `==` was identity: equal fields compared False, and `!=` True
def _pair(jcls, tcls, jgrid, tgrid, data, dtype=torch.float64):
    return jcls(jgrid, data), tcls(tgrid, data, dtype=dtype)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_field_equality_matches_jax(rank):
    jgrid, tgrid = _grids()
    jcls = (jpde.ScalarField, jpde.VectorField, jpde.Tensor2Field)[rank]
    tcls = (tpde.ScalarField, tpde.VectorField, tpde.Tensor2Field)[rank]
    data = np.round(_data(rank) * 64) / 64  # exact in fp32 too
    ja, ta = _pair(jcls, tcls, jgrid, tgrid, data)
    other_grid = (jpde.UnitGrid([12, 10], periodic=True), tpde.UnitGrid([12, 10], periodic=True))
    others = {
        "copy of the data": _pair(jcls, tcls, jgrid, tgrid, data.copy()),
        "other data": _pair(jcls, tcls, jgrid, tgrid, data + 1),
        "one cell changed": _pair(jcls, tcls, jgrid, tgrid,
                                  np.where(np.arange(data.size).reshape(data.shape) == 7, 0.5,
                                           data)),
        "fp32 data": (jcls(jgrid, data.astype(np.float32)),
                      tcls(tgrid, data, dtype=torch.float32)),
        "other grid": _pair(jcls, tcls, *other_grid, data),
        "NaN": _pair(jcls, tcls, jgrid, tgrid, np.where(data > 0.5, np.nan, data)),
    }
    if rank == 0:
        others["a vector field"] = _pair(jpde.VectorField, tpde.VectorField, jgrid, tgrid,
                                         np.stack([data, data]))
    for label, (jb, tb) in others.items():
        want = bool(ja == jb)
        assert (ta == tb) is want and (tb == ta) is want, label
        assert (ta != tb) is (not want), label
    assert ta == ta and ta == ta.copy() and not ta != ta.copy()
    assert (ta == 1.0) is False and (ja == 1.0) is False  # not a field: identity
    assert hash(ta) == id(ta) and hash(ja) == id(ja)
    nan = tcls(tgrid, np.full(data.shape, np.nan), dtype=torch.float64)
    assert bool(nan == nan) is bool(jcls(jgrid, np.full(data.shape, np.nan)) ==
                                    jcls(jgrid, np.full(data.shape, np.nan)))


def test_collection_equality_matches_jax():
    jgrid, tgrid = _grids()
    s, v = _data(0), _data(1)

    def both(scalar, vector):
        return (jpde.FieldCollection([jpde.ScalarField(jgrid, scalar),
                                      jpde.VectorField(jgrid, vector)]),
                tpde.FieldCollection([tpde.ScalarField(tgrid, scalar, dtype=torch.float64),
                                      tpde.VectorField(tgrid, vector, dtype=torch.float64)]))

    ja, ta = both(s, v)
    cases = {
        "copies": both(s.copy(), v.copy()),
        "other scalar": both(s + 1, v),
        "other vector": both(s, v * 2),
        "fewer fields": (jpde.FieldCollection([jpde.ScalarField(jgrid, s)]),
                         tpde.FieldCollection([tpde.ScalarField(tgrid, s, dtype=torch.float64)])),
    }
    for label, (jb, tb) in cases.items():
        want = bool(ja == jb)
        assert (ta == tb) is want and (ta != tb) is (not want), label
    assert (ta == ta.fields[0]) is bool(ja == ja.fields[0])
    assert hash(ta) == id(ta)


# -- C6: the list and low/high forms of boundary conditions ------------------------------------
# Before the repair both raised BCDataError ("Unsupported boundary format", or
# "Unknown boundary condition data ['low', 'high']")
LIST_GRIDS = {
    "2d": ([12, 10], [{"value": 1}, {"derivative": 2}]),
    "3d": ([6, 5, 7], [{"value": 1}, {"derivative": 2}, ({"value": -1}, {"curvature": 0.5})]),
}
LIST_FORMS = {
    "list": lambda axes: axes,
    "low/high": lambda axes: {"low": {"value": 1}, "high": {"derivative": 2}},
    "low/high mixed": lambda axes: {"low": {"type": "mixed", "value": 2.0, "const": 0.5},
                                    "high": "dirichlet"},
}
OPERATORS = {  # operator: rank of its input
    "laplace": 0, "gradient": 0, "gradient_squared": 0, "divergence": 1,
    "vector_gradient": 1, "vector_laplace": 1, "tensor_divergence": 2,
}


def _apply(package, grid, operator, data, bc):
    cls = (package.ScalarField, package.VectorField, package.Tensor2Field)[OPERATORS[operator]]
    field = (cls(grid, data) if package is jpde else cls(grid, data, dtype=torch.float64))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = field.apply_operator(operator, bc)
    return np.asarray(result.data), sorted({w.category.__name__ for w in caught})


@pytest.mark.parametrize("form", LIST_FORMS)
@pytest.mark.parametrize("grid_id", LIST_GRIDS)
def test_list_and_low_high_forms_match_jax(grid_id, form):
    shape, axes = LIST_GRIDS[grid_id]
    bc = LIST_FORMS[form](axes)
    jgrid, tgrid = jpde.UnitGrid(shape), tpde.UnitGrid(shape)
    for operator, rank in OPERATORS.items():
        data = np.random.default_rng(rank).random((len(shape),) * rank + tuple(shape))
        expected, jwarn = _apply(jpde, jgrid, operator, data, bc)
        got, twarn = _apply(tpde, tgrid, operator, data, bc)
        np.testing.assert_allclose(got, expected, **TOL, err_msg=operator)
        assert twarn == jwarn, operator  # the list form warns, as in pde_tpu
    if form == "list":
        assert jwarn == ["DeprecationWarning"]


def test_list_forms_without_accept_lists():
    """With ``boundaries.accept_lists`` off the list form raises what pde_tpu
    raises; a low/high dict is unknown data, which the port refuses (C1)
    where pde_tpu drops it with a log line."""
    jgrid, tgrid = _grids()
    data = _data(0)
    with jpde.config({"boundaries.accept_lists": False}), \
            tpde.config({"boundaries.accept_lists": False}):
        with pytest.raises(jpde.grids.boundaries.BCDataError, match="Unsupported boundary"):
            jpde.ScalarField(jgrid, data).laplace([{"value": 1}, {"derivative": 2}])
        field = tpde.ScalarField(tgrid, data, dtype=torch.float64)
        with pytest.raises(BCDataError, match="Unsupported boundary"):
            field.laplace([{"value": 1}, {"derivative": 2}])
        with pytest.raises(BCDataError, match="low"):
            field.laplace({"low": {"value": 1}, "high": {"derivative": 2}})
    with pytest.raises(BCDataError, match="3 conditions for 2 axes"), \
            pytest.warns(DeprecationWarning):
        tpde.ScalarField(tgrid, data, dtype=torch.float64).laplace(["value"] * 3)


# -- C7: names pde_tpu accepts --------------------------------------------------------------
# Before the repair the keys raised KeyError and the options TypeError
CONFIG_KEYS = ("boundaries.accept_lists", "operators.conservative_stencil",
               "operators.tensor_symmetry_check", "operators.cartesian.default_backend",
               "numba.multithreading_threshold")


@pytest.mark.parametrize("key", CONFIG_KEYS)
def test_config_keys_match_jax(key):
    assert tpde.config[key] == jpde.config[key]
    value = {bool: False, str: "jnp", int: 17}[type(jpde.config[key])]
    with tpde.config({key: value}):
        assert tpde.config[key] == value
    assert tpde.config[key] == jpde.config[key]


def test_unported_options_raise_naming_a4():
    jgrid, tgrid = _grids()
    data = _data(0)
    jfield = jpde.ScalarField(jgrid, data)
    field = tpde.ScalarField(tgrid, data, dtype=torch.float64, with_ghost_cells=False)
    bc = {"derivative": 0.5}
    np.testing.assert_allclose(field.laplace(bc, spectral=False).data.numpy(),
                               np.asarray(jfield.laplace(bc, spectral=False).data), **TOL)
    np.testing.assert_allclose(field.gradient(bc, method="central").data.numpy(),
                               np.asarray(jfield.gradient(bc, method="central").data), **TOL)
    # data with ghost cells (ported with A4's second item): the valid cells are kept
    full = np.random.default_rng(1).random((2,) + tuple(n + 2 for n in SHAPE))
    for rank, jcls, tcls in ((0, jpde.ScalarField, tpde.ScalarField),
                             (1, jpde.VectorField, tpde.VectorField)):
        got = tcls(tgrid, full[0] if rank == 0 else full, dtype=torch.float64,
                   with_ghost_cells=True)
        expected = jcls(jgrid, full[0] if rank == 0 else full, with_ghost_cells=True)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(expected.data))
    # ported with A4's third item: one-sided differences (every grid), and the
    # spectral Laplacian on periodic grids (pde_tpu's ValueError elsewhere)
    for method in ("forward", "backward"):
        np.testing.assert_allclose(field.gradient(bc, method=method).data.numpy(),
                                   np.asarray(jfield.gradient(bc, method=method).data), **TOL)
    for f in (jfield, field):
        with pytest.raises(ValueError, match="periodic"):
            f.laplace(bc, spectral=True)


# -- C9: the top-level names ------------------------------------------------------------------
# Before the repair 37 names that pde_tpu exports at its top level, and the module
# aliases pdes, tools and explicit_mpi, were ported but not exported:
# `from pde_tpu_torch import DirichletBC` raised ImportError.
# ROADMAP A8's second item: until it, using one of these raised NotImplementedError
# naming A8 (test_c10_unported_names_raise_naming_a8 now checks each object's kind)
A8_NAMES = [
    "InteractivePlotTracker", "LivePlotTracker", "PlotTracker", "MovieStorage", "Movie",
    "ScalarFieldPlot", "extract_field", "movie", "movie_multiple", "movie_scalar",
    "plot_interactive", "plot_kymograph", "plot_kymographs", "plot_magnitudes",
    "BoundariesSetter"]
C9_REPAIRED = [
    "AdaptiveSolverBase", "SolverBase", "TrackerBase", "TrackerCollection", "FinishedSimulation",
    "DataFieldBase", "RankError", "DimensionError", "PeriodicityError", "Config", "Parameter",
    "ScalarExpression", "OperatorInfo", "NumpyBackend", "discretize_interval",
    "registered_solvers", "parse_interrupt", "InterruptsBase", "ConstantInterrupts",
    "RealtimeInterrupts", "set_default_bc", "get_boundary_axis", "BCBase", "BCDataError",
    "BoundariesBase", "BoundariesList", "BoundaryAxisBase", "BoundaryPair", "BoundaryPeriodic",
    "DirichletBC", "NeumannBC", "MixedBC", "CurvatureBC", "NormalDirichletBC",
    "NormalNeumannBC", "NormalMixedBC", "NormalCurvatureBC", "pdes", "tools", "explicit_mpi",
    # ROADMAP A8's first item: trackers, interrupts and storage
    "CallbackTracker", "DataTracker", "MaterialConservationTracker", "MaxRuntimeTracker",
    "PrintTracker", "RuntimeTracker", "SteadyStateTracker", "StorageTracker", "WalltimeTracker",
    "TransformedTrackerBase", "registered_trackers", "get_named_trackers", "FixedInterrupts",
    "GeometricInterrupts", "LogarithmicInterrupts", "FileStorage", "MemoryStorage",
    "ModelrunnerStorage", "StorageBase", "StorageView", "get_memory_storage",
    # ROADMAP A4's second item: the expression layer, the models and the grid API
    "evaluate", "KleinGordonPDE", "KuramotoSivashinskyPDE", "ReactionDiffusionPDE",
    "DomainError", "environment", "registered_grids", "registered_operators",
    # ROADMAP A8's second item: plot trackers, movies, views and user ghost setters
    *A8_NAMES,
    # ROADMAP A7: the Milstein solver, with the multiplicative noise it needs
    "MilsteinSolver",
]
# pde_tpu's top-level names whose objects the port does not have yet, by ROADMAP item
C9_UNPORTED = {
    # C2: pde_tpu's engine classes; the port's engines take their names ('torch' and
    # 'cuda' stand for 'xla' and 'pallas')
    "BackendBase": "C2", "PallasBackend": "C2", "XLABackend": "C2",
}


def _top_level_names(pkg) -> set:
    """A package's public top-level names, without the submodules that its
    star imports carry along (the module aliases are names of the API)."""
    import types

    return {name for name in dir(pkg) if not name.startswith("_") and (
        not isinstance(getattr(pkg, name), types.ModuleType)
        or name in ("pdes", "tools", "explicit_mpi"))}


def test_c9_top_level_names_match_jax():
    """Every public top-level name of pde_tpu is a top-level name of the port,
    but for the listed unported ones, each waiting for its ROADMAP item."""
    missing = _top_level_names(jpde) - _top_level_names(tpde)
    assert missing == set(C9_UNPORTED), sorted(missing ^ set(C9_UNPORTED))
    assert not set(C9_UNPORTED) & set(dir(tpde))


@pytest.mark.parametrize("name", C9_REPAIRED)
def test_c9_repaired_names_import(name):
    namespace = {}
    exec(f"from pde_tpu_torch import {name}", namespace)
    port, reference = namespace[name], getattr(jpde, name)
    assert type(port) is type(reference)
    if isinstance(reference, type) or callable(reference):
        assert port.__name__ == reference.__name__


def test_c9_aliases_are_the_modules():
    from pde_tpu_torch import DirichletBC, SolverBase, Config  # noqa: F401

    assert tpde.pdes is tpde.models and tpde.tools is tpde.utils
    assert tpde.explicit_mpi.ExplicitShardedSolver is tpde.ExplicitShardedSolver
    bcs = tpde.UnitGrid([4, 4]).get_boundary_conditions({"value": 1.0})
    assert all(isinstance(pair.low, tpde.DirichletBC) for pair in bcs)


# -- C10: tracker and storage names that pde_tpu accepts ------------------------------------------
# Before the repair `tracker="steady_state"`, "print" and "plot" raised ValueError("Unknown
# tracker"), a callable tracker ValueError("Cannot initialize trackers"),
# `ConsistencyTracker(interval=1)` TypeError and `parse_interrupt("0:01")` or a list
# NotImplementedError; the port had no storage package.
C10_WORKING = ["steady_state", "print", "a callable", "interval=", "a duration string",
               "a list of times", "storage"]


@pytest.mark.parametrize("case", C10_WORKING)
def test_c10_tracker_forms_match_jax(case):
    """Each form runs in both packages to the same final state and interrupt times."""
    results = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([8, 8], periodic=True)
        data = np.random.default_rng(0).random((8, 8))
        state = (pkg.ScalarField(grid, data) if pkg is jpde else
                 tpde.ScalarField(grid, data, dtype=torch.float64))
        seen = []
        tracker = {
            "steady_state": lambda: "steady_state",
            "print": lambda: "print",
            "a callable": lambda: lambda f, t: seen.append(t),
            "interval=": lambda: pkg.ConsistencyTracker(interval=0.5),
            "a duration string": lambda: pkg.CallbackTracker(
                lambda f, t: seen.append(t), interrupts=pkg.parse_interrupt("0:01")),
            "a list of times": lambda: pkg.CallbackTracker(
                lambda f, t: seen.append(t), interrupts=pkg.parse_interrupt([0.2, 0.7])),
            "storage": lambda: pkg.MemoryStorage().tracker(0.5),
        }[case]()
        result = pkg.DiffusionPDE(0.1).solve(state, t_range=1.0, dt=0.1, tracker=tracker)
        if case == "storage":
            seen = list(tracker.storage.times)
        results.append((np.asarray(result.data), seen))
    np.testing.assert_allclose(results[1][0], results[0][0], **TOL)
    assert results[1][1] == results[0][1]


@pytest.mark.parametrize("name", ["plot", "interactive"])
def test_c10_plot_tracker_names_raise_naming_a8(name, tmp_path):
    """Until A8's second item these names raised NotImplementedError naming A8. Now
    ``tracker="plot"`` runs with Agg to pde_tpu's final state, and
    ``tracker="interactive"`` without napari raises pde_tpu's ImportError."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        import napari  # noqa: F401
    except ImportError:
        napari = None
    results = []
    for pkg in (jpde, tpde):
        data = np.random.default_rng(0).random((4, 4))
        state = pkg.ScalarField(pkg.UnitGrid([4, 4], periodic=True), data)
        if name == "interactive" and napari is None:
            with pytest.raises(ImportError, match="napari"):
                pkg.DiffusionPDE(0.1).solve(state, t_range=0.2, dt=0.1, tracker=name)
            continue
        result = pkg.DiffusionPDE(0.1).solve(state, t_range=0.2, dt=0.1, tracker=name)
        results.append(np.asarray(result.data))
    plt.close("all")
    if results:
        np.testing.assert_allclose(results[1], results[0], **TOL)


@pytest.mark.parametrize("name", sorted(A8_NAMES))
def test_c10_unported_names_raise_naming_a8(name):
    """Until A8's second item these names raised NotImplementedError naming A8. Now
    each is the kind of object pde_tpu's is (a class or a function of the same name
    and the same base classes' names), at the top level and in its package."""
    port, reference = getattr(tpde, name), getattr(jpde, name)
    assert type(port) is type(reference) and port.__name__ == reference.__name__
    if isinstance(reference, type):
        assert [c.__name__ for c in port.__mro__[1:]] == [
            c.__name__ for c in reference.__mro__[1:]]
    else:
        assert callable(port)
    if name in ("PlotTracker", "LivePlotTracker", "InteractivePlotTracker"):
        assert getattr(tpde.trackers, name) is port
        assert port.name == reference.name
    if name == "MovieStorage":
        from pde_tpu_torch.storage import MovieStorage

        assert MovieStorage is port
    if name == "BoundariesSetter":
        from pde_tpu_torch.grids.boundaries import BoundariesSetter

        assert BoundariesSetter is port
    with pytest.raises(AttributeError):
        tpde.no_such_name


# -- C11: arithmetic and mutation that pde_tpu accepts ---------------------------------------------
# Before the repair `2 / f` and `np.sin(f)` raised TypeError (no __rtruediv__, no
# __array_ufunc__), `f.data = array` and `fc[0] = field` AttributeError (no setter, no
# __setitem__).
def _c11_fields(pkg, rank=0, seed=0):
    grid = pkg.UnitGrid(list(SHAPE))
    data = np.random.default_rng(seed).random((2,) * rank + SHAPE) + 0.5
    cls = (pkg.ScalarField, pkg.VectorField)[rank]
    return cls(grid, data) if pkg is jpde else cls(grid, data, dtype=torch.float64)


def _c11_collection(pkg):
    return pkg.FieldCollection([_c11_fields(pkg, 0, 1), _c11_fields(pkg, 1, 2)],
                               labels=["u", "v"])


def _set_data(f, value):
    f.data = value
    return f


def _set_item(fc, index, value):
    fc[index] = value
    return fc


C11_CALLS = {
    "2 / f": lambda pkg: 2 / _c11_fields(pkg),
    "2.5 / vector": lambda pkg: 2.5 / _c11_fields(pkg, 1),
    "np.sin(f)": lambda pkg: np.sin(_c11_fields(pkg)),
    "np.exp(-f)": lambda pkg: np.exp(-_c11_fields(pkg)),
    "np.add(f, 2)": lambda pkg: np.add(_c11_fields(pkg), 2),
    "np.power(f, 3)": lambda pkg: np.power(_c11_fields(pkg), 3),
    "np.arctan2(f, g)": lambda pkg: np.arctan2(_c11_fields(pkg), _c11_fields(pkg, 0, 3)),
    "np.maximum(f, array)": lambda pkg: np.maximum(
        _c11_fields(pkg), np.random.default_rng(4).random(SHAPE) + 0.5),
    "np.multiply(f, 2, out=g)": lambda pkg: np.multiply(
        _c11_fields(pkg), 2, out=(_c11_fields(pkg, 0, 5),)),
    "np.float64 * f": lambda pkg: np.float64(1.5) * _c11_fields(pkg),
    "f.data = array": lambda pkg: _set_data(
        _c11_fields(pkg), np.random.default_rng(6).random(SHAPE)),
    "f.data = number": lambda pkg: _set_data(_c11_fields(pkg, 1), 3.0),
    "f.data = field": lambda pkg: _set_data(_c11_fields(pkg), _c11_fields(pkg, 0, 7)),
    "fc[0] = field": lambda pkg: _set_item(_c11_collection(pkg), 0, _c11_fields(pkg, 0, 8)),
    "fc['v'] = number": lambda pkg: _set_item(_c11_collection(pkg), "v", 2.0),
    "fc.data = array": lambda pkg: _set_data(
        _c11_collection(pkg), np.random.default_rng(9).random((3,) + SHAPE)),
}


@pytest.mark.parametrize("call", C11_CALLS)
def test_c11_calls_match_jax(call):
    expected, got = (C11_CALLS[call](pkg) for pkg in (jpde, tpde))
    assert type(got).__name__ == type(expected).__name__
    assert isinstance(got.data, torch.Tensor) and got.data.dtype == torch.float64
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


def test_c11_setters_copy_onto_the_field():
    """The setters copy into the field's device and dtype: the field takes a new
    tensor, the value's holder keeps it, and a float32 field stays float32."""
    field = tpde.ScalarField(tpde.UnitGrid([4, 4]), 0.0, dtype=torch.float32)
    value = torch.arange(16, dtype=torch.float64).reshape(4, 4)
    field.data = value
    assert field.data.dtype == torch.float32 and field.data is not value
    value += 1
    assert float(field.data[3, 3]) == 15.0
    with pytest.raises(NotImplementedError, match="no torch counterpart"):
        np.spacing(field)


# -- C12: in-place operators ---------------------------------------------------------------------
# Before the repair the port had no __iadd__ etc.: `f += 1` rebound the name to a new
# field, so after `g = f; f += 1` the other name kept the old values.
C12_OPS = {"+=": "__iadd__", "-=": "__isub__", "*=": "__imul__", "/=": "__itruediv__"}


@pytest.mark.parametrize("op", C12_OPS)
def test_c12_inplace_keeps_the_field(op):
    results = []
    for pkg in (jpde, tpde):
        f = _c11_fields(pkg)
        g = f
        old = f.data
        scope = {"f": f, "x": _c11_fields(pkg, 0, 10)}
        exec(f"f {op} 1.5\nf {op} x", scope)
        assert scope["f"] is g
        results.append(g)
        if pkg is tpde:  # other holders of the old tensor keep the old values
            np.testing.assert_array_equal(old.numpy(), _c11_fields(tpde).data.numpy())
    np.testing.assert_allclose(results[1].data.numpy(), np.asarray(results[0].data), **TOL)


@pytest.mark.parametrize("op", C12_OPS)
def test_c12_collection_inplace_matches_jax_out_of_place(op):
    """pde_tpu's collections raise on `fc += 1` (AttributeError: no `_data`; not
    copied): the port's is held against pde_tpu's out-of-place `fc + 1`."""
    expected = eval(f"fc {op[0]} 1.5", {"fc": _c11_collection(jpde)})
    fc = _c11_collection(tpde)
    fields = fc.fields
    scope = {"fc": fc}
    exec(f"fc {op} 1.5", scope)
    assert scope["fc"] is fc and fc.fields == fields and fc.labels == ["u", "v"]
    for got, want in zip(fc, expected, strict=True):
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), **TOL)


# -- C13: names pde_tpu accepts --------------------------------------------------------------------
# Before the repair each raised a bare TypeError or AttributeError in the port (an
# unexpected `backend=`/`allow_symmetric=`/`mode=` argument, a missing method or
# attribute), or, for the constant conditions' representation, returned the
# placeholder "DirichletBC @ axis 0".
C13_BC = {"x-": {"value": 1.5}, "x+": {"derivative": 2.0}, "y": "periodic"}
C13_CONST_BCS = [{"value": 1.5}, {"derivative": -0.5}, {"type": "mixed", "value": 2.0,
                                                         "const": 0.5}, {"curvature": 1.0}]


def _c13_grid(pkg):
    return pkg.UnitGrid([6, 5], periodic=[False, True])


def _c13_bcs(pkg):
    return _c13_grid(pkg).get_boundary_conditions(C13_BC)


def _c13_state(pkg, rank=0, seed=0):
    grid = pkg.UnitGrid(list(SHAPE), periodic=True)
    cls = {0: pkg.ScalarField, 1: pkg.VectorField, 2: pkg.Tensor2Field}[rank]
    data = np.random.default_rng(seed).random((2,) * rank + SHAPE)
    return cls(grid, data, **({"dtype": torch.float64} if pkg is tpde else {}))


def _c13_models(pkg):
    return [pkg.DiffusionPDE(0.3), pkg.CahnHilliardPDE(), pkg.AllenCahnPDE(),
            pkg.KPZInterfacePDE(), pkg.KuramotoSivashinskyPDE(), pkg.SwiftHohenbergPDE(),
            pkg.WavePDE(), pkg.KleinGordonPDE(), pkg.ReactionDiffusionPDE(["u"], [1], ["u"])]


def _c13_rhs(pkg, method):
    """The lowered rhs of a model and of an expression PDE, with `backend=`."""
    state = _c13_state(pkg)
    out = []
    for eq in (pkg.DiffusionPDE(0.3), pkg.PDE({"c": "laplace(c) - c**3"})):
        rhs = getattr(eq, method)(state, backend="numpy")
        out += [np.asarray(x) for x in rhs([state.data], 0.0)]
    return out


def _c13_noise_realization(pkg):
    eq = pkg.DiffusionPDE(0.3, noise=0.1)
    try:
        eq.make_noise_realization(_c13_state(pkg), backend="numpy")
    except NotImplementedError:
        return "NotImplementedError"
    return "made"


def _c13_products(pkg, method, rank):
    a, b = _c13_state(pkg, rank, 1), _c13_state(pkg, rank, 2)
    op = getattr(a, method)(backend="numpy")
    return np.asarray(op(a.data, b.data))


def _c13_config(pkg):
    c = pkg.Config(mode="insert")
    c["a.b"] = 3
    c.mode = "locked"
    try:
        c["a.b"] = 4
    except RuntimeError as err:
        locked = str(err)
    return c.get("a.b"), c.get("missing", 7), c.items(), locked, list(c)


def _c13_expression(pkg):
    func = pkg.ScalarExpression("x**2 + sin(x)", signature=["x"]).get_compiled()
    x = np.linspace(0, 1, 5)
    return np.asarray(func(x if pkg is jpde else torch.as_tensor(x)))


def _c13_sides(pkg, attr, *args):
    bcs = _c13_bcs(pkg)
    return [getattr(bc, attr)(*args) for bc in (bcs["x-"], bcs["x+"], bcs[1][0])]


def _c13_representations(pkg):
    grid = pkg.CartesianGrid([(0.5, 2.0), (1.0, 3.0)], [4, 5])
    return [grid.get_boundary_conditions(bc).get_mathematical_representation("c")
            for bc in C13_CONST_BCS]


C13_CASES = {
    "make_pde_rhs(backend=)": lambda pkg: _c13_rhs(pkg, "make_pde_rhs"),
    "make_evolution_rate": lambda pkg: _c13_rhs(pkg, "make_evolution_rate"),
    "check_rhs_consistency": lambda pkg: [eq.check_rhs_consistency(_c13_state(pkg)) for eq in (
        pkg.DiffusionPDE(0.3), pkg.PDE({"c": "laplace(c) - c**3"}))],
    "make_noise_realization(backend=)": _c13_noise_realization,
    "VectorField.make_dot_operator(backend=)":
        lambda pkg: _c13_products(pkg, "make_dot_operator", 1),
    "VectorField.make_outer_prod_operator(backend=)":
        lambda pkg: _c13_products(pkg, "make_outer_prod_operator", 1),
    "Tensor2Field.make_dot_operator(backend=)":
        lambda pkg: _c13_products(pkg, "make_dot_operator", 2),
    "get_axis_index(allow_symmetric=)": lambda pkg: [
        _c13_grid(pkg).get_axis_index(key, allow_symmetric=False) for key in ("y", 0, "x")],
    "Config(mode=), get, items": _c13_config,
    "complex_valued": lambda pkg: [eq.complex_valued for eq in _c13_models(pkg)],
    "DiffusionPDE.explicit_time_dependence, expression": lambda pkg: [
        pkg.DiffusionPDE.explicit_time_dependence, pkg.DiffusionPDE(0.3).expression,
        pkg.DiffusionPDE(1).expression, pkg.DiffusionPDE(0).expression],
    "UnitGrid.to_cartesian": lambda pkg: repr(pkg.UnitGrid([3, 4], periodic=[True, False])
                                              .to_cartesian()),
    "ScalarExpression.get_compiled": _c13_expression,
    "BoundariesList[index]": lambda pkg: [repr(_c13_bcs(pkg)[i]) for i in (0, 1, -1, "x-",
                                                                          "x+", "y-")],
    "BoundariesList.boundaries": lambda pkg: [repr(bc) for bc in _c13_bcs(pkg).boundaries],
    "BoundariesList.copy": lambda pkg: (repr(_c13_bcs(pkg).copy()),
                                        _c13_bcs(pkg).copy() == _c13_bcs(pkg)),
    "BoundariesList.to_subgrid": lambda pkg: repr(_c13_bcs(pkg).to_subgrid(
        pkg.UnitGrid([3, 5], periodic=[False, True]))),
    "BoundariesList.check_value_rank": lambda pkg: _c13_bcs(pkg).check_value_rank(1),
    "BoundariesList.get_help": lambda pkg: type(_c13_bcs(pkg)).get_help().split(". ")[0],
    "pair copy": lambda pkg: [repr(pair.copy()) for pair in _c13_bcs(pkg)],
    "pair to_subgrid": lambda pkg: [repr(pair.to_subgrid(pkg.UnitGrid([3, 5], periodic=[
        False, True]))) for pair in _c13_bcs(pkg)],
    "pair get_mathematical_representation": lambda pkg: [
        pair.get_mathematical_representation("u") for pair in _c13_bcs(pkg)],
    "get_virtual_point": lambda pkg: _c13_sides(
        pkg, "get_virtual_point", np.random.default_rng(3).random((6, 5)), (2,)),
    "get_sparse_matrix_data": lambda pkg: _c13_sides(pkg, "get_sparse_matrix_data", (0, 3)),
    "local to_subgrid": lambda pkg: [repr(bc) for bc in _c13_sides(
        pkg, "to_subgrid", pkg.UnitGrid([3, 5], periodic=[False, True]))],
    "constant conditions' get_mathematical_representation": _c13_representations,
}


def _c13_same(got, expected):
    if isinstance(expected, dict):
        assert sorted(got) == sorted(expected)
        for key in expected:
            _c13_same(got[key], expected[key])
    elif isinstance(expected, (list, tuple)):
        assert len(got) == len(expected)
        for a, b in zip(got, expected, strict=True):
            _c13_same(a, b)
    elif isinstance(expected, (np.ndarray, np.generic)) and not isinstance(expected, np.bool_):
        np.testing.assert_allclose(np.asarray(got), expected, **TOL)
    else:
        assert got == expected


@pytest.mark.parametrize("case", C13_CASES)
def test_c13_names_match_jax(case):
    _c13_same(C13_CASES[case](tpde), C13_CASES[case](jpde))


def test_c13_split_mpi_raises_naming_a9():
    """pde_tpu shards one field over its device mesh; the port places a copy
    on the mesh's first device and keeps the mesh on it, the decomposition
    pde_tpu chooses over its eight CPU devices, the data equal."""
    state = _c13_state(tpde)
    with tpde.config({"parallel.devices_per_device": 8}):
        split = state.split_mpi()
    jax_mesh = jpde.GridMesh.from_grid(_c13_state(jpde).grid, "auto")
    assert split.mesh.decomposition == list(jax_mesh.decomposition)
    assert split.grid is state.grid and split is not state
    np.testing.assert_array_equal(split.data.numpy(),
                                  np.asarray(_c13_state(jpde).split_mpi().data))


def test_c13_local_to_subgrid_refuses_inhomogeneous_values():
    for pkg in (jpde, tpde):
        grid = _c13_grid(pkg)
        bc = grid.get_boundary_conditions({"x": {"value": np.linspace(0, 1, 5)},
                                           "y": "periodic"})["x-"]
        with pytest.raises(NotImplementedError, match="Inhomogeneous"):
            bc.to_subgrid(pkg.UnitGrid([3, 5], periodic=[False, True]))


# -- C14: the plot methods and a tracker attribute that pde_tpu has ------------------------------
# Before the repair each of these raised a bare AttributeError in the port. A call gives
# what pde_tpu's gives: the drawn arrays, the napari layers, the image's field, or the
# error pde_tpu raises where an optional package (napari here) is missing.
C14_NAMES = [(cls, attr) for cls in ("ScalarField", "VectorField", "Tensor2Field")
             for attr in ("plot", "plot_interactive", "_get_napari_data")] + [
    ("Tensor2Field", "plot_components"), ("FieldCollection", "plot"),
    ("FieldCollection", "plot_interactive"), ("ScalarField", "from_image"),
    ("SteadyStateTracker", "progress_bar_format")]


def _c14_field(pkg, cls):
    grid = pkg.CartesianGrid([(0, 2), (-1, 3)], [6, 5])
    rank = {"VectorField": 1, "Tensor2Field": 2}.get(cls, 0)
    data = np.random.default_rng(14).random((2,) * rank + (6, 5))
    if pkg is tpde:
        data = torch.as_tensor(data)
    if cls == "FieldCollection":
        return pkg.FieldCollection([pkg.ScalarField(grid, data, label="a"),
                                    pkg.ScalarField(grid, 2 * data, label="b")])
    return getattr(pkg, cls)(grid, data, label="f")


def _c14_drawn(ref):
    """The arrays a plot reference's artist holds."""
    if isinstance(ref, list):
        return [_c14_drawn(r) for r in ref]
    element = ref.element
    if hasattr(element, "U"):  # a quiver
        return [np.asarray(element.U), np.asarray(element.V)]
    return [np.asarray(element.get_array()), list(element.get_extent())]


def _c14_call(pkg, cls, attr, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if attr == "progress_bar_format":
        return pkg.SteadyStateTracker().progress_bar_format
    if attr == "from_image":
        image = tmp_path / "image.png"
        plt.imsave(image, np.random.default_rng(15).random((7, 9)), cmap="gray")
        field = pkg.ScalarField.from_image(image, label="img")
        return [np.asarray(field.data), repr(field.grid), field.label, str(field.data.dtype)[-7:]]
    field = _c14_field(pkg, cls)
    try:
        if attr == "plot_interactive":
            return field.plot_interactive()
        if attr == "_get_napari_data":
            return {k: {"type": v["type"], "data": np.asarray(v["data"])}
                    for k, v in field._get_napari_data().items()}
        return _c14_drawn(getattr(field, attr)())
    except ImportError as err:
        return ("raises", type(err).__name__, "napari" in str(err))
    finally:
        plt.close("all")


@pytest.mark.parametrize("cls, attr", C14_NAMES)
def test_c14_names_exist(cls, attr):
    assert hasattr(getattr(tpde, cls), attr)


@pytest.mark.parametrize("cls, attr", C14_NAMES)
def test_c14_calls_match_jax(cls, attr, tmp_path):
    _c13_same(_c14_call(tpde, cls, attr, tmp_path), _c14_call(jpde, cls, attr, tmp_path))


# -- C15: a state-dependent variance taken to the host ------------------------------------------
# Before the repair the Euler-Maruyama noise step passed every variance and derivative
# through np.asarray, which raises a bare TypeError for a CUDA tensor: a model with
# multiplicative noise ran on the CPU only. Here a tensor whose __array__ raises stands
# in for a CUDA tensor.
class _DeviceOnly(torch.Tensor):
    """A tensor that refuses to become a host array, as a CUDA tensor does."""

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert a device tensor to numpy")


def _c15_model(pkg, interpretation, device_only):
    class Multiplicative(pkg.DiffusionPDE):
        def make_noise_variance(self, state, *, ret_diff=False):
            def var_diff(leaves, t):
                var = [0.01 * (1 + y**2) for y in leaves]
                diff = [0.02 * y for y in leaves]
                if device_only:
                    var = [v.as_subclass(_DeviceOnly) for v in var]
                    diff = [d.as_subclass(_DeviceOnly) for d in diff]
                return var, diff

            return var_diff if ret_diff else (lambda leaves, t: var_diff(leaves, t)[0])

    eq = Multiplicative(0.1, noise=0.01)
    eq.noise_interpretation = interpretation
    return eq


@pytest.mark.parametrize("solver", ["euler", "milstein"])
@pytest.mark.parametrize("interpretation", ["ito", "stratonovich", "anti-ito"])
def test_c15_tensor_variance_stays_on_its_device(solver, interpretation):
    """A variance and derivative returned as device tensors run through the
    noise step of Euler-Maruyama and Milstein without a host conversion, with
    the results of ordinary tensors (and the drift term of Stratonovich and
    anti-Itô on the same route)."""
    _, grid = _grids()
    state = tpde.ScalarField(grid, _data(0), dtype=torch.float64)
    runs = []
    for device_only in (True, False):
        eq = _c15_model(tpde, interpretation, device_only)
        eq.rng = np.random.default_rng(3)
        runs.append(eq.solve(state, t_range=0.01, dt=1e-3, tracker=None, solver=solver).data)
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(TypeError, match="device tensor"):
        np.asarray(torch.ones(2).as_subclass(_DeviceOnly))


@pytest.mark.parametrize("interpretation", ["ito", "stratonovich"])
def test_c15_noise_step_matches_jax(interpretation, monkeypatch):
    """The Euler-Maruyama noise step of a state-dependent variance against
    pde_tpu's on the same unit increments."""
    import jax
    import jax.numpy as jnp
    from pde_tpu.models import base as jax_base

    jgrid, tgrid = _grids()
    data = _data(0)
    normals = torch.empty(SHAPE, dtype=torch.float64).normal_(
        generator=torch.Generator().manual_seed(5)).numpy()
    monkeypatch.setattr(jax_base, "make_increment_draw",
                        lambda: lambda key, shape, dtype=None: jnp.asarray(normals))
    jeq, teq = _c15_model(jpde, interpretation, False), _c15_model(tpde, interpretation, True)
    (jinc,) = jeq.make_sde_noise_step(jpde.ScalarField(jgrid, data))(
        [jnp.asarray(data)], 0.0, jax.random.key(0), 1e-3)
    tstate = tpde.ScalarField(tgrid, data, dtype=torch.float64)
    (tinc,) = teq.make_sde_noise_step(tstate)([tstate.data], 0.0,
                                              torch.Generator().manual_seed(5), 1e-3)
    np.testing.assert_allclose(tinc.as_subclass(torch.Tensor).numpy(), np.asarray(jinc), **TOL)


# -- C16: grid.integrate of numbers and numpy arrays ----------------------------------------
# Before the repair the port's integrate took tensors only: integrate(1.0) and
# integrate(2) raised AttributeError, a numpy array TypeError; pde_tpu returns
# the grid's volume (12.0 on [0, 4] x [0, 3]) and integrates the arrays
C16_GRIDS = {
    "cartesian": lambda pkg: pkg.CartesianGrid([[0, 4], [0, 3]], [16, 12]),
    "polar": lambda pkg: pkg.PolarSymGrid((1, 3), 8),
    "cylindrical": lambda pkg: pkg.CylindricalSymGrid(4, [0, 8], [16, 32]),
}
C16_INPUTS = {
    "float": (lambda shape: 1.0, {}),
    "int": (lambda shape: 2, {}),
    "array": (lambda shape: np.random.default_rng(0).random(shape), {}),
    "array axes": (lambda shape: np.random.default_rng(1).random(shape), {"axes": 0}),
    "tensor": (lambda shape: torch.as_tensor(np.random.default_rng(2).random(shape)), {}),
}


@pytest.fixture
def _default_float64():
    """Python scalars take torch's default dtype: float64 for the fp64 comparison."""
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(previous)


@pytest.mark.usefixtures("_default_float64")
@pytest.mark.parametrize("kind", C16_INPUTS)
@pytest.mark.parametrize("grid", C16_GRIDS)
def test_c16_integrate_matches_jax(grid, kind):
    jgrid, tgrid = C16_GRIDS[grid](jpde), C16_GRIDS[grid](tpde)
    make, kwargs = C16_INPUTS[kind]
    data = make(tgrid.shape)
    expected = np.asarray(jgrid.integrate(
        data.numpy() if isinstance(data, torch.Tensor) else data, **kwargs))
    result = tgrid.integrate(data, **kwargs)
    assert isinstance(result, torch.Tensor) and result.dtype == torch.float64
    assert result.device.type == "cpu" and tuple(result.shape) == expected.shape
    np.testing.assert_allclose(result.numpy(), expected, **TOL)
    if grid == "cartesian" and kind == "float":
        assert float(result) == 12.0


def test_c16_integrate_keeps_dtypes():
    """A numpy array keeps its dtype, a tensor its own, a Python scalar takes
    torch's default dtype, and integer data integrates as numpy promotes it."""
    grid = tpde.CartesianGrid([[0, 4], [0, 3]], [16, 12])
    ones = np.ones(grid.shape)
    assert grid.integrate(ones.astype(np.float32)).dtype == torch.float32
    assert grid.integrate(torch.ones(grid.shape, dtype=torch.float64)).dtype == torch.float64
    assert grid.integrate(1.0).dtype == torch.get_default_dtype()
    assert float(grid.integrate(ones.astype(np.int64))) == pytest.approx(12.0)


# -- C17: bf16 fields at the host boundary ---------------------------------------------------
# Before the repair each call raised a bare TypeError on a bf16 field ("can't convert
# np.ndarray of type ml_dtypes.bfloat16", "Got unsupported ScalarType BFloat16", and for
# pde_tpu's serialized "<V2" dtype "can't convert np.ndarray of type numpy.void"). The port
# holds bf16 on the host as float32, which holds every bf16 value exactly.
def _c17_fields():
    import jax.numpy as jnp

    values = np.random.default_rng(0).uniform(-1.0, 1.0, SHAPE).astype(jnp.bfloat16)
    jfield = jpde.ScalarField(jpde.UnitGrid(list(SHAPE)), values)
    tfield = tpde.ScalarField(tpde.UnitGrid(list(SHAPE)), values)
    return values, jfield, tfield


def test_c17_field_from_a_bf16_array():
    values, jfield, tfield = _c17_fields()
    assert tfield.dtype == torch.bfloat16
    np.testing.assert_array_equal(tfield.to_numpy(), np.asarray(jfield.data, dtype=np.float32))
    assert tfield.to_numpy().dtype == np.float32
    assert tfield.attributes["dtype"] == jfield.attributes["dtype"] == "bfloat16"


def test_c17_attributes_serialized_match_jax():
    _, jfield, tfield = _c17_fields()
    assert tfield.attributes_serialized == jfield.attributes_serialized
    assert json.loads(tfield.attributes_serialized["dtype"]) == "<V2"


def test_c17_line_data_match_jax():
    _, jfield, tfield = _c17_fields()
    expected, got = jfield.get_line_data(), tfield.get_line_data()
    assert got["data_y"].dtype == np.float32
    np.testing.assert_array_equal(got["data_y"], np.asarray(expected["data_y"], dtype=np.float32))
    np.testing.assert_array_equal(got["data_x"], expected["data_x"])


def test_c17_memory_storage_matches_jax():
    _, jfield, tfield = _c17_fields()
    jstorage, tstorage = jpde.MemoryStorage(), tpde.MemoryStorage()
    for storage, field in ((jstorage, jfield), (tstorage, tfield)):
        storage.start_writing(field)
        storage.append(field, 0.5)
        storage.end_writing()
    assert tstorage.info["field_attributes"] == jstorage.info["field_attributes"]
    np.testing.assert_array_equal(tstorage.data[0], np.asarray(jstorage.data[0], dtype=np.float32))
    assert tstorage[0].dtype == torch.bfloat16
    torch.testing.assert_close(tstorage[0].data, tfield.data, rtol=0, atol=0)


@pytest.mark.parametrize("source", ["from_state", "field_from_state", "hdf5 of pde_tpu",
                                    "hdf5 round trip", "movie"])
def test_c17_state_crosses_from_jax(source, tmp_path):
    """A pde_tpu bf16 field's state (its "<V2" dtype and its ml_dtypes data, or
    the two-byte voids h5py reads back) becomes a bf16 field of the same
    values; a movie's frames quantize bf16 data in float32, as numpy promotes
    pde_tpu's bf16 host data, to the same bytes."""
    from pde_tpu_torch.interop import field_from_state

    _, jfield, tfield = _c17_fields()
    if source == "movie":
        for pkg, field in ((jpde, jfield), (tpde, tfield)):
            movie = pkg.MovieStorage(str(tmp_path / f"{pkg.__name__}.mov"), vmin=-1, vmax=1)
            movie.start_writing(field)
            movie.append(field, 0.0)
            movie.end_writing()
        assert (tmp_path / "pde_tpu.mov").read_bytes() == \
            (tmp_path / "pde_tpu_torch.mov").read_bytes()
        return
    if source == "from_state":
        got = tpde.FieldBase.from_state(jfield.attributes_serialized, np.asarray(jfield.data))
    elif source == "field_from_state":
        got = field_from_state(jfield.attributes_serialized, np.asarray(jfield.data))
    elif source == "hdf5 of pde_tpu":
        jfield.to_file(str(tmp_path / "j.h5"))
        got = tpde.FieldBase.from_file(str(tmp_path / "j.h5"))
    else:
        tfield.to_file(str(tmp_path / "t.h5"))
        got = tpde.FieldBase.from_file(str(tmp_path / "t.h5"))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.data, tfield.data, rtol=0, atol=0)
    assert got.attributes_serialized == jfield.attributes_serialized


# -- C19: the engines' methods ----------------------------------------------------------------
# Before the repair the port's engines carried make_operator alone:
# `get_backend("numpy").make_pde_rhs(eq, state)` raised a bare AttributeError
ENGINE_METHODS = [
    "numpy_to_native", "native_to_numpy", "compile_function", "make_operator",
    "make_operator_no_bc", "get_operator_info", "make_ghost_cell_setter", "make_integrator",
    "make_interpolator", "make_inner_prod_operator", "make_outer_prod_operator", "make_pde_rhs",
    "make_expression_function", "make_mpi_synchronizer", "make_gaussian_noise", "make_stepper"]


@pytest.mark.parametrize("name", sorted(set(jpde.registered_backends())
                                        | set(tpde.registered_backends())))
def test_c19_every_engine_has_every_method(name):
    engine = tpde.get_backend(name)
    reference = jpde.get_backend("pallas" if name == "cuda" else name)
    for method in ENGINE_METHODS:
        assert callable(getattr(reference, method)) and callable(getattr(engine, method)), method
    assert tpde.get_backend(name) is engine  # the registry's instance, as pde_tpu's


def _c19_vectors(pkg):
    grid = pkg.UnitGrid(list(SHAPE))
    data = _data(1)
    return pkg.VectorField(grid, data), pkg.VectorField(grid, data[::-1].copy())


def _c19_case(pkg, method, engine):
    """The values of one engine method of `pkg` (the port's engine `engine`,
    pde_tpu's of the same name), as host float64 arrays."""
    backend = pkg.get_backend(engine if pkg is tpde else
                              {"torch": "jax", "numpy": "numpy"}[engine])
    grid = pkg.UnitGrid(list(SHAPE))
    values = _data(0)
    field = pkg.ScalarField(grid, values)
    # pde_tpu's engines take jax arrays throughout (its numpy engine's ghost setter
    # fails on numpy arrays); the port's take their own native data
    native = backend.numpy_to_native if pkg is tpde else jnp.asarray

    def host(x):
        x = x[0] if isinstance(x, (list, tuple)) else x
        return np.asarray(backend.native_to_numpy(x), dtype=np.float64)

    if method == "make_operator_no_bc":
        full = np.random.default_rng(1).random(tuple(n + 2 for n in SHAPE))
        return host(backend.make_operator_no_bc(grid, "laplace")(native(full)))
    if method == "make_operator":
        return host(backend.make_operator(grid, "laplace", {"derivative": 0.5})(native(values)))
    if method == "make_integrator":
        return host(backend.make_integrator(grid)(native(values)))
    if method == "make_pde_rhs":
        eq = pkg.PDE({"c": "laplace(c) - c**3"}, bc={"value": 0.2})
        return host(backend.make_pde_rhs(eq, field)([native(values)], 0.5))
    if method == "make_inner_prod_operator":
        a, b = _c19_vectors(pkg)
        return host(backend.make_inner_prod_operator(a)(native(a.data), native(b.data)))
    if method == "make_outer_prod_operator":
        a, b = _c19_vectors(pkg)
        return host(backend.make_outer_prod_operator(a)(native(a.data), native(b.data)))
    if method == "make_interpolator":
        points = np.random.default_rng(2).uniform(1.0, 9.0, (7, 2))
        return host(backend.make_interpolator(field)(native(values), native(points)))
    if method == "make_stepper":
        eq = pkg.DiffusionPDE(0.1, bc={"derivative": 0})
        solver = pkg.ExplicitSolver(eq, backend=engine if pkg is tpde else "numpy")
        result = backend.make_stepper(solver, field, 0.01)(field, 0.0, 0.2)
        result = result[0] if isinstance(result, tuple) else result
        return np.asarray(result.data, dtype=np.float64)
    if method == "make_ghost_cell_setter":
        full = np.zeros(tuple(n + 2 for n in SHAPE))
        full[1:-1, 1:-1] = values
        bcs = grid.get_boundary_conditions({"x": {"value": 0.3}, "y": {"derivative": -0.2}})
        return host(backend.make_ghost_cell_setter(bcs)(native(full), 0.0, None))
    if method == "make_expression_function":
        expression = pkg.ScalarExpression("sin(x) * y + 2")
        x, y = np.linspace(0, 1, 5), np.linspace(1, 2, 5)
        return host(backend.make_expression_function(expression)(native(x), native(y)))
    if method == "get_operator_info":
        info = backend.get_operator_info(grid, "gradient")
        return np.array([info.rank_in, info.rank_out], dtype=np.float64)
    if method == "compile_function":
        return host(backend.compile_function(lambda x: 2 * x + 1)(native(values)))
    if method == "numpy_to_native":
        return host(native(values))
    if method == "make_mpi_synchronizer":
        return host(backend.make_mpi_synchronizer()(native(values)))
    raise AssertionError(method)


C19_COMPARED = [m for m in ENGINE_METHODS if m not in ("native_to_numpy", "make_gaussian_noise")]


@pytest.mark.parametrize("engine", ["torch", "numpy"])
@pytest.mark.parametrize("method", C19_COMPARED)
def test_c19_methods_match_jax(method, engine):
    """Each method's values on the 12x10 fp64 grid against pde_tpu's engine of
    the same kind (native_to_numpy in each case's round trip)."""
    with jpde.config({"dtype": "float64"}) if "dtype" in jpde.config else _nullcontext():
        expected = _c19_case(jpde, method, engine)
    with tpde.config({"dtype": torch.float64}) if "dtype" in tpde.config else _nullcontext():
        got = _c19_case(tpde, method, engine)
    np.testing.assert_allclose(got, expected, **TOL)


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


@pytest.mark.parametrize("engine", ["torch", "numpy", "cuda"])
def test_c19_native_types_and_noise(engine):
    """The native type (a tensor on the config's device, the numpy engine's a
    host array); the noise: the state's shape and dtype, mean and variance
    within 6 standard errors, a stream of its own per call of the factory
    seed."""
    backend = tpde.get_backend(engine)
    native = backend.numpy_to_native(np.arange(6.0).reshape(2, 3), dtype=np.float32)
    if engine == "numpy":
        assert isinstance(native, np.ndarray) and native.dtype == np.float32
    else:
        assert isinstance(native, torch.Tensor) and native.dtype == torch.float32
        assert native.device.type == "cpu"
    np.testing.assert_array_equal(backend.native_to_numpy(native), np.arange(6.0).reshape(2, 3))
    state = tpde.ScalarField(tpde.UnitGrid([64, 64]), 0.0, dtype=torch.float64)
    noise = backend.make_gaussian_noise(state, rng=0)
    first, second = torch.as_tensor(noise()), torch.as_tensor(noise())
    assert first.shape == state.data.shape and first.dtype == torch.float64
    assert not torch.equal(first, second)
    again = torch.as_tensor(backend.make_gaussian_noise(state, rng=0)())
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    n = first.numel()
    assert abs(float(first.mean())) < 6 / n**0.5
    assert abs(float(first.var()) - 1.0) < 6 * (2 / n) ** 0.5


# -- C20: the names of the packages and modules -----------------------------------------------
# Before the repair C9's check compared the top level alone: `from pde_tpu_torch.grids import
# BoundariesSetter`, `from pde_tpu_torch.fields import RankError`, `from pde_tpu_torch.ops
# import wrap_with_bcs` and `pde_tpu_torch.utils.environment` raised, and
# packages_from_requirements and ops.common's make_full_padder were missing
C20_JAX_ONLY = {
    # the engines' class names (C2: 'torch' and 'cuda' stand for 'jax' and 'pallas')
    "pde_tpu": set(C9_UNPORTED),
    "pde_tpu.backends": set(C9_UNPORTED),
    # helpers of traced JAX code
    "pde_tpu.grids.base": {"axis_coords_traced", "cell_coords_traced", "cell_volumes_traced",
                           "local_slice_traced", "radial_factor_traced"},
    # the halo pad of a sharded jax.Array
    "pde_tpu.parallel.fused": {"make_halo_pad"},
    "pde_tpu.utils.spectral": {"make_correlated_noise_jax"},
}


def _c20_modules() -> list[str]:
    """pde_tpu's packages and modules whose namesake the port has."""
    import importlib.util
    import pkgutil

    names = ["pde_tpu"]
    for info in pkgutil.walk_packages(jpde.__path__, "pde_tpu."):
        port = "pde_tpu_torch" + info.name[len("pde_tpu"):]
        if importlib.util.find_spec(port) is not None:
            names.append(info.name)
    return names


def _c20_names(module) -> set:
    """A module's public names, but for its submodules and, outside a
    package's ``__init__``, the classes and functions it only imports."""
    import types

    package = hasattr(module, "__path__")
    return {name for name in dir(module) if not name.startswith("_")
            and not isinstance(getattr(module, name), types.ModuleType)
            and (package or getattr(getattr(module, name), "__module__", None)
                 == module.__name__)}


@pytest.mark.parametrize("name", _c20_modules())
def test_c20_module_names_match_jax(name):
    """Every public name a pde_tpu package or module defines or exports is a
    name of the port's namesake, but for the JAX-only ones."""
    import importlib

    reference = importlib.import_module(name)
    port = importlib.import_module("pde_tpu_torch" + name[len("pde_tpu"):])
    missing = _c20_names(reference) - set(dir(port))
    assert missing == C20_JAX_ONLY.get(name, set()), sorted(missing)


@pytest.mark.parametrize("statement", [
    "from pde_tpu_torch.grids import BoundariesSetter, OperatorInfo, discretize_interval",
    "from pde_tpu_torch.grids import BoundariesBase, BoundariesList, set_default_bc",
    "from pde_tpu_torch.fields import RankError",
    "from pde_tpu_torch.ops import make_derivative, make_derivative2, wrap_with_bcs",
    "from pde_tpu_torch.utils import environment",
    "from pde_tpu_torch.utils.config import packages_from_requirements",
    "from pde_tpu_torch.ops.common import make_full_padder",
])
def test_c20_names_import(statement):
    namespace = {}
    exec(statement, namespace)
    exec(statement.replace("pde_tpu_torch", "pde_tpu"), reference := {})
    for name in statement.split(" import ")[1].split(", "):
        assert namespace[name].__name__ == reference[name].__name__


def test_c20_full_padder_and_requirements(tmp_path):
    from pde_tpu.ops.common import make_full_padder as jax_padder
    from pde_tpu.utils.config import packages_from_requirements as jax_packages
    from pde_tpu_torch.ops.common import make_full_padder
    from pde_tpu_torch.utils.config import packages_from_requirements

    data = _data(1)
    got = make_full_padder(tpde.UnitGrid(list(SHAPE)), 1)(data)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_padder(jpde.UnitGrid(list(SHAPE)),
                                                                     1)(data)))
    requirements = tmp_path / "requirements.txt"
    requirements.write_text("# a comment\nnumpy>=1.20\n\ntorch==2.1\nsympy\n")
    assert packages_from_requirements(requirements) == jax_packages(requirements) == [
        "numpy", "torch", "sympy"]
    assert packages_from_requirements(tmp_path / "missing.txt") == []
