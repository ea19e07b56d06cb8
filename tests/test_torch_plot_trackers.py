"""The plot trackers and the user ghost-cell setters of the port, held against
``pde_tpu`` on the CPU in fp64: ``PlotTracker`` and ``LivePlotTracker``
(``tracker="plot"``) write their ``output_file`` and draw the arrays
``pde_tpu``'s draw; ``BoundariesSetter`` runs (a callable ``bc=``) agree with
``pde_tpu``'s over 20 steps in 1D and 2D to 1e-12 and equal the same
conditions given as data, and the kernels' gates refuse the setter. (The
interactive tracker's queue protocol is in ``test_torch_interactive.py``.)
matplotlib draws with Agg; every figure is closed."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pde_tpu as jpde  # noqa: E402
import pde_tpu_torch as tpde  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu"}):
        yield
    plt.close("all")


def _state(pkg, shape=(10, 8), seed=0, collection=False):
    grid = pkg.UnitGrid(list(shape), periodic=True)
    data = np.random.default_rng(seed).random(shape)
    field = pkg.ScalarField(grid, data if pkg is jpde else torch.as_tensor(data), label="c")
    return pkg.FieldCollection([field, field * 2], labels=["a", "b"]) if collection else field


def _drawn(figure):
    images = [ax.images[0].get_array() for ax in figure.axes if ax.images]
    lines = [ax.lines[0].get_ydata() for ax in figure.axes if ax.lines]
    return [np.ma.getdata(a) for a in images] + [np.asarray(y) for y in lines]


@pytest.mark.parametrize("case", ["PlotTracker 2d", "PlotTracker collection",
                                  "LivePlotTracker 1d", "tracker='plot'"])
def test_plot_trackers_match_jax(case, tmp_path):
    """Each tracker draws the last interrupt's state, as pde_tpu's does, and
    writes its file; the figure it draws on is the one the last state updated."""
    drawn = {}
    for pkg in (jpde, tpde):
        shape = (12,) if "1d" in case else (10, 8)
        state = _state(pkg, shape, collection="collection" in case)
        output = tmp_path / f"{pkg.__name__}.png"
        kwargs = dict(output_file=str(output), title="t={time:.1f}")
        tracker = {"PlotTracker 2d": lambda: pkg.PlotTracker(0.3, **kwargs),
                   "PlotTracker collection": lambda: pkg.PlotTracker(0.3, **kwargs),
                   "LivePlotTracker 1d": lambda: pkg.LivePlotTracker(0.3, show=False,
                                                                     max_fps=np.inf, **kwargs),
                   "tracker='plot'": lambda: "plot"}[case]()
        captured = []
        original_close = plt.close
        # keep the figure the tracker closes at its end, to read what it drew
        plt.close = lambda fig=None: captured.append(fig) if fig is not None else original_close()
        eq = (pkg.PDE({"a": "laplace(a)", "b": "0.1 * laplace(b)"}) if "collection" in case
              else pkg.DiffusionPDE(0.1))
        try:
            result = eq.solve(state, t_range=0.9, dt=0.1, tracker=tracker)
        finally:
            plt.close = original_close
        drawn[pkg] = [_drawn(fig) for fig in captured if hasattr(fig, "axes")][-1:]
        drawn[pkg].append(np.asarray(result.data))
        if case != "tracker='plot'":
            assert output.stat().st_size > 0
            assert captured[-1]._suptitle.get_text() == "t=0.9"
    assert len(drawn[tpde]) == len(drawn[jpde]) == 2
    for got, expected in zip(drawn[tpde][0], drawn[jpde][0], strict=True):
        np.testing.assert_allclose(got, expected, **TOL)
    np.testing.assert_allclose(drawn[tpde][1], drawn[jpde][1], **TOL)


def test_plot_tracker_draws_the_host_copy():
    """Each drawn interrupt copies the state to the host once: the tracker's
    plot holds the final state's values."""
    tracker = tpde.PlotTracker(0.5)
    result = tpde.DiffusionPDE(0.1).solve(_state(tpde), t_range=1.0, dt=0.1,
                                          tracker=[tracker])
    np.testing.assert_allclose(np.ma.getdata(tracker._plot_ref.element.get_array()),
                               result.to_numpy().T, **TOL)


def _jax_setter(full, args=None):
    """Dirichlet 0 on every side of the full array (jax, functional)."""
    for axis in range(full.ndim):
        lo = [slice(None)] * full.ndim
        hi = [slice(None)] * full.ndim
        lo[axis], hi[axis] = 0, -1
        inner_lo, inner_hi = list(lo), list(hi)
        inner_lo[axis], inner_hi[axis] = 1, -2
        full = full.at[tuple(lo)].set(-full[tuple(inner_lo)])
        full = full.at[tuple(hi)].set(-full[tuple(inner_hi)])
    return full


def _torch_setter(full, args=None):
    """The same ghosts on a torch tensor, written into a copy."""
    full = full.clone()
    for axis in range(full.ndim):
        full.select(axis, 0).copy_(-full.select(axis, 1))
        full.select(axis, -1).copy_(-full.select(axis, -2))
    return full


def _time_setter(full, args=None):
    """Ghost values that follow the time the operators pass in ``args``."""
    full = full.clone()
    full[0], full[-1] = args["t"], -args["t"]
    return full


def _jax_time_setter(full, args=None):
    return full.at[0].set(args["t"]).at[-1].set(-args["t"])


@pytest.mark.parametrize("shape", [(16,), (12, 10)], ids=["1d", "2d"])
def test_boundaries_setter_matches_jax(shape):
    """20 Euler steps with a callable bc against pde_tpu's, and against the port's
    own run with the same condition as data (bc={"value": 0})."""
    data = np.random.default_rng(9).random(shape)
    results = {}
    for pkg, setter in ((jpde, _jax_setter), (tpde, _torch_setter), (tpde, {"value": 0})):
        state = pkg.ScalarField(pkg.UnitGrid(list(shape)),
                                data if pkg is jpde else torch.as_tensor(data))
        eq = pkg.DiffusionPDE(0.5, bc=setter)
        result = eq.solve(state, t_range=2.0, dt=0.1, tracker=None, backend="numpy")
        results[pkg, callable(setter)] = np.asarray(result.data)
    np.testing.assert_allclose(results[tpde, True], results[jpde, True], **TOL)
    np.testing.assert_allclose(results[tpde, True], results[tpde, False], **TOL)


def test_boundaries_setter_takes_the_time_and_is_refused_by_the_kernels():
    state = _state(tpde, (12,))
    grid = state.grid
    bcs = grid.get_boundary_conditions(_time_setter)
    assert isinstance(bcs, tpde.BoundariesSetter)
    assert tpde.grids.boundaries.BoundariesBase.from_data(bcs, grid=grid) is bcs
    assert bcs == grid.get_boundary_conditions(_time_setter) and hash(bcs) == hash(_time_setter)
    jstate = _state(jpde, (12,))
    np.testing.assert_allclose(state.laplace(_time_setter, args={"t": 0.7}).to_numpy(),
                               np.asarray(jstate.laplace(_jax_time_setter, args={"t": 0.7}).data),
                               **TOL)
    eq = tpde.DiffusionPDE(0.5, bc=_torch_setter)
    state2d = _state(tpde)
    eq.solve(state2d, t_range=0.3, dt=0.1, tracker=None, backend="torch")
    assert eq.diagnostics["solver"]["fused_unsupported"] == "Fused window requires per-axis BCs"
    with pytest.raises(RuntimeError, match="per-axis BCs"):
        eq.solve(state2d, t_range=0.3, dt=0.1, tracker=None, backend="cuda")
    with pytest.raises(NotImplementedError, match="per-axis BCs"):
        tpde.get_backend("cuda").make_operator(state2d.grid, "laplace", _torch_setter)
