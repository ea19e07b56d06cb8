"""Adaptive stepping of the port (``solvers/base.py``'s ``AdaptiveSolverBase``:
Euler step doubling, Runge-Kutta-Fehlberg 4(5) in ``solvers/runge_kutta.py``)
against ``pde_tpu``'s compiled ``while_loop`` on the same numpy inputs, fp64:
``adjust_dt``, the README example (BASELINE config 1 as written) and config
3's Swift-Hohenberg and wave runs (``tests/test_integration.py:117-149``); the
chunked host reads, the refusals, and dt carried across tracker windows.

Tolerances. Each run is held to two builds of ``pde_tpu``:

- As its own tests run it. XLA's CPU compiler contracts ``a*b + c`` into
  fused multiply-adds and its algebraic simplifier re-associates constant
  factors (``0.5*dt*(0.1*lap)``), so one error estimate already differs from
  the port's (and from ``pde_tpu``'s own eager ops) in the last bit of the
  state. The estimate is a difference of two nearly equal states, so that bit
  becomes a relative difference of dt: measured README 7.5e-12, wave 6.8e-12,
  Swift-Hohenberg at tolerance 1e-6 1.2e-10, the README in windows of t = 1
  2.5e-9, and 1.3e-7 for a window's last proposal (its step is cut to
  ``t_end - t``, a difference of nearly equal times). The proposed steps (the
  statistics' maximum, the last dt) are held to about ten times those, the
  step counts exactly, the first and mean dt and the states to 1e-12 (in
  windows to 1e-11, measured 1.5e-12).
- Compiled without either rewrite (``EXACT_XLA_FLAGS``: the ISA capped at
  AVX, which has no FMA, and the ``algsimp`` pass off), in a process of its
  own since XLA reads its flags once. Then the two packages do the same
  operations in the same order and every case, dt included, is held to
  1e-12 (on x86-64 they are bit-equal). Either rewrite alone leaves a
  difference: both are the cause.
"""

import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.base import adjust_dt as jax_adjust_dt
from pde_tpu_torch.solvers import base as solver_base

torch.set_num_threads(1)

STATE = dict(rtol=1e-12, atol=1e-12)
#: XLA's CPU compiler without fused multiply-adds or algebraic rewrites
EXACT_XLA_FLAGS = "--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"
MIXED_BC = {"x": "periodic", "y-": {"value": 0}, "y+": {"derivative": 0}}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _leaves(state):
    fields = list(state) if isinstance(state, (jpde.FieldCollection, tpde.FieldCollection)) \
        else [state]
    return [np.asarray(f.data.cpu() if isinstance(f.data, torch.Tensor) else f.data)
            for f in fields]


def _summary(run):
    """What a comparison reads of ``(state, info)`` from ``solve(..., ret_info=True)``."""
    res, info = run
    solver = info["solver"]
    stats = solver["dt_statistics"]
    return {
        "adaptive": solver["dt_adaptive"], "steps": solver["steps"], "dt": solver["dt"],
        "stats": (stats.count, stats.min, stats.mean, stats.max),
        "trials": solver.get("adaptive_trials"), "t_final": info["controller"]["t_final"],
        "state": _leaves(res),
    }


def _assert_same_run(ref, torch_run, dt_rtol=1e-12, last_rtol=None, state_tol=STATE):
    """`torch_run` against pde_tpu's `ref` (a :func:`_summary`)."""
    assert isinstance(torch_run[1]["solver"]["dt_statistics"], tpde.utils.OnlineStatistics)
    run = _summary(torch_run)
    assert run["adaptive"] is True and ref["adaptive"] is True
    assert run["steps"] == ref["steps"] == run["stats"][0] == ref["stats"][0]
    np.testing.assert_allclose(run["stats"][1:3], ref["stats"][1:3], rtol=1e-12)
    np.testing.assert_allclose(run["stats"][3], ref["stats"][3], rtol=dt_rtol)
    np.testing.assert_allclose(run["dt"], ref["dt"], rtol=last_rtol or dt_rtol)
    for a, b in zip(run["state"], ref["state"], strict=True):
        np.testing.assert_allclose(a, b, **state_tol)
    # every accepted step is one trial; rejected trials come on top
    assert run["trials"] >= run["steps"]
    assert run["t_final"] == pytest.approx(ref["t_final"], rel=1e-12)


def _pde_tpu_runs():
    """pde_tpu's side of every comparison below, as :func:`_summary`s."""
    return {
        "readme": _summary(_readme(jpde, _readme_data())),
        "swift-hohenberg": _summary(_swift_hohenberg(jpde, _sh_data())),
        "wave": _summary(_wave(jpde)),
        "windows": _summary(_readme(jpde, _readme_data(), tracker="consistency")),
    }


@pytest.fixture(scope="module")
def exact(tmp_path_factory):
    """:func:`_pde_tpu_runs` with pde_tpu compiled under ``EXACT_XLA_FLAGS``."""
    tests = Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("exact") / "runs.pkl"
    code = (
        "import pickle, sys, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        f"sys.path[:0] = [{str(tests)!r}, {str(tests.parent)!r}]\n"
        "import test_torch_adaptive as t\n"
        f"pickle.dump(t._pde_tpu_runs(), open({str(out)!r}, 'wb'))\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": EXACT_XLA_FLAGS}
    subprocess.run([sys.executable, "-c", code], env=env, cwd=tests.parent, check=True,
                   timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("dt", [0.1, 1e-3])
def test_adjust_dt_matches_pde_tpu(dt):
    crossover = (0.9 / 4.0) ** 5
    errors = np.array([0.0, crossover, crossover * (1 - 1e-15), crossover * (1 + 1e-15),
                       1e-3, 0.5, 1.0, 1.0 + 1e-12, 3.0, 1e6, np.nan, np.inf, -np.inf])
    expected = np.asarray(jax_adjust_dt(np.float64(dt), errors))
    got = solver_base.adjust_dt(torch.tensor(dt, dtype=torch.float64),
                                torch.as_tensor(errors)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-15, atol=0)
    # the branches: the 4x cap below the crossover, the 4x shrink of a
    # non-finite error, the 10x floor of the shrink
    assert got[0] == got[2] == 4 * dt and got[-3] == got[-2] == dt / 4 and got[-1] == 4 * dt
    assert got[9] == pytest.approx(0.1 * dt)


def _readme_data():
    return np.random.default_rng(0).uniform(size=(64, 64))


def _readme(pkg, data, tracker=None, **kwargs):
    state = pkg.ScalarField(pkg.UnitGrid([64, 64]), data, **kwargs)
    return pkg.DiffusionPDE(0.1).solve(state, t_range=10, tracker=tracker, ret_info=True)


def test_readme_example_matches_pde_tpu(exact):
    """``DiffusionPDE(0.1).solve(state, t_range=10)`` on 64², no dt, the
    default solver: 115 accepted steps, final dt 0.1866 in both packages."""
    torch_run = _readme(tpde, _readme_data(), dtype=torch.float64)
    _assert_same_run(_summary(_readme(jpde, _readme_data())), torch_run, dt_rtol=1e-10)
    _assert_same_run(exact["readme"], torch_run)
    info = torch_run[1]["solver"]
    assert info["steps"] == 115 and info["dt"] == pytest.approx(0.1866, abs=1e-4)
    assert info["class"] == "EulerSolver" and "fused_step" not in info
    # one host read per chunk of trials and one per window, not one per trial
    assert info["host_syncs"] == math.ceil(info["adaptive_trials"] / solver_base.ADAPTIVE_CHUNK) + 1


def _sh_data():
    return np.random.default_rng(1).uniform(-0.1, 0.1, (12, 12))


def _swift_hohenberg(pkg, data, **kwargs):
    grid = pkg.UnitGrid([12, 12], periodic=[True, False])
    state = pkg.ScalarField(grid, data, **kwargs)
    return pkg.SwiftHohenbergPDE(rate=0.1, bc=MIXED_BC).solve(
        state, t_range=1, solver="runge-kutta", adaptive=True, tolerance=1e-6, tracker=None,
        ret_info=True)


def _blob():
    grid = jpde.CartesianGrid([(0, 16), (0, 16)], (16, 16), periodic=[True, False])
    return np.array(jpde.ScalarField.from_expression(grid, "exp(-((x-8)**2 + (y-8)**2))").data)


def _wave(pkg, dt=None, **kwargs):
    u0 = _blob()
    grid = pkg.UnitGrid([16, 16], periodic=[True, False])
    eq = pkg.WavePDE(speed=1, bc=MIXED_BC)
    init = eq.get_initial_condition(pkg.ScalarField(grid, u0, **kwargs))
    return eq.solve(init, t_range=1, dt=dt, solver="runge-kutta", adaptive=dt is None,
                    tolerance=1e-6, tracker=None, ret_info=True)


def test_rkf45_swift_hohenberg_mixed_bcs_matches_pde_tpu(exact):
    torch_run = _swift_hohenberg(tpde, _sh_data(), dtype=torch.float64)
    _assert_same_run(_summary(_swift_hohenberg(jpde, _sh_data())), torch_run, dt_rtol=1e-9)
    _assert_same_run(exact["swift-hohenberg"], torch_run)
    assert torch_run[1]["solver"]["class"] == "RungeKuttaSolver"


def test_rkf45_wave_mixed_bcs_matches_pde_tpu(exact):
    torch_run = _wave(tpde, dtype=torch.float64)
    _assert_same_run(_summary(_wave(jpde)), torch_run, dt_rtol=1e-10)
    _assert_same_run(exact["wave"], torch_run)
    # and it matches the port's own fine fixed-dt RK4 run, as config 3's test asks
    ref, info = _wave(tpde, dt=1e-3, dtype=torch.float64)
    assert info["solver"]["dt_adaptive"] is False and info["solver"]["steps"] == 1000
    np.testing.assert_allclose(_leaves(torch_run[0])[0], _leaves(ref)[0], atol=1e-4)


def test_chunk_of_trials_equals_chunk_of_one(monkeypatch):
    """Trials past the window's end change nothing, so reading the host once
    per chunk gives the bits of reading it after every trial."""
    grid = tpde.UnitGrid([24, 24], periodic=[True, False])
    data = np.random.default_rng(2).uniform(-0.1, 0.1, (24, 24))
    runs = {}
    for chunk in (1, solver_base.ADAPTIVE_CHUNK, 5):
        monkeypatch.setattr(solver_base, "ADAPTIVE_CHUNK", chunk)
        state = tpde.ScalarField(grid, data, dtype=torch.float64)
        runs[chunk] = tpde.SwiftHohenbergPDE(rate=0.1, bc=MIXED_BC).solve(
            state, t_range=0.7, solver="runge-kutta", tolerance=1e-5, tracker=None, ret_info=True)
    (ref, ref_info), *others = runs.values()
    for res, info in others:
        assert torch.equal(res.data, ref.data)
        for key in ("steps", "dt", "adaptive_trials"):
            assert info["solver"][key] == ref_info["solver"][key]
        assert info["solver"]["dt_statistics"].to_dict() == ref_info["solver"]["dt_statistics"].to_dict()
    assert runs[1][1]["solver"]["host_syncs"] == runs[1][1]["solver"]["adaptive_trials"] + 1


def test_dt_below_dt_min_raises():
    state = tpde.ScalarField.random_uniform(tpde.UnitGrid([16, 16]), dtype=torch.float64,
                                            rng=np.random.default_rng(3))
    solver = tpde.EulerSolver(tpde.DiffusionPDE(1.0), adaptive=True, tolerance=1e-30)
    solver.dt_min = 1e-4
    stepper = solver.make_stepper(state)
    with pytest.raises(RuntimeError, match="Time step below dt_min=0.0001"):
        stepper(state, 0.0, 1.0)


def test_refusals():
    state = tpde.ScalarField.random_uniform(tpde.UnitGrid([16, 16]), dtype=torch.float64,
                                            rng=np.random.default_rng(4))
    with pytest.raises(RuntimeError, match="stochastic"):
        tpde.DiffusionPDE(0.1, noise=0.1).solve(state, t_range=1, tracker=None)
    with pytest.raises(RuntimeError, match="stochastic"):
        tpde.RungeKuttaSolver(tpde.DiffusionPDE(0.1, noise=0.1), adaptive=True).make_stepper(state)
    with pytest.raises(NotImplementedError, match="fixed-dt stepping only"):
        tpde.DiffusionPDE(0.1).solve(state, t_range=1, tracker=None, backend="numpy")
    for solver in ("euler", "runge-kutta"):
        with pytest.raises(RuntimeError, match="no adaptive-dt kernel path"):
            tpde.AllenCahnPDE().solve(state, t_range=1, tracker=None, backend="cuda", solver=solver)
    # a decomposed grid steps adaptively on the torch engine (the error maximum
    # over the blocks: serial's steps and state), not on the cuda engine
    serial = tpde.AllenCahnPDE().solve(state, t_range=1, tracker=None)
    for kwargs in ({"decomposition": [2, 1]}, {"solver": "explicit_sharded"}):
        got = tpde.AllenCahnPDE().solve(state, t_range=1, tracker=None, **kwargs)
        np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
        with pytest.raises(RuntimeError, match="no adaptive-dt kernel path"):
            tpde.AllenCahnPDE().solve(state, t_range=1, tracker=None, backend="cuda", **kwargs)


def test_dt_carried_across_tracker_windows(exact):
    """Each tracker window starts from the dt the last one proposed
    (``info["dt"]``), as in pde_tpu: windows of t = 1 give 130 steps where one
    window gives 115."""
    data = _readme_data()
    torch_run = _readme(tpde, data, tracker="consistency", dtype=torch.float64)
    _assert_same_run(_summary(_readme(jpde, data, tracker="consistency")), torch_run,
                     dt_rtol=2.5e-8, last_rtol=1e-6, state_tol=dict(rtol=1e-11, atol=1e-11))
    _assert_same_run(exact["windows"], torch_run)
    assert torch_run[1]["solver"]["steps"] == 130

    # a window's last proposal is where the next one starts: from it the
    # second window takes fewer steps than from a reset dt
    state = tpde.ScalarField(tpde.UnitGrid([64, 64]), data, dtype=torch.float64)
    second = {}
    for reset in (False, True):
        solver = tpde.EulerSolver(tpde.DiffusionPDE(0.1), adaptive=True)
        stepper = solver.make_stepper(state)
        mid, t = stepper(state, 0.0, 1.0)
        assert t == pytest.approx(1.0) and solver.info["dt"] > 1e-3
        if reset:
            solver.info["dt"] = 1e-3
        before = solver.info["steps"]
        stepper(mid, t, 2.0)
        second[reset] = solver.info["steps"] - before
    assert second[False] < second[True]
