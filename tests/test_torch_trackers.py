"""Trackers and interrupt schedules of the port (``pde_tpu_torch.trackers``),
held against ``pde_tpu`` on the CPU in fp64: every schedule's sequence and
``parse_interrupt``/``parse_duration`` exactly, ``solve`` with storage, data,
callback, print, steady-state, conservation and consistency trackers (times
and stop reasons exactly, frames and values within 1e-12), the registry, and
two properties of the port's own: a field handed to a tracker never changes
afterwards (fused, plain, plain sharded and decomposed-window routes), and a
decomposed [2, 2] run stores frames bit-equal to the serial run's. States come
from ``default_rng`` on 16² grids, schedules with few distinct window lengths."""

import io
import math

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.utils.parse_duration import parse_duration as jparse_duration
from pde_tpu_torch.utils.parse_duration import parse_duration as tparse_duration

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
SHAPE = (16, 16)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _pair(periodic=True, seed=0, shape=SHAPE):
    """The same seeded scalar state in both packages."""
    data = np.random.default_rng(seed).random(shape)
    return (jpde.ScalarField(jpde.UnitGrid(list(shape), periodic=periodic), data),
            tpde.ScalarField(tpde.UnitGrid(list(shape), periodic=periodic), data,
                             dtype=torch.float64))


# -- interrupt schedules (pure Python: compared exactly) ---------------------------------------
SCHEDULES = {
    "constant": lambda p: p.ConstantInterrupts(1.3),
    "constant t_start": lambda p: p.ConstantInterrupts(0.7, t_start=2.05),
    "constant 12.8": lambda p: p.ConstantInterrupts(12.8),
    "logarithmic": lambda p: p.LogarithmicInterrupts(0.35, 1.7),
    "logarithmic t_start": lambda p: p.LogarithmicInterrupts(0.2, factor=2.5, t_start=1.0),
    "geometric": lambda p: p.GeometricInterrupts(0.2, 2.0),
    "fixed": lambda p: p.FixedInterrupts([0.33, 1.01, 2.57, 3.0, 7.5]),
    "fixed scalar": lambda p: p.FixedInterrupts(2.5),
    "parsed number": lambda p: p.parse_interrupt(0.45),
    "parsed list": lambda p: p.parse_interrupt((0.1, 0.25, 4)),
    "parsed none": lambda p: p.parse_interrupt(None),
}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_interrupt_sequences_match_jax(schedule):
    """initialize, then next at the reached times (some past the next
    interrupt, as a window's rounding leaves them), equal float for float;
    a copy continues the same sequence."""
    seqs = []
    for pkg in (jpde, tpde):
        sched = SCHEDULES[schedule](pkg)
        assert type(sched).__name__ == type(SCHEDULES[schedule](jpde)).__name__
        seq = [sched.initialize(0.0)]
        for i in range(14):
            t = seq[-1] if math.isfinite(seq[-1]) else 100.0
            seq.append(sched.next(t + (0.05 if i % 3 == 2 else 0.0)))
        seq.append(sched.dt)
        copied = sched.copy()
        seq += [copied.next(50.0), sched.next(50.0), repr(sched)]
        seqs.append(seq)
    assert seqs[0] == seqs[1]


@pytest.mark.parametrize("duration", [2, "0:00:02", "1:30", "1 day, 0:00:02"])
def test_realtime_interrupts_match_jax(duration, monkeypatch):
    """Wall-clock schedules adapt their window to the elapsed time: under the
    same clock both packages give the same times."""
    now = {"t": 0.0}
    monkeypatch.setattr("time.monotonic", lambda: now["t"])
    seqs = []
    for pkg in (jpde, tpde):
        ticks = iter(np.cumsum([0.0, 0.3, 5.0, 1.0, 0.01, 2.0, 40.0, 1.1]).tolist())
        now["t"] = next(ticks)
        sched = pkg.RealtimeInterrupts(duration, dt_initial=0.01)
        seq = [sched.duration, sched.initialize(0.5)]
        for tick in ticks:
            now["t"] = tick
            seq.append(sched.next(seq[-1]))
        seqs.append(seq + [sched.dt])
    assert seqs[0] == seqs[1]


@pytest.mark.parametrize("text", ["90", "1:30", "1:30:00", "2 days, 1:00:05", "1 d 0:0:1.5",
                                  "0.25", "-3", "bad", "1:2:3:4"])
def test_parse_duration_matches_jax(text):
    try:
        expected = jparse_duration(text)
    except ValueError:
        with pytest.raises(ValueError, match="Cannot parse duration"):
            tparse_duration(text)
        return
    assert tparse_duration(text) == expected


@pytest.mark.parametrize("data", [3, 2.5, np.float64(0.5), None, "0:00:03", [1, 2.5],
                                  (0.5,), np.array([0.1, 0.2]), range(3), object()],
                         ids=lambda d: type(d).__name__)
def test_parse_interrupt_forms_match_jax(data):
    try:
        expected = jpde.parse_interrupt(data)
    except TypeError:
        with pytest.raises(TypeError, match="Cannot parse interrupt"):
            tpde.parse_interrupt(data)
        return
    got = tpde.parse_interrupt(data)
    assert type(got).__name__ == type(expected).__name__
    assert [got.initialize(0.0), got.next(0.0), got.next(1.0), got.dt] == [
        expected.initialize(0.0), expected.next(0.0), expected.next(1.0), expected.dt]
    assert tpde.trackers.interrupts.interval_to_interrupts is tpde.parse_interrupt


def test_schedule_instances_are_copied():
    sched = tpde.ConstantInterrupts(2.0)
    tracker = tpde.CallbackTracker(lambda f: None, interrupts=sched)
    assert tracker.interrupts is not sched
    assert tpde.CallbackTracker(lambda f: None, interval=0.5).interrupts.dt == 0.5


# -- solve with trackers ------------------------------------------------------------------------
# schedule label -> (schedule(pkg), t_range, dt)
SOLVE_SCHEDULES = {
    "constant 12.8": (lambda p: p.ConstantInterrupts(12.8), 25.6, 0.1),
    "logarithmic": (lambda p: p.LogarithmicInterrupts(0.35, 1.7), 4.0, 0.1),
    "fixed off the grid of dt": (lambda p: [0.33, 1.01, 2.57, 3.0], 4.0, 0.1),
    "t_range (5, 10)": (lambda p: 1.3, (5, 10), 0.1),
}


def _run_trackers(pkg, state, schedule, t_range, dt, **kw):
    storage = pkg.MemoryStorage()
    data = pkg.DataTracker(lambda f: float(f.average), interrupts=schedule)
    data2 = pkg.DataTracker(lambda f, t: (t, float(f.integral)), interrupts=schedule)
    seen = []
    callback = pkg.CallbackTracker(lambda f, t: seen.append(t), interrupts=schedule)
    calls = []
    trackers = [storage.tracker(schedule), data, data2, callback,
                lambda f: calls.append(float(f.average)), "consistency"]
    result, info = pkg.DiffusionPDE(0.1).solve(state, t_range=t_range, dt=dt,
                                               tracker=trackers, ret_info=True, **kw)
    return {"times": list(storage.times), "frames": [np.asarray(f.data) for f in storage],
            "data": (data.times, data.data, data2.times, data2.data), "seen": seen,
            "calls": calls, "result": np.asarray(result.data),
            "info": (info["controller"]["t_final"], info["controller"].get("stop_reason"),
                     info["controller"]["successful"])}


@pytest.mark.parametrize("schedule", SOLVE_SCHEDULES)
def test_solve_with_trackers_matches_jax(schedule):
    """Storage, two data trackers, a callback of two arguments and a bare
    callable: times equal float for float, frames and values within 1e-12."""
    make, t_range, dt = SOLVE_SCHEDULES[schedule]
    jstate, tstate = _pair()
    expected = _run_trackers(jpde, jstate, make(jpde), t_range, dt)
    got = _run_trackers(tpde, tstate, make(tpde), t_range, dt)
    assert got["times"] == expected["times"]
    assert got["seen"] == expected["seen"] == got["data"][0] == got["times"]
    assert got["info"] == expected["info"]
    assert got["data"][0] == expected["data"][0] and got["data"][2] == expected["data"][2]
    np.testing.assert_allclose(got["data"][1], expected["data"][1], **TOL)
    np.testing.assert_allclose(np.array(got["data"][3]), np.array(expected["data"][3]), **TOL)
    np.testing.assert_allclose(got["calls"], expected["calls"], **TOL)
    assert len(got["frames"]) == len(expected["frames"]) > 2
    for a, b in zip(got["frames"], expected["frames"], strict=True):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(got["result"], expected["result"], **TOL)


@pytest.mark.parametrize("ext", ["csv", "pickle"])
def test_data_tracker_exports_match_jax(ext, tmp_path):
    """A DataTracker's dataframe and files (pandas imported when used) hold
    pde_tpu's times and values."""
    frames, contents = [], []
    for pkg, state in zip((jpde, tpde), _pair(), strict=True):
        path = tmp_path / f"{pkg.__name__}.{ext}"
        tracker = pkg.DataTracker(lambda f: {"mean": float(f.average),
                                             "max": float(f.data.max())},
                                  interrupts=0.5, filename=str(path))
        pkg.DiffusionPDE(0.1).solve(state, t_range=1.5, dt=0.1, tracker=tracker)
        frames.append(tracker.dataframe)
        contents.append(path.read_bytes() if ext == "csv" else
                        __import__("pickle").loads(path.read_bytes()))
    assert list(frames[1].columns) == list(frames[0].columns) == ["time", "mean", "max"]
    np.testing.assert_allclose(frames[1].to_numpy(), frames[0].to_numpy(), **TOL)
    if ext == "pickle":
        assert contents[1][0] == contents[0][0]
    with pytest.raises(ValueError, match="extension"):
        tpde.DataTracker(lambda f: 0).to_file(str(tmp_path / "data.txt"))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_print_tracker_matches_jax(kind):
    outputs = []
    for pkg, state in zip((jpde, tpde), _pair(), strict=True):
        stream = io.StringIO()
        tracker = pkg.PrintTracker(interrupts=0.5, stream=stream)
        if kind == "real":
            pkg.DiffusionPDE(0.1).solve(state, t_range=1.5, dt=0.1, tracker=tracker)
        else:
            data = np.asarray(state.data) * (1 - 2j)
            field = (pkg.ScalarField(state.grid, data) if pkg is jpde else
                     tpde.ScalarField(state.grid, torch.as_tensor(data)))
            tracker.handle(field, 0.25)
            tracker.handle(pkg.FieldCollection([field, field]), 0.5)
        outputs.append(stream.getvalue())
    assert outputs[1] == outputs[0] and outputs[0].count("\n") >= 2


def _stop(pkg, state, trackers, t_range, dt, eq=None):
    eq = eq or pkg.DiffusionPDE(1.0, bc={"derivative": 0})
    result, info = eq.solve(state, t_range=t_range, dt=dt, tracker=trackers, ret_info=True)
    return (info["controller"]["t_final"], info["controller"].get("stop_reason"),
            info["controller"]["successful"]), np.asarray(result.data)


STOPS = {
    # label -> (trackers(pkg), periodic, t_range, dt, equation(pkg) or None)
    "steady state": (lambda p: [p.SteadyStateTracker(2.0, atol=1e-4, rtol=1e-4)], False,
                     500, 0.1, None),
    "steady state by name": (lambda p: ["steady_state"], False, 400, 0.2, None),
    "steady state, evolution rate": (
        lambda p: [p.SteadyStateTracker(
            1.0, atol=1e-3, rtol=1e-3,
            evolution_rate=lambda f, t: f.laplace({"derivative": 0}))], False, 500, 0.1, None),
    "material not conserved": (lambda p: [p.MaterialConservationTracker(0.5, atol=1e-3,
                                                                        rtol=1e-3)],
                               False, 50, 0.05,
                               lambda p: p.DiffusionPDE(1.0, bc={"value": 0})),
    "material conserved": (lambda p: ["material_conservation"], False, 5, 0.1, None),
    "non-finite": (lambda p: [p.ConsistencyTracker(interval=0.5)], True, 200, 1.0,
                   lambda p: p.DiffusionPDE(100.0)),
    "max runtime": (lambda p: [p.MaxRuntimeTracker("0:00:00", interrupts=0.5)], False, 5, 0.1,
                    None),
}


@pytest.mark.parametrize("case", STOPS)
def test_stops_match_jax(case):
    """Each stopping tracker stops both packages at the same time with the
    same reason (in fp64 the decisions are equal)."""
    make, periodic, t_range, dt, make_eq = STOPS[case]
    jstate, tstate = _pair(periodic=periodic, seed=1)
    runs = [_stop(pkg, state, make(pkg), t_range, dt, make_eq and make_eq(pkg))
            for pkg, state in ((jpde, jstate), (tpde, tstate))]
    assert runs[1][0] == runs[0][0]
    if case != "non-finite":
        np.testing.assert_allclose(runs[1][1], runs[0][1], **TOL)
    t_final, reason, _ = runs[1][0]
    if case == "material conserved":
        assert reason is None and t_final == t_range
    else:
        assert reason is not None and t_final < t_range


def test_non_finite_state_aborts_at_once():
    jstate, tstate = _pair()
    data = np.asarray(jstate.data).copy()
    data[3, 4] = np.nan
    runs = [_stop(pkg, pkg.ScalarField(state.grid, data) if pkg is jpde else
                  tpde.ScalarField(state.grid, data, dtype=torch.float64),
                  "auto", 1.0, 0.1, pkg.DiffusionPDE(0.1))[0]
            for pkg, state in ((jpde, jstate), (tpde, tstate))]
    assert runs[0] == runs[1] == (0.0, "Simulation aborted at t=0.0 (Field was not finite)",
                                  False)


def test_steady_state_tracker_keeps_its_state_on_the_device():
    _, state = _pair()
    tracker = tpde.SteadyStateTracker(interval=1.0)
    tracker.initialize(state)
    tracker.handle(state, 0.0)
    (last,) = tracker._last_data
    assert isinstance(last, torch.Tensor) and last.device == state.device
    assert last.data_ptr() != state.data.data_ptr()


def test_collection_conservation_matches_jax():
    """A collection's magnitudes, one float each, against pde_tpu's."""
    rng = np.random.default_rng(2)
    a, b = rng.random(SHAPE), rng.random(SHAPE)
    eqs = {"u": "laplace(u) - 0.5 * u", "v": "laplace(v)"}
    runs = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid(list(SHAPE), periodic=True)
        kw = {} if pkg is jpde else {"dtype": torch.float64}
        state = pkg.FieldCollection([pkg.ScalarField(grid, a, **kw),
                                     pkg.ScalarField(grid, b, **kw)], labels=["u", "v"])
        tracker = pkg.MaterialConservationTracker(0.1, atol=1e-2, rtol=1e-2)
        runs.append(_stop(pkg, state, [tracker], 2.0, 0.05, pkg.PDE(eqs))[0])
        np.testing.assert_allclose(tracker._reference, [np.mean(a), np.mean(b)], **TOL)
    assert runs[0] == runs[1] and "Material is not conserved" in runs[1][1]


def test_walltime_tracker_and_profiler():
    _, state = _pair()
    tracker = tpde.WalltimeTracker(0.5)
    _, info = tpde.DiffusionPDE(0.1).solve(state, t_range=1.0, dt=0.1, tracker=tracker,
                                            ret_info=True)
    # as in pde_tpu, the wall time goes to the diagnostics' own "profiler" entry
    assert info["profiler"]["walltime"] >= 0
    assert {"solver", "tracker", "compilation"} <= set(info["controller"]["profiler"])
    assert info["package_version"] == tpde.__version__
    assert issubclass(tpde.RuntimeTracker, tpde.MaxRuntimeTracker)


def test_named_trackers_match_jax(monkeypatch):
    assert tpde.registered_trackers() == jpde.registered_trackers()
    assert set(tpde.get_named_trackers()) == set(jpde.get_named_trackers())
    for name in ("consistency", "material_conservation", "print", "progress", "steady_state"):
        tracker = tpde.TrackerBase.from_data(name, interval=2)
        assert type(tracker).__name__ == type(jpde.TrackerBase.from_data(name)).__name__
        assert tracker.interrupts.dt == 2
    assert isinstance(tpde.TrackerBase.from_data(lambda f: None), tpde.CallbackTracker)
    with pytest.raises(ValueError, match="Unknown tracker"):
        tpde.TrackerBase.from_data("nonsense")
    # "auto" without tqdm, as on the card's machine: the consistency tracker alone
    monkeypatch.setitem(__import__("sys").modules, "tqdm", None)
    for pkg in (jpde, tpde):
        auto = pkg.TrackerCollection.from_data("auto")
        assert [type(t).__name__ for t in auto] == ["ConsistencyTracker"]
        assert auto.trackers[0].interrupts.dt == 1.0


def test_transformed_tracker_base():
    _, state = _pair()
    tracker = tpde.TransformedTrackerBase(transformation=lambda f, t: f * t)
    assert float(tracker._transform(state, 2.0).average) == pytest.approx(
        2 * float(state.average), rel=1e-14)
    one = tpde.TransformedTrackerBase(transformation=lambda f: -f)
    assert float(one._transform(state, 2.0).average) == pytest.approx(-float(state.average))
    with pytest.raises(TypeError, match="callable"):
        tpde.TransformedTrackerBase(transformation=3)


# -- the port's own properties --------------------------------------------------------------------
ROUTES = {
    # route -> (equation, solve keywords, expected solver info)
    "fused window": (lambda: tpde.DiffusionPDE(0.1), {}, {"fused_step": True}),
    "fused multi-field AB2": (lambda: tpde.CahnHilliardPDE(),
                              {"solver": "adams-bashforth"}, {"fused_step": True}),
    "plain loop": (lambda: tpde.DiffusionPDE(0.1), {"backend": "numpy"}, {}),
    "decomposed window": (lambda: tpde.DiffusionPDE(0.1), {"decomposition": [2, 2]},
                          {"fused_step": True}),
    "plain sharded": (lambda: tpde.PDE({"c": "laplace(c) + 0.01 * x * c"}),
                      {"decomposition": [2, 2]}, {"sharded_halo": 1}),
}


@pytest.mark.parametrize("route", ROUTES)
def test_handed_fields_never_change(route):
    """A tracker may keep the fields it is handed: no later window writes
    them, on every route a window takes."""
    make_eq, kw, expected = ROUTES[route]
    _, state = _pair(seed=3)
    state = tpde.ScalarField(state.grid, state.data * 0.2, dtype=torch.float64)
    kept = []
    storage = tpde.MemoryStorage()
    tracker = [tpde.CallbackTracker(lambda f: kept.append((f, f.data.clone())), 0.01),
               storage.tracker(0.02)]
    eq = make_eq()
    eq.solve(state, t_range=0.1, dt=0.005, tracker=tracker, **kw)
    for key, value in expected.items():
        assert eq.diagnostics["solver"].get(key) == value
    assert len(kept) == 11
    for (field, snapshot), frame in zip(kept[::2], storage.data, strict=True):
        assert torch.equal(field.data, snapshot)
        np.testing.assert_array_equal(frame, snapshot.numpy())
    assert not torch.equal(kept[0][1], kept[-1][1])


DECOMPOSED = {
    # case -> (equation, dt, t_end, the serial run's keywords)
    "diffusion (#12)": (lambda: tpde.DiffusionPDE(0.1), 0.1, 12.8, {}),
    "cahn-hilliard (#8)": (lambda: tpde.CahnHilliardPDE(), 0.005, 0.32, {}),
    "plain sharded": (lambda: tpde.PDE({"c": "laplace(c) + 0.01 * x * c"}), 0.05, 1.6,
                      {"backend": "numpy"}),
}


@pytest.mark.parametrize("case", DECOMPOSED)
def test_decomposed_storage_bit_equal_to_serial(case):
    """The decomposed stepper combines the blocks on every call, so the
    trackers see whole fields: frames stored from a [2, 2] run equal the
    serial run's bit for bit."""
    make_eq, dt, t_end, serial_kw = DECOMPOSED[case]
    _, state = _pair(seed=4)
    runs = []
    for kw in ({"decomposition": [2, 2]}, serial_kw):
        storage = tpde.MemoryStorage()
        values = tpde.DataTracker(lambda f: float(f.integral), interrupts=t_end / 4)
        make_eq().solve(state, t_range=t_end, dt=dt, tracker=[storage.tracker(t_end / 8),
                                                              values], **kw)
        runs.append((storage, values))
    (sharded, s_values), (serial, values) = runs
    assert list(sharded.times) == list(serial.times) and len(serial) == 9
    for a, b in zip(sharded.data, serial.data, strict=True):
        np.testing.assert_array_equal(a, b)
    assert s_values.data == values.data and s_values.times == values.times
