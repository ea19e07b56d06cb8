"""The interactive (napari) tracker of the port, held against ``pde_tpu`` on
the CPU: ``NapariViewer`` and ``InteractivePlotTracker`` talk to a fake viewer
process through their queue as ``pde_tpu``'s do, and without napari (absent
here) both packages raise the same ``ImportError``.

The port spawns the viewer's process, which imports this module to find the
fake viewer: so the module imports only the standard library and numpy at
its top, and the packages inside the tests."""

import json
import queue
from functools import partial

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _on_the_cpu():
    import torch

    import pde_tpu_torch as tpde

    torch.set_num_threads(1)
    with tpde.config({"device": "cpu"}):
        yield


def _packages():
    """(pde_tpu, its interactive module), (the port, its interactive module)."""
    import pde_tpu as jpde
    import pde_tpu_torch as tpde
    from pde_tpu.trackers import interactive as jinteractive
    from pde_tpu_torch.trackers import interactive as tinteractive

    return (jpde, jinteractive), (tpde, tinteractive)


def _state(pkg, shape=(10, 8), collection=False):
    grid = pkg.UnitGrid(list(shape), periodic=True)
    data = np.random.default_rng(0).random(shape)
    if pkg.__name__ == "pde_tpu_torch":
        import torch

        data = torch.as_tensor(data)
    field = pkg.ScalarField(grid, data, label="c")
    return pkg.FieldCollection([field, field * 2], labels=["a", "b"]) if collection else field


def _fake_viewer(result_path, data_channel, initial_data):
    """Stands in for napari_process: drains the queue and records messages."""
    n_updates, closed, shapes = 0, False, []
    while True:
        try:
            action, payload = data_channel.get(timeout=30)
        except queue.Empty:
            break
        if action == "close":
            closed = True
            break
        if action == "update_data":
            n_updates += 1
            shapes = [list(np.shape(layer["data"])) for layer in payload.values()]
    with open(result_path, "w") as fh:
        json.dump({"initial_layers": sorted(initial_data), "updates": n_updates,
                   "closed": closed, "shapes": shapes}, fh)


def _close_and_wait(viewer):
    """Send the close message, then wait for the viewer's process to end (a
    spawned process may still be starting when the solve is done)."""
    viewer.close(force=False)
    viewer._process.join(timeout=120)
    assert not viewer._process.is_alive()


def test_napari_viewer_queue_protocol(tmp_path):
    (_, _), (tpde, tinteractive) = _packages()
    result = tmp_path / "viewer.json"
    state = _state(tpde, collection=True)
    viewer = tinteractive.NapariViewer(state, process_target=partial(_fake_viewer, str(result)))
    viewer.update(state, t=0.5)
    viewer.update(state, t=1.0)
    _close_and_wait(viewer)
    recorded = json.loads(result.read_text())
    assert recorded == {"initial_layers": ["a", "b"], "updates": 2, "closed": True,
                        "shapes": [[10, 8], [10, 8]]}


def test_interactive_tracker_in_solve_matches_jax(tmp_path):
    recorded = {}
    for pkg, module in _packages():
        result = tmp_path / f"{pkg.__name__}.json"
        tracker = module.InteractivePlotTracker(
            interrupts=0.05, close=False, _process_target=partial(_fake_viewer, str(result)))
        pkg.DiffusionPDE(0.1).solve(_state(pkg), t_range=0.2, dt=0.01, tracker=tracker)
        _close_and_wait(tracker._viewer)
        recorded[pkg.__name__] = json.loads(result.read_text())
    assert recorded["pde_tpu_torch"] == recorded["pde_tpu"]
    assert recorded["pde_tpu_torch"]["updates"] >= 3
    (_, _), (tpde, tinteractive) = _packages()
    assert tpde.InteractivePlotTracker is tinteractive.InteractivePlotTracker


def test_napari_absent_matches_jax():
    (jpde, jinteractive), (tpde, tinteractive) = _packages()
    assert tinteractive.napari_available() is jinteractive.napari_available() is False
    for pkg, module in _packages():
        with pytest.raises(ImportError, match="napari"):
            module.NapariViewer(_state(pkg))
        with pytest.raises(ImportError, match="napari"):
            _state(pkg).plot_interactive()
