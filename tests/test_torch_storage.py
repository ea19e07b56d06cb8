"""Storage of the port (``pde_tpu_torch.storage``) and the field serialization
it needs, held against ``pde_tpu`` on the CPU in fp64: serialized attributes
string for string, magnitudes, ``MemoryStorage`` (``from_fields``,
``from_collection``, element access, ``extract_*``, ``apply``, ``copy``,
views), ``FileStorage`` and ``to_file``/``from_file`` written by either package
and read by the other, the committed HDF5 resources, collections and a
storage run of a collection. Inputs come from ``default_rng``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.storage import FileStorage as JFileStorage

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
RESOURCES = Path(__file__).resolve().parent / "resources"


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu"}):
        yield


# kind -> (grid(pkg), field class name, complex data)
KINDS = {
    "scalar unit": (lambda p: p.UnitGrid([6, 5], periodic=[True, False]), "ScalarField", False),
    "scalar complex": (lambda p: p.UnitGrid([6, 5], periodic=True), "ScalarField", True),
    "vector cartesian": (lambda p: p.CartesianGrid([(0, 2), (-1, 3)], [6, 4]), "VectorField",
                         False),
    "tensor unit": (lambda p: p.UnitGrid([4, 5]), "Tensor2Field", False),
    "scalar cylindrical": (lambda p: p.CylindricalSymGrid(3, (0, 2), 4), "ScalarField", False),
    "scalar polar hole": (lambda p: p.PolarSymGrid((1, 3), 5), "ScalarField", False),
    "vector spherical": (lambda p: p.SphericalSymGrid(2, 6), "VectorField", False),
}


def _field_pair(kind, seed=0, label="f"):
    make_grid, cls, cplx = KINDS[kind]
    jgrid = make_grid(jpde)
    jcls = getattr(jpde, cls)
    shape = (jgrid.dim,) * jcls.rank + tuple(jgrid.shape)
    rng = np.random.default_rng(seed)
    data = rng.random(shape) + (1j * rng.random(shape) if cplx else 0)
    jfield = jcls(jgrid, data, label=label)
    tfield = getattr(tpde, cls)(make_grid(tpde), torch.as_tensor(data), label=label)
    return jfield, tfield


def _collection_pair(seed=0):
    (js, ts), (jv, tv) = (_field_pair("scalar unit", seed, "s"),
                          _field_pair("scalar unit", seed + 1, "t"))
    grid_j, grid_t = js.grid, ts.grid
    data = np.random.default_rng(seed + 2).random((2,) + tuple(grid_j.shape))
    jvec = jpde.VectorField(grid_j, data, label="v")
    tvec = tpde.VectorField(grid_t, torch.as_tensor(data), label="v")
    return (jpde.FieldCollection([js, jvec, jv], label="all"),
            tpde.FieldCollection([ts, tvec, tv], label="all"))


def _assert_same_field(port, reference):
    """The port's field or collection equals pde_tpu's: class, grid state,
    label, dtype and data (within 1e-12)."""
    assert type(port).__name__ == type(reference).__name__
    assert port.attributes_serialized == reference.attributes_serialized
    assert port.device == torch.device("cpu")
    np.testing.assert_allclose(port.data.numpy(), np.asarray(reference.data), **TOL)


# -- serialization ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", list(KINDS) + ["collection"])
def test_attributes_match_jax(kind):
    jfield, tfield = _collection_pair() if kind == "collection" else _field_pair(kind)
    assert tfield.attributes_serialized == jfield.attributes_serialized
    plain_j, plain_t = jfield.attributes, tfield.attributes
    if kind != "collection":
        assert plain_t["dtype"] == plain_j["dtype"] and plain_t["label"] == plain_j["label"]
        assert plain_t["grid"].state_serialized == plain_j["grid"].state_serialized
    decoded = type(tfield).unserialize_attributes(tfield.attributes_serialized)
    expected = type(jfield).unserialize_attributes(jfield.attributes_serialized)
    assert decoded.keys() == expected.keys()
    assert tpde.FieldBase.unserialize_attributes(tfield.attributes_serialized).keys() == \
        expected.keys()
    # from the serialized attributes, their json string and the plain ones
    data = np.asarray(jfield.data)
    for attrs in (jfield.attributes_serialized, json.dumps(jfield.attributes_serialized),
                  tfield.attributes):
        _assert_same_field(tpde.FieldBase.from_state(attrs, data), jfield)
    _assert_same_field(tpde.fields.base.field_from_serialized_attributes(
        jfield.attributes_serialized, data), jfield)


@pytest.mark.parametrize("kind", ["scalar unit", "scalar complex", "vector cartesian",
                                  "tensor unit", "collection"])
def test_magnitudes_match_jax(kind):
    if kind == "collection":
        jcol, tcol = _collection_pair(3)
        np.testing.assert_allclose(tcol.magnitudes, jcol.magnitudes, **TOL)
        return
    jfield, tfield = _field_pair(kind, 3)
    assert isinstance(tfield.magnitude, float)
    np.testing.assert_allclose(tfield.magnitude, jfield.magnitude, **TOL)


# -- MemoryStorage ---------------------------------------------------------------------------------
def _storages(times=(0.0, 0.5, 1.25, 3.0), kind="vector cartesian"):
    pairs = [_field_pair(kind, seed) for seed in range(len(times))]
    return (jpde.MemoryStorage.from_fields(times, [j for j, _ in pairs]),
            tpde.MemoryStorage.from_fields(times, [t for _, t in pairs]))


def _assert_same_storage(port, reference):
    assert len(port) == len(reference) and list(port.times) == list(reference.times)
    for (t, field), (t_ref, ref) in zip(port.items(), reference.items(), strict=True):
        assert t == t_ref
        _assert_same_field(field, ref)


def test_memory_storage_matches_jax():
    jst, tst = _storages()
    _assert_same_storage(tst, jst)
    assert all(isinstance(frame, np.ndarray) for frame in tst.data)
    assert tst.shape == jst.shape and tst.data_shape == jst.data_shape
    assert tst.dtype == jst.dtype and not tst.has_collection
    _assert_same_field(tst[-1], jst[-1])
    for port, ref in zip(tst[1:3], jst[1:3], strict=True):
        _assert_same_field(port, ref)
    with pytest.raises(IndexError):
        tst[4]
    with pytest.raises(TypeError):
        tst["a"]
    for t_range in (None, 1.0, (0.4, 1.3)):
        _assert_same_storage(tst.extract_time_range(t_range), jst.extract_time_range(t_range))
    for func in (lambda f: f * 2, lambda f, t: f * t, lambda f: None):
        _assert_same_storage(tst.apply(func), jst.apply(func))
    _assert_same_storage(tst.copy(), jst.copy())
    # from_fields without times; append without a time
    fields = [field for field in tst]
    again = tpde.MemoryStorage.from_fields(fields=fields)
    again.append(fields[0])
    assert again.times == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_memory_storage_frames_are_host_copies():
    """A frame is one copy to the host, not a view of the state; read back it
    is a new field on the config key device's device."""
    _, field = _field_pair("scalar unit")
    storage = tpde.MemoryStorage()
    storage.start_writing(field)
    storage.append(field, 0.0)
    frame = storage.data[0]
    assert isinstance(frame, np.ndarray) and frame.ctypes.data != field.data.data_ptr()
    np.testing.assert_array_equal(frame, field.data.numpy())
    read = storage[0]
    assert read.data.data_ptr() != field.data.data_ptr() and read.device.type == "cpu"
    with tpde.config({"device": "meta"}):
        assert storage[0].device.type == "meta"
    with pytest.raises(RuntimeError, match="readonly"):
        tpde.MemoryStorage(write_mode="readonly").start_writing(field)


def test_collection_storage_and_views_match_jax():
    pairs = [_collection_pair(seed) for seed in range(3)]
    times = [0.0, 0.1, 0.2]
    jst = jpde.MemoryStorage.from_fields(times, [j for j, _ in pairs])
    tst = tpde.MemoryStorage.from_fields(times, [t for _, t in pairs])
    _assert_same_storage(tst, jst)
    assert tst.has_collection and tst.data[0].shape == (4, 6, 5)
    for field_id in (0, 1, "t"):
        _assert_same_storage(tst.extract_field(field_id), jst.extract_field(field_id))
        jview, tview = jst.view_field(field_id), tst.view_field(field_id)
        assert len(tview) == len(jview) and list(tview.times) == list(jview.times)
        assert tview.grid == tst.grid
        for (t, port), (t_ref, ref) in zip(tview.items(), jview.items(), strict=True):
            assert t == t_ref
            _assert_same_field(port, ref)
        for port, ref in zip(tview, jview, strict=True):
            _assert_same_field(port, ref)
        _assert_same_field(tview[1], jview[1])
    assert tst.extract_field("s", label="renamed")[0].label == "renamed"
    # from_collection: storages of fields at the same times into one of collections
    jparts, tparts = [jst.extract_field(i) for i in (0, 2)], [tst.extract_field(i) for i in (0, 2)]
    _assert_same_storage(tpde.MemoryStorage.from_collection(tparts, label="pair"),
                         jpde.MemoryStorage.from_collection(jparts, label="pair"))
    assert len(tpde.MemoryStorage.from_collection([])) == 0
    shifted = tpde.MemoryStorage.from_fields([0.0, 0.1, 0.3], list(tparts[1]))
    with pytest.raises(ValueError, match="incompatible times"):
        tpde.MemoryStorage.from_collection([tparts[0], shifted])
    _, single = _storages()
    with pytest.raises(RuntimeError):
        single.extract_field(0)
    with pytest.raises(RuntimeError):
        single.view_field(0)


def test_storage_tracker_transformation_matches_jax():
    """A transformed storage tracker; the initial field is transformed at t = 0
    (pde_tpu's quirk), the frames at their times."""
    runs = []
    for pkg in (jpde, tpde):
        data = np.random.default_rng(5).random((8, 8))
        kw = {} if pkg is jpde else {"dtype": torch.float64}
        state = pkg.ScalarField(pkg.UnitGrid([8, 8], periodic=True), data, **kw)
        seen = []
        storage = pkg.MemoryStorage()
        tracker = storage.tracker(interval=0.5, transformation=lambda f, t: (
            seen.append(t), f * (1 + t))[1])
        pkg.DiffusionPDE(0.1).solve(state, t_range=1.0, dt=0.1, tracker=tracker)
        runs.append((storage, seen))
    (jst, jseen), (tst, tseen) = runs
    assert tseen == jseen and tseen[0] == 0
    _assert_same_storage(tst, jst)
    with tpde.storage.get_memory_storage(tst[0]) as storage:
        assert len(storage) == 0 and storage.grid == tst.grid


def test_solve_collection_storage_matches_jax():
    """Storage of a collection's solve (the stacked frames of pde_tpu)."""
    rng = np.random.default_rng(6)
    a, b = rng.random((12, 12)), rng.random((12, 12))
    eqs = {"u": "laplace(u) - u * v", "v": "0.5 * laplace(v) + u * v"}
    runs = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([12, 12], periodic=True)
        kw = {} if pkg is jpde else {"dtype": torch.float64}
        state = pkg.FieldCollection([pkg.ScalarField(grid, a, **kw),
                                     pkg.ScalarField(grid, b, **kw)], labels=["u", "v"])
        storage = pkg.MemoryStorage()
        pkg.PDE(eqs).solve(state, t_range=0.2, dt=0.01, tracker=storage.tracker(0.05))
        runs.append(storage)
    _assert_same_storage(runs[1], runs[0])
    assert runs[1].has_collection and len(runs[1]) == 5


# -- files -------------------------------------------------------------------------------------------
def _write_storage(pkg, path, fields, times, **kw):
    storage = (JFileStorage if pkg is jpde else tpde.FileStorage)(str(path), **kw)
    storage.start_writing(fields[0], info={"note": "written", "tensor": object()})
    for t, field in zip(times, fields, strict=True):
        storage.append(field, t)
    storage.end_writing()
    storage.close()


@pytest.mark.parametrize("kind", ["scalar unit", "scalar complex", "tensor unit",
                                  "scalar cylindrical", "collection"])
@pytest.mark.parametrize("writer", ["port", "pde_tpu"])
def test_file_storage_interchanges_with_jax(kind, writer, tmp_path):
    """An HDF5 trajectory written by either package reads in the other (and
    in itself) to the same times, data and attributes."""
    pairs = [(_collection_pair(seed) if kind == "collection" else _field_pair(kind, seed))
             for seed in range(3)]
    times = [0.0, 0.25, 1.5]
    path = tmp_path / "trajectory.h5"
    pkg, index = (tpde, 1) if writer == "port" else (jpde, 0)
    _write_storage(pkg, path, [pair[index] for pair in pairs], times)
    jread = JFileStorage(str(path), write_mode="read_only")
    tread = tpde.FileStorage(str(path), write_mode="read_only")
    assert tread.info["note"] == jread.info["note"] == "written"
    assert tread.has_collection == (kind == "collection")
    if kind == "collection":  # pde_tpu rebuilds a collection's fields in its default dtype
        assert list(tread.times) == list(jread.times) == times
        for port, (ref, _) in zip(tread, pairs, strict=True):
            _assert_same_field(port, ref)
    else:
        _assert_same_storage(tread, jread)
    for port, (ref, _) in zip(tread, pairs, strict=True):
        np.testing.assert_allclose(port.data.numpy(), np.asarray(ref.data), **TOL)
    jread.close()
    tread.close()


@pytest.mark.parametrize("kind", ["scalar complex", "vector spherical", "tensor unit",
                                  "collection"])
def test_field_files_interchange_with_jax(kind, tmp_path):
    jfield, tfield = _collection_pair() if kind == "collection" else _field_pair(kind)
    tfield.to_file(str(tmp_path / "port.h5"))
    jfield.to_file(str(tmp_path / "jax.h5"))
    _assert_same_field(tpde.FieldBase.from_file(str(tmp_path / "jax.h5")), jfield)
    _assert_same_field(tpde.FieldBase.from_file(str(tmp_path / "port.h5")), jfield)
    back = jpde.FieldBase.from_file(str(tmp_path / "port.h5"))
    assert back.attributes_serialized == jfield.attributes_serialized
    np.testing.assert_allclose(np.asarray(back.data), np.asarray(jfield.data), **TOL)


def test_committed_resources_read_as_in_jax():
    jread = JFileStorage(str(RESOURCES / "trajectory_v1.h5"), write_mode="read_only")
    tread = tpde.FileStorage(str(RESOURCES / "trajectory_v1.h5"), write_mode="read_only")
    _assert_same_storage(tread, jread)
    assert isinstance(tread[1].grid, tpde.CylindricalSymGrid) and len(tread) == 3
    assert tread.info == jread.info
    jread.close()
    tread.close()
    jfield = jpde.FieldBase.from_file(str(RESOURCES / "field_v1.h5"))
    tfield = tpde.FieldBase.from_file(str(RESOURCES / "field_v1.h5"))
    _assert_same_field(tfield, jfield)
    assert isinstance(tfield, tpde.VectorField) and tfield.label == "flow"


def test_file_storage_modes(tmp_path):
    """Write modes, closing and reopening, resizing limits and compression, as
    pde_tpu's FileStorage does them."""
    grid = tpde.UnitGrid([4, 4])
    fields = [tpde.ScalarField(grid, float(i), dtype=torch.float64) for i in range(4)]
    path = tmp_path / "modes.h5"
    _write_storage(tpde, path, fields[:2], [0.0, 1.0], compression=False, keep_opened=False)
    appended = tpde.FileStorage(str(path), write_mode="append")
    assert len(appended) == 2
    appended.start_writing(fields[2])
    appended.append(fields[2], 2.0)
    appended.end_writing()
    assert list(appended.times) == [0.0, 1.0, 2.0]
    np.testing.assert_array_equal(appended[2].data.numpy(), 2.0)
    appended.close()
    with pytest.raises(RuntimeError, match="readonly"):
        tpde.FileStorage(str(path), write_mode="readonly").start_writing(fields[0])
    truncated = tpde.FileStorage(str(path), write_mode="truncate")
    _write_storage(tpde, path, fields[3:], [5.0], write_mode="truncate")
    reread = JFileStorage(str(path), write_mode="read_only")
    assert list(reread.times) == [5.0]
    reread.close()
    del truncated
    fixed = tpde.FileStorage(str(tmp_path / "fixed.h5"), max_length=1)
    fixed.start_writing(fields[0])
    fixed.append(fields[0], 0.0)
    with pytest.raises(Exception):
        fixed.append(fields[1], 1.0)
    fixed.close()


def test_solve_into_file_storage_matches_jax(tmp_path):
    runs = []
    for pkg in (jpde, tpde):
        data = np.random.default_rng(7).random((10, 10))
        kw = {} if pkg is jpde else {"dtype": torch.float64}
        state = pkg.ScalarField(pkg.UnitGrid([10, 10], periodic=True), data, **kw)
        storage = (JFileStorage if pkg is jpde else tpde.FileStorage)(
            str(tmp_path / f"{pkg.__name__}.h5"))
        pkg.DiffusionPDE(0.1).solve(state, t_range=2.0, dt=0.1,
                                    tracker=storage.tracker(0.5))
        runs.append(storage)
    _assert_same_storage(runs[1], runs[0])
    assert runs[1].info["controller"]["t_end"] == 2.0
    for storage in runs:
        storage.close()


class _Group:
    """A stand-in for a modelrunner storage group."""

    def __init__(self):
        self.arrays, self.attrs = {}, {}

    def write_array(self, loc, arr, attrs):
        self.arrays[loc], self.attrs[loc.rsplit("/", 1)[0]] = arr, attrs

    def read_array(self, loc):
        return self.arrays[loc]

    def read_attrs(self, loc):
        return self.attrs[loc]


def test_modelrunner_storage_with_a_group():
    group = _Group()
    storage = tpde.ModelrunnerStorage(group)
    assert storage.times == []
    _, tst = _storages()
    storage.start_writing(tst[0])
    for t, field in tst.items():
        storage.append(field, t)
    storage.end_writing()
    assert list(storage.times) == list(tst.times)
    _assert_same_storage(storage, tst)
