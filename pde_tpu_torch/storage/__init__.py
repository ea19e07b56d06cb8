"""Storage of simulation time series: in memory, in HDF5 files and in
modelrunner groups. ``MovieStorage`` is ROADMAP A8's second item."""

from .base import StorageBase, StorageTracker, StorageView
from .file import FileStorage
from .memory import MemoryStorage, get_memory_storage
from .modelrunner import ModelrunnerStorage


def __getattr__(name: str):
    if name == "MovieStorage":
        raise NotImplementedError(
            "MovieStorage is not ported yet (ROADMAP A8, the movie storage and its codec)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
