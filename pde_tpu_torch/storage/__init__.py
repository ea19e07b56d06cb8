"""Storage of simulation time series: in memory, in HDF5 files, in
modelrunner groups and in movie files."""

from .base import StorageBase, StorageTracker, StorageView
from .file import FileStorage
from .memory import MemoryStorage, get_memory_storage
from .modelrunner import ModelrunnerStorage
from .movie import MovieStorage
