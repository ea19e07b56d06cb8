"""Utilities of the port (configuration, online statistics)."""

from .config import Config, Parameter, config
from .math import OnlineStatistics
